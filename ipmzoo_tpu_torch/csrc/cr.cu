// Whole-reduction block cyclic reduction of an SPD block-tridiagonal
// matrix for Hopper (sm_90a): factor (K6) and multi right-hand-side solve
// (K7), with a plain C interface loaded through ctypes
// (ipmzoo_tpu_torch/ops/cuda_cr.py).
//
// K6 cr_factor_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/cr_pallas.py:_factor_kernel
// K7 cr_solve_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/cr_pallas.py:_solve_kernel
// Their plain versions are ipmzoo_tpu_torch/ops/cr.py:cr_factor_plain /
// cr_solve_plain, which repeat this file's arithmetic in the same order.
//
// What they compute.  D (N, b, b) diagonal and E (N-1, b, b) sub-diagonal
// blocks.  At the level of stride s = 1, 2, 4, ... < N the blocks at
// positions p = s, 3s, 5s, ... < N are eliminated: Pinv[p] is the explicit
// inverse of the pivot (Cholesky L, then L^-1 by forward substitution on
// the identity, then L^-T L^-1), Eb[p] / Ea[p] its couplings to p - s and
// p + s, the even blocks take their Schur updates and the couplings of
// the next level are formed.  Every position is eliminated at one level,
// position 0 is the root, so the factors are three (N, b, b) arrays
// indexed by block position.  The solve folds the odd right-hand sides
// into the even ones level by level (down-sweep), solves the root, and
// recovers the odd unknowns in reverse (up-sweep).
//
// What bounds them on this card.  At the banded+arrow slice's shape
// (N = 256, b = 16, float32) the factor reads 0.5 MB, writes 0.8 MB and
// does about 1e7 multiply-adds: memory traffic and arithmetic would both
// take about a microsecond.  The time is the latency of a chain of
// dependent steps, ceil(log2 N) levels of b Cholesky columns and a few
// b-long dot products each, run by the one thread block that owns the
// instance.
//
// Design.  One thread block per instance of the batch (gridDim.x = batch),
// all levels inside the kernel, __syncthreads() between the phases of a
// level.  A thread addresses block p +- s by index, so only the live
// pivots of a level are touched and N need not be a power of two.  Each
// phase is a flat loop over its output elements (pivot, row, column),
// strided over the block's threads, one dot product of length b per
// element; the Cholesky runs its b columns in turn with one thread per
// (pivot, row) and a barrier after every column.  The working copies of
// D and E, the Cholesky workspace and the solve's working right-hand
// sides live in global scratch that the wrapper allocates (at the
// slice's shape they exceed one SM's shared memory and stay in the L2).
// Scratch and outputs that are written and read again inside a kernel are
// not __restrict__ and are read with ordinary loads, which __syncthreads()
// keeps coherent within the block.  b and k are run-time arguments.
//
// Arithmetic is plain IEEE: no fast-math flags.
//
// K6 cluster route, cr_factor_kernel_cluster, replaces the same TPU kernel
// (cr_pallas.py:_factor_kernel), picked per call by ops/cuda_cr.py
// (k6_route) from times measured on an H100.  The block route above runs
// an instance on one SM with its working blocks in the L2, and waits on
// an L2 round trip and a block barrier at every Cholesky column: 0.71 ms
// at N = 256, b = 16, whatever the batch.  Here a thread-block cluster of
// C = 8 or 16 blocks (cudaLaunchKernelEx with a cluster dimension; 16
// needs the non-portable size) holds one instance, and the three working
// blocks of every position live in the shared memory of the rank that
// owns it (the map is stated once, above cr_factor_kernel_cluster).  A
// neighbour's blocks are read through distributed shared memory
// (cluster.map_shared_rank): a segment copies a neighbour's block it
// reads by broadcast into its own scratch first.  A segment of BP = 8 or
// 16 lanes (template parameter, b <= BP) handles one b x b block: the
// Cholesky, the triangular inverse and Pinv = X^T X in registers by
// shuffles, the b x b products of the coupling and update phases a
// column a lane over shared memory, one output block a segment.  Each
// element keeps this file's formula and
// order of accumulation (diagonal stored as 1 / L_jj, sqrt, dot products
// from their first term in increasing k), so ops/cr.py stays the plain
// version of both routes.  Two cluster barriers a level (after the
// pivots' inverses and couplings, after the even positions' updates) and
// none inside a block's Cholesky.  Pinv, Eb and Ea leave in the block
// route's (B, N, b, b) layout, which K7 reads unchanged; the route needs
// no global scratch.  What bounds it: a level's chain of dependent steps
// on one warp (the 16 x 16 inverse alone takes ~9 us), nine levels at
// N = 256 (PERF.md §6).
//
// K7 shared route, cr_solve_kernel_shared, replaces the same TPU kernel
// (cr_pallas.py:_solve_kernel), picked per call by ops/cuda_cr.py
// (k7_route) from times measured on an H100.  The block route above runs
// an instance on one SM and keeps the working right-hand sides, the
// per-level products and x in global scratch, so each of its 2 log2 N
// phases waits on L2 round trips for them before its barrier, and its
// b-long dot products (b and k run-time, nothing __restrict__) do not
// unroll.  The work is small (6 b^2 k (N - 1) multiply-adds, 3.5 M at
// N = 256, b = 16, k = 9) and the k columns are independent, as the TPU
// kernel's batch axis over them says.  So here a thread block takes one
// (instance, group of kc columns), grid (B, ceil(k / kc)): at one
// instance the solve spreads over several SMs, each block reading the
// factors (0.79 MB at the slice's shape in float32, in the L2 after K6)
// through const __restrict__ pointers.  The group's working right-hand
// sides and the level scratch live in shared memory, (N + N / 2) b kc
// values, and x overwrites them in place.  b is bounded by a template
// parameter (BP = 8 or 16, b <= BP), so the dot products unroll and a
// factor row's loads issue back to back.  Two barriers a level, as the
// block route, with no L2 round trip for the right-hand sides between
// them.  What bounds it: the load pipe of the one SM a group runs on.  A
// row product gives each lane its own factor row, so a warp's load of one
// column touches a cache line per pair of rows: the rows are read in
// 16-byte pieces where b = BP and the factors are aligned, and W's
// columns likewise where a group holds one column.  Then the chain of
// 2 log2 N + 2 phases, each an L2 round trip, b dependent multiply-adds
// and a barrier (PERF.md §6).  At most 512 threads a block, so a thread's
// factor row and W column stay in registers.

#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// Explicit inverses of the npiv pivots at positions first + i * step:
// P in Dw[p] (overwritten by L^-1), L in Xw[p], the inverse in Pinv[p].
// Ends with a barrier.
template <typename T>
__device__ void chol_inv_phase(T* Dw, T* Xw, T* Pinv, int npiv, int first,
                               int step, int b) {
  const int tid = threadIdx.x, nt = blockDim.x, bb = b * b;
  // Cholesky, column by column: thread (pivot, row i) forms L[i][j].  The
  // diagonal holds 1 / L[j][j]; every thread of a column recomputes it.
  const int rows = npiv * b;
  for (int base = 0; base < rows; base += nt) {
    const int idx = base + tid;
    const bool active = idx < rows;
    const int piv = active ? idx / b : 0;
    const int i = idx - piv * b;
    const int p = first + piv * step;
    const T* P = Dw + p * bb;
    T* L = Xw + p * bb;
    for (int j = 0; j < b; ++j) {
      if (active && i >= j) {
        T acc = P[j * b + j];
        for (int k = 0; k < j; ++k) acc -= L[j * b + k] * L[j * b + k];
        const T idj = T(1) / root(acc);
        if (i == j) {
          L[j * b + j] = idj;
        } else {
          T col = P[i * b + j];
          for (int k = 0; k < j; ++k) col -= L[i * b + k] * L[j * b + k];
          L[i * b + j] = col * idj;
        }
      }
      __syncthreads();
    }
  }
  // X = L^-1, thread (pivot, column j) down its column:
  // X[i][j] = (delta_ij - sum_{j <= k < i} L[i][k] X[k][j]) / L[i][i]
  for (int idx = tid; idx < rows; idx += nt) {
    const int piv = idx / b;
    const int j = idx - piv * b;
    const int p = first + piv * step;
    const T* L = Xw + p * bb;
    T* X = Dw + p * bb;
    X[j * b + j] = L[j * b + j];
    for (int i = j + 1; i < b; ++i) {
      T acc = L[i * b + j] * X[j * b + j];
      for (int k = j + 1; k < i; ++k) acc += L[i * b + k] * X[k * b + j];
      X[i * b + j] = (T(0) - acc) * L[i * b + i];
    }
  }
  __syncthreads();
  // Pinv[i][j] = sum_{k >= max(i, j)} X[k][i] X[k][j]
  const int elems = npiv * bb;
  for (int e = tid; e < elems; e += nt) {
    const int piv = e / bb;
    const int rem = e - piv * bb;
    const int i = rem / b, j = rem - (rem / b) * b;
    const int p = first + piv * step;
    const T* X = Dw + p * bb;
    const int lo = i > j ? i : j;
    T acc = X[lo * b + i] * X[lo * b + j];
    for (int k = lo + 1; k < b; ++k) acc += X[k * b + i] * X[k * b + j];
    Pinv[p * bb + rem] = acc;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cr_factor_kernel(const T* __restrict__ D, const T* __restrict__ E, T* Pinv,
                 T* Eb, T* Ea, T* Dw, T* Ew, T* Xw, int N, int b) {
  const int tid = threadIdx.x, nt = blockDim.x, bb = b * b;
  const int total = N * bb;
  const int64_t inst = static_cast<int64_t>(blockIdx.x);
  D += inst * total;
  E += inst * (total - bb);
  Pinv += inst * total;
  Eb += inst * total;
  Ea += inst * total;
  Dw += inst * total;
  Ew += inst * total;
  Xw += inst * total;

  // working copies; Ew[q] couples q and q + s at the current level
  for (int e = tid; e < total; e += nt) {
    Dw[e] = D[e];
    Ew[e] = e < total - bb ? E[e] : T(0);
    if (e < bb) {
      Eb[e] = T(0);
      Ea[e] = T(0);
    }
  }
  __syncthreads();

  for (int s = 1; s < N; s <<= 1) {
    const int npiv = (N + s - 1) / (2 * s);
    chol_inv_phase(Dw, Xw, Pinv, npiv, s, 2 * s, b);

    // per odd p: keep its couplings, T = Pinv Eb -> Xw[p],
    // G = Ea Pinv -> Dw[p] (both workspaces are dead after the inverse)
    for (int e = tid; e < npiv * bb; e += nt) {
      const int piv = e / bb;
      const int rem = e - piv * bb;
      const int i = rem / b, j = rem - (rem / b) * b;
      const int p = (2 * piv + 1) * s;
      const T* Pi = Pinv + p * bb;
      const T* eb = Ew + (p - s) * bb;
      const T* ea = Ew + p * bb;
      Eb[p * bb + rem] = eb[rem];
      Ea[p * bb + rem] = ea[rem];
      T t = Pi[i * b] * eb[j];
      T g = ea[i * b] * Pi[j];
      for (int k = 1; k < b; ++k) {
        t += Pi[i * b + k] * eb[k * b + j];
        g += ea[i * b + k] * Pi[k * b + j];
      }
      Xw[p * bb + rem] = t;
      Dw[p * bb + rem] = g;
    }
    __syncthreads();

    // per even q: D[q] -= Eb^T T of its right odd, then Ea Pinv Ea^T of
    // its left odd; the new coupling of q to q + 2s is -Ea T
    const int neven = (N + 2 * s - 1) / (2 * s);
    for (int e = tid; e < neven * bb; e += nt) {
      const int m = e / bb;
      const int rem = e - m * bb;
      const int i = rem / b, j = rem - (rem / b) * b;
      const int q = 2 * s * m;
      T de = Dw[q * bb + rem];
      T enew = T(0);
      const int pr = q + s;
      if (pr < N) {
        const T* eb = Eb + pr * bb;
        const T* t = Xw + pr * bb;
        T acc = eb[i] * t[j];
        for (int k = 1; k < b; ++k) acc += eb[k * b + i] * t[k * b + j];
        de -= acc;
        if (pr + s < N) {
          const T* ea = Ea + pr * bb;
          T a2 = ea[i * b] * t[j];
          for (int k = 1; k < b; ++k) a2 += ea[i * b + k] * t[k * b + j];
          enew = -a2;
        }
      }
      if (q > 0) {
        const T* g = Dw + (q - s) * bb;
        const T* ea = Ea + (q - s) * bb;
        T acc = g[i * b] * ea[j * b];
        for (int k = 1; k < b; ++k) acc += g[i * b + k] * ea[j * b + k];
        de -= acc;
      }
      Dw[q * bb + rem] = de;
      Ew[q * bb + rem] = enew;
    }
    __syncthreads();
  }
  chol_inv_phase(Dw, Xw, Pinv, 1, 0, 1, b);
}

// ---------------------------------------------------------------------
// K6 cluster route.
//
// Ownership, the one place it is stated: position p > 0 is eliminated at
// level l = ctz(p) as that level's pivot m = p >> (l + 1); position 0 is
// the root, counted as level L (the number of levels) with m = 0.  Block
// rank m % C of the instance's cluster of C blocks owns p and keeps its
// three working blocks (Dw, Ew, and Xw, which holds T at p's level) in
// slot slot_base[m % C][l] + m / C of its shared memory, where
// slot_base[r][l] counts rank r's positions at the levels before l.  So
// every level's pivots are spread over the cluster's ranks, a rank's
// pivots at level l are its slots slot_base[r][l] .. slot_base[r][l+1],
// and the even positions at level l (every position eliminated later)
// are its slots from slot_base[r][l+1] on.  ops/cuda_cr.py mirrors the
// map (cluster_owner, cluster_slots) and its tests check it.

constexpr int kMaxCluster = 16;
constexpr int kMaxLevels = 32;
constexpr int kTableInts = kMaxCluster * (kMaxLevels + 2);

// Bytes before the working blocks: the slot table and `slots` positions,
// rounded up to 16.
__host__ __device__ inline size_t cluster_head(int slots) {
  return (static_cast<size_t>(kTableInts + slots) * sizeof(int) + 15) / 16
         * 16;
}

__host__ __device__ inline int cr_levels(int N) {
  int L = 0;
  while ((1LL << L) < N) ++L;
  return L;
}

__host__ __device__ inline int cr_pivots(int N, int l, int L) {
  if (l == L) return 1;
  const long long s = 1LL << l;
  return static_cast<int>((N + s - 1) / (2 * s));
}

__host__ __device__ inline int cr_count(int N, int l, int L, int r, int C) {
  const int np = cr_pivots(N, l, L);
  return np > r ? (np - r - 1) / C + 1 : 0;
}

// Slots of rank r (rank 0 holds the most) and its positions at levels
// 1 .. L, the even positions of level 0.
__host__ __device__ inline int cr_slots(int N, int r, int C, int from) {
  const int L = cr_levels(N);
  int n = 0;
  for (int l = from; l <= L; ++l) n += cr_count(N, l, L, r, C);
  return n;
}

// One segment of BP lanes (BP = 8 or 16, b <= BP) per b x b block.  The
// inverse runs in registers (below); the products of the coupling and
// update phases run a column a lane, the other operand read from shared
// memory by all lanes at once (a broadcast), over a loop of rows.
// Padding lanes (>= b) compute on zeros and store nothing.  Blocks sit in
// shared memory at row stride R = b + 1.

// Explicit inverse of the SPD block P in cr_factor_kernel's arithmetic,
// row i in lane i's registers: the Cholesky factor right-looking (each
// entry subtracts its terms in increasing k, the diagonal kept as
// 1 / L_jj), X = L^-1 a column a lane, Pinv = X^T X, every operand of
// another lane taken by shuffle.  Leaves Pinv in S1 (lane j writes row
// j, which is column j: the sums are symmetric term by term); ends with
// a warp barrier.  (A shared-memory version of the same sums, a row or
// column a lane with a broadcast operand, took 12.1 us against these
// 8.7 us for b = 16 in float32 on an H100: PERF.md §6.)
template <typename T, int BP>
__device__ void chol_inv_seg(const T* P, T* S1, int b, int lane,
                             unsigned mask) {
  const int R = b + 1;
  T a[BP], lr[BP];
#pragma unroll
  for (int c = 0; c < BP; ++c) {
    a[c] = (lane < b && c < b) ? P[lane * R + c] : T(0);
    lr[c] = T(0);
  }
#pragma unroll
  for (int j = 0; j < BP; ++j) {
    if (j >= b) break;
    const T idj = T(1) / root(__shfl_sync(mask, a[j], j, BP));
    if (lane == j) lr[j] = idj;
    if (lane > j) lr[j] = a[j] * idj;
#pragma unroll
    for (int c = j + 1; c < BP; ++c) {
      const T lc = __shfl_sync(mask, lr[j], c, BP);   // L[c][j]
      if (lane > j && c <= lane) a[c] -= lr[j] * lc;
    }
  }
  // X = L^-1, lane j down column j: X[r][j] = (0 - L[r][j] X[j][j] -
  // sum_{j < k < r} L[r][k] X[k][j]) / L[r][r]
  T xc[BP];
#pragma unroll
  for (int k = 0; k < BP; ++k) xc[k] = k == lane ? lr[k] : T(0);
#pragma unroll
  for (int r = 1; r < BP; ++r) {
    if (r >= b) break;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < r; ++k) {
      const T lrk = __shfl_sync(mask, lr[k], r, BP);   // L[r][k]
      if (k == lane) acc = lrk * xc[k];
      if (k > lane) acc += lrk * xc[k];
    }
    const T lrr = __shfl_sync(mask, lr[r], r, BP);
    if (r > lane) xc[r] = (T(0) - acc) * lrr;
  }
  // Pinv[c][j] = sum_{k >= max(c, j)} X[k][c] X[k][j], column j in lane j
#pragma unroll
  for (int k = 0; k < BP; ++k) {
    if (k >= b) break;
#pragma unroll
    for (int c = 0; c <= k; ++c) {
      const T xkc = __shfl_sync(mask, xc[k], c, BP);   // X[k][c]
      const int lo = c > lane ? c : lane;
      if (k == lo) a[c] = xkc * xc[k];
      if (k > lo) a[c] += xkc * xc[k];
    }
  }
  if (lane < b) {
#pragma unroll
    for (int c = 0; c < BP; ++c) {
      if (c < b) S1[lane * R + c] = a[c];
    }
  }
  __syncwarp(mask);
}

// At most 256 threads a block.
constexpr int kClusterThreads = 256;
// Scratch blocks a segment: Pinv at the pivots and a copy of the right
// odd's Ea at the even positions; a copy of the left odd's G; the new
// couplings until Ew may be overwritten.
constexpr int kScratch = 3;

template <typename T, int BP>
__global__ void __launch_bounds__(kClusterThreads)
cr_factor_kernel_cluster(const T* __restrict__ D, const T* __restrict__ E,
                         T* __restrict__ Pinv, T* __restrict__ Eb,
                         T* __restrict__ Ea, int N, int b) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  // dynamic shared memory: the slot table, rank 0's slot positions, the
  // working blocks of rank 0's number of slots, each segment's scratch
  auto slot_base = reinterpret_cast<int(*)[kMaxLevels + 2]>(shared_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int L = cr_levels(N);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % BP, seg = tid / BP, nseg = nt / BP;
  const unsigned mask = (BP == 32 ? 0xffffffffu : ((1u << BP) - 1u))
                        << ((tid & 31) & ~(BP - 1));
  const int bb = b * b, R = b + 1, BS = b * R;
  const bool col = lane < b;
  const int64_t inst = static_cast<int64_t>(blockIdx.x) / C;
  const int64_t total = static_cast<int64_t>(N) * bb;
  D += inst * total;
  E += inst * (total - bb);
  Pinv += inst * total;
  Eb += inst * total;
  Ea += inst * total;

  for (int r = tid; r < C; r += nt) {
    int acc = 0;
    for (int l = 0; l <= L; ++l) {
      slot_base[r][l] = acc;
      acc += cr_count(N, l, L, r, C);
    }
    slot_base[r][L + 1] = acc;
  }
  __syncthreads();
  const int nslots = slot_base[rank][L + 1];
  const int mine0 = cr_slots(N, 0, C, 0);   // rank 0's slots: the layout
  int* slot_pos = reinterpret_cast<int*>(shared_raw) + kTableInts;
  T* V = reinterpret_cast<T*>(shared_raw + cluster_head(mine0));
  T* S1 = V + (static_cast<int64_t>(mine0) * 3 + seg * kScratch) * BS;
  T* S2 = S1 + BS;
  T* S3 = S2 + BS;
  for (int k = tid; k < nslots; k += nt) {
    int l = 0;
    while (slot_base[rank][l + 1] <= k) ++l;
    const int m = rank + C * (k - slot_base[rank][l]);
    slot_pos[k] = l == L ? 0 : (2 * m + 1) << l;
  }
  __syncthreads();
  // the working blocks of a slot: 0 Dw, 1 Ew, 2 Xw (T at its level)
  auto blk = [&](T* base, int slot, int which) {
    return base + (static_cast<int64_t>(slot) * 3 + which) * BS;
  };
  // block `which` of position p, in the shared memory of its owner
  auto remote = [&](int p, int which) {
    int r = 0, k = slot_base[0][L];
    if (p > 0) {
      const int l = __ffs(p) - 1, m = p >> (l + 1);
      r = m % C;
      k = slot_base[r][l] + m / C;
    }
    return blk(cluster.map_shared_rank(V, r), k, which);
  };

  for (int k = seg; k < nslots; k += nseg) {
    const int64_t p = slot_pos[k];
    T* Dk = blk(V, k, 0);
    T* Ek = blk(V, k, 1);
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      if (!col || i >= b) continue;
      Dk[i * R + lane] = D[p * bb + i * b + lane];
      Ek[i * R + lane] = p < N - 1 ? E[p * bb + i * b + lane] : T(0);
    }
  }
  if (rank == 0) {
    for (int e = tid; e < bb; e += nt) {
      Eb[e] = T(0);
      Ea[e] = T(0);
    }
  }
  cluster.sync();

  for (int l = 0; l < L; ++l) {
    const int s = 1 << l;
    // the pivots: inverse, couplings, T = Pinv Eb -> Xw, G = Ea Pinv -> Dw
    for (int k = slot_base[rank][l] + seg; k < slot_base[rank][l + 1];
         k += nseg) {
      const int64_t go = static_cast<int64_t>(slot_pos[k]) * bb;
      T* Dp = blk(V, k, 0);
      const T* Ep = blk(V, k, 1);
      T* Xp = blk(V, k, 2);
      chol_inv_seg<T, BP>(Dp, S1, b, lane, mask);
      const T* Er = remote(slot_pos[k] - s, 1);
      T pc[BP], ec[BP];   // column `lane` of Pinv and of Eb
#pragma unroll
      for (int kk = 0; kk < BP; ++kk) {
        pc[kk] = (col && kk < b) ? S1[kk * R + lane] : T(0);
        ec[kk] = (col && kk < b) ? Er[kk * R + lane] : T(0);
        if (col && kk < b) {
          Pinv[go + kk * b + lane] = pc[kk];
          Eb[go + kk * b + lane] = ec[kk];
          Ea[go + kk * b + lane] = Ep[kk * R + lane];
        }
      }
#pragma unroll 2
      for (int i = 0; i < b; ++i) {
        T t = T(0), g = T(0);
#pragma unroll
        for (int kk = 0; kk < BP; ++kk) {
          if (kk >= b) break;
          const T pik = S1[i * R + kk], eik = Ep[i * R + kk];
          t = kk == 0 ? pik * ec[0] : t + pik * ec[kk];
          g = kk == 0 ? eik * pc[0] : g + eik * pc[kk];
        }
        if (col) {
          Xp[i * R + lane] = t;
          Dp[i * R + lane] = g;
        }
      }
      __syncwarp(mask);
    }
    cluster.sync();

    // the even positions: D[q] -= Eb^T T of the right odd, then G Ea^T of
    // the left odd; the new coupling of q to q + 2s is -Ea T
    for (int k = slot_base[rank][l + 1] + seg; k < nslots; k += nseg) {
      const int q = slot_pos[k];
      T* Dq = blk(V, k, 0);
      T* Eq = blk(V, k, 1);   // Eb of q + s, read before it is replaced
      const int pr = q + s;
      const bool has_r = pr < N, right = pr + s < N, has_l = q > 0;
      T tc[BP], ac[BP];   // column `lane` of T[pr]; row `lane` of Ea[q - s]
      const T* Tr = has_r ? remote(pr, 2) : nullptr;
      const T* Ar = right ? remote(pr, 1) : nullptr;
      const T* Gl = has_l ? remote(q - s, 0) : nullptr;
      const T* Al = has_l ? remote(q - s, 1) : nullptr;
#pragma unroll
      for (int kk = 0; kk < BP; ++kk) {
        const bool in = col && kk < b;
        tc[kk] = (in && has_r) ? Tr[kk * R + lane] : T(0);
        ac[kk] = (in && has_l) ? Al[lane * R + kk] : T(0);
      }
      // the broadcast operands, copied from their owners: Ea[pr] -> S1,
      // G[q - s] -> S2
#pragma unroll
      for (int i = 0; i < BP; ++i) {
        if (!col || i >= b) continue;
        if (right) S1[i * R + lane] = Ar[i * R + lane];
        if (has_l) S2[i * R + lane] = Gl[i * R + lane];
      }
      __syncwarp(mask);
#pragma unroll 2
      for (int i = 0; i < b; ++i) {
        T de = col ? Dq[i * R + lane] : T(0), en = T(0);
        if (has_r) {
          T acc = T(0), a2 = T(0);
#pragma unroll
          for (int kk = 0; kk < BP; ++kk) {
            if (kk >= b) break;
            const T ebki = Eq[kk * R + i];
            acc = kk == 0 ? ebki * tc[0] : acc + ebki * tc[kk];
            if (right) {
              const T aik = S1[i * R + kk];
              a2 = kk == 0 ? aik * tc[0] : a2 + aik * tc[kk];
            }
          }
          de -= acc;
          if (right) en = -a2;
        }
        if (has_l) {
          T acc = T(0);
#pragma unroll
          for (int kk = 0; kk < BP; ++kk) {
            if (kk >= b) break;
            const T gik = S2[i * R + kk];
            acc = kk == 0 ? gik * ac[0] : acc + gik * ac[kk];
          }
          de -= acc;
        }
        if (col) {
          Dq[i * R + lane] = de;
          S3[i * R + lane] = en;
        }
      }
      __syncwarp(mask);
#pragma unroll
      for (int i = 0; i < BP; ++i) {
        if (col && i < b) Eq[i * R + lane] = S3[i * R + lane];
      }
      __syncwarp(mask);
    }
    cluster.sync();
  }

  // the root, position 0, on rank 0
  if (rank == 0 && seg == 0) {
    chol_inv_seg<T, BP>(blk(V, slot_base[0][L], 0), S1, b, lane, mask);
#pragma unroll
    for (int i = 0; i < BP; ++i) {
      if (col && i < b) Pinv[i * b + lane] = S1[i * R + lane];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cr_solve_kernel(const T* __restrict__ Pinv, const T* __restrict__ Eb,
                const T* __restrict__ Ea, const T* __restrict__ r, T* x,
                T* Rw, T* Gw, int N, int b, int k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bb = b * b, bk = b * k;
  const int64_t inst = static_cast<int64_t>(blockIdx.x);
  Pinv += inst * N * bb;
  Eb += inst * N * bb;
  Ea += inst * N * bb;
  r += inst * N * bk;
  x += inst * N * bk;
  Rw += inst * N * bk;
  Gw += inst * N * bk;

  for (int e = tid; e < N * bk; e += nt) Rw[e] = r[e];
  __syncthreads();

  // down-sweep; the odd entries of Rw keep their value at their level
  int top = 0;
  for (int s = 1; s < N; s <<= 1) {
    top = s;
    const int npiv = (N + s - 1) / (2 * s);
    for (int e = tid; e < npiv * bk; e += nt) {
      const int piv = e / bk;
      const int rem = e - piv * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int p = (2 * piv + 1) * s;
      const T* Pi = Pinv + p * bb + i * b;
      const T* R = Rw + p * bk + c;
      T acc = Pi[0] * R[0];
      for (int j = 1; j < b; ++j) acc += Pi[j] * R[j * k];
      Gw[p * bk + rem] = acc;
    }
    __syncthreads();
    const int neven = (N + 2 * s - 1) / (2 * s);
    for (int e = tid; e < neven * bk; e += nt) {
      const int m = e / bk;
      const int rem = e - m * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int q = 2 * s * m;
      T v = Rw[q * bk + rem];
      if (q + s < N) {
        const T* eb = Eb + (q + s) * bb + i;
        const T* g = Gw + (q + s) * bk + c;
        T acc = eb[0] * g[0];
        for (int j = 1; j < b; ++j) acc += eb[j * b] * g[j * k];
        v -= acc;
      }
      if (q > 0) {
        const T* ea = Ea + (q - s) * bb + i * b;
        const T* g = Gw + (q - s) * bk + c;
        T acc = ea[0] * g[0];
        for (int j = 1; j < b; ++j) acc += ea[j] * g[j * k];
        v -= acc;
      }
      Rw[q * bk + rem] = v;
    }
    __syncthreads();
  }

  // root
  for (int e = tid; e < bk; e += nt) {
    const int i = e / k, c = e - (e / k) * k;
    const T* Pi = Pinv + i * b;
    const T* R = Rw + c;
    T acc = Pi[0] * R[0];
    for (int j = 1; j < b; ++j) acc += Pi[j] * R[j * k];
    x[e] = acc;
  }
  __syncthreads();

  // up-sweep
  for (int s = top; s >= 1; s >>= 1) {
    const int npiv = (N + s - 1) / (2 * s);
    for (int e = tid; e < npiv * bk; e += nt) {
      const int piv = e / bk;
      const int rem = e - piv * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int p = (2 * piv + 1) * s;
      T v = Rw[p * bk + rem];
      {
        const T* eb = Eb + p * bb + i * b;
        const T* xl = x + (p - s) * bk + c;
        T acc = eb[0] * xl[0];
        for (int j = 1; j < b; ++j) acc += eb[j] * xl[j * k];
        v -= acc;
      }
      if (p + s < N) {
        const T* ea = Ea + p * bb + i;
        const T* xr = x + (p + s) * bk + c;
        T acc = ea[0] * xr[0];
        for (int j = 1; j < b; ++j) acc += ea[j * b] * xr[j * k];
        v -= acc;
      }
      Gw[p * bk + rem] = v;
    }
    __syncthreads();
    for (int e = tid; e < npiv * bk; e += nt) {
      const int piv = e / bk;
      const int rem = e - piv * bk;
      const int i = rem / k, c = rem - (rem / k) * k;
      const int p = (2 * piv + 1) * s;
      const T* Pi = Pinv + p * bb + i * b;
      const T* g = Gw + p * bk + c;
      T acc = Pi[0] * g[0];
      for (int j = 1; j < b; ++j) acc += Pi[j] * g[j * k];
      x[p * bk + rem] = acc;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// K7 shared route.
//
// BP consecutive values at a 16-byte aligned F (a factor row in device
// memory, or a column of one in shared memory), in 16-byte loads.
template <int BP>
__device__ __forceinline__ void load_row(const float* F, float (&f)[BP]) {
#pragma unroll
  for (int q = 0; q < BP / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(F)[q];
    f[4 * q] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
}

template <int BP>
__device__ __forceinline__ void load_row(const double* F, double (&f)[BP]) {
#pragma unroll
  for (int q = 0; q < BP / 2; ++q) {
    const double2 v = reinterpret_cast<const double2*>(F)[q];
    f[2 * q] = v.x;
    f[2 * q + 1] = v.y;
  }
}

// acc = F[0] W[0] + F[fs] W[ws] + ... over b terms, in increasing order
// from the first product (cr_solve_kernel's order), along a row of the
// factor block (ROW: fs = 1) or down a column (fs = b).  The factor's b
// values are loaded first, back to back; BP >= b bounds the unrolling.
// A row of b = BP values, 16-byte aligned (`vec`), comes in 16-byte
// loads: with a lane a row, a warp's scalar loads of one column touch as
// many cache lines as it has rows, 4 (float32) or 2 (float64) times the
// lines of the same row read in 16-byte pieces.  So does W's column from
// shared memory where it is contiguous (ws = 1, one column a group), each
// 16-byte load a broadcast to the lanes of one position.
template <typename T, int BP, bool ROW>
__device__ __forceinline__ T dot_bp(const T* __restrict__ F, const T* W,
                                    int ws, int b, bool vec) {
  T f[BP];
  if (ROW && vec) {
    load_row<BP>(F, f);
  } else {
    const int fs = ROW ? 1 : b;
#pragma unroll
    for (int j = 0; j < BP; ++j) f[j] = j < b ? F[j * fs] : T(0);
  }
  if (b == BP && ws == 1) {
    T wv[BP];
    load_row<BP>(W, wv);
    T acc = f[0] * wv[0];
#pragma unroll
    for (int j = 1; j < BP; ++j) acc += f[j] * wv[j];
    return acc;
  }
  T acc = f[0] * W[0];
#pragma unroll
  for (int j = 1; j < BP; ++j) {
    if (j < b) acc += f[j] * W[j * ws];
  }
  return acc;
}

// One thread block per (instance, group of kc columns): blockIdx.y takes
// columns c0 = y kc .. c0 + w - 1.  The group's working right-hand sides
// W (N, b, w) sit in dynamic shared memory and the up-sweep overwrites
// them with x in place: every position p >= 1 is a pivot at exactly one
// level, so an odd entry keeps its down-sweep value until its level of
// the up-sweep, and by then its neighbours p -+ s (multiples of 2s) hold
// their x.  G ((N + 1) / 2, b, w) holds the down-sweep's Pinv W and the
// up-sweep's right-hand sides by pivot rank within the level; the root
// uses it as a temporary.  Each output element keeps cr_solve_kernel's
// formula and order, its lane map too (column fastest, then row, then
// position: row products read one factor row broadcast over the columns,
// transposed products contiguous rows across lanes).
// At most 512 threads a block: a thread keeps a factor row and a column
// of W in registers (2 BP values), which at 1024 threads (64 registers)
// spilled.
constexpr int kSharedThreads = 512;

template <typename T, int BP>
__global__ void __launch_bounds__(kSharedThreads)
cr_solve_kernel_shared(const T* __restrict__ Pinv, const T* __restrict__ Eb,
                       const T* __restrict__ Ea, const T* __restrict__ r,
                       T* __restrict__ x, int N, int b, int k, int kc,
                       bool vec) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bb = b * b;
  const int c0 = static_cast<int>(blockIdx.y) * kc;
  const int w = k - c0 < kc ? k - c0 : kc;
  const int bw = b * w;
  T* W = reinterpret_cast<T*>(shared_raw);
  T* G = W + static_cast<size_t>(N) * bw;
  const int64_t inst = static_cast<int64_t>(blockIdx.x);
  Pinv += inst * N * bb;
  Eb += inst * N * bb;
  Ea += inst * N * bb;
  r += inst * N * b * k;
  x += inst * N * b * k;

  for (int e = tid; e < N * bw; e += nt) {
    const int row = e / w;
    W[e] = r[static_cast<int64_t>(row) * k + c0 + (e - row * w)];
  }
  __syncthreads();

  // down-sweep
  int top = 0;
  for (int s = 1; s < N; s <<= 1) {
    top = s;
    const int npiv = (N + s - 1) / (2 * s);
    for (int e = tid; e < npiv * bw; e += nt) {
      const int piv = e / bw, rem = e - piv * bw;
      const int i = rem / w, c = rem - i * w;
      const int p = (2 * piv + 1) * s;
      G[e] = dot_bp<T, BP, true>(Pinv + p * bb + i * b, W + p * bw + c, w,
                                 b, vec);
    }
    __syncthreads();
    const int neven = (N + 2 * s - 1) / (2 * s);
    for (int e = tid; e < neven * bw; e += nt) {
      const int m = e / bw, rem = e - m * bw;
      const int i = rem / w, c = rem - i * w;
      const int q = 2 * s * m;
      T v = W[q * bw + rem];
      if (q + s < N) {
        v -= dot_bp<T, BP, false>(Eb + (q + s) * bb + i, G + m * bw + c, w,
                                  b, vec);
      }
      if (q > 0) {
        v -= dot_bp<T, BP, true>(Ea + (q - s) * bb + i * b,
                                 G + (m - 1) * bw + c, w, b, vec);
      }
      W[q * bw + rem] = v;
    }
    __syncthreads();
  }

  // root, through G
  for (int e = tid; e < bw; e += nt) {
    const int i = e / w, c = e - i * w;
    G[e] = dot_bp<T, BP, true>(Pinv + i * b, W + c, w, b, vec);
  }
  __syncthreads();
  for (int e = tid; e < bw; e += nt) W[e] = G[e];
  __syncthreads();

  // up-sweep
  for (int s = top; s >= 1; s >>= 1) {
    const int npiv = (N + s - 1) / (2 * s);
    for (int e = tid; e < npiv * bw; e += nt) {
      const int piv = e / bw, rem = e - piv * bw;
      const int i = rem / w, c = rem - i * w;
      const int p = (2 * piv + 1) * s;
      T v = W[p * bw + rem];
      v -= dot_bp<T, BP, true>(Eb + p * bb + i * b, W + (p - s) * bw + c, w,
                               b, vec);
      if (p + s < N) {
        v -= dot_bp<T, BP, false>(Ea + p * bb + i, W + (p + s) * bw + c, w,
                                  b, vec);
      }
      G[e] = v;
    }
    __syncthreads();
    for (int e = tid; e < npiv * bw; e += nt) {
      const int piv = e / bw, rem = e - piv * bw;
      const int i = rem / w, c = rem - i * w;
      const int p = (2 * piv + 1) * s;
      W[p * bw + rem] =
          dot_bp<T, BP, true>(Pinv + p * bb + i * b, G + piv * bw + c, w, b,
                              vec);
    }
    __syncthreads();
  }

  for (int e = tid; e < N * bw; e += nt) {
    const int row = e / w;
    x[static_cast<int64_t>(row) * k + c0 + (e - row * w)] = W[e];
  }
}

// Threads for one instance: the widest phase's element count rounded up
// to a warp, at most `most`.
int threads_for(int64_t elements, int most = kMaxThreads) {
  int64_t t = (elements + 31) / 32 * 32;
  if (t < 32) t = 32;
  if (t > most) t = most;
  return static_cast<int>(t);
}

template <typename T>
int launch_factor(const T* D, const T* E, T* Pinv, T* Eb, T* Ea, T* Dw,
                  T* Ew, T* Xw, int N, int b, int64_t B,
                  cudaStream_t stream) {
  const int threads = threads_for(static_cast<int64_t>((N + 1) / 2) * b * b);
  cr_factor_kernel<T><<<static_cast<unsigned int>(B), threads, 0, stream>>>(
      D, E, Pinv, Eb, Ea, Dw, Ew, Xw, N, b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const T* Pinv, const T* Eb, const T* Ea, const T* r, T* x,
                 T* Rw, T* Gw, int N, int b, int k, int64_t B,
                 cudaStream_t stream) {
  const int threads = threads_for(static_cast<int64_t>((N + 1) / 2) * b * k);
  cr_solve_kernel<T><<<static_cast<unsigned int>(B), threads, 0, stream>>>(
      Pinv, Eb, Ea, r, x, Rw, Gw, N, b, k);
  return static_cast<int>(cudaGetLastError());
}

// The most dynamic shared memory a block may take on sm_90, in bytes.
constexpr int kSharedCap = 232448;

// The cluster route's launch: threads a block and dynamic shared memory
// (rank 0's slot positions, then its slots' three working blocks at row
// stride b + 1).
struct ClusterShape {
  int threads;
  size_t shared;
};

template <typename T, int BP>
ClusterShape cluster_shape(int N, int b, int C) {
  const int slots = cr_slots(N, 0, C, 0);
  const int pivots0 = cr_slots(N, 0, C, 0) - cr_slots(N, 0, C, 1);
  const int evens0 = cr_slots(N, 0, C, 1);
  int seg = pivots0 > evens0 ? pivots0 : evens0;
  if (seg < 1) seg = 1;
  if (seg > kClusterThreads / BP) seg = kClusterThreads / BP;
  return {seg * BP,
          cluster_head(slots) + static_cast<size_t>(slots * 3 + seg *
                                                    kScratch) *
                                    b * (b + 1) * sizeof(T)};
}

template <typename T, int BP>
cudaLaunchConfig_t cluster_config(int N, int b, int C, int64_t B,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  const ClusterShape sh = cluster_shape<T, BP>(N, b, C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(B * C), 1, 1);
  cfg.blockDim = dim3(sh.threads, 1, 1);
  cfg.dynamicSmemBytes = sh.shared;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Raise the kernel's dynamic shared-memory limit, and with `cluster` allow
// clusters of 16, once per device (bit d of `done`), so a launch captured
// in a CUDA graph makes no such call.
template <typename Kernel>
int allow_limits(Kernel kernel, std::atomic<unsigned>& done, bool cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  done.fetch_or(bit);
  return 0;
}

template <typename T, int BP>
int launch_factor_cluster_at(const T* D, const T* E, T* Pinv, T* Eb, T* Ea,
                             int N, int b, int64_t B, int C,
                             cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  const int err =
      allow_limits(cr_factor_kernel_cluster<T, BP>, done, true);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<T, BP>(N, b, C, B, stream, &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, cr_factor_kernel_cluster<T, BP>, D, E, Pinv, Eb, Ea, N, b);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool cluster_fits(int N, int b, int C) {
  if (b < 1 || b > 16 || C < 1 || C > kMaxCluster || N < 1) return false;
  const size_t shared = b <= 8 ? cluster_shape<T, 8>(N, b, C).shared
                               : cluster_shape<T, 16>(N, b, C).shared;
  return shared <= static_cast<size_t>(kSharedCap);
}

template <typename T>
int launch_factor_cluster(const T* D, const T* E, T* Pinv, T* Eb, T* Ea,
                          int N, int b, int64_t B, int C,
                          cudaStream_t stream) {
  if (!cluster_fits<T>(N, b, C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 8) {
    return launch_factor_cluster_at<T, 8>(D, E, Pinv, Eb, Ea, N, b, B, C,
                                          stream);
  }
  return launch_factor_cluster_at<T, 16>(D, E, Pinv, Eb, Ea, N, b, B, C,
                                         stream);
}

// What the cluster route's launch at (N, b, C) takes: threads a block,
// dynamic shared memory, and cudaOccupancyMaxActiveClusters.
template <typename T, int BP>
int cluster_occupancy_at(int N, int b, int C, int* out) {
  static std::atomic<unsigned> done{0};
  const int err =
      allow_limits(cr_factor_kernel_cluster<T, BP>, done, true);
  if (err) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config<T, BP>(N, b, C, 1, nullptr, &attr);
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(
                     cr_factor_kernel_cluster<T, BP>), &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = static_cast<int>(cfg.blockDim.x);
  out[1] = static_cast<int>(cfg.dynamicSmemBytes);
  out[2] = clusters;
  return 0;
}

template <typename T>
int cluster_occupancy(int N, int b, int C, int* out) {
  if (!cluster_fits<T>(N, b, C)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return b <= 8 ? cluster_occupancy_at<T, 8>(N, b, C, out)
                : cluster_occupancy_at<T, 16>(N, b, C, out);
}

template <typename T, int BP>
int launch_solve_shared_at(const T* Pinv, const T* Eb, const T* Ea,
                           const T* r, T* x, int N, int b, int k, int kc,
                           int64_t B, size_t shared, cudaStream_t stream) {
  static std::atomic<unsigned> done{0};
  if (shared > 48 * 1024) {
    const int err = allow_limits(cr_solve_kernel_shared<T, BP>, done, false);
    if (err) return err;
  }
  const int threads = threads_for(static_cast<int64_t>((N + 1) / 2) * b * kc,
                                  kSharedThreads);
  const dim3 grid(static_cast<unsigned int>(B),
                  static_cast<unsigned int>((k + kc - 1) / kc));
  // 16-byte row loads where a row is BP values and the factors are
  // aligned (so is every row then: b^2 and b are multiples of 4)
  const auto aligned = [](const T* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = b == BP && aligned(Pinv) && aligned(Eb) && aligned(Ea);
  cr_solve_kernel_shared<T, BP><<<grid, threads, shared, stream>>>(
      Pinv, Eb, Ea, r, x, N, b, k, kc, vec);
  return static_cast<int>(cudaGetLastError());
}

// The K7 shared route: the working right-hand sides of kc columns and the
// scratch G, (N + (N + 1) / 2) b kc values, in shared memory.
template <typename T>
int launch_solve_shared(const T* Pinv, const T* Eb, const T* Ea, const T* r,
                        T* x, int N, int b, int k, int kc, int64_t B,
                        cudaStream_t stream) {
  if (N < 1 || b < 1 || b > 16 || kc < 1 || kc > k ||
      (k + kc - 1) / kc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = static_cast<size_t>(N + (N + 1) / 2) * b * kc *
                        sizeof(T);
  if (shared > static_cast<size_t>(kSharedCap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 8) {
    return launch_solve_shared_at<T, 8>(Pinv, Eb, Ea, r, x, N, b, k, kc, B,
                                        shared, stream);
  }
  return launch_solve_shared_at<T, 16>(Pinv, Eb, Ea, r, x, N, b, k, kc, B,
                                       shared, stream);
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous arrays with the batch axis first: D, Pinv, Eb, Ea and the
// scratch Dw, Ew, Xw are (B, N, b, b); E is (B, N-1, b, b); r, x and the
// scratch Rw, Gw are (B, N, b, k).  The caller guarantees N, b, k, B > 0
// and N * b * max(b, k) < 2^31.
extern "C" {

int ipmzoo_cr_factor_f32(const float* D, const float* E, float* Pinv,
                         float* Eb, float* Ea, float* Dw, float* Ew,
                         float* Xw, int N, int b, long long B,
                         void* stream) {
  return launch_factor<float>(D, E, Pinv, Eb, Ea, Dw, Ew, Xw, N, b, B,
                              static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_factor_f64(const double* D, const double* E, double* Pinv,
                         double* Eb, double* Ea, double* Dw, double* Ew,
                         double* Xw, int N, int b, long long B,
                         void* stream) {
  return launch_factor<double>(D, E, Pinv, Eb, Ea, Dw, Ew, Xw, N, b, B,
                               static_cast<cudaStream_t>(stream));
}

// The K6 cluster route takes the block route's D, E, Pinv, Eb, Ea and no
// scratch, with 1 <= b <= 16, 1 <= C <= 16, B C < 2^31 and the shared
// memory of cluster_shape within 232448 bytes.  The occupancy functions
// write threads a block, dynamic shared bytes and
// cudaOccupancyMaxActiveClusters into out[0..2].
int ipmzoo_cr_factor_cluster_f32(const float* D, const float* E,
                                 float* Pinv, float* Eb, float* Ea, int N,
                                 int b, long long B, int C, void* stream) {
  return launch_factor_cluster<float>(D, E, Pinv, Eb, Ea, N, b, B, C,
                                      static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_factor_cluster_f64(const double* D, const double* E,
                                 double* Pinv, double* Eb, double* Ea, int N,
                                 int b, long long B, int C, void* stream) {
  return launch_factor_cluster<double>(D, E, Pinv, Eb, Ea, N, b, B, C,
                                       static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_factor_cluster_occupancy_f32(int N, int b, int C, int* out) {
  return cluster_occupancy<float>(N, b, C, out);
}

int ipmzoo_cr_factor_cluster_occupancy_f64(int N, int b, int C, int* out) {
  return cluster_occupancy<double>(N, b, C, out);
}

int ipmzoo_cr_solve_f32(const float* Pinv, const float* Eb, const float* Ea,
                        const float* r, float* x, float* Rw, float* Gw,
                        int N, int b, int k, long long B, void* stream) {
  return launch_solve<float>(Pinv, Eb, Ea, r, x, Rw, Gw, N, b, k, B,
                             static_cast<cudaStream_t>(stream));
}

// The K7 shared route takes the block route's Pinv, Eb, Ea, r and x and no
// scratch, with 1 <= b <= 16, 1 <= kc <= k, ceil(k / kc) <= 65535 groups
// and (N + (N + 1) / 2) b kc sizeof(T) <= 232448 bytes of shared memory.
int ipmzoo_cr_solve_shared_f32(const float* Pinv, const float* Eb,
                               const float* Ea, const float* r, float* x,
                               int N, int b, int k, int kc, long long B,
                               void* stream) {
  return launch_solve_shared<float>(Pinv, Eb, Ea, r, x, N, b, k, kc, B,
                                    static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_solve_shared_f64(const double* Pinv, const double* Eb,
                               const double* Ea, const double* r, double* x,
                               int N, int b, int k, int kc, long long B,
                               void* stream) {
  return launch_solve_shared<double>(Pinv, Eb, Ea, r, x, N, b, k, kc, B,
                                     static_cast<cudaStream_t>(stream));
}

int ipmzoo_cr_solve_f64(const double* Pinv, const double* Eb,
                        const double* Ea, const double* r, double* x,
                        double* Rw, double* Gw, int N, int b, int k,
                        long long B, void* stream) {
  return launch_solve<double>(Pinv, Eb, Ea, r, x, Rw, Gw, N, b, k, B,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
