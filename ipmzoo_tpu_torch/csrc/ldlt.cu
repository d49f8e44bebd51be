// Batched LDL^T factor (K2), single right-hand-side solve (K3), multi
// right-hand-side solve (K4) and fused factor + multi right-hand-side
// solve (K5) for Hopper (sm_90a), with a plain C interface loaded through
// ctypes (ipmzoo_tpu_torch/ops/cuda_ldlt.py).
//
// K2 ldlt_factor_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_factor_kernel
// K3 ldlt_solve_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_solve_kernel
// K4 ldlt_solve_matrix_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_solve_matrix_kernel
// K5 ldlt_factor_solve_matrix_kernel replaces the TPU kernel
//     ipmzoo_tpu/ops/pallas_ldlt.py:_factor_solve_matrix_kernel
// Their plain versions are ipmzoo_tpu_torch/ops/ldlt.py:ldlt / solve_ldlt
// / solve_ldlt_matrix / ldlt_solve_matrix.
//
// What bounds them on this card.  The solver factors one small augmented
// KKT system per QP instance and per iteration: at n = 24 that is about
// 2.3 KB of f32 matrix per instance, read once and written once, for
// about 2.3k multiply-adds (n^3/6).  At ~1 FMA per byte moved the work
// sits far below the card's compute ridge, so the kernels are bound by
// memory traffic and, at the batch sizes of the solver's tail stages
// (a few hundred instances), by latency.
//
// Design.  One thread per QP instance, as the TPU kernels put one
// instance on each vector lane.  Matrices are stored structure-of-arrays,
// (n, n, B) with the batch index fastest, so the 32 threads of a warp
// that read element (i, j) of 32 neighbouring instances touch one
// contiguous 128-byte line (f32): every load and store is coalesced, and
// each instance's matrix crosses device memory once in and once out.
// The column loop re-reads finished columns of L, which stay in L1/L2.
// There is no shared-memory staging and no warp-level cooperation yet;
// n is a runtime argument.
//
// Arithmetic is plain IEEE: no fast-math flags.  An exactly-zero pivot,
// and only that, is replaced by pivot_floor, as in the plain version.
//
// K4 solves k right-hand sides against one factor (the Schur-complement
// IPM's H^-1 F^T panel: n = 64, k = 16, B = 512 blocks).  The TPU kernel
// reads each factor once for all k columns from VMEM.  Here the first
// design is one thread per (instance, column): the grid is
// (ceil(B / 128), k), so the threads of one warp are 32 neighbouring
// instances of the same column and every load and store is coalesced;
// the k threads of one instance re-read the same factor, which L1/L2
// serve after the first column (an f32 factor panel of 512 instances at
// n = 64 is 8 MB, far inside the 50 MB L2).  Rhs and solution are SoA
// (n, k, B).  The forward sweep accumulates each row in a register in
// the order of the plain version's column sweep.  This thread route stays
// above the warp route's shared memory (ops/cuda_ldlt.py:k4_route).
//
// K4 warp route, ldlt_solve_matrix_kernel_warp, replaces the same TPU
// kernel (pallas_ldlt.py:_solve_matrix_kernel).  The thread route reads
// the factor k times, once per column, each thread n^2 dependent loads
// with x read and written in device memory inside its loops: a chain of
// L2 round trips, not bytes (16.9 MB at the Schur shape take 5 us) nor
// multiply-adds.  Here, as the TPU kernel, each factor is read once for
// all k columns: a block stages a tile of G instances of L's strict lower
// triangle and D as K3's warp route does (stage_factor), and segments of
// a warp (SEG lanes, R rows a lane) each solve one matrix's group of
// KC = 4 right-hand sides in registers: several warps share one staged
// factor (at n = 64, k = 16: four warps a matrix).  R is read and X
// written in the public layout (B, n, k) through the tile, so the caller
// needs no transpose.  The forward sweep shuffles x_j from its owner
// (the thread route's order per row), then the division by D, then the
// backward sweep column by column from the last (rounding differs from
// the plain version's row sums).  Where the tile's right-hand sides do not
// fit beside the factor the block walks column chunks against it.  What
// bounds it: one dependent shuffle-FMA step per row and sweep, 2 n steps
// of KC columns, and the staging of a 168 KB tile per SM at the Schur
// shape.

//
// K5 factors each matrix and solves its k right-hand sides in one launch,
// with the factor never leaving the chip between the two halves, as the
// TPU kernel keeps it in VMEM.  Its callers are the levels of the
// nested-dissection factorisation: 16 to a few hundred matrices of order
// 16-64 with 40-64 right-hand sides each (the boundary coupling), and a
// benchmark point of 10240 matrices of order 32 with 2.  The TPU kernel
// puts 128 or more instances on the vector lanes; one thread per instance
// would leave this card empty at a level's batch (K2 at n = 64 runs
// hundreds of instances on a few SMs).  So K5 is one thread block per
// matrix, layout (B, n, n) / (B, n, k) as the callers hold it, no
// transpose.  What bounds it: the bytes are one read of A and R and one
// write of L, D and X, 2/3 n^3 + 4 k n^2 operations against
// (2 n^2 + n + 2 n k) values, about 30 operations per byte at a level's
// shape in float32: under the card's ridge, so the bound is bytes, and
// the time is the latency of n dependent elimination steps.
//
// Design.  The augmented panel [A | R], n x (n + k), sits in shared
// memory (dynamic, up to the 227 KB a block may take; the wrapper falls
// back to K2 + K4 above that).  A right-looking elimination runs the n
// columns: at column j the pivot is read (an exactly-zero pivot becomes
// pivot_floor), the column is divided by it (the unscaled column is kept
// aside), and the rank-one update is applied to the lower triangle of
// the trailing matrix and to every rhs column alike, so forward
// substitution is the same elimination; two barriers per column.  Then
// the rhs is divided by D, and the backward substitution runs column by
// column from the last, threads over (row, rhs column), one barrier per
// column.  Threads are (32, blockDim.y): a warp walks 32 neighbouring
// columns of one row, so shared-memory accesses are conflict-free.  L, D
// and X are written once.  Each entry subtracts its terms in increasing
// j, as the plain version's column sweeps do.
//
// Second routes, chosen per call by ops/cuda_ldlt.py (k5_route, k2_route)
// from times measured on an H100 (PERF.md):
//
// K5 warp route, ldlt_factor_solve_matrix_kernel_warp, replaces the same
// TPU kernel (pallas_ldlt.py:_factor_solve_matrix_kernel) at orders
// n <= 32.  The block route above spends an order-32 matrix's ~11k
// multiply-adds between ~95 block barriers, and at 2 right-hand sides 30
// of 32 lanes idle in its back substitution: it is bound by barrier
// latency, not by bytes (the bytes of (10240, 32, 2) in float32 take
// 0.027 ms at 3.35 TB/s).  Here one warp (or a 8- / 16-lane segment of
// one, several matrices a warp) holds a matrix and has no block barrier
// at all.  Lane i keeps row i of A in registers (the padded order NP is a
// template parameter so every register index is static; instantiated
// for NP = 8, 16, 32).  At column j the pivot is the shuffle of lane j's
// diagonal, lane i > j scales its entry, and the rank-one update of row i
// takes each other row's unscaled column-j entry by shuffle: ~n^2/2
// shuffles and FMAs, no shared memory.  Then the right-hand sides go in
// chunks of KP = 2 or 8 columns (template parameter; any k): forward
// sweep by shuffling row j of the chunk (lane i's own L_ij is a[j]),
// division by D, and backward sweep reading L_ji from the factor staged
// in shared memory.  Every load and store of A, R, L and X goes through
// shared memory with consecutive lanes on consecutive addresses (a lane
// reading its own row from device memory would stride n values across
// the warp).  Four warps a block (no block barrier; only __syncwarp).
//
// K2 block route, ldlt_factor_kernel_block, replaces the same TPU kernel
// as K2 (pallas_ldlt.py:_factor_kernel) where one thread per matrix
// starves the card: at the Schur slice's H blocks (n = 64, B = 512) the
// SoA route runs 512 threads on 4 SMs, each a left-looking loop of n^3/3
// dependent reads.  It is K5's block structure with no right-hand side:
// one thread block per matrix, the matrix in dynamic shared memory
// ((n^2 + 2n) values, so n <= 169 in float64 and <= 240 in float32 under
// the 227 KB a block may take), right-looking elimination with two
// barriers per column, 32 x 4 threads up to order 32 and 32 x 8 above.
// It reads A in the public layout (B, n, n), so the caller's transpose
// to SoA is gone, and writes L (n, n, B) and D (n, B) in the SoA layout
// that K3 and K4 read.  Those stores are strided by B: each value takes a
// 32-byte sector of its own, 4x (float64) or 8x (float32) the bytes of
// the outputs (about 20 us at the Schur shape), chosen over a transpose
// kernel after it because the Schur iteration is bound by launches, not
// by device time.
//
// K3 warp route, ldlt_solve_kernel_warp, replaces the same TPU kernel as
// K3 (pallas_ldlt.py:_solve_kernel).  The thread route above gives each
// matrix one thread: n^2 dependent loads from the SoA factor, x read and
// written in device memory inside the loop, and at the Schur slice's H
// blocks (n = 64, B = 512) four blocks on four SMs.  What bounds the
// solve is one read of L, D and b and one write of x (2 n^2 operations
// against n^2 / 2 + 3 n values: far under the ridge), so the design is
// about latency and sectors.  A thread block owns a tile of G consecutive
// instances, G values of one SoA element filling a 32-byte sector (8 in
// float32, 4 in float64): consecutive threads load consecutive instances
// of the strict lower triangle, D and b into dynamic shared memory, each
// instance a padded row-major matrix at row stride n + 1.  Then SEG lanes
// (8, 16 or 32, template parameter) hold one matrix, lane l rows l, l +
// SEG, ... (R rows, template parameter, up to order 96), x in registers:
// the forward sweep takes x_j by shuffle from its owner and lanes i > j
// subtract L_ij x_j (the thread route's order per row), the division by
// D, and the backward sweep column by column from the last (each row
// subtracts its terms in decreasing j: rounding differs from the thread
// route's row sums).  Only the segment's mask in the sweeps; one block
// barrier after the staging and one before x leaves, coalesced, through
// the same tile.  Shared memory is G n (n + 3) values, so the route takes
// n <= 83 in both types (232448 bytes); ops/cuda_ldlt.py:k3_route keeps
// the thread route above that.
//
// K5 split route, ldlt_factor_solve_matrix_kernel_split, replaces the same
// TPU kernel (pallas_ldlt.py:_factor_solve_matrix_kernel) at the nested-
// dissection levels (orders 16-64, 40-64 right-hand sides, 16 to a few
// hundred matrices).  The block route above spends a level's matrix of
// order 64 between ~190 block barriers, each separating a few multiply-
// adds a thread: at 105 matrices, one 256-thread block an SM, nothing
// hides them, and it runs at ~80x its bound.  Here a thread block owns one
// matrix (so that every SM gets work at a level's batch) with three block
// barriers in all.  (1) A and R are copied into dynamic shared memory by
// asynchronous copies (cp.async), consecutive threads on consecutive
// addresses: A at row stride n + 1 in a group of its own, then R at the
// odd row stride k | 1, whose copies land while the factor runs; a
// barrier once A is in.  (2) One SEG-lane segment (16 lanes for n <= 16,
// else a warp; lane l holds rows l, l + SEG, ..., R rows, a template
// parameter so every register index is static) factors the matrix with
// no block barrier: right-looking, column by column, each lane setting
// its unscaled column-j entries aside in shared memory, the pivot read
// back (an exactly-zero pivot becomes pivot_floor), each lane scaling its
// own entries and updating its rows of the trailing lower triangle with
// the other rows' unscaled entries.  Where the rows fit in registers
// (float32 up to order 64, float64 up to 32) they stay there, each moved
// one register down a column so that the column loop runs at run time
// while every register index is static (a loop over both, unrolled, is
// past what the compiler unrolls); otherwise the lanes update the staged
// panel in chunks of 8 columns.  Only __syncwarp.  (3) After a barrier
// the k right-hand sides are split across the block's segments, KC = 4
// columns a segment (more column groups than segments are walked in
// turn): the forward sweep with row j shuffled from its owner, the
// division by D and the backward sweep column by column from the last, L
// read from the staged factor with no branch around the loads, X
// overwriting R's tile in place.  (4) After a barrier L, D and X leave
// coalesced through the tile in the public layout.  Every entry subtracts
// its terms in the block route's order (the factor's rank-one updates and
// the forward elimination in increasing j, the backward sweep from the
// last column).  Shared memory is n (n + 3) + n (k | 1) values; the route
// takes orders up to 64 (two rows a lane) within the 232448 bytes a block
// may take, and ops/cuda_ldlt.py:k5_route keeps the block route and
// K2 + K4 beyond.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// Offset of element (i, j) of instance 0 in an (n, n, B) SoA array.
__device__ __forceinline__ int64_t soa(int i, int j, int n, int64_t B) {
  return (static_cast<int64_t>(i) * n + j) * B;
}

template <typename T>
__global__ void ldlt_factor_kernel(const T* __restrict__ A,
                                   T* __restrict__ L, T* __restrict__ D,
                                   int n, int64_t B, T pivot_floor) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  A += b;
  L += b;
  D += b;
  for (int j = 0; j < n; ++j) {
    // d_j = A_jj - sum_{k<j} L_jk^2 D_k
    T d = A[soa(j, j, n, B)];
    for (int k = 0; k < j; ++k) {
      const T l = L[soa(j, k, n, B)];
      d -= l * (l * D[k * B]);
    }
    if (d == T(0)) d = pivot_floor;
    D[j * B] = d;
    for (int i = 0; i < j; ++i) L[soa(i, j, n, B)] = T(0);
    L[soa(j, j, n, B)] = T(1);
    // L_ij = (A_ij - sum_{k<j} L_ik L_jk D_k) / d_j
    for (int i = j + 1; i < n; ++i) {
      T s = A[soa(i, j, n, B)];
      for (int k = 0; k < j; ++k) {
        s -= L[soa(i, k, n, B)] * (L[soa(j, k, n, B)] * D[k * B]);
      }
      L[soa(i, j, n, B)] = s / d;
    }
  }
}

template <typename T>
__global__ void ldlt_solve_kernel(const T* __restrict__ L,
                                  const T* __restrict__ D,
                                  const T* __restrict__ rhs,
                                  T* __restrict__ x, int n, int64_t B) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  L += b;
  D += b;
  rhs += b;
  x += b;
  // forward sweep with the unit-lower L: y_i = b_i - sum_{k<i} L_ik y_k
  for (int i = 0; i < n; ++i) {
    T s = rhs[i * B];
    for (int k = 0; k < i; ++k) s -= L[soa(i, k, n, B)] * x[k * B];
    x[i * B] = s;
  }
  for (int i = 0; i < n; ++i) x[i * B] = x[i * B] / D[i * B];
  // backward sweep with L^T: x_i = z_i - sum_{k>i} L_ki x_k
  for (int i = n - 1; i >= 0; --i) {
    T s = x[i * B];
    for (int k = i + 1; k < n; ++k) s -= L[soa(k, i, n, B)] * x[k * B];
    x[i * B] = s;
  }
}

template <typename T>
__global__ void ldlt_solve_matrix_kernel(const T* __restrict__ L,
                                         const T* __restrict__ D,
                                         const T* __restrict__ rhs,
                                         T* __restrict__ x, int n, int k,
                                         int64_t B) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // column blockIdx.y of the (n, k, B) rhs; rows are k * B apart
  const int64_t col = static_cast<int64_t>(blockIdx.y) * B;
  const int64_t row = static_cast<int64_t>(k) * B;
  L += b;
  D += b;
  rhs += col + b;
  x += col + b;
  // forward sweep with the unit-lower L: y_i = r_i - sum_{j<i} L_ij y_j,
  // subtracted in increasing j as the column-oriented sweep does
  for (int i = 0; i < n; ++i) {
    T s = rhs[i * row];
    for (int j = 0; j < i; ++j) s -= L[soa(i, j, n, B)] * x[j * row];
    x[i * row] = s;
  }
  for (int i = 0; i < n; ++i) x[i * row] = x[i * row] / D[i * B];
  // backward sweep with L^T: x_i = z_i - sum_{j>i} L_ji x_j
  for (int i = n - 1; i >= 0; --i) {
    T s = x[i * row];
    for (int j = i + 1; j < n; ++j) s -= L[soa(j, i, n, B)] * x[j * row];
    x[i * row] = s;
  }
}

template <typename T>
__global__ void ldlt_factor_solve_matrix_kernel(
    const T* __restrict__ A, const T* __restrict__ R, T* __restrict__ L,
    T* __restrict__ D, T* __restrict__ X, int n, int k, T pivot_floor) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* P = reinterpret_cast<T*>(shared_raw);   // [A | R], n x w, row-major
  const int w = n + k;
  T* dsh = P + static_cast<size_t>(n) * w;   // D
  T* ucol = dsh + n;                         // unscaled column j
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int tid = ty * nx + tx, nt = nx * ny;
  const int64_t b = blockIdx.x;
  A += b * n * n;
  L += b * n * n;
  D += b * n;
  R += b * n * k;
  X += b * n * k;

  for (int i = ty; i < n; i += ny) {
    for (int c = tx; c < n; c += nx) P[i * w + c] = A[i * n + c];
    for (int c = tx; c < k; c += nx) P[i * w + n + c] = R[i * k + c];
  }
  __syncthreads();

  // factor, and forward substitution of the rhs columns
  for (int j = 0; j < n; ++j) {
    T d = P[j * w + j];
    if (d == T(0)) d = pivot_floor;
    if (tid == 0) dsh[j] = d;
    for (int i = j + 1 + tid; i < n; i += nt) {
      const T u = P[i * w + j];
      ucol[i] = u;
      P[i * w + j] = u / d;
    }
    __syncthreads();
    // P_ic -= L_ij u_cj on the lower triangle (j < c <= i), and
    // R_ic -= L_ij R_jc on every rhs column
    for (int i = j + 1 + ty; i < n; i += ny) {
      const T l = P[i * w + j];
      for (int c = j + 1 + tx; c < w; c += nx) {
        if (c < n) {
          if (c <= i) P[i * w + c] -= l * ucol[c];
        } else {
          P[i * w + c] -= l * P[j * w + c];
        }
      }
    }
    __syncthreads();
  }

  for (int i = ty; i < n; i += ny) {
    const T d = dsh[i];
    for (int c = tx; c < k; c += nx) P[i * w + n + c] /= d;
  }
  __syncthreads();

  // backward substitution with L^T, column by column from the last:
  // X_ic -= L_ji X_jc for every i < j
  for (int j = n - 1; j > 0; --j) {
    for (int i = ty; i < j; i += ny) {
      const T l = P[j * w + i];
      for (int c = tx; c < k; c += nx) {
        P[i * w + n + c] -= l * P[j * w + n + c];
      }
    }
    __syncthreads();
  }

  for (int i = ty; i < n; i += ny) {
    for (int c = tx; c < n; c += nx) {
      L[i * n + c] = c < i ? P[i * w + c] : (c == i ? T(1) : T(0));
    }
    for (int c = tx; c < k; c += nx) X[i * k + c] = P[i * w + n + c];
  }
  for (int i = tid; i < n; i += nt) D[i] = dsh[i];
}

template <typename T>
__global__ void ldlt_factor_kernel_block(const T* __restrict__ A,
                                         T* __restrict__ L,
                                         T* __restrict__ D, int n, int64_t B,
                                         T pivot_floor) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* P = reinterpret_cast<T*>(shared_raw);   // A, n x n, row-major
  T* dsh = P + static_cast<size_t>(n) * n;   // D
  T* ucol = dsh + n;                         // unscaled column j
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int tid = ty * nx + tx, nt = nx * ny;
  const int nn = n * n;
  const int64_t b = blockIdx.x;
  A += b * nn;

  for (int e = tid; e < nn; e += nt) P[e] = A[e];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    T d = P[j * n + j];
    if (d == T(0)) d = pivot_floor;
    if (tid == 0) dsh[j] = d;
    for (int i = j + 1 + tid; i < n; i += nt) {
      const T u = P[i * n + j];
      ucol[i] = u;
      P[i * n + j] = u / d;
    }
    __syncthreads();
    // P_ic -= L_ij u_cj on the lower triangle of the trailing matrix
    for (int i = j + 1 + ty; i < n; i += ny) {
      const T l = P[i * n + j];
      for (int c = j + 1 + tx; c <= i; c += nx) P[i * n + c] -= l * ucol[c];
    }
    __syncthreads();
  }

  // L (n, n, B) and D (n, B): element (i, c) of matrix b at (i n + c) B + b
  for (int e = tid; e < nn; e += nt) {
    const int i = e / n, c = e - i * n;
    L[static_cast<int64_t>(e) * B + b] =
        c < i ? P[e] : (c == i ? T(1) : T(0));
  }
  for (int i = tid; i < n; i += nt) {
    D[static_cast<int64_t>(i) * B + b] = dsh[i];
  }
}

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

// The warp route's staging area for one matrix: the n x n factor panel at
// row stride NP + 1 and one chunk of right-hand sides at row stride KP + 1
// (odd strides: lane i reading row i hits its own bank).
template <int NP, int KP>
__host__ __device__ constexpr int warp_segment() {
  return NP * (NP + 1) + NP * (KP + 1);
}

template <typename T, int NP, int KP>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ldlt_factor_solve_matrix_kernel_warp(const T* __restrict__ A,
                                     const T* __restrict__ R,
                                     T* __restrict__ L, T* __restrict__ D,
                                     T* __restrict__ X, int n, int k,
                                     int64_t B, T pivot_floor) {
  constexpr int G = 32 / NP;   // matrices a warp, one per NP-lane segment
  constexpr int S = NP + 1, SK = KP + 1, SEG = warp_segment<NP, KP>();
  __shared__ T stage[kWarpsPerBlock][G * SEG];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / NP, i = lane % NP;
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp) * G;
  if (b0 >= B) return;   // the whole warp alike
  const int nb = static_cast<int>(B - b0 < G ? B - b0 : G);
  T* Pw = stage[warp];
  T* P = Pw + seg * SEG;   // this lane's matrix: factor panel
  T* Q = P + NP * S;       // and rhs chunk
  const bool live = seg < nb && i < n;
  const int nn = n * n;

  // the warp's nb matrices are contiguous in A: coalesced into the stage
  const T* Aw = A + b0 * nn;
  for (int e = lane; e < nb * nn; e += 32) {
    const int m = e / nn, r = e - m * nn, row = r / n;
    Pw[m * SEG + row * S + (r - row * n)] = Aw[e];
  }
  __syncwarp();
  T a[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) a[c] = (live && c < n) ? P[i * S + c] : T(0);

  // factor: right-looking, the pivot and each row's unscaled column-j
  // entry broadcast by shuffle; rows i > j update every column c > j
  // (the part of row i above the diagonal is never read)
  T dmine = T(1);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j >= n) break;
    T d = __shfl_sync(kFullMask, a[j], j, NP);
    if (d == T(0)) d = pivot_floor;
    if (i == j) dmine = d;
    const T u = a[j];
    const bool below = i > j;
    const T l = below ? u / d : T(0);
    if (below) a[j] = l;
#pragma unroll
    for (int c = j + 1; c < NP; ++c) {
      const T uc = __shfl_sync(kFullMask, u, c, NP);
      if (below) a[c] -= l * uc;
    }
  }

  // L through the stage: row i, exact zeros above the diagonal, ones on it
  __syncwarp();
  if (live) {
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      if (c < n) P[i * S + c] = c < i ? a[c] : (c == i ? T(1) : T(0));
    }
  }
  __syncwarp();
  T* Lw = L + b0 * nn;
  for (int e = lane; e < nb * nn; e += 32) {
    const int m = e / nn, r = e - m * nn, row = r / n;
    Lw[e] = Pw[m * SEG + row * S + (r - row * n)];
  }
  if (live) D[(b0 + seg) * n + i] = dmine;

  // the right-hand sides, KP columns at a time
  for (int c0 = 0; c0 < k; c0 += KP) {
    const int kc = k - c0 < KP ? k - c0 : KP, w = n * kc;
    for (int e = lane; e < nb * w; e += 32) {
      const int m = e / w, r = e - m * w, row = r / kc, col = r - row * kc;
      Pw[m * SEG + NP * S + row * SK + col] =
          R[((b0 + m) * n + row) * k + c0 + col];
    }
    __syncwarp();
    T x[KP];
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      x[c] = (live && c < kc) ? Q[i * SK + c] : T(0);
    }
    // forward sweep, in increasing j: x_i -= L_ij x_j
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j >= n) break;
      const T l = i > j ? a[j] : T(0);
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        const T xj = __shfl_sync(kFullMask, x[c], j, NP);
        if (i > j) x[c] -= l * xj;
      }
    }
#pragma unroll
    for (int c = 0; c < KP; ++c) x[c] /= dmine;
    // backward sweep, from the last row: x_i -= L_ji x_j, L_ji staged
#pragma unroll
    for (int j = NP - 1; j > 0; --j) {
      if (j >= n) continue;
      const T l = i < j ? P[j * S + i] : T(0);
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        const T xj = __shfl_sync(kFullMask, x[c], j, NP);
        if (i < j) x[c] -= l * xj;
      }
    }
    if (live) {
#pragma unroll
      for (int c = 0; c < KP; ++c) {
        if (c < kc) Q[i * SK + c] = x[c];
      }
    }
    __syncwarp();
    for (int e = lane; e < nb * w; e += 32) {
      const int m = e / w, r = e - m * w, row = r / kc, col = r - row * kc;
      X[((b0 + m) * n + row) * k + c0 + col] =
          Pw[m * SEG + NP * S + row * SK + col];
    }
    __syncwarp();
  }
}

// The K3 warp route's tile: G consecutive instances a thread block, G
// values of one SoA element filling a 32-byte sector (G = 8 float32, 4
// float64).
template <typename T>
__host__ __device__ constexpr int solve_tile() {
  return static_cast<int>(32 / sizeof(T));
}

// Lane mask of the SEG-lane segment that holds `lane`.
template <int SEG>
__device__ __forceinline__ unsigned segment_mask(int lane) {
  if (SEG == 32) return kFullMask;
  return ((1u << SEG) - 1u) << (lane & ~(SEG - 1));
}

// Row of entry s of a strict lower triangle stored row by row (row i
// holds entries i (i - 1) / 2 .. i (i + 1) / 2 - 1).
__device__ __forceinline__ int tri_row(int s) {
  int i = static_cast<int>((1.0f + sqrtf(8.0f * s + 1.0f)) * 0.5f);
  while (i * (i - 1) / 2 > s) --i;
  while (i * (i + 1) / 2 <= s) ++i;
  return i;
}

// Stage instances b0 .. b0 + nb - 1 of the SoA factor (L (n, n, B), D (n,
// B)) into a tile of shared memory, instance g at tile + g * per: the
// strict lower triangle of L at row stride n + 1, then D at offset
// n (n + 1).  Thread t loads instance t % G, so consecutive threads read
// consecutive instances of one element (a 32-byte sector for G = 32 /
// sizeof(T)).  blockDim.x is a multiple of G.  No barrier.
template <typename T>
__device__ __forceinline__ void stage_factor(const T* __restrict__ L,
                                             const T* __restrict__ D,
                                             T* tile, int per, int n,
                                             int64_t B, int64_t b0, int nb,
                                             int G) {
  const int tid = threadIdx.x;
  const int g = tid % G, slot0 = tid / G, nslots = blockDim.x / G;
  if (g >= nb) return;
  T* P = tile + g * per;
  const int S = n + 1, tri = n * (n - 1) / 2;
  for (int s = slot0; s < tri; s += nslots) {
    const int i = tri_row(s), j = s - i * (i - 1) / 2;
    P[i * S + j] = L[static_cast<int64_t>(i * n + j) * B + b0 + g];
  }
  for (int i = slot0; i < n; i += nslots) {
    P[n * S + i] = D[static_cast<int64_t>(i) * B + b0 + g];
  }
}

// K3 warp route.  SEG lanes (8, 16 or 32) a matrix, R rows a lane (lane l
// holds rows l, l + SEG, ...), so the padded order is SEG * R and every
// register index is static.  The block's G instances are staged once,
// coalesced, into dynamic shared memory: per instance the strict lower
// triangle of L at row stride n + 1 (lane i reading column j hits its own
// bank), then D, then b (overwritten by x).  Two block barriers (after
// staging, before the coalesced store of x); the sweeps run inside the
// segment with its own mask.
template <typename T, int SEG, int R>
__global__ void __launch_bounds__(solve_tile<T>() * SEG)
ldlt_solve_kernel_warp(const T* __restrict__ L, const T* __restrict__ D,
                       const T* __restrict__ rhs, T* __restrict__ x, int n,
                       int64_t B) {
  constexpr int G = solve_tile<T>();
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* tile = reinterpret_cast<T*>(shared_raw);
  const int S = n + 1, per = n * (n + 3);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G;
  const int nb = static_cast<int>(B - b0 < G ? B - b0 : G);

  // staging: thread t loads instance t % G, so consecutive threads read
  // consecutive instances of one element
  const int g = tid % G, slot0 = tid / G, nslots = nt / G;
  stage_factor(L, D, tile, per, n, B, b0, nb, G);
  if (g < nb) {
    for (int i = slot0; i < n; i += nslots) {
      tile[g * per + n * S + n + i] =
          rhs[static_cast<int64_t>(i) * B + b0 + g];
    }
  }
  __syncthreads();

  const int m = tid / SEG, l = tid % SEG;
  if (m < nb) {
    const T* P = tile + m * per;
    T* xs = tile + m * per + n * S + n;
    const unsigned mask = segment_mask<SEG>(tid & 31);
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * SEG + l;
      v[r] = row < n ? xs[row] : T(0);
    }
    // forward sweep with the unit-lower L, in increasing j:
    // x_i -= L_ij x_j, x_j shuffled from its owner
#pragma unroll
    for (int j = 0; j < SEG * R; ++j) {
      if (j >= n) break;
      const T y = __shfl_sync(mask, v[j / SEG], j % SEG, SEG);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
        if (row > j && row < n) v[r] -= P[row * S + j] * y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * SEG + l;
      if (row < n) v[r] = v[r] / P[n * S + row];
    }
    // backward sweep with L^T, column by column from the last:
    // x_i -= L_ji x_j for every i < j
#pragma unroll
    for (int j = SEG * R - 1; j > 0; --j) {
      if (j >= n) continue;
      const T y = __shfl_sync(mask, v[j / SEG], j % SEG, SEG);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
        if (row < j) v[r] -= P[j * S + row] * y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * SEG + l;
      if (row < n) xs[row] = v[r];
    }
  }
  __syncthreads();
  if (g < nb) {
    const T* xs = tile + g * per + n * S + n;
    for (int i = slot0; i < n; i += nslots) {
      x[static_cast<int64_t>(i) * B + b0 + g] = xs[i];
    }
  }
}

// The K4 warp route's right-hand sides a segment, and its most threads a
// block (512 leaves a thread 128 registers: at 1024 the float64
// instantiations spilled).
constexpr int kK4Cols = 4;
constexpr int kK4Threads = 512;

// K4 warp route.  A block owns a tile of G consecutive instances (stage_
// factor: L's strict lower triangle and D, once for all k columns) and
// NG column groups of KC right-hand sides a matrix: segment m * NG + q of
// SEG lanes solves matrix m's columns q KC .. q KC + KC - 1 of the chunk,
// lane l rows l, l + SEG, ... (R rows), so every register index is static.
// The chunk of CH = NG KC columns of the tile's R sits after each
// instance's D at row stride CH | 1 (odd: lane l reading row l hits its
// own bank) and X overwrites it; R and X are the public (B, n, k) layout,
// the tile's G n k values contiguous, so both cross device memory
// coalesced.  Where k > CH the block walks the chunks against the staged
// factor.  One block barrier after staging, one before X leaves.
template <typename T, int SEG, int R, int KC>
__global__ void __launch_bounds__(kK4Threads)
ldlt_solve_matrix_kernel_warp(const T* __restrict__ L,
                              const T* __restrict__ D,
                              const T* __restrict__ rhs, T* __restrict__ x,
                              int n, int k, int64_t B, int G, int NG) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* tile = reinterpret_cast<T*>(shared_raw);
  const int S = n + 1, CH = NG * KC, SR = CH | 1;
  const int per = n * S + n + n * SR;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G;
  const int nb = static_cast<int>(B - b0 < G ? B - b0 : G);
  const int64_t nk = static_cast<int64_t>(n) * k;
  stage_factor(L, D, tile, per, n, B, b0, nb, G);

  const int seg = tid / SEG, l = tid % SEG;
  const int m = seg / NG, col0 = (seg % NG) * KC;
  const T* P = tile + m * per;
  T* xs = tile + m * per + n * S + n;
  const unsigned mask = segment_mask<SEG>(tid & 31);

  for (int c0 = 0; c0 < k; c0 += CH) {
    const int kc = k - c0 < CH ? k - c0 : CH, w = n * kc;
    for (int e = tid; e < nb * w; e += nt) {
      const int mm = e / w, r = e - mm * w, row = r / kc, c = r - row * kc;
      tile[mm * per + n * S + n + row * SR + c] =
          rhs[(b0 + mm) * nk + static_cast<int64_t>(row) * k + c0 + c];
    }
    __syncthreads();

    if (m < nb) {   // the whole segment alike
      T v[R][KC];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          v[r][c] = (row < n && col0 + c < kc) ? xs[row * SR + col0 + c]
                                               : T(0);
        }
      }
      // forward sweep with the unit-lower L, in increasing j:
      // x_i -= L_ij x_j, row j shuffled from its owner
#pragma unroll
      for (int j = 0; j < SEG * R; ++j) {
        if (j >= n) break;
        T y[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          y[c] = __shfl_sync(mask, v[j / SEG][c], j % SEG, SEG);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = r * SEG + l;
          if (row > j && row < n) {
            const T lij = P[row * S + j];
#pragma unroll
            for (int c = 0; c < KC; ++c) v[r][c] -= lij * y[c];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
        if (row < n) {
          const T d = P[n * S + row];
#pragma unroll
          for (int c = 0; c < KC; ++c) v[r][c] = v[r][c] / d;
        }
      }
      // backward sweep with L^T, column by column from the last:
      // x_i -= L_ji x_j for every i < j
#pragma unroll
      for (int j = SEG * R - 1; j > 0; --j) {
        if (j >= n) continue;
        T y[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          y[c] = __shfl_sync(mask, v[j / SEG][c], j % SEG, SEG);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = r * SEG + l;
          if (row < j) {
            const T lji = P[j * S + row];
#pragma unroll
            for (int c = 0; c < KC; ++c) v[r][c] -= lji * y[c];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (row < n && col0 + c < kc) xs[row * SR + col0 + c] = v[r][c];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < nb * w; e += nt) {
      const int mm = e / w, r = e - mm * w, row = r / kc, c = r - row * kc;
      x[(b0 + mm) * nk + static_cast<int64_t>(row) * k + c0 + c] =
          tile[mm * per + n * S + n + row * SR + c];
    }
    if (c0 + CH < k) __syncthreads();
  }
}

// The K5 split route's right-hand sides a segment, its most threads a
// block (384 leaves a thread 170 registers: the float32 factor of order
// 64 keeps 96 values of its rows in them) and its largest order (a warp,
// two rows a lane).
constexpr int kK5SplitCols = 4;
constexpr int kK5SplitThreads = 384;
constexpr int kK5SplitMaxOrder = 64;

// One value copied from device to shared memory by cp.async (sm_80 and
// later): it lands while the thread goes on, and wait_async_copies<N>
// waits until at most N of this thread's committed groups are in flight.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))));
}

__device__ __forceinline__ void commit_async_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether the split route's factor keeps a lane's rows in registers: row
// slot r holds (r + 1) SEG values (the rest of the padded row lies above
// the diagonal), at most 96 32-bit registers' worth, so float32 up to
// order 64 and float64 up to 32.
template <typename T, int SEG, int R>
__host__ __device__ constexpr bool split_rows_in_registers() {
  return SEG * R * (R + 1) / 2 * sizeof(T) <= 96 * 4;
}

// The split route's factor, rows in registers.  Lane l of the segment
// holds rows l, l + SEG, ... of the staged panel P (row stride S), slot r
// row r SEG + l, from the current column on: at column j register c of a
// slot holds column j + c, so the column loop runs at run time while every
// register index is static, and each update moves its entry one register
// down.  At column j the lanes set their unscaled column-j entries aside
// in ucol, the pivot is row j's, each lane scales its entries below the
// diagonal (written to P as L at once) and updates the rest of its rows
// with the other rows' unscaled entries read back from ucol.  Slot r's
// rows end at column (r + 1) SEG - 1, so it holds (r + 1) SEG registers
// and takes part in column blocks 0..r only.
template <typename T, int SEG, int R>
__device__ __forceinline__ void split_factor_registers(
    T* P, T* dsh, T* ucol, int n, int S, int l, unsigned mask,
    T pivot_floor) {
  T a[R][SEG * R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r * SEG + l;
#pragma unroll
    for (int c = 0; c < (r + 1) * SEG; ++c) {
      a[r][c] = (row < n && c < n) ? P[row * S + c] : T(0);
    }
  }
#pragma unroll
  for (int jb = 0; jb < R; ++jb) {
    const int jend = n < (jb + 1) * SEG ? n : (jb + 1) * SEG;
    for (int j = jb * SEG; j < jend; ++j) {
      __syncwarp(mask);   // the last column's reads of ucol are done
#pragma unroll
      for (int r = jb; r < R; ++r) {
        const int row = r * SEG + l;
        if (row >= j && row < n) ucol[row] = a[r][0];
      }
      __syncwarp(mask);
      T d = ucol[j];
      if (d == T(0)) d = pivot_floor;
      if (l == 0) dsh[j] = d;
      T lij[R];
#pragma unroll
      for (int r = jb; r < R; ++r) {
        const int row = r * SEG + l;
        lij[r] = T(0);
        if (row > j && row < n) {
          lij[r] = a[r][0] / d;
          P[row * S + j] = lij[r];
        }
      }
      // a_ic -= l_ij u_c for every c > j (rows i <= j have l_ij = 0, and
      // the part of a row above its diagonal is never read)
#pragma unroll
      for (int c = 1; c < (R - jb) * SEG; ++c) {
        const int col = j + c;
        const T uc = col < n ? ucol[col] : T(0);
#pragma unroll
        for (int r = jb; r < R; ++r) {
          if (c < (r + 1 - jb) * SEG) a[r][c - 1] = a[r][c] - lij[r] * uc;
        }
      }
    }
  }
}

// The split route's factor in the staged panel, where the rows do not fit
// in registers: the same steps, each lane updating its rows of P in place
// (the unscaled column set aside in ucol), kSplitChunk columns at a time,
// all of a chunk's loads issued before its stores.
constexpr int kSplitChunk = 8;

template <typename T, int SEG, int R>
__device__ __forceinline__ void split_factor_shared(
    T* P, T* dsh, T* ucol, int n, int S, int l, unsigned mask,
    T pivot_floor) {
  for (int j = 0; j < n; ++j) {
    T d = P[j * S + j];
    if (d == T(0)) d = pivot_floor;
    if (l == 0) dsh[j] = d;
    T lij[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * SEG + l;
      lij[r] = T(0);
      if (row > j && row < n) {
        const T u = P[row * S + j];
        ucol[row] = u;
        lij[r] = u / d;
        P[row * S + j] = lij[r];
      }
    }
    __syncwarp(mask);
    // P_ic -= l_ij u_c on the lower triangle (j < c <= i)
    for (int c0 = j + 1; c0 < n; c0 += kSplitChunk) {
      T uc[kSplitChunk], p[R][kSplitChunk];
#pragma unroll
      for (int t = 0; t < kSplitChunk; ++t) {
        uc[t] = c0 + t < n ? ucol[c0 + t] : T(0);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
#pragma unroll
        for (int t = 0; t < kSplitChunk; ++t) {
          p[r][t] = (c0 + t <= row && row < n) ? P[row * S + c0 + t] : T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * SEG + l;
#pragma unroll
        for (int t = 0; t < kSplitChunk; ++t) {
          if (c0 + t <= row && row < n) {
            P[row * S + c0 + t] = p[r][t] - lij[r] * uc[t];
          }
        }
      }
    }
    __syncwarp(mask);
  }
}

// K5 split route.  A block owns one matrix; the tile holds its panel (A,
// then L's strict lower triangle) at row stride n + 1, D, the unscaled
// column, and R (then X) at row stride k | 1.  Segment 0 of SEG lanes
// factors the matrix, then segment q solves column groups q, q + NG, ...
// of KC columns.
template <typename T, int SEG, int R, int KC>
__global__ void __launch_bounds__(kK5SplitThreads)
ldlt_factor_solve_matrix_kernel_split(const T* __restrict__ A,
                                      const T* __restrict__ rhs,
                                      T* __restrict__ L, T* __restrict__ D,
                                      T* __restrict__ X, int n, int k,
                                      int NG, T pivot_floor) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* P = reinterpret_cast<T*>(shared_raw);
  const int S = n + 1, SR = k | 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nn = n * n, nk = n * k;
  T* dsh = P + n * S;
  T* Xt = dsh + 2 * n;

  // stage A, then R, each a contiguous run of the public layout
  const T* Ab = A + static_cast<int64_t>(blockIdx.x) * nn;
  for (int e = tid; e < nn; e += nt) {
    const int row = e / n;
    copy_async(P + row * S + (e - row * n), Ab + e);
  }
  commit_async_copies();
  const T* Rb = rhs + static_cast<int64_t>(blockIdx.x) * nk;
  for (int e = tid; e < nk; e += nt) {
    const int row = e / k;
    copy_async(Xt + row * SR + (e - row * k), Rb + e);
  }
  commit_async_copies();
  wait_async_copies<1>();   // this thread's copies of A
  __syncthreads();

  const int q = tid / SEG, l = tid % SEG;
  const unsigned mask = segment_mask<SEG>(tid & 31);
  if (q == 0) {   // the whole segment alike
    if (split_rows_in_registers<T, SEG, R>()) {
      split_factor_registers<T, SEG, R>(P, dsh, dsh + n, n, S, l, mask,
                                        pivot_floor);
    } else {
      split_factor_shared<T, SEG, R>(P, dsh, dsh + n, n, S, l, mask,
                                     pivot_floor);
    }
  }
  wait_async_copies<0>();   // and of R
  __syncthreads();

  // the sweeps read L and D at clamped rows, so a lane of a row past n
  // reads in bounds and no load waits on a branch; its values are never
  // stored
  int rowc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rowc[r] = r * SEG + l < n ? r * SEG + l : n - 1;
  }
  for (int c0 = q * KC; c0 < k; c0 += NG * KC) {
    T v[R][KC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * SEG + l;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        v[r][c] = (row < n && c0 + c < k) ? Xt[row * SR + c0 + c] : T(0);
      }
    }
    // forward sweep with the unit-lower L, in increasing j:
    // x_i -= L_ij x_j, row j shuffled from its owner
#pragma unroll
    for (int j = 0; j < SEG * R; ++j) {
      if (j >= n) break;
      T y[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        y[c] = __shfl_sync(mask, v[j / SEG][c], j % SEG, SEG);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r + 1) * SEG - 1 <= j) continue;   // static: no row below j
        const T lij = r * SEG + l > j ? P[rowc[r] * S + j] : T(0);
#pragma unroll
        for (int c = 0; c < KC; ++c) v[r][c] -= lij * y[c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T d = dsh[rowc[r]];
#pragma unroll
      for (int c = 0; c < KC; ++c) v[r][c] = v[r][c] / d;
    }
    // backward sweep with L^T, column by column from the last:
    // x_i -= L_ji x_j for every i < j
#pragma unroll
    for (int j = SEG * R - 1; j > 0; --j) {
      if (j >= n) continue;
      T y[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        y[c] = __shfl_sync(mask, v[j / SEG][c], j % SEG, SEG);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r * SEG >= j) continue;   // static: no row above j
        const T lji = r * SEG + l < j ? P[j * S + rowc[r]] : T(0);
#pragma unroll
        for (int c = 0; c < KC; ++c) v[r][c] -= lji * y[c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * SEG + l;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (row < n && c0 + c < k) Xt[row * SR + c0 + c] = v[r][c];
      }
    }
  }
  __syncthreads();

  // L with exact zeros above the diagonal and ones on it, D and X
  T* Lb = L + static_cast<int64_t>(blockIdx.x) * nn;
  for (int e = tid; e < nn; e += nt) {
    const int row = e / n, c = e - row * n;
    Lb[e] = c < row ? P[row * S + c] : (c == row ? T(1) : T(0));
  }
  for (int i = tid; i < n; i += nt) {
    D[static_cast<int64_t>(blockIdx.x) * n + i] = dsh[i];
  }
  T* Xb = X + static_cast<int64_t>(blockIdx.x) * nk;
  for (int e = tid; e < nk; e += nt) {
    const int row = e / k;
    Xb[e] = Xt[row * SR + (e - row * k)];
  }
}

unsigned int grid_for(int64_t B) {
  return static_cast<unsigned int>((B + kThreads - 1) / kThreads);
}

// The most dynamic shared memory a block may take on sm_90, in bytes.
constexpr int kSharedCap = 232448;

// Raise `kernel`'s dynamic shared-memory limit to kSharedCap once per
// device (bit d of `done`), at its first launch there that needs more than
// the default 48 KB, so a launch captured in a CUDA graph makes no such
// call.
template <typename Kernel>
int allow_shared_cap(Kernel kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bit = 1u << (dev & 31);
  if (done.load() & bit) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSharedCap);
  if (err != cudaSuccess) return static_cast<int>(err);
  done.fetch_or(bit);
  return 0;
}

template <typename T>
int launch_factor(const T* A, T* L, T* D, int n, int64_t B, T pivot_floor,
                  cudaStream_t stream) {
  ldlt_factor_kernel<T><<<grid_for(B), kThreads, 0, stream>>>(
      A, L, D, n, B, pivot_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve(const T* L, const T* D, const T* rhs, T* x, int n,
                 int64_t B, cudaStream_t stream) {
  ldlt_solve_kernel<T><<<grid_for(B), kThreads, 0, stream>>>(L, D, rhs, x,
                                                             n, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_solve_matrix(const T* L, const T* D, const T* rhs, T* x, int n,
                        int k, int64_t B, cudaStream_t stream) {
  const dim3 grid(grid_for(B), static_cast<unsigned int>(k));
  ldlt_solve_matrix_kernel<T><<<grid, kThreads, 0, stream>>>(L, D, rhs, x,
                                                             n, k, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_factor_solve_matrix(const T* A, const T* R, T* L, T* D, T* X,
                               int n, int k, int64_t B, T pivot_floor,
                               cudaStream_t stream) {
  static std::atomic<unsigned> cap_set{0};
  const size_t shared =
      (static_cast<size_t>(n) * (n + k) + 2 * static_cast<size_t>(n)) *
      sizeof(T);
  if (shared > 48 * 1024) {
    const int err =
        allow_shared_cap(ldlt_factor_solve_matrix_kernel<T>, cap_set);
    if (err) return err;
  }
  // 32 x 4 threads up to order 32, 32 x 8 above
  const dim3 block(32, n > 32 ? 8 : 4);
  ldlt_factor_solve_matrix_kernel<T>
      <<<static_cast<unsigned int>(B), block, shared, stream>>>(
          A, R, L, D, X, n, k, pivot_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_factor_block(const T* A, T* L, T* D, int n, int64_t B,
                        T pivot_floor, cudaStream_t stream) {
  static std::atomic<unsigned> cap_set{0};
  const size_t shared =
      (static_cast<size_t>(n) * n + 2 * static_cast<size_t>(n)) * sizeof(T);
  if (shared > 48 * 1024) {
    const int err = allow_shared_cap(ldlt_factor_kernel_block<T>, cap_set);
    if (err) return err;
  }
  const dim3 block(32, n > 32 ? 8 : 4);
  ldlt_factor_kernel_block<T>
      <<<static_cast<unsigned int>(B), block, shared, stream>>>(
          A, L, D, n, B, pivot_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NP, int KP>
int launch_warp(const T* A, const T* R, T* L, T* D, T* X, int n, int k,
                int64_t B, T pivot_floor, cudaStream_t stream) {
  const int64_t per_block = kWarpsPerBlock * (32 / NP);
  const unsigned int grid =
      static_cast<unsigned int>((B + per_block - 1) / per_block);
  ldlt_factor_solve_matrix_kernel_warp<T, NP, KP>
      <<<grid, 32 * kWarpsPerBlock, 0, stream>>>(A, R, L, D, X, n, k, B,
                                                 pivot_floor);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int SEG, int R>
int launch_solve_warp_at(const T* L, const T* D, const T* rhs, T* x, int n,
                         int64_t B, size_t shared, cudaStream_t stream) {
  static std::atomic<unsigned> cap_set{0};
  if (shared > 48 * 1024) {
    const int err = allow_shared_cap(ldlt_solve_kernel_warp<T, SEG, R>,
                                     cap_set);
    if (err) return err;
  }
  constexpr int G = solve_tile<T>();
  const unsigned int grid = static_cast<unsigned int>((B + G - 1) / G);
  ldlt_solve_kernel_warp<T, SEG, R>
      <<<grid, G * SEG, shared, stream>>>(L, D, rhs, x, n, B);
  return static_cast<int>(cudaGetLastError());
}

// the K3 warp route: SEG lanes a matrix for n <= 32 (the smallest of 8,
// 16, 32 that holds n), else a warp with 2 or 3 rows a lane
template <typename T>
int launch_solve_warp(const T* L, const T* D, const T* rhs, T* x, int n,
                      int64_t B, cudaStream_t stream) {
  const size_t shared = static_cast<size_t>(solve_tile<T>()) * n * (n + 3) *
                        sizeof(T);
  if (n > 96 || shared > static_cast<size_t>(kSharedCap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 8) return launch_solve_warp_at<T, 8, 1>(L, D, rhs, x, n, B,
                                                  shared, stream);
  if (n <= 16) return launch_solve_warp_at<T, 16, 1>(L, D, rhs, x, n, B,
                                                    shared, stream);
  if (n <= 32) return launch_solve_warp_at<T, 32, 1>(L, D, rhs, x, n, B,
                                                    shared, stream);
  if (n <= 64) return launch_solve_warp_at<T, 32, 2>(L, D, rhs, x, n, B,
                                                    shared, stream);
  return launch_solve_warp_at<T, 32, 3>(L, D, rhs, x, n, B, shared, stream);
}

template <typename T, int SEG, int R>
int launch_solve_matrix_warp_at(const T* L, const T* D, const T* rhs, T* x,
                                int n, int k, int64_t B, int G, int NG,
                                size_t shared, cudaStream_t stream) {
  static std::atomic<unsigned> cap_set{0};
  if (shared > 48 * 1024) {
    const int err = allow_shared_cap(
        ldlt_solve_matrix_kernel_warp<T, SEG, R, kK4Cols>, cap_set);
    if (err) return err;
  }
  const unsigned int grid = static_cast<unsigned int>((B + G - 1) / G);
  ldlt_solve_matrix_kernel_warp<T, SEG, R, kK4Cols>
      <<<grid, G * NG * SEG, shared, stream>>>(L, D, rhs, x, n, k, B, G, NG);
  return static_cast<int>(cudaGetLastError());
}

// the K4 warp route: segments as K3's warp route's (8, 16 or 32 lanes up
// to order 32, then a warp with 2 or 3 rows a lane), G instances a block
// and NG groups of kK4Cols columns a matrix, as the caller sizes them
template <typename T>
int launch_solve_matrix_warp(const T* L, const T* D, const T* rhs, T* x,
                             int n, int k, int64_t B, int G, int NG,
                             cudaStream_t stream) {
  const int seg = n <= 8 ? 8 : (n <= 16 ? 16 : 32);
  if (n < 1 || n > 96 || k < 1 || G < 1 || NG < 1 ||
      static_cast<int64_t>(G) * NG * seg > kK4Threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t per = static_cast<size_t>(n) * (n + 2) +
                     static_cast<size_t>(n) * ((NG * kK4Cols) | 1);
  const size_t shared = static_cast<size_t>(G) * per * sizeof(T);
  if (shared > static_cast<size_t>(kSharedCap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 8) return launch_solve_matrix_warp_at<T, 8, 1>(
      L, D, rhs, x, n, k, B, G, NG, shared, stream);
  if (n <= 16) return launch_solve_matrix_warp_at<T, 16, 1>(
      L, D, rhs, x, n, k, B, G, NG, shared, stream);
  if (n <= 32) return launch_solve_matrix_warp_at<T, 32, 1>(
      L, D, rhs, x, n, k, B, G, NG, shared, stream);
  if (n <= 64) return launch_solve_matrix_warp_at<T, 32, 2>(
      L, D, rhs, x, n, k, B, G, NG, shared, stream);
  return launch_solve_matrix_warp_at<T, 32, 3>(L, D, rhs, x, n, k, B, G, NG,
                                               shared, stream);
}

// the smallest padded order NP that holds n, and KP = 2 for k <= 2, else 8
template <typename T>
int launch_factor_solve_matrix_warp(const T* A, const T* R, T* L, T* D,
                                    T* X, int n, int k, int64_t B,
                                    T pivot_floor, cudaStream_t stream) {
  if (n > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 2) {
    if (n <= 8) return launch_warp<T, 8, 2>(A, R, L, D, X, n, k, B,
                                            pivot_floor, stream);
    if (n <= 16) return launch_warp<T, 16, 2>(A, R, L, D, X, n, k, B,
                                              pivot_floor, stream);
    return launch_warp<T, 32, 2>(A, R, L, D, X, n, k, B, pivot_floor,
                                 stream);
  }
  if (n <= 8) return launch_warp<T, 8, 8>(A, R, L, D, X, n, k, B,
                                          pivot_floor, stream);
  if (n <= 16) return launch_warp<T, 16, 8>(A, R, L, D, X, n, k, B,
                                            pivot_floor, stream);
  return launch_warp<T, 32, 8>(A, R, L, D, X, n, k, B, pivot_floor, stream);
}

template <typename T, int SEG, int R>
int launch_split_at(const T* A, const T* rhs, T* L, T* D, T* X, int n,
                    int k, int64_t B, int NG, T pivot_floor, size_t shared,
                    cudaStream_t stream) {
  static std::atomic<unsigned> cap_set{0};
  if (shared > 48 * 1024) {
    const int err = allow_shared_cap(
        ldlt_factor_solve_matrix_kernel_split<T, SEG, R, kK5SplitCols>,
        cap_set);
    if (err) return err;
  }
  ldlt_factor_solve_matrix_kernel_split<T, SEG, R, kK5SplitCols>
      <<<static_cast<unsigned int>(B), NG * SEG, shared, stream>>>(
          A, rhs, L, D, X, n, k, NG, pivot_floor);
  return static_cast<int>(cudaGetLastError());
}

// the K5 split route: a block per matrix, 16 lanes a matrix up to order
// 16, else a warp with one or two rows a lane; NG column groups of
// kK5SplitCols a matrix, as the caller sizes them
template <typename T>
int launch_factor_solve_matrix_split(const T* A, const T* rhs, T* L, T* D,
                                     T* X, int n, int k, int64_t B, int NG,
                                     T pivot_floor, cudaStream_t stream) {
  const int seg = n <= 16 ? 16 : 32;
  if (n < 1 || n > kK5SplitMaxOrder || k < 1 || B < 1 ||
      B > 0x7fffffff || NG < 1 || NG * seg > kK5SplitThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared =
      (static_cast<size_t>(n) * (n + 3) + static_cast<size_t>(n) * (k | 1)) *
      sizeof(T);
  if (shared > static_cast<size_t>(kSharedCap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 16) return launch_split_at<T, 16, 1>(A, rhs, L, D, X, n, k, B,
                                                NG, pivot_floor, shared,
                                                stream);
  if (n <= 32) return launch_split_at<T, 32, 1>(A, rhs, L, D, X, n, k, B,
                                                NG, pivot_floor, shared,
                                                stream);
  return launch_split_at<T, 32, 2>(A, rhs, L, D, X, n, k, B, NG,
                                   pivot_floor, shared, stream);
}

}  // namespace

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers to
// contiguous SoA arrays: A, L (n, n, B); D, rhs, x (n, B) for K2/K3, and
// rhs, x (n, k, B) for K4.  The caller guarantees n > 0, B > 0 and
// 0 < k <= 65535.  K5 takes contiguous A, L (B, n, n); D (B, n); R, X
// (B, n, k), with n, k > 0, 0 < B < 2^31 and
// (n (n + k) + 2 n) sizeof(T) <= 232448 bytes of shared memory; its warp
// route the same arrays with 0 < n <= 32 and any k > 0.  The K2 block
// route takes contiguous A (B, n, n) and writes SoA L (n, n, B), D (n, B),
// with 0 < B < 2^31 and (n^2 + 2 n) sizeof(T) <= 232448.  The K3 warp
// route takes K3's SoA arrays with 0 < n <= 96 and
// G n (n + 3) sizeof(T) <= 232448 (G = 32 / sizeof(T)).  The K4 warp
// route takes K4's SoA L (n, n, B) and D (n, B) and contiguous R, X in the
// public layout (B, n, k), with 0 < n <= 96, k > 0, 0 < B, a tile of
// G >= 1 instances a block and NG >= 1 groups of 4 columns a matrix,
// G NG SEG <= 512 threads (SEG = 8, 16 or 32 by n) and
// G (n (n + 2) + n (4 NG | 1)) sizeof(T) <= 232448 bytes of shared memory.
// The K5 split route takes K5's contiguous A (B, n, n) and R, X (B, n, k)
// with 0 < n <= 64, k > 0, 0 < B < 2^31 and NG >= 1 column groups of 4 a
// matrix, NG SEG <= 384 threads (SEG = 16 for n <= 16, else 32) and
// (n (n + 3) + n (k | 1)) sizeof(T) <= 232448 bytes of shared memory; it
// writes L (B, n, n) and D (B, n).
extern "C" {

int ipmzoo_ldlt_factor_solve_matrix_split_f32(const float* A, const float* R,
                                              float* L, float* D, float* X,
                                              int n, int k, long long B,
                                              int NG, float pivot_floor,
                                              void* stream) {
  return launch_factor_solve_matrix_split<float>(
      A, R, L, D, X, n, k, B, NG, pivot_floor,
      static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_solve_matrix_split_f64(const double* A,
                                              const double* R, double* L,
                                              double* D, double* X, int n,
                                              int k, long long B, int NG,
                                              double pivot_floor,
                                              void* stream) {
  return launch_factor_solve_matrix_split<double>(
      A, R, L, D, X, n, k, B, NG, pivot_floor,
      static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_solve_matrix_warp_f32(const float* A, const float* R,
                                             float* L, float* D, float* X,
                                             int n, int k, long long B,
                                             float pivot_floor,
                                             void* stream) {
  return launch_factor_solve_matrix_warp<float>(
      A, R, L, D, X, n, k, B, pivot_floor,
      static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_solve_matrix_warp_f64(const double* A,
                                             const double* R, double* L,
                                             double* D, double* X, int n,
                                             int k, long long B,
                                             double pivot_floor,
                                             void* stream) {
  return launch_factor_solve_matrix_warp<double>(
      A, R, L, D, X, n, k, B, pivot_floor,
      static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_block_f32(const float* A, float* L, float* D, int n,
                                 long long B, float pivot_floor,
                                 void* stream) {
  return launch_factor_block<float>(A, L, D, n, B, pivot_floor,
                                    static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_block_f64(const double* A, double* L, double* D,
                                 int n, long long B, double pivot_floor,
                                 void* stream) {
  return launch_factor_block<double>(A, L, D, n, B, pivot_floor,
                                     static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_solve_matrix_f32(const float* A, const float* R,
                                        float* L, float* D, float* X, int n,
                                        int k, long long B,
                                        float pivot_floor, void* stream) {
  return launch_factor_solve_matrix<float>(
      A, R, L, D, X, n, k, B, pivot_floor,
      static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_solve_matrix_f64(const double* A, const double* R,
                                        double* L, double* D, double* X,
                                        int n, int k, long long B,
                                        double pivot_floor, void* stream) {
  return launch_factor_solve_matrix<double>(
      A, R, L, D, X, n, k, B, pivot_floor,
      static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_f32(const float* A, float* L, float* D, int n,
                           long long B, float pivot_floor, void* stream) {
  return launch_factor<float>(A, L, D, n, B, pivot_floor,
                              static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_factor_f64(const double* A, double* L, double* D, int n,
                           long long B, double pivot_floor, void* stream) {
  return launch_factor<double>(A, L, D, n, B, pivot_floor,
                               static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_f32(const float* L, const float* D, const float* rhs,
                          float* x, int n, long long B, void* stream) {
  return launch_solve<float>(L, D, rhs, x, n, B,
                             static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_f64(const double* L, const double* D,
                          const double* rhs, double* x, int n, long long B,
                          void* stream) {
  return launch_solve<double>(L, D, rhs, x, n, B,
                              static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_warp_f32(const float* L, const float* D,
                               const float* rhs, float* x, int n,
                               long long B, void* stream) {
  return launch_solve_warp<float>(L, D, rhs, x, n, B,
                                  static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_warp_f64(const double* L, const double* D,
                               const double* rhs, double* x, int n,
                               long long B, void* stream) {
  return launch_solve_warp<double>(L, D, rhs, x, n, B,
                                   static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_matrix_warp_f32(const float* L, const float* D,
                                      const float* rhs, float* x, int n,
                                      int k, long long B, int G, int NG,
                                      void* stream) {
  return launch_solve_matrix_warp<float>(L, D, rhs, x, n, k, B, G, NG,
                                         static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_matrix_warp_f64(const double* L, const double* D,
                                      const double* rhs, double* x, int n,
                                      int k, long long B, int G, int NG,
                                      void* stream) {
  return launch_solve_matrix_warp<double>(L, D, rhs, x, n, k, B, G, NG,
                                          static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_matrix_f32(const float* L, const float* D,
                                 const float* rhs, float* x, int n, int k,
                                 long long B, void* stream) {
  return launch_solve_matrix<float>(L, D, rhs, x, n, k, B,
                                    static_cast<cudaStream_t>(stream));
}

int ipmzoo_ldlt_solve_matrix_f64(const double* L, const double* D,
                                 const double* rhs, double* x, int n, int k,
                                 long long B, void* stream) {
  return launch_solve_matrix<double>(L, D, rhs, x, n, k, B,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
