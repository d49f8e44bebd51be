// T1, T2a, T2b: the measurement kernels of the roofline report for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (ipmzoo_tpu_torch/ops/cuda_roofline.py).
//
// T1 fma_chains_kernel replaces the TPU kernel
//     tools/roofline.py:_fma_kernel
// T2a factor_reps_kernel (thread route) and factor_reps_team_kernel (team
// route) replace the TPU kernel
//     tools/roofline.py:_factor_bench_kernel
// T2b solve_reps_kernel (thread route) and solve_reps_team_kernel (team
// route) replace the TPU kernel
//     tools/roofline.py:_solve_bench_kernel
// Their plain versions are ipmzoo_tpu_torch/ops/cuda_roofline.py:
// fma_chains_plain / factor_reps_plain / solve_reps_plain.
//
// These kernels exist to be timed: each answers one question about the
// fused whole-solve kernel K1 (csrc/fused_ipm.cuh).
//
// T1: what rate of multiply-adds does this card reach outside the tensor
// cores?  Each thread loads one x, derives a = 0.999 x + 1e-3 and CHAINS
// accumulators acc_i = 0.1 (i + 1) x, runs `reps` rounds of
// acc_i = acc_i * a + x on every accumulator and stores their sum.  The
// accumulators are a compile-time-sized array indexed by unrolled loops,
// so they sit in registers; the loop body holds no load and no store.
// It is bound by operations: 2 * CHAINS * reps per thread against 8 or 16
// bytes of traffic.  A chain is a dependent sequence, so one thread keeps
// CHAINS multiply-adds in flight; whether that, times the warps resident
// on an SM, covers the pipeline's latency is what the sweep over CHAINS,
// threads per block and blocks per SM finds out.  `reps` is a run-time
// argument and the round loop is unrolled by a fixed 8, so the
// instruction count per round is exact at any `reps`.  With x in [0, 1],
// a <= 1 and the accumulators grow at most linearly in `reps`: they stay
// finite in float32 up to reps ~ 1e38.
//
// T2: how far are K1's factorisation and triangular solves from that
// rate, inside K1's own storage?  One thread per instance, 64 threads per
// block as K1, the matrix read SoA (N, N, B) with the batch fastest into
// the per-thread packed lower triangle in local memory exactly as
// fused_step holds it, then `reps` times the very functions K1 runs:
// ldlt_packed (T2a) or, after one factorisation, ldlt_solve_packed (T2b).
// The input of repetition r is scaled by 1 + 1e-6 r so that no two
// repetitions share a value.  The time per repetition is the slope
// between two values of `reps`, which cancels the launch and the
// prologue.  Bound: operations (about N^3/3 a factor, that is N^3/6
// multiply-adds, and 2 N^2 a solve, against one read of the matrix per
// repetition that L2 serves).
//
// Each T2 kernel writes two values per instance.  `acc` is the TPU
// kernel's own output, the sum over repetitions of D[0] (T2a) or x[0]
// (T2b).  D[0] is the first pivot, K0[0][0] (1 + 1e-6 r): on the TPU the
// writes into scratch memory keep the rest of the factorisation alive,
// here the compiler would delete everything after column 0.  So `sink`
// sums, over the repetitions, every D[j] and the last row of L (T2a) or
// every x[i] (T2b): it depends on the whole computation, and the
// wrappers hold it to the plain version.
//
// T2a has a second route, the team route (factor_reps_team_kernel): the
// same repetitions on K1's team route (fused_team.cuh), whose launches are
// all of the fused slice's K1 launches.  A team of kLanes (16) lanes an
// instance, 64-thread blocks of kTeamsPerBlock teams; each team's region
// in dynamic shared memory holds the packed K0, staged once a launch with
// consecutive threads on consecutive instances, and the K and D that
// team_ldlt (the team route's factor, TeamFactor) works on, as
// team_fused_step holds them.  Repetition r copies K0 (1 + 1e-6 r) into K,
// lane by lane, and factors it; its sink sums the same entries as the
// thread route's, each lane its own, and team_sum adds the lanes' parts
// at the end: another order than the plain version's, held to a
// tolerance.  Bound as the thread route's: the factor's operations.  On
// the team route the factor is one column after the other, a team
// barrier each, with the rows below a column spread over the lanes.
//
// T2b has the same team route (solve_reps_team_kernel): each team's
// region (SolveTeamLayout) holds the packed K0 and b0, staged once a
// launch as T2a's K0, D, b and the slot.  The prologue factors K0 in
// place by team_ldlt, as K1's team route does; repetition r writes
// b = b0 (1 + 1e-6 r), entry i in lane i % kLanes, which is
// team_ldlt_solve's own ownership, so no barrier comes before the solve,
// and then runs team_ldlt_solve, the solve team_direction runs in K1:
// x in registers, x_j broadcast by shuffle, K and D read from shared
// memory.  acc is the sum of x[0] in lane 0; sink each lane's sum of its
// own entries of x, added over the team by team_sum.  K and D are not
// written in the repetition loop, so a compiler could keep a lane's
// factor entries in registers across repetitions and time a cheaper
// solve than K1's, which refactors every iteration: the loop is kept
// rolled, and team_ldlt_solve's closing barrier orders every repetition's
// shared-memory loads after the last one's (chip_roofline.py reads the
// loop's loads in the build's SASS).  Bound: the solve's operations.
//
// Arithmetic is plain IEEE (no fast-math); nvcc contracts a * b + c into
// one FMA, which is the point of T1 and a rounding-level difference to
// the plain versions elsewhere.  Without nvcc the team route runs one
// lane a team, or with IPMZOO_TEAM_EMULATE (C++20, threads) kLanes host
// threads a team, as the host builds of K1's team route do.

#include "fused_ipm.cuh"
#include "fused_team.cuh"

namespace ipmzoo_roofline {

using ipmzoo_fused::kLanes;
using ipmzoo_fused::kTeamsPerBlock;
using ipmzoo_fused::kTeamThreads;
using ipmzoo_fused::ldlt_packed;
using ipmzoo_fused::ldlt_solve_packed;
using ipmzoo_fused::Team;
using ipmzoo_fused::team_ldlt;
using ipmzoo_fused::team_ldlt_solve;
using ipmzoo_fused::team_sum;
using ipmzoo_fused::team_sync;
using ipmzoo_fused::tri;

// T1 for one element.
template <typename T, int CHAINS>
IPM_FN T fma_chains_value(T x, int reps) {
  const T a = x * T(0.999) + T(1e-3);
  T acc[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc[i] = x * T(0.1 * (i + 1));
#pragma unroll 8
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) acc[i] = acc[i] * a + x;
  }
  T out = acc[0];
#pragma unroll
  for (int i = 1; i < CHAINS; ++i) out = out + acc[i];
  return out;
}

// The packed lower triangle of instance b of K0 (N, N, S), times `scale`.
template <typename T, int N>
IPM_FN void load_packed(const T* K0, int64_t S, int64_t b, T scale, T* K) {
  for (int i = 0; i < N; ++i)
    for (int j = 0; j <= i; ++j)
      K[tri(i, j)] = K0[(static_cast<int64_t>(i) * N + j) * S + b] * scale;
}

// T2a for instance b: `reps` factorisations of K0 (1 + 1e-6 r).
template <typename T, int N>
IPM_FN void factor_reps_instance(const T* K0, int64_t S, int64_t b, int reps,
                                 T pivot_floor, T* acc_out, T* sink_out) {
  T K[N * (N + 1) / 2];
  T D[N];
  T acc = T(0), sink = T(0);
  for (int r = 0; r < reps; ++r) {
    load_packed<T, N>(K0, S, b, T(1.0 + 1e-6 * r), K);
    ldlt_packed<T, N>(K, D, pivot_floor);
    acc = acc + D[0];
    T s = T(0);
    for (int j = 0; j < N; ++j) s += D[j];
    for (int k = 0; k < N - 1; ++k) s += K[tri(N - 1, k)];
    sink = sink + s;
  }
  acc_out[b] = acc;
  sink_out[b] = sink;
}

// T2b for instance b: one factorisation of K0, then `reps` solves against
// b0 (1 + 1e-6 r).
template <typename T, int N>
IPM_FN void solve_reps_instance(const T* K0, const T* b0, int64_t S,
                                int64_t b, int reps, T pivot_floor,
                                T* acc_out, T* sink_out) {
  T K[N * (N + 1) / 2];
  T D[N];
  T x[N];
  load_packed<T, N>(K0, S, b, T(1), K);
  ldlt_packed<T, N>(K, D, pivot_floor);
  T acc = T(0), sink = T(0);
  for (int r = 0; r < reps; ++r) {
    const T scale = T(1.0 + 1e-6 * r);
    for (int i = 0; i < N; ++i) x[i] = b0[i * S + b] * scale;
    ldlt_solve_packed<T, N>(K, D, x);
    acc = acc + x[0];
    T s = T(0);
    for (int i = 0; i < N; ++i) s += x[i];
    sink = sink + s;
  }
  acc_out[b] = acc;
  sink_out[b] = sink;
}

// T2a's team route: one team's region in shared memory, in values; the
// stride padded as TeamLayout's, so the two teams of a warp start 16
// banks apart.
template <int N>
struct FactorTeamLayout {
  static constexpr int kTri = N * (N + 1) / 2;
  static constexpr int kK0 = 0;
  static constexpr int kK = kK0 + kTri;
  static constexpr int kD = kK + kTri;
  static constexpr int kSlot = kD + N;
  static constexpr int kEnd = kSlot + 1;
  static constexpr int kStride = (kEnd + 31) / 32 * 32 + 16;
};

// T2b's team route: one team's region, padded as FactorTeamLayout's.
// K0 is factored in place into K.
template <int N>
struct SolveTeamLayout {
  static constexpr int kK = 0;
  static constexpr int kD = kK + N * (N + 1) / 2;
  static constexpr int kB0 = kD + N;
  static constexpr int kB = kB0 + N;
  static constexpr int kSlot = kB + N;
  static constexpr int kEnd = kSlot + 1;
  static constexpr int kStride = (kEnd + 31) / 32 * 32 + 16;
};

// The packed lower triangles of the nb instances from b0 of K0 (N, N, S)
// into the start of their teams' regions, `stride` values apart;
// consecutive e = first, first + step, ... take consecutive instances of
// one entry.
template <typename T, int N>
IPM_FN void stage_packed(const T* K0, int64_t S, int64_t b0, int nb,
                         T* smem, int stride, int first, int step) {
  static_assert(FactorTeamLayout<N>::kK0 == 0 && SolveTeamLayout<N>::kK == 0,
                "the packed K0 opens a team's region");
  for (int e = first; e < N * N * nb; e += step) {
    const int k = e / nb, g = e - k * nb;
    const int i = k / N, j = k - i * N;
    if (j <= i)
      smem[g * stride + tri(i, j)] = K0[static_cast<int64_t>(k) * S + b0 + g];
  }
}

// The right-hand sides of the nb instances from b0 of v (N, S) into their
// teams' regions at `offset`, as stage_packed.
template <typename T, int N>
IPM_FN void stage_vector(const T* v, int64_t S, int64_t b0, int nb, T* smem,
                         int stride, int offset, int first, int step) {
  for (int e = first; e < N * nb; e += step) {
    const int i = e / nb, g = e - i * nb;
    smem[g * stride + offset + i] = v[static_cast<int64_t>(i) * S + b0 + g];
  }
}

// T2a on the team route for one team's staged instance: `reps`
// factorisations of K0 (1 + 1e-6 r) by team_ldlt; acc and sink alike in
// every lane.
template <typename T, int N>
IPM_FN void factor_reps_team(const Team<T>& tm, T* region, int reps,
                             T pivot_floor, T& acc_out, T& sink_out) {
  using L = FactorTeamLayout<N>;
  const T* K0 = region + L::kK0;
  T* K = region + L::kK;
  T* D = region + L::kD;
  T acc = T(0), sink = T(0);
  for (int r = 0; r < reps; ++r) {
    const T scale = T(1.0 + 1e-6 * r);
    for (int e = tm.lane; e < L::kTri; e += kLanes) K[e] = K0[e] * scale;
    team_sync(tm);
    team_ldlt<T, N>(tm, K, D, pivot_floor);
    if (tm.lane == 0) acc = acc + D[0];
    for (int j = tm.lane; j < N; j += kLanes) sink += D[j];
    for (int k = tm.lane; k < N - 1; k += kLanes) sink += K[tri(N - 1, k)];
    team_sync(tm);   // every lane's reads done before the next copy
  }
  acc_out = team_sum(tm, acc);
  sink_out = team_sum(tm, sink);
}

// T2b on the team route for one team's staged instance: team_ldlt of K0
// in place, then `reps` solves of b0 (1 + 1e-6 r) by team_ldlt_solve;
// acc and sink alike in every lane.
template <typename T, int N>
IPM_FN void solve_reps_team(const Team<T>& tm, T* region, int reps,
                            T pivot_floor, T& acc_out, T& sink_out) {
  using L = SolveTeamLayout<N>;
  T* K = region + L::kK;
  T* D = region + L::kD;
  const T* b0 = region + L::kB0;
  T* b = region + L::kB;
  team_ldlt<T, N>(tm, K, D, pivot_floor);
  T acc = T(0), sink = T(0);
  // rolled: one solve a trip, K and D loaded from shared memory in each
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
    const T scale = T(1.0 + 1e-6 * r);
    for (int i = tm.lane; i < N; i += kLanes) b[i] = b0[i] * scale;
    team_ldlt_solve<T, N>(tm, K, D, b);
    if (tm.lane == 0) acc = acc + b[0];
    for (int i = tm.lane; i < N; i += kLanes) sink += b[i];
  }
  acc_out = team_sum(tm, acc);
  sink_out = team_sum(tm, sink);
}

#ifdef __CUDACC__
// K1's block size (ipmzoo_fused::kThreads).
constexpr int kInstanceThreads = 64;

template <typename T, int CHAINS>
__global__ void fma_chains_kernel(const T* __restrict__ x,
                                  T* __restrict__ out, int64_t n, int reps) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = fma_chains_value<T, CHAINS>(x[i], reps);
}

template <typename T, int N>
__global__ void factor_reps_kernel(const T* __restrict__ K0, int64_t S,
                                   int reps, T pivot_floor,
                                   T* __restrict__ acc, T* __restrict__ sink) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= S) return;
  factor_reps_instance<T, N>(K0, S, b, reps, pivot_floor, acc, sink);
}

template <typename T, int N>
__global__ void __launch_bounds__(kTeamThreads)
factor_reps_team_kernel(const T* __restrict__ K0, int64_t S, int reps,
                        T pivot_floor, T* __restrict__ acc,
                        T* __restrict__ sink) {
  extern __shared__ __align__(16) unsigned char reps_smem[];
  T* smem = reinterpret_cast<T*>(reps_smem);
  using L = FactorTeamLayout<N>;
  const int team = threadIdx.x / kLanes;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTeamsPerBlock;
  const int nb = static_cast<int>(
      S - b0 < kTeamsPerBlock ? S - b0 : kTeamsPerBlock);
  stage_packed<T, N>(K0, S, b0, nb, smem, L::kStride, threadIdx.x,
                     blockDim.x);
  __syncthreads();
  if (team >= nb) return;   // the whole team alike
  T* region = smem + team * L::kStride;
  const Team<T> tm{static_cast<int>(threadIdx.x % kLanes),
                   ipmzoo_fused::team_mask(threadIdx.x), region + L::kSlot};
  T a, s;
  factor_reps_team<T, N>(tm, region, reps, pivot_floor, a, s);
  if (tm.lane == 0) {
    acc[b0 + team] = a;
    sink[b0 + team] = s;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kTeamThreads)
solve_reps_team_kernel(const T* __restrict__ K0, const T* __restrict__ b0,
                       int64_t S, int reps, T pivot_floor,
                       T* __restrict__ acc, T* __restrict__ sink) {
  extern __shared__ __align__(16) unsigned char reps_smem[];
  T* smem = reinterpret_cast<T*>(reps_smem);
  using L = SolveTeamLayout<N>;
  const int team = threadIdx.x / kLanes;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTeamsPerBlock;
  const int nb = static_cast<int>(
      S - first < kTeamsPerBlock ? S - first : kTeamsPerBlock);
  stage_packed<T, N>(K0, S, first, nb, smem, L::kStride, threadIdx.x,
                     blockDim.x);
  stage_vector<T, N>(b0, S, first, nb, smem, L::kStride, L::kB0,
                     threadIdx.x, blockDim.x);
  __syncthreads();
  if (team >= nb) return;   // the whole team alike
  T* region = smem + team * L::kStride;
  const Team<T> tm{static_cast<int>(threadIdx.x % kLanes),
                   ipmzoo_fused::team_mask(threadIdx.x), region + L::kSlot};
  T a, s;
  solve_reps_team<T, N>(tm, region, reps, pivot_floor, a, s);
  if (tm.lane == 0) {
    acc[first + team] = a;
    sink[first + team] = s;
  }
}

template <typename T, int N>
__global__ void solve_reps_kernel(const T* __restrict__ K0,
                                  const T* __restrict__ b0, int64_t S,
                                  int reps, T pivot_floor,
                                  T* __restrict__ acc, T* __restrict__ sink) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= S) return;
  solve_reps_instance<T, N>(K0, b0, S, b, reps, pivot_floor, acc, sink);
}
#endif

// Entry points.  With nvcc each enqueues one launch on `stream` and
// returns cudaGetLastError(); without it (the host build of the tests)
// the same per-element code runs in a loop and 0 is returned.  -1: a
// template argument (chains, n) that is not instantiated.

template <typename T, int CHAINS>
int fma_chains_launch(const T* x, T* out, long long n, int reps, int threads,
                      void* stream) {
#ifdef __CUDACC__
  const unsigned grid = static_cast<unsigned>((n + threads - 1) / threads);
  fma_chains_kernel<T, CHAINS>
      <<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n,
                                                                reps);
  return static_cast<int>(cudaGetLastError());
#else
  (void)threads;
  (void)stream;
  for (long long i = 0; i < n; ++i)
    out[i] = fma_chains_value<T, CHAINS>(x[i], reps);
  return 0;
#endif
}

template <typename T>
int fma_chains_entry(const T* x, T* out, long long n, int chains, int reps,
                     int threads, void* stream) {
  switch (chains) {
    case 4:
      return fma_chains_launch<T, 4>(x, out, n, reps, threads, stream);
    case 8:
      return fma_chains_launch<T, 8>(x, out, n, reps, threads, stream);
    case 16:
      return fma_chains_launch<T, 16>(x, out, n, reps, threads, stream);
    default:
      return -1;
  }
}

template <typename T, int N>
int factor_reps_launch(const T* K0, T* acc, T* sink, long long B, int reps,
                       T pivot_floor, void* stream) {
#ifdef __CUDACC__
  const unsigned grid =
      static_cast<unsigned>((B + kInstanceThreads - 1) / kInstanceThreads);
  factor_reps_kernel<T, N>
      <<<grid, kInstanceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          K0, B, reps, pivot_floor, acc, sink);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  for (long long b = 0; b < B; ++b)
    factor_reps_instance<T, N>(K0, B, b, reps, pivot_floor, acc, sink);
  return 0;
#endif
}

template <typename T, int N>
int factor_reps_team_launch(const T* K0, T* acc, T* sink, long long B,
                            int reps, T pivot_floor, void* stream) {
  using L = FactorTeamLayout<N>;
#ifdef __CUDACC__
  return ipmzoo_fused::launch_team(
      factor_reps_team_kernel<T, N>,
      static_cast<int>(sizeof(T)) * L::kStride * kTeamsPerBlock, B, stream,
      K0, B, reps, pivot_floor, acc, sink);
#else
  (void)stream;
  std::vector<T> region(L::kStride);
  for (long long b = 0; b < B; ++b) {
    stage_packed<T, N>(K0, B, b, 1, region.data(), L::kStride, 0, 1);
    ipmzoo_fused::host_team(
        region.data() + L::kSlot, [&](const Team<T>& tm) {
          T a, s;
          factor_reps_team<T, N>(tm, region.data(), reps, pivot_floor, a, s);
          if (tm.lane == 0) {
            acc[b] = a;
            sink[b] = s;
          }
        });
  }
  return 0;
#endif
}

template <typename T, int N>
int solve_reps_launch(const T* K0, const T* b0, T* acc, T* sink, long long B,
                      int reps, T pivot_floor, void* stream) {
#ifdef __CUDACC__
  const unsigned grid =
      static_cast<unsigned>((B + kInstanceThreads - 1) / kInstanceThreads);
  solve_reps_kernel<T, N>
      <<<grid, kInstanceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          K0, b0, B, reps, pivot_floor, acc, sink);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  for (long long b = 0; b < B; ++b)
    solve_reps_instance<T, N>(K0, b0, B, b, reps, pivot_floor, acc, sink);
  return 0;
#endif
}

template <typename T, int N>
int solve_reps_team_launch(const T* K0, const T* b0, T* acc, T* sink,
                           long long B, int reps, T pivot_floor,
                           void* stream) {
  using L = SolveTeamLayout<N>;
#ifdef __CUDACC__
  return ipmzoo_fused::launch_team(
      solve_reps_team_kernel<T, N>,
      static_cast<int>(sizeof(T)) * L::kStride * kTeamsPerBlock, B, stream,
      K0, b0, B, reps, pivot_floor, acc, sink);
#else
  (void)stream;
  std::vector<T> region(L::kStride);
  for (long long b = 0; b < B; ++b) {
    stage_packed<T, N>(K0, B, b, 1, region.data(), L::kStride, 0, 1);
    stage_vector<T, N>(b0, B, b, 1, region.data(), L::kStride, L::kB0, 0,
                       1);
    ipmzoo_fused::host_team(
        region.data() + L::kSlot, [&](const Team<T>& tm) {
          T a, s;
          solve_reps_team<T, N>(tm, region.data(), reps, pivot_floor, a, s);
          if (tm.lane == 0) {
            acc[b] = a;
            sink[b] = s;
          }
        });
  }
  return 0;
#endif
}

// What a team route of T2 is at order N in type T (solve: T2b, else
// T2a): out4 = (lanes a team, threads a block, bytes of shared memory a
// team, teams resident per SM; the last 0 in a host build).
template <typename T, int N>
int reps_team_shape_at(int solve, int* out4) {
  const int bytes = static_cast<int>(sizeof(T)) *
                    (solve ? SolveTeamLayout<N>::kStride
                           : FactorTeamLayout<N>::kStride);
  out4[0] = kLanes;
  out4[1] = kTeamThreads;
  out4[2] = bytes;
  out4[3] = 0;
#ifdef __CUDACC__
  return solve ? ipmzoo_fused::team_occupancy(solve_reps_team_kernel<T, N>,
                                              bytes * kTeamsPerBlock,
                                              out4 + 3)
               : ipmzoo_fused::team_occupancy(factor_reps_team_kernel<T, N>,
                                              bytes * kTeamsPerBlock,
                                              out4 + 3);
#else
  return 0;
#endif
}

// The orders instantiated: the fused slice's augmented order 24, and 8
// for small checks.
template <typename T>
int factor_reps_entry(const T* K0, T* acc, T* sink, int n, long long B,
                      int reps, T pivot_floor, void* stream) {
  switch (n) {
    case 8:
      return factor_reps_launch<T, 8>(K0, acc, sink, B, reps, pivot_floor,
                                      stream);
    case 24:
      return factor_reps_launch<T, 24>(K0, acc, sink, B, reps, pivot_floor,
                                       stream);
    default:
      return -1;
  }
}

template <typename T>
int factor_reps_team_entry(const T* K0, T* acc, T* sink, int n, long long B,
                           int reps, T pivot_floor, void* stream) {
  switch (n) {
    case 8:
      return factor_reps_team_launch<T, 8>(K0, acc, sink, B, reps,
                                           pivot_floor, stream);
    case 24:
      return factor_reps_team_launch<T, 24>(K0, acc, sink, B, reps,
                                            pivot_floor, stream);
    default:
      return -1;
  }
}

template <typename T>
int solve_reps_entry(const T* K0, const T* b0, T* acc, T* sink, int n,
                     long long B, int reps, T pivot_floor, void* stream) {
  switch (n) {
    case 8:
      return solve_reps_launch<T, 8>(K0, b0, acc, sink, B, reps, pivot_floor,
                                     stream);
    case 24:
      return solve_reps_launch<T, 24>(K0, b0, acc, sink, B, reps,
                                      pivot_floor, stream);
    default:
      return -1;
  }
}

template <typename T>
int solve_reps_team_entry(const T* K0, const T* b0, T* acc, T* sink, int n,
                          long long B, int reps, T pivot_floor,
                          void* stream) {
  switch (n) {
    case 8:
      return solve_reps_team_launch<T, 8>(K0, b0, acc, sink, B, reps,
                                          pivot_floor, stream);
    case 24:
      return solve_reps_team_launch<T, 24>(K0, b0, acc, sink, B, reps,
                                           pivot_floor, stream);
    default:
      return -1;
  }
}

template <typename T>
int reps_team_shape(int solve, int n, int* out4) {
  switch (n) {
    case 8:
      return reps_team_shape_at<T, 8>(solve, out4);
    case 24:
      return reps_team_shape_at<T, 24>(solve, out4);
    default:
      return -1;
  }
}

}  // namespace ipmzoo_roofline

#define IPMZOO_ROOFLINE_ENTRY_POINTS(T, SFX)                                  \
  extern "C" int ipmzoo_fma_chains_##SFX(const T* x, T* out, long long n,     \
                                         int chains, int reps, int threads,   \
                                         void* stream) {                      \
    return ipmzoo_roofline::fma_chains_entry<T>(x, out, n, chains, reps,      \
                                                threads, stream);             \
  }                                                                           \
  extern "C" int ipmzoo_factor_reps_##SFX(const T* K0, T* acc, T* sink,       \
                                          int n, long long B, int reps,       \
                                          T pivot_floor, void* stream) {      \
    return ipmzoo_roofline::factor_reps_entry<T>(K0, acc, sink, n, B, reps,   \
                                                 pivot_floor, stream);        \
  }                                                                           \
  extern "C" int ipmzoo_factor_reps_team_##SFX(                              \
      const T* K0, T* acc, T* sink, int n, long long B, int reps,             \
      T pivot_floor, void* stream) {                                          \
    return ipmzoo_roofline::factor_reps_team_entry<T>(                        \
        K0, acc, sink, n, B, reps, pivot_floor, stream);                      \
  }                                                                           \
  extern "C" int ipmzoo_solve_reps_##SFX(const T* K0, const T* b0, T* acc,    \
                                         T* sink, int n, long long B,         \
                                         int reps, T pivot_floor,             \
                                         void* stream) {                      \
    return ipmzoo_roofline::solve_reps_entry<T>(K0, b0, acc, sink, n, B,      \
                                                reps, pivot_floor, stream);   \
  }                                                                           \
  extern "C" int ipmzoo_solve_reps_team_##SFX(                               \
      const T* K0, const T* b0, T* acc, T* sink, int n, long long B,          \
      int reps, T pivot_floor, void* stream) {                                \
    return ipmzoo_roofline::solve_reps_team_entry<T>(                         \
        K0, b0, acc, sink, n, B, reps, pivot_floor, stream);                  \
  }                                                                           \
  extern "C" int ipmzoo_reps_team_shape_##SFX(int solve, int n, int* out4) {  \
    return ipmzoo_roofline::reps_team_shape<T>(solve, n, out4);               \
  }

IPMZOO_ROOFLINE_ENTRY_POINTS(float, f32)
IPMZOO_ROOFLINE_ENTRY_POINTS(double, f64)
