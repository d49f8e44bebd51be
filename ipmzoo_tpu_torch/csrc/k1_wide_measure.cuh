// K1's wide and block routes measured: two entries that chip_profile.py's
// `wide` section builds beside the routes (ops/cuda_k1_measure.py).  No
// solver loads them.
//
// This file is not compiled alone: ops/cuda_k1_measure.py:source prints
// the block route's text (models/fused_source.py:fused_wide_block_source:
// fused_ipm.cuh, fused_team.cuh at 32 lanes, fused_wide_block.cuh, the
// generated `struct Form` and its entry points), then k1_clock.cuh
// (measure_clock, ClockedFactor), this file and
// IPMZOO_K1_MEASURE_ENTRY_POINTS(ipmzoo_fused::Form).
//
// * The factor alone (factor_reps_kernel): `reps` LDL^T factorisations of
//   each instance's packed matrix K0, every one from a fresh copy: the
//   wide route's (team_ldlt on one warp, K and D in a device-memory
//   workspace) or the block route's (block_ldlt on W warps, K, D and the
//   products in shared memory).  `resident` > 0 makes the grid that many
//   blocks an SM, each looping over the instances, so an SM holds at most
//   the route's own blocks without shared memory to cap them; `pad` > 0
//   asks each block for that many bytes of shared memory all the same,
//   which caps the blocks an SM holds the other way and takes the bytes
//   from the L1 that the wide route's factor reads through.
// * The share of a launch in the factor (the clocked kernels): each
//   route's kernel, its factor wrapped in clock64 reads (ClockedFactor);
//   per instance the cycles its team spent in the factor and the cycles
//   its block lived.

namespace ipmzoo_fused {

// Values of shared memory the factor alone takes: on the block route's
// factor K, D, two product buffers, the flag and a slot; on the wide
// route's a slot.
template <int N>
IPM_FN constexpr int measure_factor_values(bool shared) {
  return shared ? N * (N + 1) / 2 + 3 * N + 2 : 1;
}

#ifdef __CUDACC__
template <typename T, int N, bool kShared>
__global__ void __launch_bounds__(kBlockMaxThreads)
factor_reps_kernel(const T* K0, long long B, int reps, T pivot_floor,
                   T* work, T* sink) {
  extern __shared__ __align__(16) unsigned char measure_smem[];
  constexpr int kTri = N * (N + 1) / 2;
  T* smem = reinterpret_cast<T*>(measure_smem);
  const int tid = static_cast<int>(threadIdx.x), nt = blockDim.x;
  const BlockFactor<T> bf{tid, nt, smem + kTri + N, smem + kTri + 3 * N};
  const Team<T> tm{tid & 31, 0xffffffffu,
                   smem + measure_factor_values<N>(kShared) - 1};
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    T* K = kShared ? smem : work + b * (kTri + N);
    T* D = K + kTri;
    const T* src = K0 + b * kTri;
    T acc = T(0);
    for (int r = 0; r < reps; ++r) {
      for (int e = tid; e < kTri; e += nt) K[e] = src[e];
      __syncthreads();
      if (kShared) {
        block_ldlt<T, N>(bf, K, D, pivot_floor);
      } else {
        team_ldlt<T, N>(tm, K, D, pivot_floor);
      }
      if (tid == 0) {
        T s = T(0);
        for (int j = 0; j < N; ++j) s += D[j];
        for (int k = 0; k < N - 1; ++k) s += K[tri(N - 1, k)];
        acc = acc + s;
      }
      __syncthreads();
    }
    if (tid == 0) sink[b] = acc;
  }
}

// The wide route's kernel (fused_wide.cuh:fused_wide_kernel) with its
// factor clocked; cycles (2 x B): the factor's, then the block's life.
template <typename F, typename T>
__global__ void __launch_bounds__(32)
clocked_wide_kernel(Data<T> dat, Params<T> prm, const T* v0, const T* mu0,
                    const T* it0, Out<T> out, int max_iter, int warm,
                    int gondzio, T* ws, long long* cycles) {
  const long long t0 = clock64();
  extern __shared__ __align__(16) unsigned char measure_smem[];
  const int64_t b = blockIdx.x;
  T* region = ws + b * TeamLayout<F>::kStride;
  stage_data<F, T>(dat, region, b, 1, threadIdx.x, 32);
  __syncwarp();
  const Team<T> tm{static_cast<int>(threadIdx.x), 0xffffffffu,
                   reinterpret_cast<T*>(measure_smem)};
  const ClockedFactor<TeamFactor> factor{TeamFactor{}, cycles + b};
  solve_team<F, T>(tm, staged<F, T>(region), work<F, T>(region), factor,
                   prm, v0, mu0, it0, out, dat.S, b, max_iter, warm,
                   gondzio);
  if (threadIdx.x == 0) cycles[dat.S + b] = clock64() - t0;
}

// The block route's kernel (fused_wide_block.cuh:fused_wide_block_kernel)
// with its factor clocked on warp 0; cycles as clocked_wide_kernel's.
template <typename F, typename T>
__global__ void __launch_bounds__(kBlockMaxThreads)
clocked_block_kernel(Data<T> dat, Params<T> prm, const T* v0, const T* mu0,
                     const T* it0, Out<T> out, int max_iter, int warm,
                     int gondzio, T* ws, long long* cycles) {
  const long long t0 = clock64();
  extern __shared__ __align__(16) unsigned char measure_smem[];
  using L = BlockLayout<F>;
  T* smem = reinterpret_cast<T*>(measure_smem);
  const int64_t b = blockIdx.x;
  const int tid = static_cast<int>(threadIdx.x);
  T* region = ws + b * block_data_stride<F>();
  stage_data<F, T>(dat, region, b, 1, tid, blockDim.x);
  __syncthreads();
  const BlockFactor<T> bf{tid, static_cast<int>(blockDim.x), smem + L::kKD,
                          smem + L::kFlag};
  const Team<T> tm{tid & 31, 0xffffffffu, smem + L::kSlot};
  if (tid < 32) {
    const ClockedFactor<BlockFactor<T>> factor{bf, cycles + b};
    solve_team<F, T>(tm, staged<F, T>(region), block_work<F, T>(smem),
                     factor, prm, v0, mu0, it0, out, dat.S, b, max_iter,
                     warm, gondzio);
    bf.finish(tm);
  } else {
    bf.template help<F::kAug>(smem + L::kK, smem + L::kDiag,
                              prm.pivot_floor);
  }
  if (tid == 0) cycles[dat.S + b] = clock64() - t0;
}
#endif

// The factor alone for F's order: `reps` factorisations of each of the B
// packed matrices K0 on `warps` warps (block_ldlt, shared memory) or,
// warps = 0, on one warp (team_ldlt, K and D in `work`: B x (kTri +
// kAug) values); `resident` and `pad` as the head of this file says.
// sink[b] sums, over the repetitions, every D[j] and the last row of L.
// Without nvcc, one host thread an instance; the emulated build refuses.
template <typename F, typename T>
int factor_reps_entry(const T* K0, long long B, int reps, int warps,
                      int resident, int pad, T pivot_floor, T* work, T* sink,
                      void* stream) {
  constexpr int N = F::kAug, kTri = F::kTri;
#ifdef __CUDACC__
  if (warps != 0 && !block_warps_ok(warps))
    return static_cast<int>(cudaErrorInvalidValue);
  int bytes = static_cast<int>(sizeof(T)) *
              measure_factor_values<N>(warps != 0);
  if (pad > bytes) bytes = pad;
  if (bytes > kTeamSharedCap) return static_cast<int>(cudaErrorInvalidValue);
  long long grid = B;
  if (resident > 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (static_cast<long long>(resident) * sms < grid)
      grid = static_cast<long long>(resident) * sms;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (warps) {
    err = allow_shared(factor_reps_kernel<T, N, true>);
    if (err) return err;
    factor_reps_kernel<T, N, true>
        <<<static_cast<unsigned>(grid), warps * 32, bytes, st>>>(
            K0, B, reps, pivot_floor, work, sink);
  } else {
    err = allow_shared(factor_reps_kernel<T, N, false>);
    if (err) return err;
    factor_reps_kernel<T, N, false>
        <<<static_cast<unsigned>(grid), 32, bytes, st>>>(
            K0, B, reps, pivot_floor, work, sink);
  }
  return static_cast<int>(cudaGetLastError());
#elif defined(IPMZOO_TEAM_HOST_THREADS)
  (void)K0, (void)B, (void)reps, (void)warps, (void)resident, (void)pad;
  (void)pivot_floor, (void)work, (void)sink, (void)stream;
  return 1;
#else
  (void)resident, (void)pad, (void)stream;
  if (warps != 0 && !block_warps_ok(warps)) return 1;
  std::vector<T> smem(measure_factor_values<N>(true));
  const BlockFactor<T> bf{0, 1, smem.data() + kTri + N,
                          smem.data() + kTri + 3 * N};
  const Team<T> tm{0, 1u, smem.data() + kTri + 3 * N + 1};
  for (long long b = 0; b < B; ++b) {
    T* K = warps ? smem.data() : work + b * (kTri + N);
    T* D = K + kTri;
    T acc = T(0);
    for (int r = 0; r < reps; ++r) {
      for (int e = 0; e < kTri; ++e) K[e] = K0[b * kTri + e];
      if (warps) {
        block_ldlt<T, N>(bf, K, D, pivot_floor);
      } else {
        team_ldlt<T, N>(tm, K, D, pivot_floor);
      }
      T s = T(0);
      for (int j = 0; j < N; ++j) s += D[j];
      for (int k = 0; k < N - 1; ++k) s += K[tri(N - 1, k)];
      acc = acc + s;
    }
    sink[b] = acc;
  }
  return 0;
#endif
}

// One launch of the clocked wide kernel (warps = 0; `ws`: B x
// TeamLayout<F>::kStride values) or clocked block kernel on `warps` warps
// (`ws`: B x block_data_stride<F>() values), with the C signature of the
// block route's entry and cycles (2 x B, zeroed by the caller) before the
// stream.  Without nvcc, one host thread an instance, no cycles counted;
// the emulated build refuses.
template <typename F, typename T>
int clocked_entry(const T* const* data9, const T* v0, const T* mu0,
                  const T* it0, T* const* out6, long long B,
                  const T* params6, int max_iter, int warm, int gondzio,
                  int warps, T* ws, long long* cycles, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  const Out<T> out{out6[0], out6[1], out6[2], out6[3], out6[4], out6[5]};
  constexpr int kSlotValues = F::kSlots > 0 ? F::kSlots : 1;
#ifdef __CUDACC__
  if (warps != 0 && !block_warps_ok(warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(B);
  int err;
  if (warps) {
    const int bytes = block_bytes<F, T>();
    if (bytes > kTeamSharedCap)
      return static_cast<int>(cudaErrorInvalidValue);
    err = allow_shared(clocked_block_kernel<F, T>);
    if (err) return err;
    clocked_block_kernel<F, T><<<grid, warps * 32, bytes, st>>>(
        dat, prm, v0, mu0, it0, out, max_iter, warm, gondzio, ws, cycles);
  } else {
    const int bytes = static_cast<int>(sizeof(T)) * kSlotValues;
    err = allow_shared(clocked_wide_kernel<F, T>);
    if (err) return err;
    clocked_wide_kernel<F, T><<<grid, 32, bytes, st>>>(
        dat, prm, v0, mu0, it0, out, max_iter, warm, gondzio, ws, cycles);
  }
  return static_cast<int>(cudaGetLastError());
#elif defined(IPMZOO_TEAM_HOST_THREADS)
  (void)dat, (void)prm, (void)out, (void)v0, (void)mu0, (void)it0;
  (void)max_iter, (void)warm, (void)gondzio, (void)warps, (void)ws;
  (void)cycles, (void)stream;
  return 1;
#else
  (void)stream;
  using L = BlockLayout<F>;
  if (warps != 0 && !block_warps_ok(warps)) return 1;
  std::vector<T> smem(warps ? L::kValues : kSlotValues);
  for (long long b = 0; b < B; ++b) {
    cycles[b] = cycles[B + b] = 0;
    if (warps) {
      T* region = ws + b * block_data_stride<F>();
      stage_data<F, T>(dat, region, b, 1, 0, 1);
      const BlockFactor<T> bf{0, 1, smem.data() + L::kKD,
                              smem.data() + L::kFlag};
      const Team<T> tm{0, 1u, smem.data() + L::kSlot};
      const ClockedFactor<BlockFactor<T>> factor{bf, cycles + b};
      solve_team<F, T>(tm, staged<F, T>(region), block_work<F, T>(
                           smem.data()), factor, prm, v0, mu0, it0, out, B,
                       b, max_iter, warm, gondzio);
    } else {
      T* region = ws + b * TeamLayout<F>::kStride;
      stage_data<F, T>(dat, region, b, 1, 0, 1);
      const Team<T> tm{0, 1u, smem.data()};
      const ClockedFactor<TeamFactor> factor{TeamFactor{}, cycles + b};
      solve_team<F, T>(tm, staged<F, T>(region), work<F, T>(region), factor,
                       prm, v0, mu0, it0, out, B, b, max_iter, warm,
                       gondzio);
    }
  }
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_K1_MEASURE_ENTRY_POINTS(F)                                    \
  extern "C" int ipmzoo_k1_factor_reps_f32(                                  \
      const float* K0, long long B, int reps, int warps, int resident,       \
      int pad, float pivot_floor, float* work, float* sink, void* stream) {  \
    return ipmzoo_fused::factor_reps_entry<F, float>(                        \
        K0, B, reps, warps, resident, pad, pivot_floor, work, sink, stream); \
  }                                                                          \
  extern "C" int ipmzoo_k1_factor_reps_f64(                                  \
      const double* K0, long long B, int reps, int warps, int resident,      \
      int pad, double pivot_floor, double* work, double* sink,               \
      void* stream) {                                                        \
    return ipmzoo_fused::factor_reps_entry<F, double>(                       \
        K0, B, reps, warps, resident, pad, pivot_floor, work, sink, stream); \
  }                                                                          \
  extern "C" int ipmzoo_k1_clocked_f32(                                      \
      const float* const* data9, const float* v0, const float* mu0,          \
      const float* it0, float* const* out6, long long B,                     \
      const float* params6, int max_iter, int warm, int gondzio, int warps,  \
      float* ws, long long* cycles, void* stream) {                          \
    return ipmzoo_fused::clocked_entry<F, float>(                            \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        warps, ws, cycles, stream);                                          \
  }                                                                          \
  extern "C" int ipmzoo_k1_clocked_f64(                                      \
      const double* const* data9, const double* v0, const double* mu0,       \
      const double* it0, double* const* out6, long long B,                   \
      const double* params6, int max_iter, int warm, int gondzio, int warps, \
      double* ws, long long* cycles, void* stream) {                         \
    return ipmzoo_fused::clocked_entry<F, double>(                           \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        warps, ws, cycles, stream);                                          \
  }
