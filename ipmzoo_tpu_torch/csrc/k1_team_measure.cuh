// K1's team route measured: the share of a launch in its factor, read
// inside the launch by the SM's clock.  chip_profile.py's `fused` section
// builds it beside the routes (ops/cuda_k1_measure.py:team_library); no
// solver loads it.
//
// This file is not compiled alone: ops/cuda_k1_measure.py:team_source
// prints the team route's text (models/fused_source.py:fused_team_source:
// fused_ipm.cuh, fused_team.cuh, the generated `struct Form` and its entry
// points), then k1_clock.cuh, this file and
// IPMZOO_K1_TEAM_MEASURE_ENTRY_POINTS(ipmzoo_fused::Form).
//
// clocked_team_kernel is the team route's kernel
// (fused_team.cuh:fused_team_kernel: its bounds, blocks, shared memory and
// staging) with the factor wrapped in clock64 reads (ClockedFactor
// <TeamFactor>): per instance, the cycles its team spent in the factor and
// the cycles from its block's start to the team's end.  T3's team route
// (fused_phases_team.cuh) estimates the same factor's cost as the
// difference of two prefixes, each its own build; this reading has no
// such confound.

namespace ipmzoo_fused {

#ifdef __CUDACC__
template <typename F, typename T>
__global__ void __launch_bounds__(kTeamThreads, sizeof(T) == 4 ? 8 : 4)
clocked_team_kernel(Data<T> dat, Params<T> prm, const T* v0, const T* mu0,
                    const T* it0, Out<T> out, int max_iter, int warm,
                    int gondzio, long long* cycles) {
  const long long t0 = clock64();
  extern __shared__ __align__(16) unsigned char measure_smem[];
  T* smem = reinterpret_cast<T*>(measure_smem);
  using L = TeamLayout<F>;
  const int team = threadIdx.x / kLanes;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTeamsPerBlock;
  const int nb = static_cast<int>(
      dat.S - b0 < kTeamsPerBlock ? dat.S - b0 : kTeamsPerBlock);
  stage_data<F, T>(dat, smem, b0, nb, threadIdx.x, blockDim.x);
  __syncthreads();
  if (team >= nb) return;
  T* region = smem + team * L::kStride;
  const Team<T> tm{static_cast<int>(threadIdx.x % kLanes),
                   team_mask(threadIdx.x), region + L::kSlot};
  const int64_t b = b0 + team;
  const ClockedFactor<TeamFactor> factor{TeamFactor{}, cycles + b};
  solve_team<F, T>(tm, staged<F, T>(region), work<F, T>(region), factor,
                   prm, v0, mu0, it0, out, dat.S, b, max_iter, warm,
                   gondzio);
  if (tm.lane == 0) cycles[dat.S + b] = clock64() - t0;
}
#endif

// One launch of the clocked team kernel, with the C signature of the team
// route's entry and cycles (2 x B, zeroed by the caller) before the
// stream.  Without nvcc, the team route's host run (host_team), no cycles
// counted.
template <typename F, typename T>
int clocked_team_entry(const T* const* data9, const T* v0, const T* mu0,
                       const T* it0, T* const* out6, long long B,
                       const T* params6, int max_iter, int warm, int gondzio,
                       long long* cycles, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  const Out<T> out{out6[0], out6[1], out6[2], out6[3], out6[4], out6[5]};
  using L = TeamLayout<F>;
#ifdef __CUDACC__
  return launch_team(clocked_team_kernel<F, T>, team_block_bytes<F, T>(), B,
                     stream, dat, prm, v0, mu0, it0, out, max_iter, warm,
                     gondzio, cycles);
#else
  (void)stream;
  std::vector<T> region(L::kStride);
  for (long long b = 0; b < B; ++b) {
    cycles[b] = cycles[B + b] = 0;
    stage_data<F, T>(dat, region.data(), b, 1, 0, 1);
    host_team(region.data() + L::kSlot, [&](const Team<T>& tm) {
      const ClockedFactor<TeamFactor> factor{TeamFactor{}, cycles + b};
      solve_team<F, T>(tm, staged<F, T>(region.data()),
                       work<F, T>(region.data()), factor, prm, v0, mu0, it0,
                       out, B, b, max_iter, warm, gondzio);
    });
  }
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_K1_TEAM_MEASURE_ENTRY_POINTS(F)                               \
  extern "C" int ipmzoo_k1_clocked_team_f32(                                 \
      const float* const* data9, const float* v0, const float* mu0,          \
      const float* it0, float* const* out6, long long B,                     \
      const float* params6, int max_iter, int warm, int gondzio,             \
      long long* cycles, void* stream) {                                     \
    return ipmzoo_fused::clocked_team_entry<F, float>(                       \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        cycles, stream);                                                     \
  }                                                                          \
  extern "C" int ipmzoo_k1_clocked_team_f64(                                 \
      const double* const* data9, const double* v0, const double* mu0,       \
      const double* it0, double* const* out6, long long B,                   \
      const double* params6, int max_iter, int warm, int gondzio,            \
      long long* cycles, void* stream) {                                     \
    return ipmzoo_fused::clocked_team_entry<F, double>(                      \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        cycles, stream);                                                     \
  }
