// T3, wide route: prefixes of one fused interior-point iteration on K1's
// wide route, for Hopper (sm_90a).
//
// Replaces, beside the thread, team and block routes, the TPU kernel
// tools/fused_phases.py:phase_kernel.  Its plain version is
// ipmzoo_tpu_torch/models/fused_phases.py:phase_plain.
//
// Why this route.  Above augmented order 128, where K1_BLOCK_RULE does
// not take the order or the block overflows the shared memory (float64
// above aug 192, float32 above 257), K1 runs its wide route
// (fused_wide.cuh).  This header runs the prefixes there on K1's wide
// layout and launch: one warp a block and an instance, the team code at
// 32 lanes, the instance's TeamLayout region in a device-memory workspace
// of TeamLayout<F>::kStride values an instance, the team slots in shared
// memory, the factor team_ldlt (TeamFactor).
//
// This file is not compiled alone: models/fused_phases.py:
// phase_wide_source prints fused_ipm.cuh, fused_team.cuh at 32 lanes,
// fused_wide.cuh, fused_phases_team.cuh, this text, the `struct Form` of
// models/codegen_team.py:CppTeam and the entry points for one PHASE
// (IPMZOO_PHASE_WIDE_ENTRY_POINTS).  The outputs and their meaning are
// fused_phases_team.cuh's.  Without __CUDACC__ the entry loops over the
// instances with the region in the workspace the caller passes: one
// lane, or 32 host threads with IPMZOO_TEAM_EMULATE.

namespace ipmzoo_fused {

#ifdef __CUDACC__
// K1's wide launch (fused_wide_kernel's bounds and staging), the prefix in
// place of the solve.
template <typename F, typename T, int PHASE>
__global__ void __launch_bounds__(kWideThreads)
phase_wide_kernel(Data<T> dat, Params<T> prm, T* acc, T* sink, int reps,
                  int perturb, T* ws) {
  extern __shared__ __align__(16) unsigned char phase_wide_smem[];
  using L = TeamLayout<F>;
  const int64_t b = blockIdx.x;
  T* region = ws + b * L::kStride;
  stage_data<F, T>(dat, region, b, 1, threadIdx.x, kWideThreads);
  __syncwarp();
  const Team<T> tm{static_cast<int>(threadIdx.x), 0xffffffffu,
                   reinterpret_cast<T*>(phase_wide_smem)};
  T a, s;
  phase_team<F, T, PHASE>(tm, staged<F, T>(region), work<F, T>(region),
                          TeamFactor{}, prm, reps, perturb, a, s);
  if (tm.lane == 0) {
    acc[b] = a;
    sink[b] = s;
  }
}
#endif

// Entry point, with the C signature of fused_phases.cuh:phase_entry and
// the workspace (B x TeamLayout<F>::kStride values of the working type on
// the data's device) before the stream.  With nvcc it enqueues one launch
// on `stream` and returns its cudaError; without it, it runs each
// instance's prefix and returns 0.
template <typename F, typename T, int PHASE>
int phase_wide_entry(const T* const* data9, T* acc, T* sink, long long B,
                     const T* params6, int reps, int perturb, T* ws,
                     void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  using L = TeamLayout<F>;
#ifdef __CUDACC__
  const int bytes = wide_block_bytes<F, T>();
  if (bytes > kTeamSharedCap) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const int err = allow_shared(phase_wide_kernel<F, T, PHASE>);
    if (err) return err;
  }
  phase_wide_kernel<F, T, PHASE><<<static_cast<unsigned>(B), kWideThreads,
                                   bytes, static_cast<cudaStream_t>(stream)>>>(
      dat, prm, acc, sink, reps, perturb, ws);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  std::vector<T> slot(wide_slot_values<F>());
  for (long long b = 0; b < B; ++b) {
    T* region = ws + b * L::kStride;
    stage_data<F, T>(dat, region, b, 1, 0, 1);
    host_team(slot.data(), [&](const Team<T>& tm) {
      T a, s;
      phase_team<F, T, PHASE>(tm, staged<F, T>(region), work<F, T>(region),
                              TeamFactor{}, prm, reps, perturb, a, s);
      if (tm.lane == 0) {
        acc[b] = a;
        sink[b] = s;
      }
    });
  }
  return 0;
#endif
}

// What the prefix's wide build is, as fused_wide.cuh:fused_wide_shape
// says of K1's: out4 = (lanes an instance, threads a block, values of
// workspace an instance, blocks of this prefix's kernel resident per SM;
// the last 0 in a host build).
template <typename F, int PHASE>
int phase_wide_shape(int itemsize, int* out4) {
  out4[0] = kLanes;
  out4[1] = kWideThreads;
  out4[2] = TeamLayout<F>::kStride;
  out4[3] = 0;
#ifdef __CUDACC__
  return static_cast<int>(
      itemsize == 8
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                out4 + 3, phase_wide_kernel<F, double, PHASE>, kWideThreads,
                wide_block_bytes<F, double>())
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                out4 + 3, phase_wide_kernel<F, float, PHASE>, kWideThreads,
                wide_block_bytes<F, float>()));
#else
  (void)itemsize;
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_PHASE_WIDE_ENTRY_POINTS(F, PHASE)                             \
  extern "C" int ipmzoo_phase_wide_f32(                                      \
      const float* const* data9, float* acc, float* sink, long long B,       \
      const float* params6, int reps, int perturb, float* ws,                \
      void* stream) {                                                        \
    return ipmzoo_fused::phase_wide_entry<F, float, PHASE>(                  \
        data9, acc, sink, B, params6, reps, perturb, ws, stream);            \
  }                                                                          \
  extern "C" int ipmzoo_phase_wide_f64(                                      \
      const double* const* data9, double* acc, double* sink, long long B,    \
      const double* params6, int reps, int perturb, double* ws,              \
      void* stream) {                                                        \
    return ipmzoo_fused::phase_wide_entry<F, double, PHASE>(                 \
        data9, acc, sink, B, params6, reps, perturb, ws, stream);            \
  }                                                                          \
  extern "C" int ipmzoo_phase_wide_shape(int itemsize, int* out4) {          \
    return ipmzoo_fused::phase_wide_shape<F, PHASE>(itemsize, out4);         \
  }
