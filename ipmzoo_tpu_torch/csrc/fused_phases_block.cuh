// T3, block route: prefixes of one fused interior-point iteration on K1's
// block route, for Hopper (sm_90a).
//
// Replaces, beside the thread, team and wide routes, the TPU kernel
// tools/fused_phases.py:phase_kernel, which has no limit on the order.
// Its plain version is ipmzoo_tpu_torch/models/fused_phases.py:
// phase_plain.
//
// Why this route.  Above augmented order 128 K1 runs its block route
// (fused_wide_block.cuh) wherever ops/cuda_fused.py:K1_BLOCK_RULE takes
// the order and the block fits the shared memory: the wide slice
// (portfolio of 128 assets, aug 129) among them.  This header runs the
// prefixes there through K1's own functions, on its layout and launch, so
// that the phases it times are those of the kernel the wide slice
// launches.
//
// This file is not compiled alone: models/fused_phases.py:
// phase_block_source prints fused_ipm.cuh, fused_team.cuh at 32 lanes,
// fused_wide_block.cuh, fused_phases_team.cuh, this text, the `struct
// Form` of models/codegen_team.py:CppTeam and one line that instantiates
// the entry points for one PHASE (IPMZOO_PHASE_BLOCK_ENTRY_POINTS).
//
// Layout and launch are K1's block route's: one thread block of W = 2, 4
// or 8 warps an instance (a launch argument; the kernel is built for
// kBlockMaxThreads), BlockLayout in dynamic shared memory (the packed
// factor, D, b, the work vectors, the product buffers and the slots), the
// staged data in a device-memory workspace of block_data_stride<F>()
// values an instance, staged once a launch by all the threads.  Warp 0
// runs fused_phases_team.cuh:phase_team with a BlockFactor, so the factor
// of prefixes 2-4 is block_ldlt on all W x 32 threads, and then lets the
// other warps leave (BlockFactor::finish); the other warps join each
// factor (BlockFactor::help), exactly as in fused_wide_block.cuh:
// solve_block.  The outputs and their meaning are fused_phases_team.cuh's.
//
// Without __CUDACC__ the entry loops over the instances with the staged
// data in the workspace the caller passes and the shared region in a host
// buffer: one thread an instance, or with IPMZOO_TEAM_EMULATE W x 32 host
// threads, the first 32 the team, as K1's block route does.

namespace ipmzoo_fused {

// Instance b's prefix by the thread `bf.tid` of its block: the data
// staged in `region`, the shared arrays at `smem`; lane 0 of warp 0
// writes acc[b] and sink[b].
template <typename F, typename T, int PHASE>
IPM_FN void phase_block(const Team<T>& tm, const BlockFactor<T>& bf,
                        const T* region, T* smem, const Params<T>& prm,
                        int reps, int perturb, T* acc, T* sink, int64_t b) {
  const Work<T> w = block_work<F, T>(smem);
  if (bf.tid < 32) {
    T a, s;
    phase_team<F, T, PHASE>(tm, staged<F, T>(region), w, bf, prm, reps,
                            perturb, a, s);
    if (tm.lane == 0) {
      acc[b] = a;
      sink[b] = s;
    }
    bf.finish(tm);
  } else {
    bf.template help<F::kAug>(w.K, w.D, prm.pivot_floor);
  }
}

#ifdef __CUDACC__
// K1's block launch (fused_wide_block_kernel's bounds, staging and
// roles), the prefix in place of the solve.
template <typename F, typename T, int PHASE>
__global__ void __launch_bounds__(kBlockMaxThreads)
phase_block_kernel(Data<T> dat, Params<T> prm, T* acc, T* sink, int reps,
                   int perturb, T* ws) {
  extern __shared__ __align__(16) unsigned char phase_block_smem[];
  using L = BlockLayout<F>;
  T* smem = reinterpret_cast<T*>(phase_block_smem);
  const int64_t b = blockIdx.x;
  const int tid = static_cast<int>(threadIdx.x);
  T* region = ws + b * block_data_stride<F>();
  stage_data<F, T>(dat, region, b, 1, tid, blockDim.x);
  __syncthreads();
  const BlockFactor<T> bf{tid, static_cast<int>(blockDim.x), smem + L::kKD,
                          smem + L::kFlag};
  const Team<T> tm{tid & 31, 0xffffffffu, smem + L::kSlot};
  phase_block<F, T, PHASE>(tm, bf, region, smem, prm, reps, perturb, acc,
                           sink, b);
}
#endif

// Entry point, with the C signature of fused_phases.cuh:phase_entry and
// the block's warps and the workspace (B x block_data_stride<F>() values
// of the working type on the data's device) before the stream.  With nvcc
// it enqueues one launch on `stream` and returns its cudaError
// (cudaErrorInvalidValue for a W other than 2, 4 or 8 or a block over the
// shared-memory cap; the limit raised above 48 KB at every launch, see
// allow_shared); without it, it runs each instance's prefix and returns 0
// (1 for a refused W).
template <typename F, typename T, int PHASE>
int phase_block_entry(const T* const* data9, T* acc, T* sink, long long B,
                      const T* params6, int reps, int perturb, int warps,
                      T* ws, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  if (!block_warps_ok(warps)) {
#ifdef __CUDACC__
    return static_cast<int>(cudaErrorInvalidValue);
#else
    return 1;
#endif
  }
#ifdef __CUDACC__
  const int bytes = block_bytes<F, T>();
  if (bytes > kTeamSharedCap) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const int err = allow_shared(phase_block_kernel<F, T, PHASE>);
    if (err) return err;
  }
  phase_block_kernel<F, T, PHASE>
      <<<static_cast<unsigned>(B), warps * 32, bytes,
         static_cast<cudaStream_t>(stream)>>>(dat, prm, acc, sink, reps,
                                              perturb, ws);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  using L = BlockLayout<F>;
  std::vector<T> smem(L::kValues);
  for (long long b = 0; b < B; ++b) {
    T* region = ws + b * block_data_stride<F>();
    stage_data<F, T>(dat, region, b, 1, 0, 1);
#ifdef IPMZOO_TEAM_HOST_THREADS
    const int threads = warps * 32;
    std::barrier<> team_bar(kLanes), block_bar(threads);
    TeamHost host{&team_bar, {}};
    std::vector<std::thread> lanes;
    for (int l = 0; l < threads; ++l) {
      lanes.emplace_back([&, l] {
        const BlockFactor<T> bf{l, threads, smem.data() + L::kKD,
                                smem.data() + L::kFlag, &block_bar};
        const Team<T> tm{l & 31, 0u, smem.data() + L::kSlot, &host};
        phase_block<F, T, PHASE>(tm, bf, region, smem.data(), prm, reps,
                                 perturb, acc, sink, b);
      });
    }
    for (auto& t : lanes) t.join();
#else
    const BlockFactor<T> bf{0, 1, smem.data() + L::kKD,
                            smem.data() + L::kFlag};
    const Team<T> tm{0, 1u, smem.data() + L::kSlot};
    phase_block<F, T, PHASE>(tm, bf, region, smem.data(), prm, reps, perturb,
                             acc, sink, b);
#endif
  }
  return 0;
#endif
}

// What the prefix's block build is at W = `warps`, as
// fused_wide_block.cuh:fused_block_shape says of K1's: out5 = (lanes of
// the team, threads a block, values of workspace an instance, bytes of
// shared memory a block, blocks of this prefix's kernel resident per SM;
// the last 0 in a host build and where the block does not fit).
template <typename F, int PHASE>
int phase_block_shape(int itemsize, int warps, int* out5) {
  const bool f64 = itemsize == 8;
  out5[0] = kLanes;
  out5[1] = warps * 32;
  out5[2] = block_data_stride<F>();
  out5[3] = f64 ? block_bytes<F, double>() : block_bytes<F, float>();
  out5[4] = 0;
#ifdef __CUDACC__
  if (!block_warps_ok(warps)) return static_cast<int>(cudaErrorInvalidValue);
  if (out5[3] > kTeamSharedCap) return 0;
  const auto occupancy = [&](auto kernel) {
    const int e = allow_shared(kernel);
    if (e) return e;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out5 + 4, kernel, warps * 32, out5[3]));
  };
  return f64 ? occupancy(phase_block_kernel<F, double, PHASE>)
             : occupancy(phase_block_kernel<F, float, PHASE>);
#else
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_PHASE_BLOCK_ENTRY_POINTS(F, PHASE)                            \
  extern "C" int ipmzoo_phase_block_f32(                                     \
      const float* const* data9, float* acc, float* sink, long long B,       \
      const float* params6, int reps, int perturb, int warps, float* ws,     \
      void* stream) {                                                        \
    return ipmzoo_fused::phase_block_entry<F, float, PHASE>(                 \
        data9, acc, sink, B, params6, reps, perturb, warps, ws, stream);     \
  }                                                                          \
  extern "C" int ipmzoo_phase_block_f64(                                     \
      const double* const* data9, double* acc, double* sink, long long B,    \
      const double* params6, int reps, int perturb, int warps, double* ws,   \
      void* stream) {                                                        \
    return ipmzoo_fused::phase_block_entry<F, double, PHASE>(                \
        data9, acc, sink, B, params6, reps, perturb, warps, ws, stream);     \
  }                                                                          \
  extern "C" int ipmzoo_phase_block_shape(int itemsize, int warps,           \
                                          int* out5) {                       \
    return ipmzoo_fused::phase_block_shape<F, PHASE>(itemsize, warps, out5); \
  }
