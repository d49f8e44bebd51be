// K1, wide route: the fused whole-solve interior-point kernel for Hopper
// (sm_90a) at augmented orders where neither the thread route nor the team
// route fits, one warp per QP instance with its state in device memory.
//
// Replaces, beside the thread route (fused_ipm.cuh) and the team route
// (fused_team.cuh), the TPU kernel ipmzoo_tpu/models/fused.py:
// _fused_kernel (FusedBatchedIPM.solve_fused), which has no limit on the
// order.  Its plain version is ipmzoo_tpu_torch/models/fused.py:
// FusedBatchedIPM._fused_plain.  ops/cuda_fused.py:k1_route picks this
// route where four teams overflow a block's shared memory, the augmented
// order is above 128 and the block route (fused_wide_block.cuh) does not
// take the launch (K1_BLOCK_RULE, or its block over the shared memory).
//
// This file is not compiled alone: models/fused_source.py:
// fused_wide_source prints fused_ipm.cuh, fused_team.cuh at 32 lanes,
// this file, the team route's generated `struct Form`
// (models/codegen_team.py:CppTeam) and the entry points
// (IPMZOO_FUSED_WIDE_ENTRY_POINTS); chip_smoke.py's check build compiles
// each generated function apart (its APART says why).
//
// Why a third route.  Above order 128 the thread route's per-thread
// arrays (the packed factor alone is aug (aug + 1) / 2 values) no longer
// fit a thread's local memory, and one team's TeamLayout region (the
// staged data, the iterate, the work vectors and the packed factor: about
// 33K values at n=100, m_ineq=40, aug 140) takes 131 KB in float32 and
// 263 KB in float64, so four teams do not fit a block's 227 KB.
//
// Design.  The team code of fused_team.cuh runs unchanged at kLanes = 32,
// one warp an instance, one warp a block:
// * the instance's TeamLayout region lives in a device-memory workspace,
//   TeamLayout<F>::kStride values an instance, that the wrapper allocates
//   on the launch's device and stream (ops/cuda_fused.py:call); the
//   warp stages its instance's data there once, as the team route stages
//   into shared memory;
// * the team slots (the generated code's vectors read across lanes) stay
//   in the block's shared memory;
// * lanes exchange values through the region exactly where the team route
//   exchanges them through shared memory: after a team barrier,
//   __syncwarp(0xffffffff), which orders the participating lanes'
//   accesses to device memory as it orders shared memory.  Every
//   read-after-write across lanes of the team code is behind such a
//   barrier: each generated function starts and ends with one, the factor
//   has one a column, the solve one after its writes, the ratio tests and
//   the update one before;
// * the solve's sweeps go a warp's width of columns at a time above order
//   128 (fused_team.cuh:team_ldlt_solve), in the same order of operations.
//
// What bounds it.  An iteration factors the packed order-aug matrix
// (aug^3 / 6 multiply-adds, one lane a row, the rows read from the region
// through L1 and L2) and solves it two to four times: latency of the
// column loop and the L1 / L2 traffic of the factor, not the card's
// arithmetic rate.  Tensor cores, TMA and a blocked in-kernel factor are
// later work.
//
// Arithmetic is plain IEEE (no fast-math).  Without __CUDACC__ the entry
// loops over the instances with the region in the workspace the caller
// passes (a host buffer): one lane, or 32 host threads a team with
// IPMZOO_TEAM_EMULATE, as the team route's host builds.

namespace ipmzoo_fused {

static_assert(kLanes == 1 || kLanes == 32,
              "the wide route is one warp an instance (1 lane in the host "
              "build)");

// Threads a block of the wide kernel: one warp, one instance.
constexpr int kWideThreads = 32;

// Values of shared memory a block keeps for its team slots.
template <typename F>
constexpr int wide_slot_values() {
  return F::kSlots > 0 ? F::kSlots : 1;
}

// Bytes of dynamic shared memory a block of the wide kernel takes.
template <typename F, typename T>
constexpr int wide_block_bytes() {
  return static_cast<int>(sizeof(T)) * wide_slot_values<F>();
}

#ifdef __CUDACC__
template <typename F, typename T>
__global__ void __launch_bounds__(kWideThreads)
fused_wide_kernel(Data<T> dat, Params<T> prm, const T* v0, const T* mu0,
                  const T* it0, Out<T> out, int max_iter, int warm,
                  int gondzio, T* work) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  using L = TeamLayout<F>;
  const int64_t b = blockIdx.x;
  T* region = work + b * L::kStride;
  stage_data<F, T>(dat, region, b, 1, threadIdx.x, kWideThreads);
  __syncwarp();
  const Team<T> tm{static_cast<int>(threadIdx.x), 0xffffffffu,
                   reinterpret_cast<T*>(wide_smem)};
  solve_team<F, T>(tm, region, prm, v0, mu0, it0, out, dat.S, b, max_iter,
                   warm, gondzio);
}
#endif

// Entry point, with the C signature of fused_ipm.cuh:fused_entry and the
// workspace last but one: B x TeamLayout<F>::kStride values of the
// working type on the data's device.  With nvcc it enqueues one launch of
// the wide kernel on `stream` and returns its cudaError; without it, it
// runs each instance's solve with its region in the workspace.
template <typename F, typename T>
int fused_wide_entry(const T* const* data9, const T* v0, const T* mu0,
                     const T* it0, T* const* out6, long long B,
                     const T* params6, int max_iter, int warm, int gondzio,
                     T* work, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  const Out<T> out{out6[0], out6[1], out6[2], out6[3], out6[4], out6[5]};
  using L = TeamLayout<F>;
#ifdef __CUDACC__
  const int bytes = wide_block_bytes<F, T>();
  if (bytes > kTeamSharedCap) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const int err = allow_shared(fused_wide_kernel<F, T>);
    if (err) return err;
  }
  fused_wide_kernel<F, T><<<static_cast<unsigned>(B), kWideThreads, bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      dat, prm, v0, mu0, it0, out, max_iter, warm, gondzio, work);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  std::vector<T> slot(wide_slot_values<F>());
  for (long long b = 0; b < B; ++b) {
    T* region = work + b * L::kStride;
    stage_data<F, T>(dat, region, b, 1, 0, 1);
#ifdef IPMZOO_TEAM_HOST_THREADS
    std::barrier<> bar(kLanes);
    TeamHost host{&bar, {}};
    std::vector<std::thread> lanes;
    for (int l = 0; l < kLanes; ++l) {
      lanes.emplace_back([&, l] {
        const Team<T> tm{l, 0u, slot.data(), &host};
        solve_team<F, T>(tm, region, prm, v0, mu0, it0, out, B, b, max_iter,
                         warm, gondzio);
      });
    }
    for (auto& t : lanes) t.join();
#else
    const Team<T> tm{0, 1u, slot.data()};
    solve_team<F, T>(tm, region, prm, v0, mu0, it0, out, B, b, max_iter,
                     warm, gondzio);
#endif
  }
  return 0;
#endif
}

// What the wide build is: out4 = (lanes an instance, threads a block,
// values of workspace an instance, blocks resident per SM; the last 0 in
// a host build) for the working type of `itemsize` bytes.
template <typename F>
int fused_wide_shape(int itemsize, int* out4) {
  out4[0] = kLanes;
  out4[1] = kWideThreads;
  out4[2] = TeamLayout<F>::kStride;
  out4[3] = 0;
#ifdef __CUDACC__
  int blocks = 0;
  cudaError_t err;
  if (itemsize == 8) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_wide_kernel<F, double>, kWideThreads,
        wide_block_bytes<F, double>());
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_wide_kernel<F, float>, kWideThreads,
        wide_block_bytes<F, float>());
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out4[3] = blocks;
#else
  (void)itemsize;
#endif
  return 0;
}

}  // namespace ipmzoo_fused

#define IPMZOO_FUSED_WIDE_ENTRY_POINTS(F)                                    \
  extern "C" int ipmzoo_fused_wide_f32(                                      \
      const float* const* data9, const float* v0, const float* mu0,          \
      const float* it0, float* const* out6, long long B,                     \
      const float* params6, int max_iter, int warm, int gondzio,             \
      float* work, void* stream) {                                           \
    return ipmzoo_fused::fused_wide_entry<F, float>(                         \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        work, stream);                                                       \
  }                                                                          \
  extern "C" int ipmzoo_fused_wide_f64(                                      \
      const double* const* data9, const double* v0, const double* mu0,       \
      const double* it0, double* const* out6, long long B,                   \
      const double* params6, int max_iter, int warm, int gondzio,            \
      double* work, void* stream) {                                          \
    return ipmzoo_fused::fused_wide_entry<F, double>(                        \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        work, stream);                                                       \
  }                                                                          \
  extern "C" int ipmzoo_fused_wide_shape(int itemsize, int* out4) {          \
    return ipmzoo_fused::fused_wide_shape<F>(itemsize, out4);                \
  }
