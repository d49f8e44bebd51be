// K1, block route: the fused whole-solve interior-point kernel for Hopper
// (sm_90a) above augmented order 128, one thread block an instance, with
// the packed KKT factor and the work vectors in shared memory.
//
// Replaces, beside the thread, team and wide routes, the TPU kernel
// ipmzoo_tpu/models/fused.py:_fused_kernel (FusedBatchedIPM.solve_fused).
// Its plain version is ipmzoo_tpu_torch/models/fused.py:
// FusedBatchedIPM._fused_plain.  ops/cuda_fused.py:k1_route takes this
// route above order 128 where K1_BLOCK_RULE's measured rows say so, else
// the wide route (fused_wide.cuh).
//
// This file is not compiled alone: models/fused_source.py:
// fused_wide_block_source prints fused_ipm.cuh, fused_team.cuh at 32
// lanes, this file, the same generated `struct Form` as the team and
// wide routes (models/codegen_team.py:CppTeam) and the entry points
// (IPMZOO_FUSED_BLOCK_ENTRY_POINTS).
//
// What bound the wide route.  One warp an instance, the whole TeamLayout
// region in a device-memory workspace.  Its factor, team_ldlt, reads about
// aug^3 / 3 values of the packed factor an iteration; with ~8 warps on an
// SM the SM's factors overflow its L1, and the batch's regions (134 MB at
// aug 129, B=1024) the 50 MB L2, so the factor streams from device
// memory: ~41 GB for a cold 14-iteration launch at aug 129, B=1024.
//
// Design.  A block of W warps (W = 2, 4 or 8, a launch argument) runs one
// instance:
// * the packed factor K, D, b, the seven work vectors and the team slots
//   live in the block's dynamic shared memory (BlockLayout); the staged
//   data (Q, c, the A blocks, the bounds) stays in the device-memory
//   workspace, TeamLayout's data part, staged once by all W x 32 threads
//   and read-only after that.  One instance a block: the eight instances
//   of a 32-byte sector of an SoA field are staged by eight neighbouring
//   blocks, through L2;
// * warp 0 runs everything but the factor through the present team code
//   at 32 lanes (fused_team.cuh:solve_team, with K, D and b now in shared
//   memory); the other warps wait at a block barrier;
// * the LDL^T runs on all W x 32 threads (block_ldlt): column j's rows
//   below the pivot spread over the block, row j + 1 + t on thread t; the
//   products K[j,k] D[k] of each column computed once into shared memory
//   (two buffers: column j + 1's are computed while column j factors, its
//   last one by the thread that finishes K[j+1,j]); one block barrier a
//   column.  Every element keeps team_ldlt's arithmetic and order: the
//   pivot sum and each row's dot over k ascending, the same products, the
//   same pivot-floor rule.  So the route computes the wide route's x,
//   iterations, residual, gap and mu bit for bit: built with each
//   generated function compiled apart (chip_smoke.py: APART), it gives
//   the wide route's bits so built, and at one lane and emulated on the
//   host the builds agree as they are.  The builds as launched part in
//   the last bits where nvcc contracts a multiply-add in one kernel and
//   not in the other.
//
// What bounds it.  The column loop's dependent chain: the pivot and each
// row's dot are j dependent multiply-adds at column j, about aug^2 / 2
// steps a factor, plus one barrier a column; and warp 0's share (the
// generated functions, three to five solves an iteration) on one warp an
// instance.  A trailing update that reorders the sums (tensor cores, or
// register tiles) is later work: it changes the bits.
//
// Arithmetic is plain IEEE (no fast-math).  Without __CUDACC__ the entry
// loops over the instances with the staged data in the workspace the
// caller passes and the shared region in a host buffer: one thread an
// instance, or with IPMZOO_TEAM_EMULATE W x 32 host threads, the first 32
// the team, so the host build runs the block barriers and the row split.

namespace ipmzoo_fused {

static_assert(kLanes == 1 || kLanes == 32,
              "the block route's team is one warp (1 lane in the host "
              "build)");

// The most threads a block of the block route: 8 warps.  The kernel is
// built for it, so any W of 2, 4 or 8 launches the same build.
constexpr int kBlockMaxThreads = 256;

// Offsets, in values of the working type, of what a block keeps in
// shared memory: the work vectors, the packed factor, D, b, two buffers
// of a column's products K[j,k] D[k], the team slots and the flag that
// tells the helper warps to leave.
template <typename F>
struct BlockLayout {
  static constexpr int kV = 0;
  static constexpr int kR = kV + F::kTotal;
  static constexpr int kDaff = kR + F::kTotal;
  static constexpr int kD = kDaff + F::kTotal;
  static constexpr int kTrial = kD + F::kTotal;
  static constexpr int kDm = kTrial + F::kTotal;
  static constexpr int kDnew = kDm + F::kTotal;
  static constexpr int kK = kDnew + F::kTotal;
  static constexpr int kDiag = kK + F::kTri;
  static constexpr int kB = kDiag + F::kAug;
  static constexpr int kKD = kB + F::kAug;
  static constexpr int kSlot = kKD + 2 * F::kAug;
  static constexpr int kFlag = kSlot + F::kSlots;
  static constexpr int kValues = kFlag + 1;
};

// Values of workspace an instance: TeamLayout's data part (the staged
// data ends where its work vectors begin), padded to 32 values.
template <typename F>
IPM_FN constexpr int block_data_stride() {
  return (TeamLayout<F>::kV + 31) / 32 * 32;
}

// Bytes of dynamic shared memory a block of the block route takes.
template <typename F, typename T>
constexpr int block_bytes() {
  return static_cast<int>(sizeof(T)) * BlockLayout<F>::kValues;
}

template <typename F, typename T>
IPM_FN Work<T> block_work(T* smem) {
  using L = BlockLayout<F>;
  return {smem + L::kV,    smem + L::kR,     smem + L::kDaff,
          smem + L::kD,    smem + L::kTrial, smem + L::kDm,
          smem + L::kDnew, smem + L::kK,     smem + L::kDiag,
          smem + L::kB};
}

// The block's threads around one instance's factor: this thread, the
// block's threads, the two product buffers (2 x order values) and the
// flag in shared memory.
template <typename T>
struct BlockFactor {
  int tid, threads;
  T* kd;
  T* flag;
#ifdef IPMZOO_TEAM_HOST_THREADS
  std::barrier<>* bar;
#endif

  IPM_FN void sync() const {
#if defined(__CUDA_ARCH__)
    __syncthreads();
#elif defined(IPMZOO_TEAM_HOST_THREADS)
    bar->arrive_and_wait();
#endif
  }

  // Warp 0, from the team's step: call the other warps in, then factor.
  template <int N>
  IPM_FN void run(const Team<T>& tm, T* K, T* D, T pivot_floor) const;

  // The other warps: join each factor until warp 0 says it is done.
  template <int N>
  IPM_FN void help(T* K, T* D, T pivot_floor) const;

  // Warp 0, after its solve: let the other warps leave.
  IPM_FN void finish(const Team<T>& tm) const {
    if (tm.lane == 0) *flag = T(1);
    sync();
  }
};

// In-place LDL^T of the packed lower triangle K (N x N) in shared memory
// on all the block's threads, team_ldlt's arithmetic element for element:
// column j's pivot alike on every thread that needs it, its rows below
// spread over the threads, the products K[j,k] D[k] read from the buffer
// that column j - 1 filled; column j + 1's buffer filled meanwhile.  Only
// an exactly-zero pivot is replaced by pivot_floor.  One barrier a
// column, the last one after column N - 1.
template <typename T, int N>
IPM_FN void block_ldlt(const BlockFactor<T>& bf, T* K, T* D,
                       T pivot_floor) {
  const int tid = bf.tid, nt = bf.threads;
  for (int j = 0; j < N; ++j) {
    const T* kd = bf.kd + (j & 1) * N;
    T* next = bf.kd + ((j + 1) & 1) * N;
    if (j + 1 < N) {
      // K[j+1,k] for k < j and D[k] are final
      const T* row = K + tri(j + 1, 0);
      for (int k = tid; k < j; k += nt) next[k] = row[k] * D[k];
    }
    const int i0 = j + 1 + tid;
    if (i0 < N || tid == 0) {
      const T* Kj = K + tri(j, 0);
      T s = T(0), t = T(0);
      if (i0 < N) {   // the pivot's sum beside the first row's dot
        const T* Ki = K + tri(i0, 0);
        for (int k = 0; k < j; ++k) {
          const T c = kd[k];
          s += Kj[k] * c;
          t += Ki[k] * c;
        }
      } else {
        for (int k = 0; k < j; ++k) s += Kj[k] * kd[k];
      }
      T d = Kj[j] - s;
      if (d == T(0)) d = pivot_floor;
      for (int i = i0; i < N; i += nt) {
        T* Ki = K + tri(i, 0);
        if (i > i0) {
          t = T(0);
          for (int k = 0; k < j; ++k) t += Ki[k] * kd[k];
        }
        Ki[j] = (Ki[j] - t) / d;
      }
      if (tid == 0) {   // row j + 1 is thread 0's
        D[j] = d;
        if (j + 1 < N) next[j] = K[tri(j + 1, j)] * d;
      }
    }
    bf.sync();
  }
}

template <typename T>
template <int N>
IPM_FN void BlockFactor<T>::run(const Team<T>& tm, T* K, T* D,
                                T pivot_floor) const {
  if (tm.lane == 0) *flag = T(0);
  sync();
  block_ldlt<T, N>(*this, K, D, pivot_floor);
}

template <typename T>
template <int N>
IPM_FN void BlockFactor<T>::help(T* K, T* D, T pivot_floor) const {
  for (;;) {
    sync();
    if (*flag != T(0)) return;
    block_ldlt<T, N>(*this, K, D, pivot_floor);
  }
}

// Instance b's whole solve by the thread `bf.tid` of its block: the data
// staged in `region`, the shared arrays at `smem`.
template <typename F, typename T>
IPM_FN void solve_block(const Team<T>& tm, const BlockFactor<T>& bf,
                        T* region, T* smem, const Params<T>& prm,
                        const T* v0, const T* mu0, const T* it0,
                        const Out<T>& out, int64_t S, int64_t b,
                        int max_iter, int warm, int gondzio) {
  const Work<T> w = block_work<F, T>(smem);
  if (bf.tid < 32) {
    solve_team<F, T>(tm, staged<F, T>(region), w, bf, prm, v0, mu0, it0,
                     out, S, b, max_iter, warm, gondzio);
    bf.finish(tm);
  } else {
    bf.template help<F::kAug>(w.K, w.D, prm.pivot_floor);
  }
}

#ifdef __CUDACC__
template <typename F, typename T>
__global__ void __launch_bounds__(kBlockMaxThreads)
fused_wide_block_kernel(Data<T> dat, Params<T> prm, const T* v0,
                        const T* mu0, const T* it0, Out<T> out, int max_iter,
                        int warm, int gondzio, T* work) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  using L = BlockLayout<F>;
  T* smem = reinterpret_cast<T*>(block_smem);
  const int64_t b = blockIdx.x;
  const int tid = static_cast<int>(threadIdx.x);
  T* region = work + b * block_data_stride<F>();
  stage_data<F, T>(dat, region, b, 1, tid, blockDim.x);
  __syncthreads();
  const BlockFactor<T> bf{tid, static_cast<int>(blockDim.x), smem + L::kKD,
                          smem + L::kFlag};
  const Team<T> tm{tid & 31, 0xffffffffu, smem + L::kSlot};
  solve_block<F, T>(tm, bf, region, smem, prm, v0, mu0, it0, out, dat.S, b,
                    max_iter, warm, gondzio);
}
#endif

// Whether W = `warps` is a block the route takes.
constexpr bool block_warps_ok(int warps) {
  return warps == 2 || warps == 4 || warps == 8;
}

// Entry point, with the C signature of fused_wide.cuh:fused_wide_entry
// and the block's warps before the workspace: B x block_data_stride<F>()
// values of the working type on the data's device.  With nvcc it enqueues
// one launch of the block kernel on `stream` and returns its cudaError
// (cudaErrorInvalidValue for a W other than 2, 4, 8 or a block over the
// shared-memory cap); without it, it runs each instance's solve.
template <typename F, typename T>
int fused_block_entry(const T* const* data9, const T* v0, const T* mu0,
                      const T* it0, T* const* out6, long long B,
                      const T* params6, int max_iter, int warm, int gondzio,
                      int warps, T* work, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  const Out<T> out{out6[0], out6[1], out6[2], out6[3], out6[4], out6[5]};
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
    const int err = allow_shared(fused_wide_block_kernel<F, T>);
    if (err) return err;
  }
  fused_wide_block_kernel<F, T>
      <<<static_cast<unsigned>(B), warps * 32, bytes,
         static_cast<cudaStream_t>(stream)>>>(dat, prm, v0, mu0, it0, out,
                                              max_iter, warm, gondzio, work);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  using L = BlockLayout<F>;
  std::vector<T> smem(L::kValues);
  for (long long b = 0; b < B; ++b) {
    T* region = work + b * block_data_stride<F>();
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
        solve_block<F, T>(tm, bf, region, smem.data(), prm, v0, mu0, it0,
                          out, B, b, max_iter, warm, gondzio);
      });
    }
    for (auto& t : lanes) t.join();
#else
    const BlockFactor<T> bf{0, 1, smem.data() + L::kKD,
                            smem.data() + L::kFlag};
    const Team<T> tm{0, 1u, smem.data() + L::kSlot};
    solve_block<F, T>(tm, bf, region, smem.data(), prm, v0, mu0, it0, out,
                      B, b, max_iter, warm, gondzio);
#endif
  }
  return 0;
#endif
}

// What the block build is at W = `warps`: out5 = (lanes of the team,
// threads a block, values of workspace an instance, bytes of shared
// memory a block, blocks resident per SM; the last 0 in a host build) for
// the working type of `itemsize` bytes.
template <typename F>
int fused_block_shape(int itemsize, int warps, int* out5) {
  const bool f64 = itemsize == 8;
  out5[0] = kLanes;
  out5[1] = warps * 32;
  out5[2] = block_data_stride<F>();
  out5[3] = f64 ? block_bytes<F, double>() : block_bytes<F, float>();
  out5[4] = 0;
#ifdef __CUDACC__
  if (!block_warps_ok(warps)) return static_cast<int>(cudaErrorInvalidValue);
  if (out5[3] > kTeamSharedCap) return 0;   // does not fit: 0 blocks
  int blocks = 0;
  cudaError_t err;
  if (f64) {
    const int e = allow_shared(fused_wide_block_kernel<F, double>);
    if (e) return e;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_wide_block_kernel<F, double>, warps * 32, out5[3]);
  } else {
    const int e = allow_shared(fused_wide_block_kernel<F, float>);
    if (e) return e;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fused_wide_block_kernel<F, float>, warps * 32, out5[3]);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out5[4] = blocks;
#endif
  return 0;
}

}  // namespace ipmzoo_fused

#define IPMZOO_FUSED_BLOCK_ENTRY_POINTS(F)                                   \
  extern "C" int ipmzoo_fused_block_f32(                                     \
      const float* const* data9, const float* v0, const float* mu0,          \
      const float* it0, float* const* out6, long long B,                     \
      const float* params6, int max_iter, int warm, int gondzio, int warps,  \
      float* work, void* stream) {                                           \
    return ipmzoo_fused::fused_block_entry<F, float>(                        \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        warps, work, stream);                                                \
  }                                                                          \
  extern "C" int ipmzoo_fused_block_f64(                                     \
      const double* const* data9, const double* v0, const double* mu0,       \
      const double* it0, double* const* out6, long long B,                   \
      const double* params6, int max_iter, int warm, int gondzio, int warps, \
      double* work, void* stream) {                                          \
    return ipmzoo_fused::fused_block_entry<F, double>(                       \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        warps, work, stream);                                                \
  }                                                                          \
  extern "C" int ipmzoo_fused_block_shape(int itemsize, int warps,           \
                                          int* out5) {                       \
    return ipmzoo_fused::fused_block_shape<F>(itemsize, warps, out5);        \
  }
