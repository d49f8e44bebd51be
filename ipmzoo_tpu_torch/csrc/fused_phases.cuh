// T3: prefixes of one fused interior-point iteration, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/fused_phases.py:phase_kernel.  Its plain
// version is ipmzoo_tpu_torch/models/fused_phases.py:phase_plain.
//
// Like K1 this file is not compiled alone:
// ipmzoo_tpu_torch/models/fused_phases.py prints csrc/fused_ipm.cuh, this
// text, the same generated `struct Form` as K1's and one line that
// instantiates the entry points for one PHASE
// (IPMZOO_PHASE_ENTRY_POINTS).  Each prefix is a translation unit of its
// own, so ptxas reports its registers, stack frame and spills apart from
// the others: which phase of K1 takes the registers is the question the
// kernel exists to answer.
//
// Per instance, at the cold start of the fused solve (bound midpoints,
// ones, mu = mu0), with K1's one thread per instance, K1's block size and
// K1's per-thread local storage (the packed triangle K, D, the
// right-hand sides and deltas), PHASE selects how much of one iteration
// runs, each prefix through the functions K1 itself runs:
//
//   0  the start iterate only
//   1  + F::assemble               acc += sum of the symmetric K
//   2  + ldlt_packed               acc += D[0]
//   3  + F::residuals at mu = 0, direction, F::corrector, direction
//        (both at the start mu: no step length, no sigma)
//                                   acc += the corrector delta's first entry
//   4  + three F::metrics at mu = 0  acc += residual + gap, each
//
// What bounds it: as K1, the per-thread instruction stream and
// local-memory latency; the data is read once per repetition and stays in
// L2.  The time of a prefix is one launch's; the cost of a phase is the
// difference of two prefixes, which cancels the launch and the loads but
// compares two different register allocations, so it is an estimate.
//
// Two values leave each thread.  `acc` is what the TPU kernel writes.  It
// consumes only D[0] of the factorisation, which would let the compiler
// drop the rest of ldlt_packed at PHASE 2; on the TPU the writes to
// scratch memory keep that work.  `sink` therefore also sums everything a
// phase produces (the start iterate, K, all of D and L, every entry of
// the delta) and is held to the plain version.
//
// Repetitions and identical calls.  `reps` repeats the prefix inside the
// kernel on the iterate scaled by 1 + 1e-6 r (r = 0 is the iterate
// itself), for a slope over repetition counts.  The three metrics calls
// of PHASE 4 have identical inputs and a compiler merges them into one;
// call k therefore runs on the iterate scaled by 1 + 1e-6 k perturb with
// `perturb` a run-time argument: 0 gives the TPU kernel's value exactly,
// and the compiler cannot know it is 0, so the three calls stay.

namespace ipmzoo_fused {

template <typename F, typename T, int PHASE>
IPM_FN void phase_instance(const Data<T>& batch, const Params<T>& prm,
                           T* acc_out, T* sink_out, int64_t b, int reps,
                           int perturb) {
  Data<T> dat = batch;
  dat.Q = at_instance(batch.Q, b);
  dat.c = at_instance(batch.c, b);
  dat.A_ineq = at_instance(batch.A_ineq, b);
  dat.l_A_ineq = at_instance(batch.l_A_ineq, b);
  dat.u_A_ineq = at_instance(batch.u_A_ineq, b);
  dat.A_eq = at_instance(batch.A_eq, b);
  dat.b_eq = at_instance(batch.b_eq, b);
  dat.l_x = at_instance(batch.l_x, b);
  dat.u_x = at_instance(batch.u_x, b);

  T v0[F::kTotal];
  F::template init<T>(dat, v0);
  const T mu = prm.mu0;
  T acc = T(0), sink = T(0);
  for (int rep = 0; rep < reps; ++rep) {
    const T scale = T(1.0 + 1e-6 * rep);
    T v[F::kTotal];
    for (int i = 0; i < F::kTotal; ++i) v[i] = v0[i] * scale;
    if (PHASE == 0) {
      for (int i = 0; i < F::kTotal; ++i) sink += v[i];
    }
    T K[F::kTri];
    T D[F::kAug];
    if (PHASE >= 1) {
      F::template assemble<T>(dat, prm, v, mu, K);
      T s = T(0);
      for (int i = 0; i < F::kAug; ++i) {
        for (int j = 0; j < i; ++j) s += T(2) * K[tri(i, j)];
        s += K[tri(i, i)];
      }
      acc += s;
      sink += s;
    }
    if (PHASE >= 2) {
      ldlt_packed<T, F::kAug>(K, D, prm.pivot_floor);
      acc += D[0];
      T s = T(0);
      for (int i = 0; i < F::kAug; ++i) {
        for (int j = 0; j < i; ++j) s += K[tri(i, j)];
        s += D[i];
      }
      sink += s;
    }
    if (PHASE >= 3) {
      T r[F::kTotal];
      F::template residuals<T>(dat, prm, v, T(0), r);
      T d_aff[F::kTotal];
      direction<F, T>(dat, prm, v, T(0), r, K, D, d_aff);
      F::template corrector<T>(dat, prm, v, mu, mu, d_aff, r);
      T d[F::kTotal];
      direction<F, T>(dat, prm, v, mu, r, K, D, d);
      acc += d[0];
      T s = T(0);
      for (int i = 0; i < F::kTotal; ++i) s += d[i];
      sink += s;
    }
    if (PHASE >= 4) {
      for (int k = 0; k < 3; ++k) {
        const T nudge = T(1.0 + 1e-6 * (k * perturb));
        T vk[F::kTotal];
        for (int i = 0; i < F::kTotal; ++i) vk[i] = v[i] * nudge;
        T residual, gap;
        F::template metrics<T>(dat, prm, vk, residual, gap);
        acc += residual + gap;
        sink += residual + gap;
      }
    }
  }
  acc_out[b] = acc;
  sink_out[b] = sink;
}

#ifdef __CUDACC__
template <typename F, typename T, int PHASE>
__global__ void phase_kernel(Data<T> dat, Params<T> prm, T* acc, T* sink,
                             int reps, int perturb) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= dat.S) return;
  phase_instance<F, T, PHASE>(dat, prm, acc, sink, b, reps, perturb);
}
#endif

// Entry point: data9 and params6 as for fused_entry; acc and sink are
// (1, B) device arrays.  With nvcc it enqueues one launch on `stream`
// and returns cudaGetLastError(); without it (the host build of the
// tests) it loops over the instances and returns 0.
template <typename F, typename T, int PHASE>
int phase_entry(const T* const* data9, T* acc, T* sink, long long B,
                const T* params6, int reps, int perturb, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
#ifdef __CUDACC__
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  phase_kernel<F, T, PHASE>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          dat, prm, acc, sink, reps, perturb);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  for (long long b = 0; b < B; ++b)
    phase_instance<F, T, PHASE>(dat, prm, acc, sink, b, reps, perturb);
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_PHASE_ENTRY_POINTS(F, PHASE)                                   \
  extern "C" int ipmzoo_phase_f32(const float* const* data9, float* acc,      \
                                  float* sink, long long B,                   \
                                  const float* params6, int reps,             \
                                  int perturb, void* stream) {                \
    return ipmzoo_fused::phase_entry<F, float, PHASE>(                        \
        data9, acc, sink, B, params6, reps, perturb, stream);                 \
  }                                                                           \
  extern "C" int ipmzoo_phase_f64(const double* const* data9, double* acc,    \
                                  double* sink, long long B,                  \
                                  const double* params6, int reps,            \
                                  int perturb, void* stream) {                \
    return ipmzoo_fused::phase_entry<F, double, PHASE>(                       \
        data9, acc, sink, B, params6, reps, perturb, stream);                 \
  }
