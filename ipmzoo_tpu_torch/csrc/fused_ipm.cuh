// K1: the fused whole-solve interior-point kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel ipmzoo_tpu/models/fused.py:_fused_kernel
// (FusedBatchedIPM.solve_fused).  Its plain version is
// ipmzoo_tpu_torch/models/fused.py:FusedBatchedIPM._fused_plain.
//
// This file is the hand-written part of K1.  It is not compiled alone:
// ipmzoo_tpu_torch/models/fused_source.py prints, for one formulation
// and one set of sizes, a `struct Form` of generated functions (the
// symbolic derivation evaluated per instance: metrics, KKT cells,
// right-hand sides, the corrector remainder, back-substitution, Gondzio
// targets) and appends it to this text together with the entry points
// (IPMZOO_FUSED_ENTRY_POINTS).  Every size is a compile-time constant of
// Form; max_iter, warm and gondzio are run-time arguments, so one build
// serves every stage of a compaction schedule.
//
// What bounds it on this card.  Each instance reads its data once
// (n=16, m=8: 448 values) and then runs up to max_iter Mehrotra
// iterations on it, each one an aug_dim^3/6 factorisation plus a few
// dozen vector passes: a few thousand multiply-adds per iteration per
// instance, with no traffic to device memory beyond the data re-reads
// of the lazy matrices (which stay in L1/L2).  The kernel is bound by
// the per-thread instruction stream and by local-memory latency, not by
// HBM bandwidth.
//
// Design.  One thread per QP instance, where the TPU put one instance on
// each vector lane.  Data, warm state and outputs are SoA (..., B) with
// the batch fastest, so a warp's loads of one element for 32 neighbouring
// instances form one coalesced line.  The iterate, the deltas and the
// packed lower triangle of the augmented KKT matrix live in per-thread
// local arrays (CUDA interleaves local memory across a warp, so these
// accesses coalesce too); the data matrices are never copied per thread,
// the generated code reads Q and A from global memory where a lazy
// matrix entry needs them.  Each thread leaves its loop when its own
// instance is done or when it reaches max_iter.  That gives per-instance
// results identical to the tile-wide while loop of fused.py:486-513,
// because there a done lane is frozen: its iterate, mu, residual, gap
// and iteration count re-enter unchanged until the tile ends.
//
// Arithmetic is plain IEEE (no fast-math).  nvcc contracts a*b+c into
// FMAs, so float32 iterates can part from the plain version's on a few
// instances; float64 agrees to rounding.  Shared-memory staging, warp
// cooperation and tensor cores are not used yet.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
#define __host__
#define __device__
#endif

#define IPM_FN __host__ __device__ inline

namespace ipmzoo_fused {

// Device pointers to the nine data arrays of a batch, SoA with the batch
// fastest: Q (n, n, S), c (n, S), A_ineq (m, n, S), l_A_ineq / u_A_ineq
// (m, S), A_eq (e, n, S), b_eq (e, S), l_x / u_x (n, S).  An array with
// a zero dimension is null.  Inside solve_instance every pointer is
// offset to the thread's instance, so entry (i, j) of Q is
// Q[(i * n + j) * S].
template <typename T>
struct Data {
  const T *Q, *c, *A_ineq, *l_A_ineq, *u_A_ineq, *A_eq, *b_eq, *l_x, *u_x;
  int64_t S;
};

// Scalar settings of the solver, in the working type.
template <typename T>
struct Params {
  T tol, mu0, delta0, pivot_floor, mu_floor, fraction_to_boundary;
};

// Outputs, SoA: x (n, S), vars (total, S), iterations / residual / gap /
// mu (1, S).
template <typename T>
struct Out {
  T *x, *vars, *iterations, *residual, *gap, *mu;
};

IPM_FN float ipm_sqrt(float x) { return sqrtf(x); }
IPM_FN double ipm_sqrt(double x) { return sqrt(x); }
IPM_FN float ipm_log(float x) { return logf(x); }
IPM_FN double ipm_log(double x) { return log(x); }
IPM_FN float ipm_abs(float x) { return fabsf(x); }
IPM_FN double ipm_abs(double x) { return fabs(x); }

// jnp.minimum / jnp.maximum: a NaN operand gives NaN.
template <typename T>
IPM_FN T ipm_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}
template <typename T>
IPM_FN T ipm_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// 1/x with 0 mapped to sqrt(float32 max) in every working type, the SoA
// evaluator's safe reciprocal.
template <typename T>
IPM_FN T ipm_recip(T x) {
  return x == T(0) ? T(1.8446742974197924e+19) : T(1) / x;
}

// Packed lower triangle: entry (i, j), j <= i.
IPM_FN int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// In-place LDL^T of the packed lower triangle K (N x N): L overwrites K
// strictly below the diagonal, D goes to D.  The column algorithm of
// fused.py:_ldlt_into_refs; only an exactly-zero pivot is replaced by
// pivot_floor.
template <typename T, int N>
IPM_FN void ldlt_packed(T* K, T* D, T pivot_floor) {
  T w[N];
  for (int j = 0; j < N; ++j) {
    T s = T(0);
    for (int k = 0; k < j; ++k) {
      w[k] = K[tri(j, k)] * D[k];
      s += K[tri(j, k)] * w[k];
    }
    T d = K[tri(j, j)] - s;
    if (d == T(0)) d = pivot_floor;
    D[j] = d;
    for (int i = j + 1; i < N; ++i) {
      T t = T(0);
      for (int k = 0; k < j; ++k) t += K[tri(i, k)] * w[k];
      K[tri(i, j)] = (K[tri(i, j)] - t) / d;
    }
  }
}

// Solve L D L^T x = b in place against ldlt_packed's factors
// (fused.py:_solve_from_refs).
template <typename T, int N>
IPM_FN void ldlt_solve_packed(const T* K, const T* D, T* x) {
  for (int i = 1; i < N; ++i) {
    T s = x[i];
    for (int k = 0; k < i; ++k) s -= K[tri(i, k)] * x[k];
    x[i] = s;
  }
  for (int i = 0; i < N; ++i) x[i] = x[i] / D[i];
  for (int i = N - 2; i >= 0; --i) {
    T s = T(0);
    for (int k = i + 1; k < N; ++k) s += K[tri(k, i)] * x[k];
    x[i] = x[i] - s;
  }
}

// One search direction against the factored system: the generated
// augmented right-hand side, the solve, the generated back-substitution
// of the eliminated variables (fused.py:_search_direction_soa).
template <typename F, typename T>
IPM_FN void direction(const Data<T>& dat, const Params<T>& prm, const T* v,
                      T mu_r, const T* r, const T* K, const T* D,
                      T* delta) {
  T b[F::kAug];
  F::template aug_rhs<T>(dat, prm, v, mu_r, r, b);
  ldlt_solve_packed<T, F::kAug>(K, D, b);
  F::template back_substitute<T>(dat, prm, v, mu_r, r, b, delta);
}

// alpha = min(alpha, (bound - v) / d) over the entries moving toward a
// bound; a null bound pointer means no bound.
template <typename T>
IPM_FN T box_ratio(T alpha, const T* v, const T* d, int size, const T* lb,
                   const T* ub, int64_t S) {
  for (int i = 0; i < size; ++i) {
    if (lb != nullptr && d[i] < T(0))
      alpha = ipm_min(alpha, (lb[i * S] - v[i]) / d[i]);
    if (ub != nullptr && d[i] > T(0))
      alpha = ipm_min(alpha, (ub[i * S] - v[i]) / d[i]);
  }
  return alpha;
}

// Fraction-to-boundary step: the largest alpha <= 1 keeping the
// nonnegative variables, and with box_test the explicit boxes, feasible
// (fused.py:_max_step_soa).
template <typename F, typename T>
IPM_FN T max_step(const Data<T>& dat, const T* v, const T* d) {
  T alpha = T(1);
  for (int g = 0; g < F::kNonnegGroups; ++g) {
    const int off = F::nonneg_offset(g), size = F::nonneg_size(g);
    for (int i = 0; i < size; ++i) {
      if (d[off + i] < T(0)) alpha = ipm_min(alpha, -v[off + i] / d[off + i]);
    }
  }
  if (F::kBoxTest) {
    alpha = box_ratio(alpha, v + F::kX, d + F::kX, F::kN,
                      F::kXLower ? dat.l_x : nullptr,
                      F::kXUpper ? dat.u_x : nullptr, dat.S);
    if (F::kS >= 0) {
      alpha = box_ratio(alpha, v + F::kS, d + F::kS, F::kM,
                        F::kSLower ? dat.l_A_ineq : nullptr,
                        F::kSUpper ? dat.u_A_ineq : nullptr, dat.S);
    }
  }
  return alpha;
}

// One Gondzio centrality-corrector round (fused.py:_gondzio_round_soa):
// complementarity products at an enlarged trial step are pulled back
// into [0.1, 10] mu_target by one more solve with the same factors; the
// corrected direction is kept only if it lengthens the step.
template <typename F, typename T>
IPM_FN void gondzio_round(const Data<T>& dat, const Params<T>& prm,
                          const T* v, T mu, T mu_target, const T* K,
                          const T* D, T* d, T& alpha) {
  const T alpha_t = ipm_min(alpha + T(0.1), T(1));
  T trial[F::kTotal];
  for (int i = 0; i < F::kTotal; ++i) trial[i] = v[i] + alpha_t * d[i];
  T r[F::kTotal];
  F::template gondzio_targets<T>(dat, prm, trial, mu_target, r);
  T dm[F::kTotal];
  direction<F, T>(dat, prm, v, mu, r, K, D, dm);
  T d_new[F::kTotal];
  for (int i = 0; i < F::kTotal; ++i) d_new[i] = d[i] + dm[i];
  const T alpha_new = max_step<F, T>(dat, v, d_new);
  if (alpha_new >= ipm_min(alpha + T(0.1 * 0.1), T(1))) {
    for (int i = 0; i < F::kTotal; ++i) d[i] = d_new[i];
    alpha = alpha_new;
  }
}

// One Mehrotra predictor-corrector iteration of one instance
// (fused.py:_fused_step).  `gap` is the duality measure at v.
template <typename F, typename T>
IPM_FN void fused_step(const Data<T>& dat, const Params<T>& prm, const T* v,
                       T mu, T gap, int gondzio, T* v_new, T& mu_new) {
  T K[F::kTri];
  T D[F::kAug];
  F::template assemble<T>(dat, prm, v, mu, K);
  ldlt_packed<T, F::kAug>(K, D, prm.pivot_floor);

  // affine predictor at mu = 0
  T r[F::kTotal];
  F::template residuals<T>(dat, prm, v, T(0), r);
  T d_aff[F::kTotal];
  direction<F, T>(dat, prm, v, T(0), r, K, D, d_aff);
  const T alpha_aff = max_step<F, T>(dat, v, d_aff);

  // sigma = (gap_aff / gap)^3 at the affine trial point
  T trial[F::kTotal];
  for (int i = 0; i < F::kTotal; ++i) trial[i] = v[i] + alpha_aff * d_aff[i];
  T res_aff, gap_aff;
  F::template metrics<T>(dat, prm, trial, res_aff, gap_aff);
  const bool pos = gap > T(0);
  const T g = gap_aff / (pos ? gap : T(1));
  const T sigma = pos ? g * g * g : T(0);
  // the dtype-tied floor keeps the barrier diagonals (~1/mu^2) finite
  mu_new = ipm_max(gap * sigma, prm.mu_floor);

  // corrector with the Taylor remainder, same factors
  F::template corrector<T>(dat, prm, v, mu, mu_new, d_aff, r);
  T d[F::kTotal];
  direction<F, T>(dat, prm, v, mu_new, r, K, D, d);
  T alpha = max_step<F, T>(dat, v, d);
  for (int k = 0; k < gondzio; ++k)
    gondzio_round<F, T>(dat, prm, v, mu, mu_new, K, D, d, alpha);

  const T step = prm.fraction_to_boundary * alpha;
  for (int i = 0; i < F::kTotal; ++i) v_new[i] = v[i] + step * d[i];
}

template <typename T>
IPM_FN const T* at_instance(const T* p, int64_t b) {
  return p == nullptr ? p : p + b;
}

// The whole solve of instance b (fused.py:_fused_kernel for one lane):
// cold start (bound midpoints, ones) or warm resume, then iterations
// until this instance is done or `max_iter` were taken in this call.
template <typename F, typename T>
IPM_FN void solve_instance(const Data<T>& batch, const Params<T>& prm,
                           const T* v0, const T* mu0, const T* it0,
                           const Out<T>& out, int64_t b, int max_iter,
                           int warm, int gondzio) {
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
  const int64_t S = dat.S;

  T v[F::kTotal];
  T mu, iterations;
  if (warm) {
    for (int i = 0; i < F::kTotal; ++i) v[i] = v0[i * S + b];
    mu = mu0[b];
    iterations = it0[b];
  } else {
    F::template init<T>(dat, v);
    mu = prm.mu0;
    iterations = T(0);
  }
  T residual, gap;
  F::template metrics<T>(dat, prm, v, residual, gap);
  bool done = residual < prm.tol && gap < prm.tol;
  for (int it = 0; it < max_iter && !done; ++it) {
    T v_new[F::kTotal];
    T mu_new;
    fused_step<F, T>(dat, prm, v, mu, gap, gondzio, v_new, mu_new);
    for (int i = 0; i < F::kTotal; ++i) v[i] = v_new[i];
    mu = mu_new;
    F::template metrics<T>(dat, prm, v, residual, gap);
    iterations = iterations + T(1);
    done = residual < prm.tol && gap < prm.tol;
  }

  for (int i = 0; i < F::kN; ++i) out.x[i * S + b] = v[F::kX + i];
  for (int i = 0; i < F::kTotal; ++i) out.vars[i * S + b] = v[i];
  out.iterations[b] = iterations;
  out.residual[b] = residual;
  out.gap[b] = gap;
  out.mu[b] = mu;
}

#ifdef __CUDACC__
constexpr int kThreads = 64;

template <typename F, typename T>
__global__ void fused_kernel(Data<T> dat, Params<T> prm, const T* v0,
                             const T* mu0, const T* it0, Out<T> out,
                             int max_iter, int warm, int gondzio) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= dat.S) return;
  solve_instance<F, T>(dat, prm, v0, mu0, it0, out, b, max_iter, warm,
                       gondzio);
}
#endif

// Entry point: data9 and out6 are host arrays of device pointers (in the
// order of Data and Out), params6 a host array in the order of Params.
// With nvcc it enqueues one launch of K1 on `stream` and returns
// cudaGetLastError(); without it (the host build of the tests) it runs
// the same per-instance code in a loop and returns 0.
template <typename F, typename T>
int fused_entry(const T* const* data9, const T* v0, const T* mu0,
                const T* it0, T* const* out6, long long B, const T* params6,
                int max_iter, int warm, int gondzio, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  const Out<T> out{out6[0], out6[1], out6[2], out6[3], out6[4], out6[5]};
#ifdef __CUDACC__
  const unsigned grid = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  fused_kernel<F, T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dat, prm, v0, mu0, it0, out, max_iter, warm, gondzio);
  return static_cast<int>(cudaGetLastError());
#else
  (void)stream;
  for (long long b = 0; b < B; ++b)
    solve_instance<F, T>(dat, prm, v0, mu0, it0, out, b, max_iter, warm,
                         gondzio);
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_FUSED_ENTRY_POINTS(F)                                         \
  extern "C" int ipmzoo_fused_f32(                                           \
      const float* const* data9, const float* v0, const float* mu0,          \
      const float* it0, float* const* out6, long long B,                     \
      const float* params6, int max_iter, int warm, int gondzio,             \
      void* stream) {                                                        \
    return ipmzoo_fused::fused_entry<F, float>(data9, v0, mu0, it0, out6, B, \
                                               params6, max_iter, warm,      \
                                               gondzio, stream);             \
  }                                                                          \
  extern "C" int ipmzoo_fused_f64(                                           \
      const double* const* data9, const double* v0, const double* mu0,       \
      const double* it0, double* const* out6, long long B,                   \
      const double* params6, int max_iter, int warm, int gondzio,            \
      void* stream) {                                                        \
    return ipmzoo_fused::fused_entry<F, double>(data9, v0, mu0, it0, out6,   \
                                                B, params6, max_iter, warm,  \
                                                gondzio, stream);            \
  }
