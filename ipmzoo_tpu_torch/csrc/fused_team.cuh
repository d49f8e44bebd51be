// K1, team route: the fused whole-solve interior-point kernel for Hopper
// (sm_90a) with a team of lanes per QP instance.
//
// Replaces, beside the thread route of fused_ipm.cuh, the TPU kernel
// ipmzoo_tpu/models/fused.py:_fused_kernel (FusedBatchedIPM.solve_fused).
// Its plain version is ipmzoo_tpu_torch/models/fused.py:
// FusedBatchedIPM._fused_plain.  ops/cuda_fused.py:k1_route picks the
// route per launch.
//
// This file is the hand-written part of the team route.  It is not
// compiled alone: ipmzoo_tpu_torch/models/fused_source.py:
// fused_team_source prints fused_ipm.cuh (the shared types and scalar
// helpers), this file, the `struct Form` of the same symbolic walk as
// the thread route's, emitted by models/codegen_team.py:CppTeam, and the
// entry points (IPMZOO_FUSED_TEAM_ENTRY_POINTS).
//
// What bounds K1 on this card.  Each instance reads its data once and
// then iterates on it: a few thousand dependent operations per
// iteration, no device-memory traffic.  The thread route gives one
// thread an instance: 64-thread blocks fill 4% of the card's thread
// slots at B=10240 and one SM in 16 at B=512, and every vector
// temporary of the generated code is a per-thread array in local memory
// (255 registers, a 10 KB stack frame).  It is bound by one thread's
// latency and by local memory.
//
// Design.  kLanes lanes (16, two teams a warp, or 32) share an instance.
// * Every vector of the generated code is spread over the team: entry i
//   lives in lane i % kLanes, so an operation on 16 entries is one
//   instruction of each lane and a temporary is one register.
// * The instance's data (Q and the A blocks at an odd row stride), the
//   iterate, the right-hand sides, the deltas, the packed KKT factor and
//   a few team slots live in dynamic shared memory, one region a team
//   (TeamLayout).  The block stages its instances' data once, with
//   consecutive threads on consecutive instances of each SoA row.
// * A value read at an index other than the one that wrote it goes
//   through shared memory, after a team barrier (__syncwarp of the team's
//   own lanes); a reduction is a shuffle tree over the team's lanes and
//   lands in every lane, so scalars and every branch are uniform over a
//   team.  Two teams of one warp never wait for each other.
// * The LDL^T of the packed K: one column at a time, the pivot computed
//   alike in every lane, the rows below it spread over the lanes, one
//   barrier a column.  The solves keep the right-hand side in registers,
//   entry i in lane i % kLanes, and broadcast x_j by shuffle.
// * Each team leaves its loop when its own instance is done or at
//   max_iter, so per-instance results do not depend on the batch, as in
//   the thread route (fused_ipm.cuh).
//
// Arithmetic is plain IEEE (no fast-math).  Without __CUDACC__ the same
// text compiles for the host with kLanes = 1: barriers are no-ops,
// reductions identities, and the entry points loop over the instances,
// so the g++ build of the tests runs this route's arithmetic.  With
// IPMZOO_TEAM_EMULATE the host build runs each team as kLanes threads
// instead, so the tests also run the lane-spread code and its barriers.

#include <vector>

#ifndef IPMZOO_TEAM_LANES
#define IPMZOO_TEAM_LANES 16
#endif

// IPMZOO_TEAM_EMULATE (host only, C++20): the team is kLanes host
// threads, a barrier for each team barrier and a scratch line for each
// shuffle, so a host build can run the lane-spread code itself.
#if defined(IPMZOO_TEAM_EMULATE) && !defined(__CUDACC__)
#define IPMZOO_TEAM_HOST_THREADS 1
#include <barrier>
#include <thread>
#endif

namespace ipmzoo_fused {

#if defined(__CUDACC__) || defined(IPMZOO_TEAM_HOST_THREADS)
constexpr int kLanes = IPMZOO_TEAM_LANES;
#else
constexpr int kLanes = 1;
#endif
static_assert(kLanes == 1 || kLanes == 16 || kLanes == 32,
              "a team is 16 or 32 lanes of one warp (1 in the host build)");

// Threads a block: 64 / kLanes teams.
constexpr int kTeamThreads = 64;
constexpr int kTeamsPerBlock = kTeamThreads / kLanes;

// Entries of a `size`-entry vector that one lane holds, and the loop over
// them: `i` is the entry, `p` its slot in the lane's arrays.
#define IPM_LANES(size) (((size) + kLanes - 1) / kLanes)
#define IPM_FOR(size)                                                  \
  for (int p = 0, i = tm.lane; p < IPM_LANES(size); ++p, i += kLanes) \
    if (i < (size))

#ifdef IPMZOO_TEAM_HOST_THREADS
struct TeamHost {
  std::barrier<>* bar;
  double line[32];
};
#endif

// One team: its lane, the warp lanes it spans, its slots in shared memory.
template <typename T>
struct Team {
  int lane;
  unsigned mask;
  T* slot;
#ifdef IPMZOO_TEAM_HOST_THREADS
  TeamHost* host;
#endif
};

// The instance's data staged in the team's shared memory, row-major, the
// matrices' rows kLd apart; the fields of Data.
template <typename T>
struct Staged {
  const T *Q, *c, *A_ineq, *l_A_ineq, *u_A_ineq, *A_eq, *b_eq, *l_x, *u_x;
};

// The team's work arrays in shared memory.
template <typename T>
struct Work {
  T *v, *r, *d_aff, *d, *trial, *dm, *d_new, *K, *D, *b;
};

// Offsets, in values of the working type, of everything a team keeps in
// shared memory; kStride is one team's region, padded so that the two
// teams of a warp start 16 banks apart.
template <typename F>
struct TeamLayout {
  static constexpr int kQ = 0;
  static constexpr int kC = kQ + F::kN * F::kLd;
  static constexpr int kA = kC + F::kN;
  static constexpr int kLA = kA + F::kM * F::kLd;
  static constexpr int kUA = kLA + F::kM;
  static constexpr int kAeq = kUA + F::kM;
  static constexpr int kBeq = kAeq + F::kE * F::kLd;
  static constexpr int kLx = kBeq + F::kE;
  static constexpr int kUx = kLx + F::kN;
  static constexpr int kV = kUx + F::kN;
  static constexpr int kR = kV + F::kTotal;
  static constexpr int kDaff = kR + F::kTotal;
  static constexpr int kD = kDaff + F::kTotal;
  static constexpr int kTrial = kD + F::kTotal;
  static constexpr int kDm = kTrial + F::kTotal;
  static constexpr int kDnew = kDm + F::kTotal;
  static constexpr int kK = kDnew + F::kTotal;
  static constexpr int kDiag = kK + F::kTri;
  static constexpr int kB = kDiag + F::kAug;
  static constexpr int kSlot = kB + F::kAug;
  static constexpr int kEnd = kSlot + F::kSlots;
  static constexpr int kStride = (kEnd + 31) / 32 * 32 + 16;
};

template <typename F, typename T>
IPM_FN Staged<T> staged(const T* region) {
  using L = TeamLayout<F>;
  return {region + L::kQ,  region + L::kC,    region + L::kA,
          region + L::kLA, region + L::kUA,   region + L::kAeq,
          region + L::kBeq, region + L::kLx,  region + L::kUx};
}

template <typename F, typename T>
IPM_FN Work<T> work(T* region) {
  using L = TeamLayout<F>;
  return {region + L::kV,     region + L::kR,  region + L::kDaff,
          region + L::kD,     region + L::kTrial, region + L::kDm,
          region + L::kDnew,  region + L::kK,  region + L::kDiag,
          region + L::kB};
}

template <typename T>
IPM_FN void team_sync(const Team<T>& tm) {
#if defined(__CUDA_ARCH__)
  __syncwarp(tm.mask);
#elif defined(IPMZOO_TEAM_HOST_THREADS)
  tm.host->bar->arrive_and_wait();
#else
  (void)tm;
#endif
}

// Lane `src`'s x (the team's own lanes numbered from 0).
template <typename T>
IPM_FN T team_shfl(const Team<T>& tm, T x, int src) {
#if defined(__CUDA_ARCH__)
  return __shfl_sync(tm.mask, x, src, kLanes);
#elif defined(IPMZOO_TEAM_HOST_THREADS)
  tm.host->line[tm.lane] = x;
  team_sync(tm);
  const T y = static_cast<T>(tm.host->line[src]);
  team_sync(tm);
  return y;
#else
  (void)tm;
  (void)src;
  return x;
#endif
}

// Lane (lane ^ o)'s x.
template <typename T>
IPM_FN T team_xor(const Team<T>& tm, T x, int o) {
#if defined(__CUDA_ARCH__)
  return __shfl_xor_sync(tm.mask, x, o, kLanes);
#else
  return team_shfl(tm, x, tm.lane ^ o);
#endif
}

// Sum over the team by a butterfly: every lane gets the same value
// (floating-point addition commutes).
template <typename T>
IPM_FN T team_sum(const Team<T>& tm, T x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += team_xor(tm, x, o);
  return x;
}

// ipm_min over the team (a NaN anywhere gives NaN, as the sequential
// loop), then lane 0's value everywhere, so the sign of a zero agrees.
template <typename T>
IPM_FN T team_min(const Team<T>& tm, T x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    x = ipm_min(x, team_xor(tm, x, o));
  return kLanes > 1 ? team_shfl(tm, x, 0) : x;
}

// In-place LDL^T of the packed lower triangle K (N x N) in shared memory,
// the arithmetic of fused_ipm.cuh:ldlt_packed: column j's pivot alike in
// every lane, its rows below spread over the lanes, a barrier a column.
// Only an exactly-zero pivot is replaced by pivot_floor.
template <typename T, int N>
IPM_FN void team_ldlt(const Team<T>& tm, T* K, T* D, T pivot_floor) {
  for (int j = 0; j < N; ++j) {
    T s = T(0);
    for (int k = 0; k < j; ++k) {
      const T l = K[tri(j, k)];
      s += l * (l * D[k]);
    }
    T d = K[tri(j, j)] - s;
    if (d == T(0)) d = pivot_floor;
    for (int i = j + 1 + tm.lane; i < N; i += kLanes) {
      T t = T(0);
      for (int k = 0; k < j; ++k) t += K[tri(i, k)] * (K[tri(j, k)] * D[k]);
      K[tri(i, j)] = (K[tri(i, j)] - t) / d;
    }
    if (tm.lane == 0) D[j] = d;
    team_sync(tm);
  }
}

// The factor of the team and wide routes: team_ldlt on the team's lanes.
// solve_team takes the factor as a policy, so that a route can run it on
// more threads than the team (fused_wide_block.cuh: BlockFactor).
struct TeamFactor {
  template <int N, typename T>
  IPM_FN void run(const Team<T>& tm, T* K, T* D, T pivot_floor) const {
    team_ldlt<T, N>(tm, K, D, pivot_floor);
  }
};

// Orders up to which team_ldlt_solve unrolls its sweeps whole; above it
// (the wide route, fused_wide.cuh) a sweep unrolls only over the lanes'
// slots and loops over the columns of each.
constexpr int kUnrolledSolve = 128;

// Solve L D L^T x = b in place (b in shared memory) against team_ldlt's
// factors: x in registers, entry i in lane i % kLanes, x_j broadcast by
// shuffle; forward, diagonal and backward sweeps, column j after column
// j - 1 (forward) or j + 1 (backward) whatever the loop's shape.  A lane
// reads and writes only its own entries of b, so one barrier, after the
// writes, is enough.
template <typename T, int N>
IPM_FN void team_ldlt_solve(const Team<T>& tm, const T* K, const T* D,
                            T* b) {
  constexpr int P = IPM_LANES(N);
  T x[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = tm.lane + p * kLanes;
    x[p] = i < N ? b[i] : T(0);
  }
  if constexpr (N <= kUnrolledSolve) {
#pragma unroll
    for (int j = 0; j < N - 1; ++j) {
      const T xj = team_shfl(tm, x[j / kLanes], j % kLanes);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = tm.lane + p * kLanes;
        if (i > j && i < N) x[p] -= K[tri(i, j)] * xj;
      }
    }
  } else {
    // column j = q kLanes + c lives in slot q of lane c; rows below it in
    // slots q and up
#pragma unroll
    for (int q = 0; q < P; ++q) {
      for (int c = 0; c < kLanes && q * kLanes + c < N - 1; ++c) {
        const int j = q * kLanes + c;
        const T xj = team_shfl(tm, x[q], c);
#pragma unroll
        for (int p = q; p < P; ++p) {
          const int i = tm.lane + p * kLanes;
          if (i > j && i < N) x[p] -= K[tri(i, j)] * xj;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = tm.lane + p * kLanes;
    if (i < N) x[p] = x[p] / D[i];
  }
  if constexpr (N <= kUnrolledSolve) {
#pragma unroll
    for (int j = N - 1; j > 0; --j) {
      const T xj = team_shfl(tm, x[j / kLanes], j % kLanes);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int i = tm.lane + p * kLanes;
        if (i < j) x[p] -= K[tri(j, i)] * xj;
      }
    }
  } else {
    // rows above column j lie in slots q and below
#pragma unroll
    for (int q = P - 1; q >= 0; --q) {
      for (int c = kLanes - 1; c >= 0; --c) {
        const int j = q * kLanes + c;
        if (j >= N || j == 0) continue;
        const T xj = team_shfl(tm, x[q], c);
#pragma unroll
        for (int p = 0; p <= q; ++p) {
          const int i = tm.lane + p * kLanes;
          if (i < j) x[p] -= K[tri(j, i)] * xj;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = tm.lane + p * kLanes;
    if (i < N) b[i] = x[p];
  }
  team_sync(tm);
}

// One search direction against the factored system (fused_ipm.cuh:
// direction): the generated right-hand side into w.b, the solve, the
// generated back-substitution.
template <typename F, typename T>
IPM_FN void team_direction(const Team<T>& tm, const Staged<T>& dat,
                           const Params<T>& prm, const Work<T>& w, T mu_r,
                           const T* r, T* delta) {
  F::template aug_rhs<T>(tm, dat, prm, w.v, mu_r, r, w.b);
  team_ldlt_solve<T, F::kAug>(tm, w.K, w.D, w.b);
  F::template back_substitute<T>(tm, dat, prm, w.v, mu_r, r, w.b, delta);
}

// alpha = min(alpha, (bound - v) / d) over this lane's entries moving
// toward a bound; a null bound means no bound.
template <typename T>
IPM_FN T team_box_ratio(const Team<T>& tm, T alpha, const T* v, const T* d,
                        int size, const T* lb, const T* ub) {
  for (int i = tm.lane; i < size; i += kLanes) {
    if (lb != nullptr && d[i] < T(0))
      alpha = ipm_min(alpha, (lb[i] - v[i]) / d[i]);
    if (ub != nullptr && d[i] > T(0))
      alpha = ipm_min(alpha, (ub[i] - v[i]) / d[i]);
  }
  return alpha;
}

// Fraction-to-boundary step (fused_ipm.cuh:max_step): each lane's ratios,
// then the minimum over the team.  The minimum has no rounding, so the
// step is the sequential loop's.
template <typename F, typename T>
IPM_FN T team_max_step(const Team<T>& tm, const Staged<T>& dat, const T* v,
                       const T* d) {
  T alpha = T(1);
  for (int g = 0; g < F::kNonnegGroups; ++g) {
    const int off = F::nonneg_offset(g), size = F::nonneg_size(g);
    for (int i = tm.lane; i < size; i += kLanes) {
      if (d[off + i] < T(0))
        alpha = ipm_min(alpha, -v[off + i] / d[off + i]);
    }
  }
  if (F::kBoxTest) {
    alpha = team_box_ratio(tm, alpha, v + F::kX, d + F::kX, F::kN,
                           F::kXLower ? dat.l_x : nullptr,
                           F::kXUpper ? dat.u_x : nullptr);
    if (F::kS >= 0) {
      alpha = team_box_ratio(tm, alpha, v + F::kS, d + F::kS, F::kM,
                             F::kSLower ? dat.l_A_ineq : nullptr,
                             F::kSUpper ? dat.u_A_ineq : nullptr);
    }
  }
  return team_min(tm, alpha);
}

// One Gondzio centrality-corrector round (fused_ipm.cuh:gondzio_round).
template <typename F, typename T>
IPM_FN void team_gondzio_round(const Team<T>& tm, const Staged<T>& dat,
                               const Params<T>& prm, const Work<T>& w, T mu,
                               T mu_target, T& alpha) {
  const T alpha_t = ipm_min(alpha + T(0.1), T(1));
  IPM_FOR(F::kTotal) w.trial[i] = w.v[i] + alpha_t * w.d[i];
  F::template gondzio_targets<T>(tm, dat, prm, w.trial, mu_target, w.r);
  team_direction<F, T>(tm, dat, prm, w, mu, w.r, w.dm);
  IPM_FOR(F::kTotal) w.d_new[i] = w.d[i] + w.dm[i];
  team_sync(tm);
  const T alpha_new = team_max_step<F, T>(tm, dat, w.v, w.d_new);
  if (alpha_new >= ipm_min(alpha + T(0.1 * 0.1), T(1))) {
    IPM_FOR(F::kTotal) w.d[i] = w.d_new[i];
    alpha = alpha_new;
  }
  team_sync(tm);
}

// One Mehrotra predictor-corrector iteration of the team's instance
// (fused_ipm.cuh:fused_step), the LDL^T by `factor`; w.v is updated in
// place.
template <typename F, typename T, typename Factor>
IPM_FN void team_fused_step(const Team<T>& tm, const Staged<T>& dat,
                            const Params<T>& prm, const Work<T>& w, T mu,
                            T gap, int gondzio, T& mu_new,
                            const Factor& factor) {
  F::template assemble<T>(tm, dat, prm, w.v, mu, w.K);
  factor.template run<F::kAug>(tm, w.K, w.D, prm.pivot_floor);

  // affine predictor at mu = 0
  F::template residuals<T>(tm, dat, prm, w.v, T(0), w.r);
  team_direction<F, T>(tm, dat, prm, w, T(0), w.r, w.d_aff);
  const T alpha_aff = team_max_step<F, T>(tm, dat, w.v, w.d_aff);

  // sigma = (gap_aff / gap)^3 at the affine trial point
  IPM_FOR(F::kTotal) w.trial[i] = w.v[i] + alpha_aff * w.d_aff[i];
  T res_aff, gap_aff;
  F::template metrics<T>(tm, dat, prm, w.trial, res_aff, gap_aff);
  const bool pos = gap > T(0);
  const T g = gap_aff / (pos ? gap : T(1));
  const T sigma = pos ? g * g * g : T(0);
  mu_new = ipm_max(gap * sigma, prm.mu_floor);

  // corrector with the Taylor remainder, same factors
  F::template corrector<T>(tm, dat, prm, w.v, mu, mu_new, w.d_aff, w.r);
  team_direction<F, T>(tm, dat, prm, w, mu_new, w.r, w.d);
  T alpha = team_max_step<F, T>(tm, dat, w.v, w.d);
  for (int k = 0; k < gondzio; ++k)
    team_gondzio_round<F, T>(tm, dat, prm, w, mu, mu_new, alpha);

  const T step = prm.fraction_to_boundary * alpha;
  team_sync(tm);
  IPM_FOR(F::kTotal) w.v[i] = w.v[i] + step * w.d[i];
}

// Copy `rows` x `cols` entries of one SoA field (entry k of instance b at
// src[k * S + b]) for the nb instances from b0 into their teams' regions,
// `stride` values apart, at `off`, rows `ld` apart.  Consecutive
// e = first, first + step, ... take consecutive instances of one entry.
template <typename T>
IPM_FN void stage_field(const T* src, int rows, int cols, int ld, int off,
                        T* smem, int stride, int64_t S, int64_t b0, int nb,
                        int first, int step) {
  if (src == nullptr) return;
  const int count = rows * cols;
  for (int e = first; e < count * nb; e += step) {
    const int k = e / nb, g = e - k * nb;
    const int r = k / cols, c = k - r * cols;
    smem[g * stride + off + r * ld + c] =
        src[static_cast<int64_t>(k) * S + b0 + g];
  }
}

template <typename F, typename T>
IPM_FN void stage_data(const Data<T>& dat, T* smem, int64_t b0, int nb,
                       int first, int step) {
  using L = TeamLayout<F>;
  constexpr int n = F::kN, m = F::kM, e = F::kE, ld = F::kLd;
  constexpr int st = L::kStride;
  const int64_t S = dat.S;
  stage_field(dat.Q, n, n, ld, L::kQ, smem, st, S, b0, nb, first, step);
  stage_field(dat.c, n, 1, 1, L::kC, smem, st, S, b0, nb, first, step);
  stage_field(dat.A_ineq, m, n, ld, L::kA, smem, st, S, b0, nb, first, step);
  stage_field(dat.l_A_ineq, m, 1, 1, L::kLA, smem, st, S, b0, nb, first,
              step);
  stage_field(dat.u_A_ineq, m, 1, 1, L::kUA, smem, st, S, b0, nb, first,
              step);
  stage_field(dat.A_eq, e, n, ld, L::kAeq, smem, st, S, b0, nb, first, step);
  stage_field(dat.b_eq, e, 1, 1, L::kBeq, smem, st, S, b0, nb, first, step);
  stage_field(dat.l_x, n, 1, 1, L::kLx, smem, st, S, b0, nb, first, step);
  stage_field(dat.u_x, n, 1, 1, L::kUx, smem, st, S, b0, nb, first, step);
}

// The whole solve of instance b by its team, the data already staged in
// `dat`, the work arrays at `w`, the LDL^T by `factor`
// (fused_ipm.cuh:solve_instance).
template <typename F, typename T, typename Factor>
IPM_FN void solve_team(const Team<T>& tm, const Staged<T>& dat,
                       const Work<T>& w, const Factor& factor,
                       const Params<T>& prm, const T* v0, const T* mu0,
                       const T* it0, const Out<T>& out, int64_t S, int64_t b,
                       int max_iter, int warm, int gondzio) {
  T mu, iterations;
  if (warm) {
    IPM_FOR(F::kTotal) w.v[i] = v0[i * S + b];
    mu = mu0[b];
    iterations = it0[b];
  } else {
    F::template init<T>(tm, dat, w.v);
    mu = prm.mu0;
    iterations = T(0);
  }
  T residual, gap;
  F::template metrics<T>(tm, dat, prm, w.v, residual, gap);
  bool done = residual < prm.tol && gap < prm.tol;
  for (int it = 0; it < max_iter && !done; ++it) {
    T mu_new;
    team_fused_step<F, T>(tm, dat, prm, w, mu, gap, gondzio, mu_new,
                          factor);
    mu = mu_new;
    F::template metrics<T>(tm, dat, prm, w.v, residual, gap);
    iterations = iterations + T(1);
    done = residual < prm.tol && gap < prm.tol;
  }

  IPM_FOR(F::kN) out.x[i * S + b] = w.v[F::kX + i];
  IPM_FOR(F::kTotal) out.vars[i * S + b] = w.v[i];
  if (tm.lane == 0) {
    out.iterations[b] = iterations;
    out.residual[b] = residual;
    out.gap[b] = gap;
    out.mu[b] = mu;
  }
}

// The whole solve of instance b by its team, everything in `region`
// (TeamLayout) and the LDL^T by team_ldlt.
template <typename F, typename T>
IPM_FN void solve_team(const Team<T>& tm, T* region, const Params<T>& prm,
                       const T* v0, const T* mu0, const T* it0,
                       const Out<T>& out, int64_t S, int64_t b, int max_iter,
                       int warm, int gondzio) {
  solve_team<F, T>(tm, staged<F, T>(region), work<F, T>(region),
                   TeamFactor{}, prm, v0, mu0, it0, out, S, b, max_iter,
                   warm, gondzio);
}

#ifndef __CUDACC__
// Run fn(tm) for one team on the host, its slots at `slot`: one lane, or
// with IPMZOO_TEAM_EMULATE kLanes threads joined by a barrier.
template <typename T, typename Fn>
void host_team(T* slot, Fn fn) {
#ifdef IPMZOO_TEAM_HOST_THREADS
  std::barrier<> bar(kLanes);
  TeamHost host{&bar, {}};
  std::vector<std::thread> lanes;
  for (int l = 0; l < kLanes; ++l)
    lanes.emplace_back([&, l] { fn(Team<T>{l, 0u, slot, &host}); });
  for (auto& t : lanes) t.join();
#else
  fn(Team<T>{0, 1u, slot});
#endif
}
#endif

// Bytes of dynamic shared memory a block of the team kernel takes.
template <typename F, typename T>
constexpr int team_block_bytes() {
  return static_cast<int>(sizeof(T)) * TeamLayout<F>::kStride *
         kTeamsPerBlock;
}

#ifdef __CUDACC__
// The warp lanes of the team that thread `t` belongs to.
__device__ inline unsigned team_mask(int t) {
  const unsigned bits =
      kLanes >= 32 ? 0xffffffffu : (1u << (kLanes % 32)) - 1u;
  return bits << ((t & 31) & ~(kLanes - 1));
}

// The register budget targets the blocks an SM holds by shared memory at
// the fused slice's sizes (7 in float32, 4 in float64): at most 128
// registers a thread in float32, 255 in float64.
template <typename F, typename T>
__global__ void __launch_bounds__(kTeamThreads, sizeof(T) == 4 ? 8 : 4)
fused_team_kernel(Data<T> dat, Params<T> prm, const T* v0, const T* mu0,
                  const T* it0, Out<T> out, int max_iter, int warm,
                  int gondzio) {
  extern __shared__ __align__(16) unsigned char team_smem[];
  T* smem = reinterpret_cast<T*>(team_smem);
  using L = TeamLayout<F>;
  const int team = threadIdx.x / kLanes;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kTeamsPerBlock;
  const int nb = static_cast<int>(
      dat.S - b0 < kTeamsPerBlock ? dat.S - b0 : kTeamsPerBlock);
  stage_data<F, T>(dat, smem, b0, nb, threadIdx.x, blockDim.x);
  __syncthreads();
  if (team >= nb) return;   // the whole team alike
  T* region = smem + team * L::kStride;
  const Team<T> tm{static_cast<int>(threadIdx.x % kLanes),
                   team_mask(threadIdx.x), region + L::kSlot};
  solve_team<F, T>(tm, region, prm, v0, mu0, it0, out, dat.S, b0 + team,
                   max_iter, warm, gondzio);
}

// The most dynamic shared memory a block may take on sm_90, in bytes.
constexpr int kTeamSharedCap = 232448;

// Raise `kernel`'s dynamic shared-memory limit on the current device to
// the cap, at each launch (and occupancy query) whose block takes more
// than the default 48 KB.  Not once per device: K1's libraries, one per
// formulation and sizes, share the generated type's name, and a static
// of a function template is then one object for the whole process (g++
// makes it a unique symbol, merged across the libraries loaded), so a
// flag kept there would leave the second library's kernel unset.
template <typename Kernel>
int allow_shared(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTeamSharedCap));
}

// Enqueue one launch of a team kernel on `stream`: blocks of
// kTeamsPerBlock teams over B instances, `bytes` of dynamic shared memory
// a block (refused above the cap, the limit raised above 48 KB).  Returns
// the cudaError.
template <typename Kernel, typename... Args>
int launch_team(Kernel kernel, int bytes, long long B, void* stream,
                Args... args) {
  if (bytes > kTeamSharedCap) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const int err = allow_shared(kernel);
    if (err) return err;
  }
  const unsigned grid =
      static_cast<unsigned>((B + kTeamsPerBlock - 1) / kTeamsPerBlock);
  kernel<<<grid, kTeamThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

// The teams of a team kernel resident per SM at `bytes` a block, into
// *teams.  Returns the cudaError.
template <typename Kernel>
int team_occupancy(Kernel kernel, int bytes, int* teams) {
  const int e = allow_shared(kernel);
  if (e) return e;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, kTeamThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *teams = blocks * kTeamsPerBlock;
  return 0;
}
#endif

// Entry point, with the C signature of fused_ipm.cuh:fused_entry.  With
// nvcc it enqueues one launch of the team kernel on `stream` and returns
// its cudaError (a block over the shared-memory cap is refused there);
// without it, it stages each instance into a host region and runs the
// same per-team code with one lane.
template <typename F, typename T>
int fused_team_entry(const T* const* data9, const T* v0, const T* mu0,
                     const T* it0, T* const* out6, long long B,
                     const T* params6, int max_iter, int warm, int gondzio,
                     void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  const Out<T> out{out6[0], out6[1], out6[2], out6[3], out6[4], out6[5]};
  using L = TeamLayout<F>;
#ifdef __CUDACC__
  return launch_team(fused_team_kernel<F, T>, team_block_bytes<F, T>(), B,
                     stream, dat, prm, v0, mu0, it0, out, max_iter, warm,
                     gondzio);
#else
  (void)stream;
  std::vector<T> region(L::kStride);
  for (long long b = 0; b < B; ++b) {
    stage_data<F, T>(dat, region.data(), b, 1, 0, 1);
    host_team(region.data() + L::kSlot, [&](const Team<T>& tm) {
      solve_team<F, T>(tm, region.data(), prm, v0, mu0, it0, out, B, b,
                       max_iter, warm, gondzio);
    });
  }
  return 0;
#endif
}

// What the team build is: out4 = (lanes a team, threads a block, bytes of
// shared memory a team, teams resident per SM; the last 0 in a host
// build) for the working type of `itemsize` bytes.
template <typename F>
int fused_team_shape(int itemsize, int* out4) {
  out4[0] = kLanes;
  out4[1] = kTeamThreads;
  out4[2] = itemsize * TeamLayout<F>::kStride;
  out4[3] = 0;
#ifdef __CUDACC__
  return itemsize == 8
             ? team_occupancy(fused_team_kernel<F, double>,
                              team_block_bytes<F, double>(), out4 + 3)
             : team_occupancy(fused_team_kernel<F, float>,
                              team_block_bytes<F, float>(), out4 + 3);
#else
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_FUSED_TEAM_ENTRY_POINTS(F)                                    \
  extern "C" int ipmzoo_fused_team_f32(                                      \
      const float* const* data9, const float* v0, const float* mu0,          \
      const float* it0, float* const* out6, long long B,                     \
      const float* params6, int max_iter, int warm, int gondzio,             \
      void* stream) {                                                        \
    return ipmzoo_fused::fused_team_entry<F, float>(                         \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        stream);                                                             \
  }                                                                          \
  extern "C" int ipmzoo_fused_team_f64(                                      \
      const double* const* data9, const double* v0, const double* mu0,       \
      const double* it0, double* const* out6, long long B,                   \
      const double* params6, int max_iter, int warm, int gondzio,            \
      void* stream) {                                                        \
    return ipmzoo_fused::fused_team_entry<F, double>(                        \
        data9, v0, mu0, it0, out6, B, params6, max_iter, warm, gondzio,      \
        stream);                                                             \
  }                                                                          \
  extern "C" int ipmzoo_fused_team_shape(int itemsize, int* out4) {          \
    return ipmzoo_fused::fused_team_shape<F>(itemsize, out4);                \
  }
