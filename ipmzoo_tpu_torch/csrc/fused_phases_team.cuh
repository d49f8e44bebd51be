// T3, team route: prefixes of one fused interior-point iteration on K1's
// team route, for Hopper (sm_90a).
//
// Replaces, beside the thread route of fused_phases.cuh, the TPU kernel
// tools/fused_phases.py:phase_kernel.  Its plain version is
// ipmzoo_tpu_torch/models/fused_phases.py:phase_plain.
//
// Why a second route.  Wherever a block of teams fits the shared memory,
// the fused slice among them, K1 runs its team route (fused_team.cuh:
// kLanes lanes an instance, the instance's data and state in shared
// memory), not the thread route that fused_phases.cuh repeats.  This
// header runs the prefixes through the team route's own functions, on its
// own layout and launch, so that the phases it times are those of the
// kernel the fused slice launches.
//
// This file is not compiled alone: models/fused_phases.py:
// phase_team_source prints fused_ipm.cuh, fused_team.cuh, this text, the
// `struct Form` of models/codegen_team.py:CppTeam at the team route's lanes
// and one line that instantiates the entry points for one PHASE
// (IPMZOO_PHASE_TEAM_ENTRY_POINTS).  Each prefix is a translation unit of
// its own, so ptxas reports its registers, stack frame and spills alone.
//
// Layout and launch are K1's team route's: 64-thread blocks of
// kTeamsPerBlock teams, one TeamLayout region a team in dynamic shared
// memory, staged once a launch by stage_data, the Staged / Work views on
// it.  Per instance, at the cold start of the fused solve (F::init, mu =
// mu0), PHASE selects how much of team_fused_step runs, each through the
// very functions it calls:
//
//   0  the start iterate only
//   1  + F::assemble               acc += sum of the symmetric K
//   2  + the factor                acc += D[0]
//   3  + F::residuals at mu = 0, team_direction, F::corrector,
//        team_direction (both at the start mu: no step length, no sigma)
//                                   acc += the corrector delta's first entry
//   4  + three F::metrics at mu = 0  acc += residual + gap, each
//
// The start iterate is kept in the work vector `trial` (no prefix runs a
// trial point) and repetition r runs on it scaled by 1 + 1e-6 r in `v`;
// the three metrics calls run on `dm`.  The data is staged once a launch,
// outside the repetitions, so the slope over `reps` leaves the staging out
// as it leaves the launch out.
//
// What bounds it: as K1's team route, the dependent chain of one team's
// shared-memory operations, barriers and shuffles; no device-memory
// traffic after the staging.
//
// The outputs keep T3's meaning (fused_phases.cuh): `acc` is what the TPU
// kernel writes; `sink` also sums everything a phase produces (the start
// iterate, K, all of D and L, every entry of the delta), so that the
// compiler cannot drop a phase whose results reach only shared memory.
// Each lane sums its own entries and the scalars that every lane holds
// alike go in once, from lane 0; team_sum adds the lanes' parts at the
// end, in another order than the plain version's, so the two agree to a
// tolerance, not to the bit.  `perturb` nudges the three metrics calls
// apart as in fused_phases.cuh.

namespace ipmzoo_fused {

// The prefix on one team, the LDL^T by `factor`, as team_fused_step takes
// it: TeamFactor (team_ldlt on the team) here and on the wide route,
// BlockFactor (block_ldlt on the whole block) on the block route
// (fused_phases_block.cuh).
template <typename F, typename T, int PHASE, typename Factor>
IPM_FN void phase_team(const Team<T>& tm, const Staged<T>& dat,
                       const Work<T>& w, const Factor& factor,
                       const Params<T>& prm, int reps, int perturb,
                       T& acc_out, T& sink_out) {
  F::template init<T>(tm, dat, w.trial);
  const T mu = prm.mu0;
  T acc = T(0), sink = T(0);
  for (int rep = 0; rep < reps; ++rep) {
    const T scale = T(1.0 + 1e-6 * rep);
    IPM_FOR(F::kTotal) w.v[i] = w.trial[i] * scale;
    if (PHASE == 0) {
      IPM_FOR(F::kTotal) sink += w.v[i];
    }
    if (PHASE >= 1) {
      F::template assemble<T>(tm, dat, prm, w.v, mu, w.K);
      T s = T(0);
      for (int i = 0; i < F::kAug; ++i)
        for (int j = tm.lane; j <= i; j += kLanes)
          s += (j < i ? T(2) : T(1)) * w.K[tri(i, j)];
      acc += s;
      sink += s;
      team_sync(tm);   // the factor overwrites K in place
    }
    if (PHASE >= 2) {
      factor.template run<F::kAug>(tm, w.K, w.D, prm.pivot_floor);
      T s = T(0);
      for (int i = 1; i < F::kAug; ++i)
        for (int j = tm.lane; j < i; j += kLanes) s += w.K[tri(i, j)];
      IPM_FOR(F::kAug) s += w.D[i];
      sink += s;
      if (tm.lane == 0) acc += w.D[0];
    }
    if (PHASE >= 3) {
      F::template residuals<T>(tm, dat, prm, w.v, T(0), w.r);
      team_direction<F, T>(tm, dat, prm, w, T(0), w.r, w.d_aff);
      F::template corrector<T>(tm, dat, prm, w.v, mu, mu, w.d_aff, w.r);
      team_direction<F, T>(tm, dat, prm, w, mu, w.r, w.d);
      IPM_FOR(F::kTotal) sink += w.d[i];
      if (tm.lane == 0) acc += w.d[0];
    }
    if (PHASE >= 4) {
      for (int k = 0; k < 3; ++k) {
        const T nudge = T(1.0 + 1e-6 * (k * perturb));
        IPM_FOR(F::kTotal) w.dm[i] = w.v[i] * nudge;
        T residual, gap;
        F::template metrics<T>(tm, dat, prm, w.dm, residual, gap);
        if (tm.lane == 0) {
          acc += residual + gap;
          sink += residual + gap;
        }
      }
    }
    team_sync(tm);   // every lane's reads done before the next writes
  }
  acc_out = team_sum(tm, acc);
  sink_out = team_sum(tm, sink);
}

#ifdef __CUDACC__
// K1's team launch (fused_team_kernel's bounds, blocks and staging), the
// prefix in place of the solve.
template <typename F, typename T, int PHASE>
__global__ void __launch_bounds__(kTeamThreads, sizeof(T) == 4 ? 8 : 4)
phase_team_kernel(Data<T> dat, Params<T> prm, T* acc, T* sink, int reps,
                  int perturb) {
  extern __shared__ __align__(16) unsigned char phase_smem[];
  T* smem = reinterpret_cast<T*>(phase_smem);
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
  T a, s;
  phase_team<F, T, PHASE>(tm, staged<F, T>(region), work<F, T>(region),
                          TeamFactor{}, prm, reps, perturb, a, s);
  if (tm.lane == 0) {
    acc[b0 + team] = a;
    sink[b0 + team] = s;
  }
}
#endif

// Entry point, with the C signature of fused_phases.cuh:phase_entry.
// With nvcc it enqueues one launch on `stream` as K1's team entry does
// (launch_team: the shared-memory limit raised at every launch above
// 48 KB, see allow_shared) and returns its cudaError; without it (the host
// build of the tests) it stages each instance into a host region and
// runs the same per-team code (host_team) and returns 0.
template <typename F, typename T, int PHASE>
int phase_team_entry(const T* const* data9, T* acc, T* sink, long long B,
                     const T* params6, int reps, int perturb, void* stream) {
  const Data<T> dat{data9[0], data9[1], data9[2], data9[3], data9[4],
                    data9[5], data9[6], data9[7], data9[8], B};
  const Params<T> prm{params6[0], params6[1], params6[2],
                      params6[3], params6[4], params6[5]};
  using L = TeamLayout<F>;
#ifdef __CUDACC__
  return launch_team(phase_team_kernel<F, T, PHASE>, team_block_bytes<F, T>(),
                     B, stream, dat, prm, acc, sink, reps, perturb);
#else
  (void)stream;
  std::vector<T> region(L::kStride);
  for (long long b = 0; b < B; ++b) {
    stage_data<F, T>(dat, region.data(), b, 1, 0, 1);
    host_team(region.data() + L::kSlot, [&](const Team<T>& tm) {
      T a, s;
      phase_team<F, T, PHASE>(tm, staged<F, T>(region.data()),
                              work<F, T>(region.data()), TeamFactor{}, prm,
                              reps, perturb, a, s);
      if (tm.lane == 0) {
        acc[b] = a;
        sink[b] = s;
      }
    });
  }
  return 0;
#endif
}

}  // namespace ipmzoo_fused

#define IPMZOO_PHASE_TEAM_ENTRY_POINTS(F, PHASE)                              \
  extern "C" int ipmzoo_phase_team_f32(const float* const* data9,             \
                                       float* acc, float* sink, long long B,  \
                                       const float* params6, int reps,        \
                                       int perturb, void* stream) {           \
    return ipmzoo_fused::phase_team_entry<F, float, PHASE>(                   \
        data9, acc, sink, B, params6, reps, perturb, stream);                 \
  }                                                                           \
  extern "C" int ipmzoo_phase_team_f64(const double* const* data9,            \
                                       double* acc, double* sink,             \
                                       long long B, const double* params6,    \
                                       int reps, int perturb, void* stream) { \
    return ipmzoo_fused::phase_team_entry<F, double, PHASE>(                  \
        data9, acc, sink, B, params6, reps, perturb, stream);                 \
  }
