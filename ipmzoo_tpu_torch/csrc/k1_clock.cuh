// The factor of a K1 route read by the SM's clock: the helpers that the
// measurement headers k1_wide_measure.cuh (the wide and block routes) and
// k1_team_measure.cuh (the team route) share.  Not compiled alone: the
// texts of ops/cuda_k1_measure.py print it after a route's text and
// before a measurement header.  No solver loads them.

namespace ipmzoo_fused {

// This thread's SM clock; 0 in the host build.
IPM_FN long long measure_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}

// A factor policy (TeamFactor, BlockFactor) whose time the team's lane 0
// adds to *cycles at each factor.
template <typename Factor>
struct ClockedFactor {
  Factor inner;
  long long* cycles;

  template <int N, typename T>
  IPM_FN void run(const Team<T>& tm, T* K, T* D, T pivot_floor) const {
    const long long t0 = measure_clock();
    inner.template run<N>(tm, K, D, pivot_floor);
    const long long t1 = measure_clock();
    if (tm.lane == 0) *cycles += t1 - t0;
  }
};

}  // namespace ipmzoo_fused
