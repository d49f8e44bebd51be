"""Timers of the port (counterpart of :mod:`ipmzoo_tpu.utils.timer`).

* :class:`Timer` — accumulating named-section wall-clock timer, as the
  reference's.
* :func:`device_trace` — a ``torch.profiler`` trace of a region (CPU and
  CUDA activities), written as a Chrome trace; a no-op without a
  directory.
* :func:`cuda_time` — median milliseconds and spread of a call on the
  card, by CUDA events.  The reference's two-point slope timing over
  enqueued repetitions exists because its backend acknowledges dispatch,
  not completion; CUDA events time the device itself, so that machinery
  has no counterpart here.
* :func:`host_time` — the same on the host clock, for CPU runs.
* :func:`slope` — time per repetition from two in-kernel repetition
  counts, which cancels the launch, the loads and the prologue.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, List, NamedTuple, Optional


class Timer:
    """Accumulating named-section timer.

    >>> t = Timer()
    >>> with t.section("factorize"):
    ...     work()
    >>> t.report()
    """

    def __init__(self):
        self._elapsed: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._starts: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self._elapsed[name] = self._elapsed.get(name, 0.0) + dt
        self._counts[name] = self._counts.get(name, 0) + 1
        return dt

    @contextlib.contextmanager
    def section(self, name: str):
        self.start(name)
        try:
            yield self
        finally:
            self.stop(name)

    def elapsed(self, name: str) -> float:
        return self._elapsed.get(name, 0.0)

    @staticmethod
    def _fmt(seconds: float) -> str:
        if seconds < 1e-3:
            return f"{seconds * 1e6:.1f} us"
        if seconds < 1.0:
            return f"{seconds * 1e3:.2f} ms"
        return f"{seconds:.3f} s"

    def report(self, print_fn=print) -> str:
        lines = ["Timing report:"]
        for name in sorted(self._elapsed):
            n = self._counts[name]
            total = self._elapsed[name]
            lines.append(f"  {name}: {self._fmt(total)}"
                         f" ({n} calls, {self._fmt(total / n)}/call)")
        out = "\n".join(lines)
        if print_fn is not None:
            print_fn(out)
        return out


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """Wrap a region in a ``torch.profiler`` trace (host and device
    timeline); on exit the Chrome trace goes to ``logdir/trace.json``.
    Yields the profiler, whose ``key_averages()`` sums device time by
    kernel.  With ``logdir=None`` this is a no-op context that yields
    None (cheap to leave in place)."""
    if logdir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timing(NamedTuple):
    """Milliseconds per call: the median over the timed runs, the spread
    (largest minus smallest run) and every run."""
    ms: float
    spread: float
    times: List[float]


def _timing(times: List[float]) -> Timing:
    return Timing(statistics.median(times), max(times) - min(times), times)


def cuda_time(fn: Callable[[], object], runs: int = 5, warmup: int = 1,
              calls: int = 1, lead: int = 0) -> Timing:
    """Time ``fn`` on the current CUDA device by CUDA events: ``warmup``
    untimed calls, then ``runs`` timed runs of ``calls`` back-to-back
    calls each (more than one for a kernel that is short against the
    launch); milliseconds per call.

    With ``lead`` = 0 a run starts on an idle device, so it includes the
    host's time to reach the first launch: right for a solve, whose
    caller pays that.  With ``lead`` > 0 that many untimed calls are
    enqueued just before the start event with no synchronise in between:
    the device is still busy when the timed calls arrive, the host's
    launch latency and its jitter hide behind it, and the time is the
    device's alone (for calls that last longer than the host needs to
    enqueue the next).  Raises without a CUDA device: a host clock is no
    device time."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time needs a CUDA device; time a CPU run "
                           "with host_time")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        for _ in range(lead):
            fn()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return _timing(times)


def host_time(fn: Callable[[], object], runs: int = 5, warmup: int = 1,
              calls: int = 1) -> Timing:
    """:func:`cuda_time`'s counterpart on the host clock, for work that
    runs on the CPU (``fn`` must return only when its work is done)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e3 * (time.perf_counter() - t0) / calls)
    return _timing(times)


def slope(timed: Callable[[int], float], k1: int, k2: int) -> float:
    """Time per repetition from two repetition counts: ``timed(k)`` is
    the time of one call that repeats its body ``k`` times inside the
    kernel, so the difference cancels what is not repeated (launch,
    loads, prologue).  Floored at a tiny positive value, so a rate
    computed from it stays finite when noise exceeds the difference."""
    if k2 <= k1:
        raise ValueError(f"slope needs k2 > k1, got {k1}, {k2}")
    return max((timed(k2) - timed(k1)) / (k2 - k1), 1e-12)
