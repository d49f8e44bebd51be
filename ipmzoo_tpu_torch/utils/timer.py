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
* :func:`cuda_time_rounds` — :func:`cuda_time` of several calls in turns.
* :func:`trace_kernels` — the device's kernels in a ``torch.profiler``
  trace, behind a leading call; :func:`device_calls` — device
  milliseconds and launches of a call from it.
* :func:`host_syncs` — how often a call waits for the card.
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


def _need_card(what: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")


class DeviceCalls(NamedTuple):
    """Per call on the card: device ms, launches, (name, device ms,
    launches) of each kernel or copy, the longest first, and whether the
    trace read was whole (else divided by the calls it holds)."""
    ms: float
    launches: float
    kernels: List[tuple]
    whole: bool = True


class LostLaunches(RuntimeError):
    """:func:`trace_kernels` kept none of its traces; ``events`` is the
    last one read."""

    def __init__(self, message: str, events: list):
        super().__init__(message)
        self.events = events


#: how often :func:`trace_kernels` takes a trace again that it does not keep
TRACE_RETAKES = 4
#: the device's idle time after :func:`trace_kernels`' leading call, and
#: the shortest idle gap in its trace that marks it: longer than any gap
#: inside a traced run (a call's own launches follow each other within the
#: host's launch time, tens of us; a sweep's groups are apart a few tens
#: of ms)
LEAD_GAP_S, LEAD_SPLIT_US = 0.1, 5e4


def after_lead(events):
    """The (name, start us, duration us) events, in the order they ran,
    after the first idle gap (from the end of every event before to the
    start of the next) of at least LEAD_SPLIT_US; all of them where there
    is none (the lead's launches were lost whole)."""
    end = None
    for i, (_, start, us) in enumerate(events):
        if end is not None and start - end >= LEAD_SPLIT_US:
            return events[i:]
        end = start + us if end is None else max(end, start + us)
    return events


def trace_kernels(run: Callable[[], object], kept: Callable[[list], bool],
                  lead: Callable[[], object]) -> list:
    """The device's kernels and copies, as (name, start us, duration us)
    in the order they ran, of ``run()`` in one ``torch.profiler`` session
    that opens with ``lead()`` and LEAD_GAP_S of idle device, read after
    that gap (:func:`after_lead`).  torch 2.11 on the H100 drops launches,
    most at the start of a session (of four K6 launches at B=32, two to
    four came back; of 20 K2 launches, 17 to 19), which the lead absorbs
    in a fresh process (not always in a long one: behind it, every trace
    of a K2 row after chip_smoke.py's Schur slice still lost one launch),
    and in a process that has opened a few hundred sessions whole traces
    come back empty.  A trace for which ``kept(events)`` is false is taken
    again, at most TRACE_RETAKES times, each retake said; then this
    raises :class:`LostLaunches`."""
    import time
    import torch
    from torch.profiler import ProfilerActivity, profile
    _need_card("trace_kernels")
    for attempt in range(1 + TRACE_RETAKES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead()
            torch.cuda.synchronize()
            time.sleep(LEAD_GAP_S)
            run()
            torch.cuda.synchronize()
        events = after_lead(sorted(
            ((e.name, e.time_range.start, e.time_range.elapsed_us())
             for e in prof.events() if e.device_type.name == "CUDA" and
             not getattr(e, "is_user_annotation", False)),
            key=lambda e: e[1]))
        if kept(events):
            return events
        print(f"trace_kernels: trace {attempt + 1} lost launches "
              f"({len(events)} device events after the lead)" +
              ("; taken again" if attempt < TRACE_RETAKES else ""))
    raise LostLaunches(f"{1 + TRACE_RETAKES} torch.profiler traces lost "
                       f"launches", events)


def device_calls(fn: Callable[[], object], calls: int = 4) -> DeviceCalls:
    """Per call of ``fn`` on the card, after an untimed call: the
    kernels' and copies' own device time, their launches, and each by
    name, from one trace (:func:`trace_kernels`, ``fn`` the lead) of
    ``calls`` calls.  Every call launches the same kernels, so a trace is
    whole when each kernel's launches are a multiple of ``calls``.  Where
    no trace is whole, the last is divided by the calls its longest
    kernel's launches count, said, and the result marked not ``whole``
    (a caller that must read whole traces checks it); where it holds no
    launch at all, :class:`LostLaunches` is raised."""
    import collections

    def whole(events):
        count = collections.Counter(name for name, _, _ in events)
        return bool(count) and all(c % calls == 0 for c in count.values())

    fn()
    try:
        events, held = trace_kernels(lambda: [fn() for _ in range(calls)],
                                     whole, fn), calls
    except LostLaunches as lost:
        events, held = lost.events, None
        if not events:
            raise
    busy, count = collections.Counter(), collections.Counter()
    for name, _, us in events:
        busy[name] += us
        count[name] += 1
    if held is None:
        main = count[max(busy, key=busy.get)]
        held = main / max(1, round(main / calls))
        print(f"device_calls: no whole trace; the last divided by the "
              f"{held:g} calls its longest kernel's launches count")
    return DeviceCalls(sum(busy.values()) / 1e3 / held,
                       sum(count.values()) / held,
                       [(k, busy[k] / 1e3 / held, count[k] / held)
                        for k in sorted(busy, key=busy.get, reverse=True)],
                       whole(events))


def cuda_time_rounds(fns: List[Callable[[], object]], rounds: int = 5,
                     warmup: bool = True) -> List[Timing]:
    """:func:`cuda_time` of several calls taken in turns: one untimed
    call of each (unless ``warmup`` is false), then ``rounds`` rounds
    that time each once (from an idle device), so a drift of the host's
    speed falls on all alike."""
    for fn in fns if warmup else ():
        fn()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for fn, out in zip(fns, times):
            out.extend(cuda_time(fn, runs=1, warmup=0).times)
    return [_timing(t) for t in times]


#: what torch's sync debug mode warns at each host sync
SYNC_WARNING = "synchronizing CUDA operation"


def host_syncs(fn: Callable[[], object], calls: int = 1) -> float:
    """How many times a call of ``fn`` makes the host wait for the card
    (``.item()``, a data-dependent shape, a copy to the host...), per
    call over ``calls`` calls: torch's sync debug mode warns at each."""
    import warnings
    import torch
    _need_card("host_syncs")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in seen) / calls


def slope(timed: Callable[[int], float], k1: int, k2: int) -> float:
    """Time per repetition from two repetition counts: ``timed(k)`` is
    the time of one call that repeats its body ``k`` times inside the
    kernel, so the difference cancels what is not repeated (launch,
    loads, prologue).  Floored at a tiny positive value, so a rate
    computed from it stays finite when noise exceeds the difference."""
    if k2 <= k1:
        raise ValueError(f"slope needs k2 > k1, got {k1}, {k2}")
    return max((timed(k2) - timed(k1)) / (k2 - k1), 1e-12)
