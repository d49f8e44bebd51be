"""The port's counterparts of the reference's last three probes, held to
them on the CPU in float64 at small sizes:

* ``chip_arrow_phases.py`` (``tools/arrow_phases.py``): its problem bit
  for bit, and each phase's output at n=64, bandwidth 4, tip 2, a batch
  of one, against the JAX ``ArrowIPM`` method on the same inputs (1e-10);
* ``chip_normal_probe.py`` (``tools/normal_probe.py``): its arrays bit for
  bit and its library pieces against the reference's own piece functions
  (recorded from its ``main`` with the timer stubbed) at n=16, m=4, B=2
  (1e-10); its eight step rows' x equal to one another within each
  gondzio (1e-10);
* ``chip_compact_sched.py`` (``tools/compact_sched_probe.py``): at B=128,
  n=8, m=4 the default schedule's ``converged`` and iterations equal to
  the JAX ``solve_batch_compact`` under the same ``schedule=``.

Each tool then runs on the CPU with its card-only measurement stubbed and
must print every row; a subprocess that imports and drives the three
loads nothing of JAX, the JAX package, bench.py or tools/.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

import bench
import chip_arrow_phases as ap
import chip_compact_sched as cs
import chip_normal_probe as npb
import ipmzoo_tpu.utils.timing as ref_timing
from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models import ArrowIPM as RefArrowIPM
from ipmzoo_tpu.models import ArrowQPData as RefArrowQPData
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.ops import banded as ref_banded
from ipmzoo_tpu_torch.utils import device as card_info
from ipmzoo_tpu_torch.utils.timer import (cuda_time_rounds, device_calls,
                                          host_syncs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F64 = torch.float64
AP = (64, 4, 2)


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- chip_arrow_phases.py ----------------------------------------------------

@pytest.mark.parametrize("sizes", [AP, (ap.N, ap.BAND, ap.TIP)])
def test_arrow_problem_is_the_reference_tools(sizes):
    want = load_tool("arrow_phases").make_problem(*sizes)
    for a, b in zip(ap.make_problem(*sizes), want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def reference_phases():
    """tools/arrow_phases.py's phase inputs and outputs at AP, float64,
    in one jitted program (its in-loop timing left out): key -> output."""
    Q, c, l, u = ap.make_problem(*AP)
    data, st, _ = RefArrowQPData.from_dense(Q, c, l, u, dtype=jnp.float64)
    solver = RefArrowIPM.for_data(data, structure=st, dtype=jnp.float64,
                                  tol=ap.TOL)

    @jax.jit
    def outputs(data):
        state = solver.init_state(data)
        vars_, rx = state.vars, state.rx
        x, lg, lh = vars_
        g, h = x - data.l_x, data.u_x - x
        w = lg / g + lh / h
        nb = solver.N * solver.b
        idx = jnp.arange(solver.b)
        Dc = data.D.at[:, idx, idx].add(jnp.reshape(w[:nb], (solver.N,
                                                             solver.b)))
        tidx = jnp.arange(solver.t)
        Ctc = data.Ct.at[tidx, tidx].add(w[nb:])
        fac0 = ref_banded.cr_factor(Dc, data.E)
        factors = ref_banded.arrow_factor(Dc, data.E, data.U, Ctc)
        r1 = jnp.ones((solver.N, solver.b, 1))
        rt = jnp.ones((solver.N, solver.b, solver.t))
        cg, ch = g * lg, h * lh
        trial = tuple(v * (1 - 1e-3) for v in vars_)
        d0 = solver._direction(data, vars_, factors, rx, cg, ch)
        step = solver._step_impl(state, data)
        return {
            # the bare factor's layout is its route's own: held through a
            # solve with it
            "factor": [ref_banded.cr_solve(fac0, rt)],
            "arrow factor": [factors.W, factors.tip_chol],
            "solve k=1": [ref_banded.cr_solve(fac0, r1)],
            "solve k=t": [ref_banded.cr_solve(fac0, rt)],
            "direction": list(d0),
            "max_step": [solver._max_step(data, vars_, d0)],
            "gap_at": [solver._gap_at(data, trial)],
            "qx": [solver._qx(data, x)],
            "metrics": list(solver._metrics(data, trial)),
            "step": [*step.vars, step.mu, step.residual, step.gap, step.rx],
        }

    out = outputs(data)
    return {k: out[k] for k in ap_keys()}


def ap_keys():
    return ["factor", "arrow factor", "solve k=1", "solve k=t", "direction",
            "max_step", "gap_at", "qx", "metrics", "step"]


@pytest.fixture(scope="module")
def arrow_pair():
    solver, data = ap.setup(*AP, batch=1, dtype=F64, device=CPU)
    return solver, data, reference_phases()


def test_arrow_rows_are_the_reference_tools(arrow_pair):
    solver, data, want = arrow_pair
    rows = ap.phases(solver, data)
    assert [k for k, _, _ in rows] == list(want)
    assert [lbl for _, lbl, _ in rows][1:] == [
        "full arrow factor (+W,+tip)", "cr solve k=1 (cr)",
        "cr solve k=2 (cr)", "full direction (arrow_solve+duals)",
        "max_step (8 ratio reductions)", "gap_at", "qx structured matvec",
        "metrics (qx + residual norms)", "FULL STEP (_step_impl)"]
    assert rows[0][1] == "cr factor kernel (cr)"


@pytest.mark.parametrize("key", ap_keys())
def test_arrow_phase_matches_the_jax_method(arrow_pair, key):
    from ipmzoo_tpu_torch.ops.banded import _bsolve
    solver, data, want = arrow_pair
    fn = {k: f for k, _, f in ap.phases(solver, data)}[key]
    out = fn()
    if key == "factor":
        rt = torch.ones((1, solver.N, solver.b, solver.t), dtype=F64)
        got = [_bsolve(out, rt)]
    else:
        got = ap.tensors(out)
    assert len(got) == len(want[key])
    for a, b in zip(got, want[key]):
        b = np.asarray(b)
        assert tuple(a.shape) == (1,) + b.shape
        assert rel(a[0].numpy(), b) <= 1e-10, key


def test_arrow_results_drop_only_the_bare_factor():
    out = ap.results(*AP, batch=2, dtype=F64, device=CPU)
    assert list(out) == ["arrow factor", "solve k=1", "solve k=t",
                         "direction", "max_step", "gap_at", "qx", "metrics",
                         "step"]
    assert all(a.dtype == F64 and a.shape[0] == 2 and
               torch.isfinite(a).all() for v in out.values() for a in v)


def stub_arrow(monkeypatch):
    monkeypatch.setattr(card_info, "nvidia_smi", lambda: "test card, 1 W")
    monkeypatch.setattr(ap, "measure", lambda fn, k, runs: (
        fn(), {"wall_ms": 1.0, "device_ms": 0.5, "launches": 3.0,
               "whole": True,
               "syncs": 0.0})[1])


def test_arrow_tool_prints_every_row(monkeypatch, capsys):
    stub_arrow(monkeypatch)
    rows = ap.run(*AP, batches=(1, 2), dtype=F64, device=CPU)
    out = capsys.readouterr().out
    assert len(rows) == 2 * 11
    for r in rows:
        assert r["card"] == "test card, 1 W"
    labels = [lbl for _, lbl, _ in ap.phases(*ap.setup(*AP, dtype=F64,
                                                       device=CPU))]
    for batch in (1, 2):
        for lbl in labels + ["sum of phases (1F+2D+2M+G+Me)"]:
            assert f"B={batch:<3d} {lbl:40s}:" in out
    # 1F + 2D + 2M + G + Me of rows of 1 ms each
    assert rows[10]["wall_ms"] == 7.0 and rows[10]["launches"] == 21.0
    assert out.count("[test card, 1 W]") == 22


# -- chip_normal_probe.py ----------------------------------------------------

NP = (16, 4, 2)


@pytest.fixture(scope="module")
def reference_pieces():
    """tools/normal_probe.py's main at NP with its timer recording each
    piece's jitted function and arguments; its step rows fail at once (a
    CompiledIPM that raises), so no step compiles."""
    mod = load_tool("normal_probe")
    import ipmzoo_tpu.models as ref_models
    seen = []

    class Refused:
        def __init__(self, *a, **k):
            raise RuntimeError("not built in this test")

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_timing, "measure_call",
               lambda f, *args: seen.append((f, args)) or 1.0)
    mp.setattr(ref_models, "CompiledIPM", Refused)
    mp.setattr(sys, "argv", ["normal_probe"] + [str(v) for v in NP])
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        mp.undo()
    return seen, buf.getvalue()


def test_normal_probe_arrays_are_the_reference_tools(reference_pieces):
    seen, _ = reference_pieces
    H, A, b1, Bm = npb.problem(*NP)
    assert np.asarray(seen[0][1][0]).tobytes() == H.tobytes()
    assert np.asarray(seen[1][1][1]).tobytes() == b1.tobytes()
    assert np.asarray(seen[2][1][1]).tobytes() == Bm.tobytes()
    assert np.asarray(seen[4][1][0]).tobytes() == A.tobytes()


def test_normal_probe_rows_are_the_reference_tools(reference_pieces):
    _, printed = reference_pieces
    H, A, b1, Bm = (torch.tensor(a) for a in npb.problem(*NP))
    for label, _ in npb.pieces(H, A, b1, Bm):
        assert f"{label}: 1000.000 ms" in printed
    for label, _, options in npb.STEPS:
        kernel = label.split()[0]
        for gz in npb.GONDZIO:
            assert f"step kernel={kernel}{options} gondzio={gz} failed" \
                in printed


def test_normal_probe_pieces_match_the_reference_functions(reference_pieces):
    """Each piece in float64 against the reference's own piece function
    on the float64 casts of its arguments (its factor recomputed in
    float64)."""
    seen, _ = reference_pieces
    arrays = npb.problem(*NP)
    H, A, b1, Bm = (torch.tensor(a, dtype=F64) for a in arrays)
    L64 = jax.vmap(jnp.linalg.cholesky)(jnp.asarray(arrays[0], jnp.float64))
    got = [fn() for _, fn in npb.pieces(H, A, b1, Bm)]
    assert len(got) == len(seen) == 5
    for i, ((f, args), out) in enumerate(zip(seen, got)):
        args = [jnp.asarray(a, jnp.float64) for a in args]
        if i in (1, 2, 3):      # the solves take the factor first
            args[0] = L64
        want = np.asarray(f(*args))
        out = out.numpy().reshape(want.shape)
        assert rel(out, want) <= 1e-10


def test_normal_probe_step_rows_agree():
    rows = npb.steps(*NP, dtype=F64, device=CPU)
    assert [(lbl, gz) for lbl, gz, _, _ in rows] == [
        (lbl, gz) for lbl, _, _ in npb.STEPS for gz in npb.GONDZIO]
    assert [s._block_inv for _, _, s, _ in rows[:4]] == [True, True,
                                                         False, False]
    assert [s._mode for _, _, s, _ in rows] == (
        ["block"] * 4 + ["blockg"] * 2 + ["normal"] * 2)
    xs = {}
    for lbl, gz, s, fn in rows:
        assert s.gondzio == gz and s.scale_tol and s.tol == npb.TOL
        st = fn()
        assert int(st.iteration.max()) == 1
        xs.setdefault(gz, []).append(st.vars[0].numpy())
    for gz, group in xs.items():
        for x in group[1:]:
            assert rel(x, group[0]) <= 1e-10, gz


def test_normal_probe_prints_every_row(monkeypatch, capsys):
    from ipmzoo_tpu_torch.utils.timer import DeviceCalls, Timing
    t = Timing(2.0, 0.1, [2.0])
    prof = DeviceCalls(1.5, 4.0, [("trsm_kernel", 1.0, 1.0)], True)
    monkeypatch.setattr(card_info, "nvidia_smi", lambda: "test card, 1 W")
    monkeypatch.setattr(npb, "time_piece", lambda fn, runs: (fn(), t,
                                                             prof)[1:])
    monkeypatch.setattr(npb, "time_steps", lambda fns, runs: [
        (t, prof, 0.0, {"ldlt block": 1}, fn().vars[0]) for fn in fns])
    rows = npb.run(*NP, dtype=F64, device=CPU)
    out = capsys.readouterr().out
    assert len(rows) == 5 + 8 and out.count("[test card, 1 W]") == 13
    assert "explicit H^-1 (n rhs fwd+bwd)" in out and "trsm_kernel" in out
    assert "step kernel=block block_inv=True gondzio=2: 2.000 ms" in out
    assert "device 1.500 ms, launches 4" in out
    assert rows[-1]["inst_it_s"] == NP[2] / 2.0 * 1e3
    assert tuple(rows[-1]["x"].shape) == (NP[2], NP[0])


# -- chip_compact_sched.py ---------------------------------------------------

CP = (128, 8, 4)


@pytest.fixture(scope="module")
def compact_port():
    return cs.setup(*CP, dtype=F64, device=CPU)


@pytest.fixture(scope="module")
def compact_run(compact_port):
    """The tool run once at CP with the card's name, the walls and the
    sync counter stubbed: its rows, what it printed, and the result of
    each counted solve by schedule."""
    from ipmzoo_tpu_torch.utils.timer import Timing
    solves, inner = {}, cs.counted_solve

    def counted_solve(solver, data, schedule):
        out = inner(solver, data, schedule)
        solves[str(schedule)] = out[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(card_info, "nvidia_smi", lambda: "test card, 1 W")
        stub_syncs(mp)
        mp.setattr(cs, "wall", lambda fns, runs: [
            Timing(10.0, 1.0, [10.0]) for _ in fns])
        mp.setattr(cs, "counted_solve", counted_solve)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rows = cs.run(*CP, dtype=F64, device=CPU)
    return rows, out.getvalue(), solves


def test_compact_default_schedule_matches_the_reference(compact_port,
                                                        compact_run):
    solver, data = compact_port
    (name, sched), *rest = cs.schedules(solver, CP[0])
    assert name == "default" and sched == [(16, 1), (16, 4), (68, 32)]
    assert [s for _, s in rest] == [
        s for _, s in load_tool_schedules()[1:]]
    # the tool's own counted solve under the default schedule
    got = compact_run[2][str(sched)]
    ref = RefIPM(Settings(), n=CP[1], m_ineq=CP[2], dtype=jnp.float64,
                 tol=cs.TOL)
    want = ref.solve_batch_compact(bench.make_batch(*CP, jnp.float64),
                                   schedule=sched)
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))


def load_tool_schedules():
    """The reference probe's schedules, read from its source (importing
    it runs the probe at bench's full size)."""
    import ast
    src = open(os.path.join(ROOT, "tools", "compact_sched_probe.py")).read()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "schedules":
            return list(ast.literal_eval(node.value).items())
    raise AssertionError("no schedules in the reference probe")


def test_compact_workload_is_benchs(compact_port):
    _, data = compact_port
    want = bench.make_batch(*CP, jnp.float64)
    np.testing.assert_array_equal(data.Q.numpy(), np.asarray(want.Q))
    np.testing.assert_array_equal(data.A_ineq.numpy(),
                                  np.asarray(want.A_ineq))
    assert (cs.B, cs.N, cs.M_INEQ, cs.TOL) == (bench.BATCH, bench.N,
                                              bench.M_INEQ, 1e-6)


def stub_syncs(monkeypatch, value=3.0):
    """The card-only sync counter stubbed: it runs the call once and
    reads ``value``; returns the calls it counted."""
    from ipmzoo_tpu_torch.utils import timer
    counted = []

    def fake(fn, calls=1):
        counted.append(fn)
        fn()
        return value
    monkeypatch.setattr(timer, "host_syncs", fake)
    return counted


def test_compact_counted_solve_counts_each_stage(compact_port, monkeypatch):
    """A first stage of 3 steps leaves instances active: one count a
    stage, within its capacity, and the wrapper taken off again; the
    syncs are the shared counter's, over the one counted solve."""
    solver, data = compact_port
    counted = stub_syncs(monkeypatch)
    sched = [(3, 1), (4, 4), (93, 32)]
    res, syncs, _, counts = cs.counted_solve(solver, data, sched)
    assert len(counts) == 3 and CP[0] >= counts[0] > counts[1] > 0
    assert counts[1] <= CP[0] // 4 and counts[2] <= CP[0] // 32
    assert bool(res.converged.all()) and "_masked_steps" not in vars(solver)
    assert syncs == 3.0 and len(counted) == 1


def test_compact_tool_prints_every_row(compact_run):
    rows, out, _ = compact_run
    assert [r["row"] for r in rows] == ["default", "deep", "wide", "k0_18"]
    assert out.count("[test card, 1 W]") == 4
    assert "default [(16, 1), (16, 4), (68, 32)]: converged 100.00%" in out
    for r in rows:
        assert r["converged"] == 1.0 and r["unconverged"] == 0
        # one count a stage, each within its stage's capacity
        caps = [CP[0] // d for _, d in r["schedule"]]
        assert len(r["actives"]) == len(caps)
        assert all(0 <= a <= c for a, c in zip(r["actives"], caps))
        assert r["it_s"] == r["iterations"] / 10.0 * 1e3
        # the syncs are the shared counter's; CPU tensors launch no kernel
        assert r["syncs"] == 3.0 and r["launches"] == {}


# -- the three together ---------------------------------------------------

def test_card_measurements_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        device_calls(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        host_syncs(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_time_rounds([lambda: None])


class FakeProfile:
    """torch.profiler.profile replaced: each session hands out the next
    of ``traces``, lists of (name, start us, duration us) on the device."""

    def __init__(self, traces):
        self.traces = iter(traces)

    def __call__(self, activities):
        import types
        trace = next(self.traces)
        events = [types.SimpleNamespace(
            name=name, device_type=types.SimpleNamespace(name="CUDA"),
            time_range=types.SimpleNamespace(
                start=start, elapsed_us=lambda us=us: us))
            for name, start, us in trace]
        return contextlib.nullcontext(
            types.SimpleNamespace(events=lambda: events))


def fake_card(monkeypatch, traces):
    from ipmzoo_tpu_torch.utils import timer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(timer, "LEAD_GAP_S", 0.0)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile(traces))


def test_trace_is_read_after_the_lead():
    """The lead's events end at the first idle gap of LEAD_SPLIT_US (from
    the end of the events before); a trace that lost the lead whole is
    read whole, and a gap shorter than the split cuts nothing."""
    from ipmzoo_tpu_torch.utils.timer import LEAD_SPLIT_US, after_lead
    lead = [("k", 0.0, 5.0), ("m", 6.0, LEAD_SPLIT_US)]
    # the gap after "m" starts at its end, not at its start
    calls = [("k", 2 * LEAD_SPLIT_US + 6.0, 5.0),
             ("m", 2 * LEAD_SPLIT_US + 12.0, 1.0)]
    assert after_lead(lead + calls) == calls
    assert after_lead(calls) == calls
    near = [("k", 0.0, 1.0), ("k", LEAD_SPLIT_US, 1.0)]
    assert after_lead(near) == near


def test_device_calls_reads_only_a_whole_trace(monkeypatch, capsys):
    """Two kernels a call: the lead is cut off, an empty trace and one
    that lost a launch are taken again (said), and the whole one is read
    per call; where all five lost launches, the last is divided by the
    calls its longest kernel counts and marked not whole; where all five
    are empty, LostLaunches is raised."""
    from ipmzoo_tpu_torch.utils import timer
    lead = [("a", 0.0, 1.0), ("b", 2.0, 3.0)]
    gap = 5.0 + timer.LEAD_SPLIT_US
    calls = [(name, gap + 10.0 * i, us) for i in range(4)
             for name, us in (("a", 1.0), ("b", 3.0))]
    fake_card(monkeypatch, [[], lead + calls[1:], lead + calls])
    ran = []
    got = device_calls(lambda: ran.append(1), calls=4)
    assert len(ran) == 1 + 3 * (1 + 4)
    assert got.ms == pytest.approx(4.0 / 1e3) and got.launches == 2.0
    assert [k for k, _, _ in got.kernels] == ["b", "a"] and got.whole
    assert capsys.readouterr().out.count("taken again") == 2
    # "a" lost one launch of four; "b", the longest, counts four calls
    fake_card(monkeypatch, [calls[1:]] * (1 + timer.TRACE_RETAKES))
    got = device_calls(lambda: None, calls=4)
    assert not got.whole and got.launches == 7 / 4
    assert got.ms == pytest.approx((3 * 1.0 + 4 * 3.0) / 4 / 1e3)
    assert "no whole trace" in capsys.readouterr().out
    fake_card(monkeypatch, [[]] * (1 + timer.TRACE_RETAKES))
    with pytest.raises(timer.LostLaunches, match="traces lost launches"):
        device_calls(lambda: None, calls=4)


@pytest.mark.parametrize("bad", [{"whole": False},
                                 {"device_ms": float("nan")},
                                 {"launches": 0.0}, {"syncs": float("nan")}])
def test_step_60_refuses_a_row_not_measured(bad):
    """chip_smoke.py's step 60 passes rows read from whole traces and
    fails one read from a lossy trace, one not measured or one that
    launched nothing."""
    import chip_smoke
    row = {"batch": 1, "key": "step", "row": "FULL STEP", "device_ms": 0.7,
           "launches": 244.0, "whole": True, "syncs": 0.0}
    chip_smoke.measured([row, {"key": "sum", "device_ms": 0.7,
                               "launches": 201.0, "whole": True}], "arrow")
    with pytest.raises(AssertionError, match="arrow row 1 FULL STEP"):
        chip_smoke.measured([{**row, **bad}], "arrow")


def test_rounds_time_the_calls_in_turns(monkeypatch):
    """One untimed call of each, then each once a round; a call's times
    are its own."""
    from ipmzoo_tpu_torch.utils import timer
    order = []

    def fake(fn, runs, warmup):
        assert (runs, warmup) == (1, 0)
        fn()
        return timer._timing([float(len(order))])

    monkeypatch.setattr(timer, "cuda_time", fake)
    a, b = (lambda: order.append("a")), (lambda: order.append("b"))
    ta, tb = cuda_time_rounds([a, b], rounds=3)
    assert order == ["a", "b"] + ["a", "b"] * 3
    assert ta.times == [3.0, 5.0, 7.0] and tb.times == [4.0, 6.0, 8.0]
    assert ta.ms == 5.0 and tb.spread == 4.0
    order.clear()
    cuda_time_rounds([a, b], rounds=1, warmup=False)
    assert order == ["a", "b"]


def test_tools_load_no_jax_and_exit_2_without_a_card():
    code = textwrap.dedent(f"""
        import sys
        import torch
        import chip_arrow_phases, chip_compact_sched, chip_normal_probe
        if not torch.cuda.is_available():
            assert chip_arrow_phases.main([]) == 2
            assert chip_normal_probe.main([]) == 2
            assert chip_compact_sched.main([]) == 2
        s, d = chip_arrow_phases.setup(*{AP}, dtype=torch.float64,
                                       device="cpu")
        assert len(chip_arrow_phases.phases(s, d)) == 10
        assert len(chip_normal_probe.steps(8, 2, 1, torch.float64,
                                           "cpu")) == 8
        s, d = chip_compact_sched.setup(64, 4, 2, torch.float64, "cpu")
        assert len(chip_compact_sched.schedules(s, 64)) == 4
        loaded = [m for m in sys.modules
                  if m in ("jax", "jaxlib", "ipmzoo_tpu", "bench", "tools")
                  or m.startswith(("jax.", "jaxlib.", "ipmzoo_tpu.",
                                   "tools."))]
        assert "ipmzoo_tpu_torch.models.arrow" in sys.modules
        print("LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
