"""The port's utilities (ipmzoo_tpu_torch/utils): timer, checkpointing,
iteration trace, solve summary.  Mirrors tests/test_utils.py on the
port's CompiledIPM and state containers, and holds the iteration trace
to the reference's record for record."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import InequalityHandling, Settings
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu.utils import IterationTrace as RefTrace
from ipmzoo_tpu_torch.models import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.convert import make_batch
from ipmzoo_tpu_torch.parallel import BlockQPData, SchurIPM
from ipmzoo_tpu_torch.utils import (IterationTrace, Timer, cuda_time,
                                    device_trace, host_time, load_metadata,
                                    load_state, save_state, slope,
                                    solve_summary)

SETTINGS = Settings(inequality_handling=InequalityHandling.SLACKED_SLACKS)
DEMO = dict(Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0], A_ineq=[[1.0, 1.0]],
            l_A_ineq=[1.0], u_A_ineq=[1.2], l_x=[0.0, 0.0],
            u_x=[10.0, 10.0])


def test_timer_sections():
    t = Timer()
    with t.section("a"):
        with t.section("b"):
            pass
    assert t.elapsed("a") >= t.elapsed("b") >= 0
    out = t.report(print_fn=None)
    assert "a:" in out and "b:" in out


def test_checkpoint_roundtrip(tmp_path):
    state = {"x": torch.arange(5.0), "nested": (torch.ones((2, 2)),
                                                torch.tensor(3))}
    path = str(tmp_path / "st.npz")
    save_state(path, state, {"iteration": 7})
    loaded = load_state(path, state)
    assert torch.equal(loaded["x"], state["x"])
    assert torch.equal(loaded["nested"][0], torch.ones((2, 2)))
    assert loaded["nested"][1].dtype == torch.int64
    assert int(loaded["nested"][1]) == 3
    assert load_metadata(path) == {"iteration": 7}
    # plain .npz, no pickle
    with np.load(path, allow_pickle=False) as data:
        assert int(data["__num_leaves__"]) == 3


def test_checkpoint_without_metadata_and_structure_mismatch(tmp_path):
    path = str(tmp_path / "st.npz")
    save_state(path, (torch.zeros(2), torch.ones(3)))
    assert load_metadata(path) is None
    with pytest.raises(ValueError, match="structure mismatch"):
        load_state(path, (torch.zeros(2),))
    with pytest.raises(TypeError, match="unsupported node"):
        save_state(path, [torch.zeros(2)])


@pytest.fixture(scope="module")
def demo_solver():
    return CompiledIPM(port_settings(SETTINGS), 2, 1, device="cpu")


def demo_data():
    return QPData.make(**DEMO, dtype=torch.float64, device="cpu")


def test_iteration_trace_matches_reference_log(demo_solver):
    """The host-stepped trace reproduces the reference's per-iteration
    log line values for the demo QP."""
    records = IterationTrace(demo_solver).run(demo_data())
    assert records[0].iteration == 0
    np.testing.assert_allclose(records[0].objective, -21.25, rtol=1e-10)
    np.testing.assert_allclose(records[0].residual, 14.07409, rtol=1e-5)
    np.testing.assert_allclose(records[0].gap, 1.0, rtol=1e-10)
    # converged end state matches the oracle trace
    assert records[-1].residual < 1e-8 and records[-1].gap < 1e-8
    assert len(records) - 1 == 12


def test_iteration_trace_matches_the_jax_trace_record_for_record(
        demo_solver):
    ref = RefTrace(RefIPM(SETTINGS, 2, 1)).run(
        RefQPData.make(**DEMO, dtype=jnp.float64))
    ours = IterationTrace(demo_solver).run(demo_data())
    assert [r.iteration for r in ours] == [r.iteration for r in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(
            [a.objective, a.residual, a.gap, a.mu],
            [b.objective, b.residual, b.gap, b.mu], rtol=1e-8, atol=1e-12)


def test_iteration_trace_takes_a_batch_of_one_and_no_more(demo_solver):
    one = make_batch(1, 2, 1, torch.float64, device="cpu")
    short = IterationTrace(demo_solver, max_iter=3).run(one)
    assert [r.iteration for r in short] == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="one instance"):
        IterationTrace(demo_solver).run(
            make_batch(2, 2, 1, torch.float64, device="cpu"))


def test_solve_summary(demo_solver, caplog):
    res = demo_solver.solve(demo_data())
    rec = solve_summary(res, log=False)
    assert rec["converged"] is True
    assert rec["iterations"] == 12
    with caplog.at_level("INFO", logger="ipmzoo_tpu_torch"):
        solve_summary(res)
    logged = json.loads(caplog.records[-1].getMessage().split(": ", 1)[1])
    assert logged == rec


def test_solver_state_checkpoint_resume(tmp_path, demo_solver):
    """Solve can be checkpointed mid-run and resumed bitwise."""
    data = demo_solver._check_data(QPData(**{
        k: getattr(demo_data(), k)[None]
        for k in demo_data().__dataclass_fields__}))
    st = demo_solver.init_state(data)
    for _ in range(3):
        st = demo_solver.step(st, data)
    path = str(tmp_path / "ipm.npz")
    save_state(path, st)
    st2 = load_state(path, st)
    assert type(st2) is type(st)
    assert st2.iteration.dtype == torch.int32 and int(st2.iteration[0]) == 3
    a = demo_solver.step(st, data)
    b = demo_solver.step(st2, data)
    for va, vb in zip(a.vars, b.vars):
        assert torch.equal(va, vb)


def test_schur_state_and_fused_warm_state_checkpoint(tmp_path):
    blk = BlockQPData(Q=torch.eye(2, dtype=torch.float64)[None].repeat(
        3, 1, 1), c=torch.ones(3, 2, dtype=torch.float64),
        F=torch.ones(3, 1, 2, dtype=torch.float64),
        l_x=-torch.ones(3, 2, dtype=torch.float64),
        u_x=torch.ones(3, 2, dtype=torch.float64),
        g=torch.zeros(1, dtype=torch.float64))
    solver = SchurIPM(2, 1, device="cpu")
    one = BlockQPData(**{k: getattr(blk, k)[None]
                         for k in blk.__dataclass_fields__})
    st = solver.init_state(one)
    path = str(tmp_path / "schur.npz")
    save_state(path, st, {"engine": "schur"})
    back = load_state(path, st)
    for f in st.__dataclass_fields__:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    warm = {"variables": torch.rand(4, 9), "mu": torch.rand(4),
            "iterations": torch.tensor([1.0, 2.0, 3.0, 4.0])}
    save_state(path, warm)
    back = load_state(path, warm)
    assert back.keys() == warm.keys()
    for k in warm:
        assert torch.equal(back[k], warm[k])


def test_slope_cancels_the_constant():
    assert slope(lambda k: 5.0 + 0.25 * k, 2, 8) == pytest.approx(0.25)
    # noise larger than the difference must not give a negative time
    assert slope(lambda k: 1.0, 2, 8) == 1e-12
    with pytest.raises(ValueError, match="k2 > k1"):
        slope(lambda k: k, 8, 8)


def test_host_time_counts_runs_and_calls():
    calls = []
    t = host_time(lambda: calls.append(1), runs=4, warmup=2, calls=3)
    assert len(calls) == 2 + 4 * 3 and len(t.times) == 4
    assert t.ms == pytest.approx(sorted(t.times)[1:3][0] / 2 +
                                 sorted(t.times)[1:3][1] / 2)
    assert t.spread == pytest.approx(max(t.times) - min(t.times))


def test_cuda_time_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_time(lambda: None)


def test_device_trace(tmp_path):
    with device_trace(None) as prof:
        assert prof is None
    logdir = str(tmp_path / "trace")
    with device_trace(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(os.path.join(logdir, "trace.json")) > 0
    assert len(prof.key_averages()) > 0
