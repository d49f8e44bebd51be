"""The nd auto-fallback's cost model (ops/ndiss.py) and the tool that
fits it on the card (chip_nd_crossover.py), on the CPU.

The port's six constants are the card's fit (``chip_nd_crossover.
CARD_FIT``), with a constant term for the nd step's own floor that the
JAX package's form lacks; ``ops/ndiss.py:REFERENCE_CONSTANTS`` are the
JAX package's five with that term at zero, and give its predictions
exactly.  Under the default every row the card measured outside the
noise band is decided as measured (PERF.md's nd tables).  The tool's fit
is held to constants it must recover from rows the model itself
generates (rtol 1e-6), and to a term it must drop; its per-side
measurement runs at side 14, on the grid's plan and on a dense pattern's,
with the timer replaced, as ``tests/test_torch_bench.py`` replaces
bench_torch's.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ipmzoo_tpu.ops import ndiss as ref_nd
from ipmzoo_tpu_torch.ops import ndiss
from ipmzoo_tpu_torch.ops.ndiss import (REFERENCE_CONSTANTS,
                                        cost_model_constants,
                                        cost_model_times)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402
import chip_nd_crossover as tool  # noqa: E402
from test_torch_ndiss import banded_qd, grid_spd  # noqa: E402

#: the JAX package's five names, and the port's six
NAMES = ("ND_T_LEVEL", "ND_FLOP_RATE", "DENSE_T_FLOOR", "DENSE_A",
         "DENSE_B")
NAMES6 = ("ND_T_STEP",) + NAMES


def reference_constants():
    return {k: getattr(ref_nd, k) for k in NAMES}


def test_default_constants_are_the_reference_and_the_card_fit_differs():
    """The default is the card's six-constant fit; REFERENCE_CONSTANTS are
    the JAX package's five with ND_T_STEP = 0, and every one of the card's
    differs from them."""
    ours, ref = cost_model_constants(), reference_constants()
    assert ours == tool.CARD_FIT
    assert tuple(ours) == NAMES6 == ndiss.COST_MODEL_NAMES
    assert REFERENCE_CONSTANTS == dict(ref, ND_T_STEP=0.0)
    assert ours["ND_T_STEP"] > 0
    for k in NAMES:
        assert tool.CARD_FIT[k] != ref[k], k


@pytest.mark.parametrize("make", [lambda: grid_spd(16, seed=2),
                                  lambda: banded_qd(200, 3, seed=1)],
                         ids=["grid", "banded"])
def test_predicted_speedup_takes_other_constants(make):
    A = make()
    plan = ndiss.nd_plan(A != 0, leaf=16)
    ref = ref_nd.nd_predicted_speedup(ref_nd.nd_plan(A != 0, leaf=16))
    assert ndiss.nd_predicted_speedup(plan, REFERENCE_CONSTANTS) == ref
    t_nd, t_dense = cost_model_times(plan.n, len(plan.levels),
                                     plan.flops_nd, tool.CARD_FIT)
    assert ndiss.nd_predicted_speedup(plan) == \
        ndiss.nd_predicted_speedup(plan, tool.CARD_FIT) == \
        t_dense / t_nd != ref


#: (side, n, levels, flops_nd, dense mode) of rows shaped as the sweep's
SHAPES = [(16, 256, 2, 503122, "ldlt"), (24, 576, 3, 1.1e6, "blockg"),
          (32, 1024, 3, 2753834, "blockg"), (48, 2304, 3, 8.7e6, "blockg"),
          (64, 4096, 4, 21112074, "blockg"), (96, 9216, 6, 46795699,
                                              "blockg")]


def rows_from(c, nd_extra=0.0, dense_extra=0.0):
    """Rows whose times the model with constants ``c`` gives exactly, plus
    ``nd_extra`` * flops_nd and ``dense_extra`` * n^2 seconds."""
    rows = []
    for g, n, lv, fl, mode in SHAPES:
        r = {"side": g, "n": n, "levels": lv, "flops_nd": fl,
             "dense_mode": mode}
        t_nd, t_dense = cost_model_times(n, lv, fl, c)
        r["nd_ms"] = (t_nd + nd_extra * fl) * 1e3
        r["dense_ms"] = (t_dense + dense_extra * n * n) * 1e3
        r["measured"] = r["dense_ms"] / r["nd_ms"]
        rows.append(r)
    return rows


#: six constants the fit must recover
KNOWN = {"ND_T_STEP": 6.0e-3, "ND_T_LEVEL": 2.5e-3, "ND_FLOP_RATE": 4.0e10,
         "DENSE_T_FLOOR": 1.5e-3, "DENSE_A": 2.0e-10, "DENSE_B": 3.0e-13}


def test_fit_recovers_known_constants():
    got = tool.fit(rows_from(KNOWN))
    assert tuple(got) == NAMES6
    for k in NAMES6:
        np.testing.assert_allclose(got[k], KNOWN[k], rtol=1e-6, err_msg=k)


def test_fit_keeps_a_dropped_term_at_zero():
    # times that fall with the flops at fixed levels, and with n^2 at
    # fixed n^3: the fit's best nonnegative terms there are zero
    c = dict(KNOWN, ND_FLOP_RATE=float("inf"), DENSE_A=0.0)
    got = tool.fit(rows_from(c, nd_extra=-1e-12, dense_extra=-1e-12))
    assert got["ND_FLOP_RATE"] == float("inf")
    assert got["DENSE_A"] == 0.0
    assert got["ND_T_STEP"] > 0 and got["ND_T_LEVEL"] > 0
    assert got["DENSE_B"] > 0
    # the model's form keeps the dropped terms at zero
    t_nd, t_dense = cost_model_times(4096, 4, 2e7, got)
    assert t_nd == got["ND_T_STEP"] + 4 * got["ND_T_LEVEL"]
    assert t_dense == got["DENSE_T_FLOOR"] + got["DENSE_B"] * 4096.0 ** 3


def test_fit_reports_the_worst_error_per_regime(capsys):
    worst = tool.report_fit(rows_from(KNOWN), KNOWN)
    assert set(worst) == {"nd", "dense 'ldlt'", "dense 'blockg'"}
    assert max(worst.values()) < 1e-12
    out = capsys.readouterr().out
    assert "ND_FLOP_RATE = 40000000000.0" in out
    assert "ND_T_STEP = 0.006" in out
    assert "decided for the slower path: " in out


@pytest.fixture
def stub_timer(monkeypatch):
    """bench_torch.dense_speedup replaced: records its solvers and gives
    2 ms a step for the structured path, 1 ms for dense."""
    seen = []

    def timer(what, solver, data, dense, ddata, device, ks, dks):
        seen.append((solver, dense, ks, dks))
        return 2.0, 1.0
    monkeypatch.setattr(bench_torch, "dense_speedup", timer)
    return seen


def test_measure_side_on_the_cpu(stub_timer):
    r = tool.measure_side(14, torch.device("cpu"))
    (nd, dense, ks, dks), = stub_timer
    assert nd._mode == "nd" and not nd.nd_fell_back
    assert nd._nd_leaf == 64 and nd.tol == dense.tol == 1e-5
    assert nd.dtype == dense.dtype == torch.float32
    assert ks == dks == tool.STEPS
    plan = nd._nd_plan
    assert (r["side"], r["n"]) == (14, 196)
    assert (r["levels"], r["flops_nd"]) == (len(plan.levels),
                                            plan.flops_nd)
    assert (r["nd_ms"], r["dense_ms"], r["measured"]) == (2.0, 1.0, 0.5)
    assert r["dense_mode"] == dense._mode == "ldlt"
    assert r["pattern"] == "grid" and len(plan.levels) > 1
    assert r["predicted_card"] == ndiss.nd_predicted_speedup(plan)
    assert r["predicted_reference"] == ndiss.nd_predicted_speedup(
        plan, REFERENCE_CONSTANTS)


def test_measure_one_level_through_main(stub_timer, tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert tool.main(["--device", "cpu", "--one-level", "--out", str(out),
                      "14"]) == 0
    (nd, dense, _, _), = stub_timer
    assert nd._mode == "nd" and not nd.nd_fell_back
    r, = json.loads(out.read_text())["rows"]
    assert (r["side"], r["n"], r["pattern"], r["levels"]) == \
        (14, 196, "dense", 1)
    assert r["flops_nd"] == nd._nd_plan.flops_nd
    assert "g= 14 n=  196 dense pattern: 1 levels" in \
        capsys.readouterr().out


def test_sweep_then_fit_through_main(stub_timer, tmp_path, capsys):
    out = tmp_path / "rows.json"
    assert tool.main(["--device", "cpu", "--out", str(out), "14"]) == 0
    run = json.loads(out.read_text())
    assert run["card"] == "cpu" and [r["side"] for r in run["rows"]] == [14]
    assert "g= 14 n=  196" in capsys.readouterr().out
    assert tool.main(["--fit", str(out), str(out)]) == 0
    printed = capsys.readouterr().out
    for k in NAMES:
        assert f"{k} = " in printed


def test_the_tool_refuses_a_machine_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert tool.main(["16"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "chip_nd_crossover: no CUDA device" in captured.err


def test_the_card_fit_keeps_the_one_level_plan_the_default_drops():
    """On a dense pattern of order 400 (one level, measured on the card
    at 0.62-0.78x) the default, the card's six-constant fit, falls back
    to 'blockg', as the JAX package's constants do; the card's earlier
    five-constant fit (no ND_T_STEP) kept nd there at 1.955x."""
    from ipmzoo_tpu_torch import CompiledIPM
    from ipmzoo_tpu_torch.models.families import grid_qp
    s = CompiledIPM(grid_qp(side=2, device="cpu").settings, n=400,
                    kernel="nd", nd_pattern=np.ones((400, 400), bool),
                    device="cpu")
    assert s.nd_fell_back and s._mode == "blockg"
    plan = s._nd_plan
    assert len(plan.levels) == 1
    assert ndiss.nd_predicted_speedup(plan) < tool.KEEP
    assert ndiss.nd_predicted_speedup(plan, REFERENCE_CONSTANTS) < tool.KEEP
    five = {"ND_T_STEP": 0.0, "ND_T_LEVEL": 2.6343e-3,
            "ND_FLOP_RATE": float("inf"), "DENSE_T_FLOOR": 5.1424e-3,
            "DENSE_A": 5.1151e-11, "DENSE_B": 8.6522e-15}
    np.testing.assert_allclose(ndiss.nd_predicted_speedup(plan, five),
                               1.955, atol=5e-4)


#: every reading of one nd step against the dense 'auto' step on the card
#: (PERF.md's nd section: an NVIDIA H100 80GB HBM3 at 700.00 W), by plan:
#: (n, levels, flops_nd, measured speedups dense / nd).  Grid plans from
#: the sweeps and chip_smoke.py's step 44, one-level plans (a dense
#: pattern) from ``--one-level``.
CARD_READINGS = {
    "grid16": (256, 2, 503122, (0.764, 0.699, 0.730, 0.714, 0.635, 0.697,
                                0.672)),
    "grid24": (576, 3, 1239260, (0.593, 0.629, 0.596, 0.519, 0.509, 0.607,
                                 0.478)),
    "grid32": (1024, 3, 2753834, (0.526, 0.571, 0.585, 0.516, 0.605, 0.565,
                                  0.628, 0.509, 0.597, 0.631, 0.637,
                                  0.588)),
    "grid48": (2304, 3, 10254118, (0.522, 0.559, 0.595, 0.558, 0.501,
                                   0.462, 0.566)),
    "grid64": (4096, 4, 21112074, (0.529, 0.534, 0.444, 0.560, 0.582, 0.513,
                                   0.488, 0.545, 0.573, 0.520, 0.619,
                                   0.564)),
    "grid80": (6400, 5, 33535606, (0.629, 0.670, 0.608, 0.884, 0.574,
                                   0.570, 0.480)),
    "grid96": (9216, 6, 46795699, (1.122, 1.134, 1.211, 0.910, 1.094, 0.855,
                                   0.988, 1.050, 1.466, 1.270, 0.833,
                                   0.873)),
    "grid112": (12544, 7, 49513331, (2.279, 2.541, 1.537, 2.246, 2.368)),
    "grid128": (16384, 7, 85409712, (2.907, 3.275, 3.028, 3.668, 3.332,
                                     2.927, 3.289)),
    "dense196": (196, 1, 2509845, (0.940, 0.892, 0.812, 0.853, 0.891,
                                   0.818)),
    "dense400": (400, 1, 21333333, (0.687, 0.771, 0.620, 0.711, 0.781,
                                    0.631)),
    "dense1024": (1024, 1, 357913941, (0.630, 0.644, 0.652, 0.621,
                                       0.670, 0.576)),
}


@pytest.mark.parametrize("plan", list(CARD_READINGS))
def test_default_decides_the_card_readings_as_measured(plan):
    """Under the default constants the fallback takes the faster path at
    every reading outside the noise band.  Where one plan's readings lie
    on both sides of the band (grid side 96: 0.833 and 0.855, 1.211-1.466
    three times) no decision suits them all: it must suit the most."""
    n, levels, flops, readings = CARD_READINGS[plan]
    t_nd, t_dense = cost_model_times(n, levels, flops)
    predicted = t_dense / t_nd
    outside = [m for m in readings if not tool.BAND[0] <= m <= tool.BAND[1]]
    wrong = [m for m in outside if tool.decides_wrong(m, predicted)]
    assert outside
    assert 2 * len(wrong) < len(outside), (plan, predicted, wrong)
    if min(outside) > tool.BAND[1] or max(outside) < tool.BAND[0]:
        assert not wrong, (plan, predicted, wrong)
    if plan in ("grid112", "grid128", "grid96"):
        assert predicted >= tool.KEEP
    else:
        assert predicted < tool.KEEP
