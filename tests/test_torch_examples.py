"""The port's example twins (examples/torch_*.py) against the JAX
package's examples (examples/*.py) at small sizes on the CPU: each twin's
``main`` returns what it prints, and each reference example's printed
lines are parsed."""

import contextlib
import importlib.util
import io
import os
import re
import sys

import pytest
import torch_host  # noqa: F401  (this worker's share of the host)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _reference(name, argv=None, *args):
    """Run the JAX package's example ``name`` (its ``main`` reads
    ``sys.argv`` where ``argv`` is given) and return its stdout."""
    mod = _load(name)
    saved = sys.argv
    if argv is not None:
        sys.argv = [f"{name}.py"] + [str(a) for a in argv]
    try:
        return _run(mod.main, *args)[1]
    finally:
        sys.argv = saved


def _line(text, prefix):
    [line] = [l for l in text.splitlines() if l.strip().startswith(prefix)]
    return line


def test_portfolio():
    ours, text = _run(_load("torch_batch_portfolio").main, 64, 8,
                      device="cpu")
    ref = _reference("batch_portfolio", [64, 8])
    assert _line(text, "backend:") == _line(ref, "backend:")
    # converged share, mean iterations and median gap at printed precision
    assert _line(text, "converged:") == _line(ref, "converged:")
    assert ours["converged"] == 1.0 and ours["budget_residual"] <= 1e-8
    m = re.search(r"budget residual (\S+)", ref)
    assert float(m.group(1)) <= 1e-8


_ARROW = re.compile(r"(structured|dense):\s+converged=(\w+) in (\d+) "
                    r"iterations, objective (\S+)")


def test_arrow():
    ours, text = _run(_load("torch_arrow_chain").main, 96, device="cpu")
    ref = _reference("arrow_chain", None, 96)
    assert _line(text, "detected") == _line(ref, "detected")
    got = {m[0]: m[1:] for m in _ARROW.findall(ref)}
    for kind, key in (("structured", ""), ("dense", "dense_")):
        conv, iters, obj = got[kind]
        assert conv == "True" and ours[f"{key}converged"]
        assert ours[f"{key}iterations"] == int(iters)
        # float32 at tol 1e-5: objectives of |f| ~ 25 agree to 1e-6
        # relative (one float32 ulp there is 1.9e-6)
        assert abs(ours[f"{key}objective"] - float(obj)) <= \
            1e-6 * (1 + abs(float(obj)))
    assert ours["max_dx"] <= 1e-3


_GRID = re.compile(r"nd:\s+converged=(\w+) iters=(\d+).*\n.*dense: "
                   r"converged=(\w+) iters=(\d+).*\n.*max\|x_nd - x_dense\| "
                   r"= (\S+)")


@pytest.mark.parametrize("side,nd_fallback,mode", [
    (12, True, "ldlt"),     # n = 144 < 192: both packages take 'ldlt'
    (16, False, "nd"),      # the nd plan itself on both sides
])
def test_grid(side, nd_fallback, mode):
    ours, text = _run(_load("torch_grid_qp").main, side, device="cpu",
                      nd_fallback=nd_fallback)
    ref = _reference("grid_qp", None, side)
    assert ours["mode"] == mode and f"path taken: '{mode}'" in text
    # the plan line is the reference's
    assert _line(text, "grid ") == _line(ref, "grid ")
    conv, iters, dconv, diters, dx = _GRID.search(ref).groups()
    assert conv == dconv == "True"
    assert ours["nd_converged"] and ours["dense_converged"]
    assert ours["nd_iterations"] == int(iters)
    assert ours["dense_iterations"] == int(diters)
    assert float(dx) <= 1e-6 and ours["max_dx"] <= 1e-6


def test_grid_default_side_falls_back():
    """At the default side 24 the card's fitted cost model falls back
    to the dense auto rule's 'blockg', where the JAX package's constants
    keep nd: the twin says which path it took."""
    ours, text = _run(_load("torch_grid_qp").main, device="cpu")
    assert ours["n"] == 576 and ours["mode"] == "blockg"
    assert "path taken: 'blockg'" in text
    assert ours["nd_converged"] and ours["dense_converged"]
    assert ours["max_dx"] <= 1e-6


_SCHUR = re.compile(r"converged: (\w+) in (\d+) iterations")


def test_schur():
    ours, text = _run(_load("torch_distributed_schur").main, 16, 4,
                      device="cpu")
    # the reference on the test session's 8 virtual devices, the port at
    # world 1
    ref = _reference("distributed_schur", [16, 4])
    assert "devices: 8" in ref and "devices: 1" in text
    conv, iters = _SCHUR.search(ref).groups()
    assert ours["converged"] == (conv == "True") and ours["converged"]
    # the escalation-parity decision: iterations within 2
    assert abs(ours["iterations"] - int(iters)) <= 2
    assert ours["two_float"]
    assert ours["coupling"] <= 1e-6
    m = re.search(r"coupling feasibility: (\S+)", ref)
    assert float(m.group(1)) <= 1e-6


def test_schur_two_ranks():
    """The Schur twin started as two processes by the launch variables
    (gloo on the CPU) spans both ranks and gives the one-rank answer."""
    import socket
    import subprocess
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    script = os.path.join("examples", "torch_distributed_schur.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "16", "4", "--device", "cpu"], cwd=ROOT,
        env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    one, _ = _run(_load("torch_distributed_schur").main, 16, 4, device="cpu")
    text = outs[0][0]
    assert "devices: 2, blocks: 16 x 4 vars" in text
    assert outs[1][0] == ""     # only the primary rank prints
    conv, iters = _SCHUR.search(text).groups()
    assert conv == "True" and int(iters) == one["iterations"]
