"""The port's own symbolic and formulation layers
(ipmzoo_tpu_torch.symbolic / .formulations): they reproduce the golden
Newton systems term for term, share no classes with the JAX package's
layers, and the port never loads that package or jax."""

import dataclasses
import gzip
import itertools
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest
import torch

import ipmzoo_tpu.formulations as ref_f
from ipmzoo_tpu_torch.formulations import (Bounds, EqualityHandling,
                                           InequalityHandling, Settings,
                                           augmented_system, newton_system,
                                           normal_equations, shorthand_rhs)
from ipmzoo_tpu_torch.models import CompiledIPM, FusedBatchedIPM
from ipmzoo_tpu_torch.models.convert import settings_from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "newton_systems.json.gz")

with gzip.open(GOLDEN, "rt") as f:
    CASES = json.load(f)


def _settings(d) -> Settings:
    return Settings(
        inequalities=Bounds(d["inequalities"]),
        variable_bounds=Bounds(d["variable_bounds"]),
        equalities=d["equalities"],
        equality_handling=EqualityHandling(d["equality_handling"]),
        inequality_handling=InequalityHandling(d["inequality_handling"]),
    )


def _render_system(ns):
    return {
        "lhs": [[e.to_string(True) for e in row] for row in ns.lhs],
        "rhs": [e.to_string(True) for e in ns.rhs],
        "variables": [v.to_string(True) for v in ns.variables],
        "delta_definitions": [[dv.to_string(True), dd.to_string(True)]
                              for dv, dd in ns.delta_definitions],
    }


def _case_id(case):
    s = case["settings"]
    return (f"i={s['inequalities']},v={s['variable_bounds']},"
            f"e={s['equalities']},eh={s['equality_handling']},"
            f"ih={s['inequality_handling']}")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_newton_parity(case):
    assert "error" not in case, "golden case failed in reference"
    settings = _settings(case["settings"])

    full = newton_system(settings)
    assert _render_system(full) == case["full"]

    sh = shorthand_rhs(full)
    assert [e.to_string(True) for e in sh.shorthand_rhs] == \
        case["shorthand_rhs"]
    assert [[v.to_string(True), d.to_string(True)]
            for v, d in sh.vector_definitions] == case["shorthand_defs"]

    aug = augmented_system(full)
    assert _render_system(aug) == case["augmented"]

    normal = normal_equations(full)
    assert _render_system(normal) == case["normal"]


def test_the_two_packages_share_no_classes():
    assert Settings is not ref_f.Settings
    assert Bounds is not ref_f.Bounds
    assert Bounds.BOTH != ref_f.Bounds.BOTH
    assert InequalityHandling.SLACKS != ref_f.InequalityHandling.SLACKS
    import ipmzoo_tpu.symbolic.expr as ref_e
    import ipmzoo_tpu_torch.symbolic.expr as port_e
    assert port_e.Expr is not ref_e.Expr and port_e.Kind is not ref_e.Kind


@pytest.mark.parametrize("solver", [CompiledIPM, FusedBatchedIPM])
def test_reference_settings_are_refused(solver):
    with pytest.raises(TypeError, match="settings_from_reference"):
        solver(ref_f.Settings(), 2, 1, device="cpu")
    # the port's own pass
    solver(settings_from_reference(ref_f.Settings()), 2, 1, device="cpu")


def _lattice(mod):
    for i, v, e, eh, ih in itertools.product(
            mod.Bounds, mod.Bounds, (False, True), mod.EqualityHandling,
            mod.InequalityHandling):
        yield mod.Settings(inequalities=i, variable_bounds=v, equalities=e,
                           equality_handling=eh, inequality_handling=ih)


def test_settings_from_reference_round_trips_the_lattice():
    import ipmzoo_tpu_torch.formulations as port_f
    refs, ports = list(_lattice(ref_f)), list(_lattice(port_f))
    assert len(refs) == len(ports) >= len(CASES)
    fields = [f.name for f in dataclasses.fields(Settings)]
    assert fields == [f.name for f in dataclasses.fields(ref_f.Settings)]
    for r, p in zip(refs, ports):
        got = settings_from_reference(r)
        assert type(got) is Settings and got == p
        for name in fields:
            a, b = getattr(got, name), getattr(r, name)
            assert getattr(a, "name", a) == getattr(b, "name", b)
            assert getattr(a, "value", a) == getattr(b, "value", b)
        # the port's own Settings and a stand-in with the same fields
        assert settings_from_reference(p) == p
        assert settings_from_reference(types.SimpleNamespace(
            **{n: getattr(r, n) for n in fields})) == p


def test_settings_from_reference_rejects_what_it_cannot_read():
    with pytest.raises(AttributeError):
        settings_from_reference(types.SimpleNamespace(equalities=True))
    src = {f.name: getattr(ref_f.Settings(), f.name)
           for f in dataclasses.fields(ref_f.Settings)}
    src["inequalities"] = types.SimpleNamespace(name="SOMETIMES")
    with pytest.raises(KeyError):
        settings_from_reference(types.SimpleNamespace(**src))


def test_port_solves_without_jax_or_the_jax_package():
    code = textwrap.dedent("""
        import sys
        import ipmzoo_tpu_torch as p
        d = p.QPData.make(Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
                          A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0],
                          u_A_ineq=[1.2], l_x=[0, 0], u_x=[10, 10],
                          device="cpu")
        r = p.CompiledIPM(p.Settings(), n=2, m_ineq=1,
                          device="cpu").solve(d)
        assert bool(r.converged) and abs(float(r.objective) + 11.28) < 1e-6
        import numpy as np
        Q = np.diag(np.full(20, 3.0)) + np.diag(np.full(19, 0.5), 1) + \\
            np.diag(np.full(19, 0.5), -1)
        Q[-1, :-1] = Q[:-1, -1] = 0.1
        a, st, _ = p.ArrowQPData.from_dense(
            Q, np.linspace(-1, 1, 20), -np.ones(20), np.ones(20),
            device="cpu")
        for method in ("scan", "cr", "pl"):
            assert bool(p.ArrowIPM.for_data(a, structure=st, method=method)
                        .solve(a).converged)
        loaded = [m for m in sys.modules
                  if m in ("jax", "jaxlib", "ipmzoo_tpu")
                  or m.startswith(("jax.", "jaxlib.", "ipmzoo_tpu."))]
        print("LOADED", loaded)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_module_of_the_port_imports_the_jax_package():
    """Source check: only docstring cross-references name ipmzoo_tpu."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|ipmzoo_tpu)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "chip_profile.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "ipmzoo_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    hits = []
    for path in files:
        with open(path) as fh:
            hits += [f"{path}: {line.strip()}" for line in fh
                     if pat.match(line)]
    assert hits == []


def test_default_device_is_the_card():
    """Without a CUDA device the entry points raise unless told 'cpu'."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    from ipmzoo_tpu_torch.models import ArrowIPM, ArrowQPData, QPData
    from ipmzoo_tpu_torch.models import convert
    from ipmzoo_tpu_torch.parallel import SchurIPM
    import numpy as np
    s = Settings()
    for make in (lambda **kw: CompiledIPM(s, 2, 1, **kw),
                 lambda **kw: FusedBatchedIPM(s, 2, 1, **kw),
                 lambda **kw: SchurIPM(2, 1, **kw),
                 lambda **kw: ArrowIPM(4, 8, 1, **kw),
                 lambda **kw: QPData.make(Q=np.eye(2), c=np.zeros(2), **kw),
                 lambda **kw: ArrowQPData.from_dense(
                     np.eye(8), np.zeros(8), -np.ones(8), np.ones(8), **kw),
                 lambda **kw: convert.make_batch(2, 3, 1, torch.float64,
                                                 **kw),
                 lambda **kw: convert.qpdata_from_numpy(
                     QPData.make(Q=np.eye(2), c=np.zeros(2), device="cpu"),
                     **kw)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()
        make(device="cpu")
