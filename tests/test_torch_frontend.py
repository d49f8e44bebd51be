"""The port's front ends (ipmzoo_tpu_torch.frontend) against the JAX
package's: the LaTeX golden cases, the derivation explorer's data and page
for every formulation key, the CLI's output flag for flag (on the CPU in
float64), and the CLI's own ``--device``."""

import contextlib
import gzip
import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.frontend import cli as ref_cli
from ipmzoo_tpu.frontend import web as ref_web
from ipmzoo_tpu_torch.formulations import (Bounds, EqualityHandling,
                                           InequalityHandling, ProblemStage,
                                           Settings)
from ipmzoo_tpu_torch.frontend import cli, web
from ipmzoo_tpu_torch.frontend.latex import (render_first_order_conditions,
                                             render_lagrangian,
                                             render_newton_systems,
                                             render_problem)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LATEX_GOLDEN = os.path.join(ROOT, "tests", "golden", "latex_strings.json.gz")


def _latex_cases():
    with gzip.open(_LATEX_GOLDEN, "rt") as f:
        return json.load(f)


@pytest.mark.parametrize("key", sorted(_latex_cases()))
def test_latex_golden(key):
    gold = _latex_cases()[key]
    ib, vb, eq, eh, ih = key.split("|")
    st = Settings(inequalities=Bounds(ib), variable_bounds=Bounds(vb),
                  equalities=eq == "1",
                  equality_handling=EqualityHandling(eh),
                  inequality_handling=InequalityHandling(ih))
    assert render_problem(st, ProblemStage.SLACKED) == gold["problem_slacked"]
    assert render_problem(st, ProblemStage.SLACKED_WITH_BARRIERS) == \
        gold["problem_barrier"]
    assert render_lagrangian(st) == gold["lagrangian"]
    assert render_first_order_conditions(st) == gold["kkt"]
    systems = render_newton_systems(st)
    for name in ("full", "augmented", "normal"):
        s = getattr(systems, name)
        for field in ("lhs", "rhs", "rhs_shorthand", "variables",
                      "delta_definitions"):
            assert getattr(s, field) == gold[name][field], \
                f"{name}.{field} mismatch"


def _keys():
    """The 336 keys of the formulation lattice, as ``build_derivations``
    makes them."""
    keys = []
    for ib in Bounds:
        for vb in Bounds:
            for eq in (False, True):
                for eh in (web._EQ if eq else ["none"]):
                    for ih in InequalityHandling:
                        keys.append(web._key(ib.value, vb.value, eq, eh,
                                             ih.value))
    return keys


@pytest.fixture(scope="module")
def derivations():
    return web.build_derivations(), ref_web.build_derivations()


def test_lattice_has_336_keys(derivations):
    ours, ref = derivations
    assert len(_keys()) == 336
    assert list(ours) == list(ref) == _keys()


@pytest.mark.parametrize("key", _keys())
def test_derivation_equals_reference(derivations, key):
    ours, ref = derivations
    assert "error" not in ours[key]
    assert ours[key] == ref[key]


def test_page_equals_reference():
    assert web._PAGE == ref_web._PAGE


def test_generate_site(tmp_path, derivations):
    out = tmp_path / "site"
    web.generate_site(str(out))
    assert sorted(os.listdir(out)) == ["derivations.json", "index.html"]
    assert (out / "index.html").read_text() == ref_web._PAGE
    with open(out / "derivations.json") as f:
        data = json.load(f)
    assert data == derivations[1]
    sample = data["both|both|0|none|slacked_slacks"]
    assert sample["systems"]["augmented"]["lhs"]


def test_dim_zeros_toggle_wired():
    page = web._PAGE
    assert 'id="dim_zeros" checked' in page
    assert "function dimZeros" in page
    assert r"{\\color{lightgray}0}" in page
    assert page.count("dimZeros(s.lhs)") == 1
    assert 'getElementById("dim_zeros").addEventListener' in page


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("flags", [["-b"], ["-o"], ["--latex"], ["-e"],
                                   ["-n"]], ids=lambda f: f[0])
def test_cli_stdout_equals_reference(flags):
    rc, ours = _stdout(cli.main, flags + ["--device", "cpu"])
    rc_ref, ref = _stdout(ref_cli.main, flags)
    assert rc == rc_ref == 0
    assert ours.splitlines() == ref.splitlines()


def test_cli_numerical_demo_values():
    _, out = _stdout(cli.main, ["-n", "--device", "cpu"])
    rows = [l for l in out.splitlines() if " x = (" in l]
    assert [r.split()[0] for r in rows] == [h.value for h in
                                            InequalityHandling]
    assert [int(r.split("iters = ")[1].split(",")[0]) for r in rows] == \
        [7, 12, 12]
    assert all(r.endswith("converged = True") for r in rows)


def test_cli_web(tmp_path):
    out = tmp_path / "site"
    rc, text = _stdout(cli.main, ["--web", str(out)])
    assert rc == 0 and text == f"wrote derivation explorer to {out}\n"
    assert (out / "index.html").read_text() == ref_web._PAGE


def test_cli_module_runs_without_jax():
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["cli", "-n", "--device", "cpu"]
        try:
            runpy.run_module("ipmzoo_tpu_torch.frontend.cli",
                             run_name="__main__", alter_sys=True)
        except SystemExit as e:
            assert not e.code, e.code
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
    assert "slacked_slacks  x = (1.2000000000, 0.0000000000)" in out.stdout
    assert "LOADED []" in out.stdout, out.stdout


def test_cli_without_a_card_refuses(capsys):
    if torch.cuda.is_available():
        pytest.skip("the default device is usable on this host")
    assert cli.main(["-n"]) == 2
    captured = capsys.readouterr()
    assert "Numerical optimization" not in captured.out
    assert "CUDA card" in captured.err and "--device cpu" in captured.err
    assert cli.main(["-e"]) == 2
