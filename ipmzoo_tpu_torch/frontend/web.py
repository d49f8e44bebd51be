"""Static derivation-explorer web page.

The port's own copy of :mod:`ipmzoo_tpu.frontend.web`: the same page and
the same ``derivations.json``, derived by the port's symbolic layer.  As
in the JAX package it stands in for the C++ original's Emscripten/WASM
page (its ``docs/``): instead of compiling the symbolic engine to WASM
and deriving in the browser, we pre-compute the derivations for the whole
formulation lattice into a JSON bundle and render with MathJax.  Same UI
surface — radio buttons for bounds / handlings, problem / Lagrangian /
KKT / Newton-system views, dimmed matrix zeros option — zero runtime
dependencies beyond a static file server.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..formulations import (Bounds, EqualityHandling, InequalityHandling,
                            ProblemStage, Settings)
from .latex import (render_first_order_conditions, render_lagrangian,
                    render_newton_systems, render_problem)

_BOUNDS = [b.value for b in Bounds]
_INEQ = [h.value for h in InequalityHandling]
# mirror the reference UI, which exposes a subset of equality handlings
# (wasm_bindings.cpp:281-310)
_EQ = ["none", "slacks", "slacked_slacks", "naive_slacks",
       "penalty_function", "regularization"]


def _key(ib, vb, eq, eh, ih) -> str:
    return f"{ib}|{vb}|{int(eq)}|{eh}|{ih}"


def build_derivations() -> dict:
    out = {}
    for ib in Bounds:
        for vb in Bounds:
            for eq in (False, True):
                for eh_name in (_EQ if eq else ["none"]):
                    for ih_name in _INEQ:
                        settings = Settings(
                            inequalities=ib, variable_bounds=vb,
                            equalities=eq,
                            equality_handling=EqualityHandling(eh_name),
                            inequality_handling=InequalityHandling(ih_name))
                        try:
                            systems = render_newton_systems(settings)
                            entry = {
                                "problem": render_problem(
                                    settings, ProblemStage.SLACKED),
                                "barrier_problem": render_problem(
                                    settings,
                                    ProblemStage.SLACKED_WITH_BARRIERS),
                                "lagrangian": render_lagrangian(settings),
                                "kkt": render_first_order_conditions(
                                    settings),
                                "systems": {
                                    name: dataclasses.asdict(
                                        getattr(systems, name))
                                    for name in ("full", "augmented",
                                                 "normal")},
                            }
                        except Exception as e:  # pragma: no cover
                            entry = {"error": str(e)}
                        out[_key(ib.value, vb.value, eq, eh_name,
                                 ih_name)] = entry
    return out


_PAGE = r"""<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>ipmzoo-tpu — interior-point method derivation explorer</title>
<script>
MathJax = {tex: {inlineMath: [['$', '$']]}, svg: {fontCache: 'global'}};
</script>
<script src="https://cdn.jsdelivr.net/npm/mathjax@3/es5/tex-svg.js"></script>
<style>
body { font-family: system-ui, sans-serif; margin: 2em; max-width: 1100px; }
fieldset { display: inline-block; vertical-align: top; margin: 0 1em 1em 0; }
h2 { margin-top: 1.5em; }
#content { margin-top: 1em; }
.section { margin-bottom: 2em; }
</style>
</head>
<body>
<h1>Interior-point method derivation explorer</h1>
<p>Formulations of IPMs for convex quadratic programming, the resulting
Newton systems, and their reductions — derived by the
<code>ipmzoo_tpu</code> symbolic layer and pre-rendered for the whole
formulation lattice.</p>

<fieldset><legend>Inequalities $l_A \leq Ax \leq u_A$</legend>
<div id="ineq"></div></fieldset>
<fieldset><legend>Variable bounds $l_x \leq x \leq u_x$</legend>
<div id="vbounds"></div></fieldset>
<fieldset><legend>Equalities $Cx = d$</legend>
<div id="eq"></div><hr><div id="eqh"></div></fieldset>
<fieldset><legend>Inequality handling</legend>
<div id="ineqh"></div></fieldset>
<fieldset><legend>Visualization</legend>
<label><input type="checkbox" id="dim_zeros" checked> Dim zeros</label></fieldset>

<div id="content">Loading derivations…</div>

<script>
const BOUNDS = ["none", "lower", "upper", "both"];
const INEQH = ["slacks", "slacked_slacks", "naive_slacks"];
const EQH = ["none", "slacks", "slacked_slacks", "naive_slacks",
             "penalty_function", "regularization"];
let DATA = null;
const state = {ib: "both", vb: "both", eq: "0", eh: "none", ih: "slacked_slacks"};

function radios(el, name, values, cur, cb) {
  el.innerHTML = values.map(v =>
    `<label><input type="radio" name="${name}" value="${v}"` +
    `${v === cur ? " checked" : ""}> ${v.replaceAll("_", " ")}</label><br>`
  ).join("");
  el.querySelectorAll("input").forEach(i => i.addEventListener("change",
    e => { cb(e.target.value); render(); }));
}

function init() {
  radios(document.getElementById("ineq"), "ib", BOUNDS, state.ib, v => state.ib = v);
  radios(document.getElementById("vbounds"), "vb", BOUNDS, state.vb, v => state.vb = v);
  radios(document.getElementById("eq"), "eq", ["0", "1"], state.eq, v => state.eq = v);
  radios(document.getElementById("eqh"), "eh", EQH, state.eh, v => state.eh = v);
  radios(document.getElementById("ineqh"), "ih", INEQH, state.ih, v => state.ih = v);
  document.getElementById("dim_zeros").addEventListener("change", render);
  render();
}

// Grey out standalone 0 entries in matrix LaTeX (reference behaviour:
// docs/ipm-derivation.js:24-27 — same regex, same colour).
function dimZeros(str) {
  const useDimmedZeros = document.getElementById("dim_zeros").checked;
  return useDimmedZeros
    ? str.replace(/(\D|^)0(\D|$)/g, '$1{\\color{lightgray}0}$2') : str;
}

function sysBlock(title, s) {
  if (!s.lhs) return `<h3>${title}</h3><p>(empty)</p>`;
  let out = `<h3>${title}</h3>
  $$\\begin{bmatrix} ${dimZeros(s.lhs)} \\end{bmatrix}
    \\begin{bmatrix} ${s.variables.replaceAll("\n", " ")} \\end{bmatrix} =
    \\begin{bmatrix} ${s.rhs_shorthand} \\end{bmatrix}$$`;
  if (s.delta_definitions)
    out += `<p>Back-substitution:</p>$$\\begin{aligned} ${s.delta_definitions} \\end{aligned}$$`;
  return out;
}

function render() {
  const eh = state.eq === "1" ? state.eh : "none";
  const key = [state.ib, state.vb, state.eq === "1" ? "1" : "0", eh, state.ih].join("|");
  const d = DATA[key];
  const el = document.getElementById("content");
  if (!d) { el.innerHTML = "<p>No derivation for this combination.</p>"; return; }
  if (d.error) { el.innerHTML = `<p>Derivation failed: ${d.error}</p>`; return; }
  el.innerHTML = `
  <div class="section"><h2>Slacked problem</h2>
  $$\\begin{aligned} ${d.problem} \\end{aligned}$$</div>
  <div class="section"><h2>Barrier problem</h2>
  $$\\begin{aligned} ${d.barrier_problem} \\end{aligned}$$</div>
  <div class="section"><h2>Lagrangian</h2>
  $$\\begin{aligned} ${d.lagrangian} \\end{aligned}$$</div>
  <div class="section"><h2>First-order optimality conditions</h2>
  $$\\begin{aligned} ${d.kkt} \\end{aligned}$$</div>
  <div class="section">${sysBlock("Newton system", d.systems.full)}</div>
  <div class="section">${sysBlock("Augmented system", d.systems.augmented)}</div>
  <div class="section">${sysBlock("Normal equations", d.systems.normal)}</div>`;
  if (window.MathJax && MathJax.typesetPromise) MathJax.typesetPromise();
}

fetch("derivations.json").then(r => r.json()).then(d => { DATA = d; init(); });
</script>
</body>
</html>
"""


def generate_site(outdir: str) -> None:
    """Write ``index.html`` and ``derivations.json`` into ``outdir`` (made
    if missing), and nowhere else."""
    os.makedirs(outdir, exist_ok=True)
    data = build_derivations()
    with open(os.path.join(outdir, "derivations.json"), "w") as f:
        json.dump(data, f)
    with open(os.path.join(outdir, "index.html"), "w") as f:
        f.write(_PAGE)
