"""Command-line demos (the port's counterpart of
:mod:`ipmzoo_tpu.frontend.cli`, with the same flags):

  -b / --basic     expression building, differentiation, simplification
  -o / --optimization   symbolic pipeline: problem -> KKT -> Newton ->
                        augmented -> normal equations, with boxed matrices
  -e / --evaluation     staged numeric evaluation examples
  -n / --numerical      end-to-end IPM solve of the demo QP
  (default: all)

  --latex          print the LaTeX derivation bundle for default settings
  --web DIR        generate the static derivation-explorer web page

and one flag of its own:

  --device DEV     where -e and -n compute (default: the CUDA card; without
                   one they refuse, so pass ``--device cpu`` on a host
                   without a card)

    python -m ipmzoo_tpu_torch.frontend.cli [-b] [-o] [-e] [-n] [--latex]
        [--web DIR] [--device cpu]

Numbers print through numpy, so on the CPU in float64 the output equals
the JAX package's CLI line for line.
"""

from __future__ import annotations

import argparse
import sys


def print_header(title: str) -> None:
    print("=" * 70)
    print(f"  {title}")
    print("=" * 70)


def run_basic_examples() -> None:
    from ..symbolic import (log, named_scalar, named_vector, number,
                            product, sum_expr, symmetric_matrix, transpose,
                            variable)
    print_header("Expression examples")
    x = variable("x")
    Q = symmetric_matrix("Q")
    c = named_vector("c")
    mu = named_scalar("\\mu")
    e = named_vector("e")

    obj = sum_expr([product([number(0.5), transpose(x), Q, x]),
                    product([transpose(c), x]),
                    product([number(-1), mu, transpose(e), log(x)])])
    print(f"objective:      {obj.to_string(True)}")
    d = obj.differentiate(x).simplify()
    print(f"d/dx:           {d.to_string(True)}")

    y = variable("y")
    expr = sum_expr([product([Q, x]), product([Q, y])]).simplify()
    print(f"Qx + Qy =       {expr.to_string(True)}")
    expr = (x - x).simplify()
    print(f"x - x =         {expr.to_string(True)}")


def _boxed(rows) -> str:
    widths = [max(len(r[j]) for r in rows) for j in range(len(rows[0]))]
    lines = []
    for r in rows:
        cells = "  ".join(c.ljust(w) for c, w in zip(r, widths))
        lines.append(f"| {cells} |")
    return "\n".join(lines)


def run_symbolic_optimization(settings=None) -> None:
    from ..formulations import (Settings, augmented_system, newton_system,
                                normal_equations, shorthand_rhs)
    settings = settings or Settings()
    print_header("Symbolic optimization pipeline")
    full = newton_system(settings)
    print(f"variables: {', '.join(v.to_string(True) for v in full.variables)}")
    print("\nFull Newton system lhs:")
    print(_boxed([[c.to_string(True) for c in row] for row in full.lhs]))
    sh = shorthand_rhs(full)
    print("\nShorthand rhs definitions:")
    for vec, d in sh.vector_definitions:
        print(f"  {vec.to_string(True)} = {d.to_string(True)}")
    aug = augmented_system(full)
    print("\nAugmented system lhs:")
    print(_boxed([[c.to_string(True) for c in row] for row in aug.lhs]))
    print("\nDelta definitions (back-substitution, applied in reverse):")
    for dvar, ddef in aug.delta_definitions:
        print(f"  {dvar.to_string(True)} = {ddef.to_string(True)}")
    normal = normal_equations(full)
    print("\nNormal equations lhs:")
    print(_boxed([[c.to_string(True) for c in row] for row in normal.lhs]))


def run_evaluation_examples(device=None) -> None:
    """The staged evaluator (``models/codegen.py``) on float64 tensors of
    ``device`` (default: the CUDA card)."""
    import torch
    from ..models import codegen as cg
    from ..symbolic import (number, product, symmetric_matrix, transpose,
                            variable)
    from ..utils.device import resolve_device
    dev = resolve_device(device)

    def arr(v):
        return torch.tensor(v, dtype=torch.float64, device=dev)

    print_header("Staged evaluation examples")
    x = variable("x")
    Q = symmetric_matrix("Q")
    env = {
        x: cg.vector(arr([1.0, 2.0, 3.0])),
        Q: cg.matrix(arr([[2.0, 1.0, 0.0], [1.0, 3.0, 1.0],
                          [0.0, 1.0, 4.0]])),
    }
    expr = product([number(0.5), transpose(x), Q, x])
    val = cg.evaluate(expr, env)
    print(f"x = {_np(env[x].val)},  Q = \n{_np(env[Q].val)}")
    print(f"1/2 x^T Q x = {_np(val.val)}")
    qx = cg.evaluate(product([Q, x]), env)
    print(f"Q x = {_np(qx.val)}")


def _np(v):
    """A tensor (or a float) as numpy prints it."""
    return v.cpu().numpy() if hasattr(v, "cpu") else v


def run_numerical_example(device=None) -> None:
    """The demo QP on ``CompiledIPM`` in float64 on ``device`` (default:
    the CUDA card), once for each inequality handling."""
    from ..formulations import InequalityHandling, Settings
    from ..models import CompiledIPM, QPData
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    print_header("Numerical optimization example (demo QP)")
    data = QPData.make(
        Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
        A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0], u_A_ineq=[1.2],
        l_x=[0.0, 0.0], u_x=[10.0, 10.0], device=dev)
    print("minimize 1/2 x^T diag(1, 0.5) x + (-10, 2)^T x")
    print("s.t.  1 <= x1 + x2 <= 1.2,  0 <= x <= 10")
    for ih in InequalityHandling:
        solver = CompiledIPM(Settings(inequality_handling=ih), n=2, m_ineq=1,
                             device=dev)
        res = solver.solve(data)
        x = [f"{float(v):.10f}" for v in res.x.cpu().numpy()]
        print(f"  {ih.value:15s} x = ({', '.join(x)}), "
              f"f = {float(res.objective):.8f}, "
              f"iters = {int(res.iterations)}, "
              f"residual = {float(res.residual):.2e}, "
              f"gap = {float(res.gap):.2e}, "
              f"converged = {bool(res.converged)}")


def run_latex(settings=None) -> None:
    from ..formulations import Settings
    from .latex import (render_lagrangian, render_newton_systems,
                        render_problem)
    settings = settings or Settings()
    print("% problem")
    print(render_problem(settings))
    print("% lagrangian")
    print(render_lagrangian(settings))
    systems = render_newton_systems(settings)
    for name in ("full", "augmented", "normal"):
        ns = getattr(systems, name)
        print(f"% {name} newton system lhs")
        print(ns.lhs)
        print(f"% {name} rhs (shorthand)")
        print(ns.rhs_shorthand)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ipmzoo-tpu-torch",
        description="symbolic + numerical IPM framework demos (PyTorch/CUDA "
                    "port)")
    parser.add_argument("-b", "--basic", action="store_true",
                        help="expression/differentiation examples")
    parser.add_argument("-o", "--optimization", action="store_true",
                        help="symbolic derivation pipeline")
    parser.add_argument("-e", "--evaluation", action="store_true",
                        help="staged numeric evaluation examples")
    parser.add_argument("-n", "--numerical", action="store_true",
                        help="end-to-end IPM solve of the demo QP")
    parser.add_argument("--latex", action="store_true",
                        help="LaTeX derivation bundle for default settings")
    parser.add_argument("--web", metavar="DIR",
                        help="generate the static derivation web page")
    parser.add_argument("--device", default=None,
                        help="device of -e and -n (default: the CUDA card; "
                             "'cpu' on a host without one)")
    args = parser.parse_args(argv)

    any_flag = any([args.basic, args.optimization, args.evaluation,
                    args.numerical, args.latex, args.web])
    if args.web:
        from .web import generate_site
        generate_site(args.web)
        print(f"wrote derivation explorer to {args.web}")
        return 0
    if args.latex:
        run_latex()
        return 0
    device = None
    if args.evaluation or args.numerical or not any_flag:
        from ..utils.device import resolve_device
        try:
            device = resolve_device(args.device)
        except (RuntimeError, AssertionError) as e:
            print(f"ipmzoo-tpu-torch: the numeric demos run on the CUDA card "
                  f"by default and none is usable ({e}); pass --device cpu "
                  f"to run them on the CPU", file=sys.stderr)
            return 2
    if args.basic or not any_flag:
        run_basic_examples()
    if args.optimization or not any_flag:
        run_symbolic_optimization()
    if args.evaluation or not any_flag:
        run_evaluation_examples(device)
    if args.numerical or not any_flag:
        run_numerical_example(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
