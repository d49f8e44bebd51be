"""Front ends (counterpart of :mod:`ipmzoo_tpu.frontend`): the CLI demos
(:mod:`.cli`, ``python -m ipmzoo_tpu_torch.frontend.cli``), the LaTeX
emitters (:mod:`.latex`) and the static derivation-explorer site
(:mod:`.web`)."""

from .latex import (NewtonSystemLatex, NewtonSystemsLatex,
                    render_first_order_conditions, render_lagrangian,
                    render_newton_system, render_newton_systems,
                    render_problem)

__all__ = ["NewtonSystemLatex", "NewtonSystemsLatex",
           "render_first_order_conditions", "render_lagrangian",
           "render_newton_system", "render_newton_systems",
           "render_problem"]
