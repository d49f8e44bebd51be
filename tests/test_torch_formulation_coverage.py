"""The port's CompiledIPM across the formulation lattice: the 13 cases of
tests/test_formulation_coverage.py (every inequality handling at three
bound configurations, three equality handlings, naive slacks with
equalities) on its QP with a known optimum, on the CPU in float64.

Each case is held to the scipy SLSQP optimum at the reference's
tolerances (1e-6 for the inequality cases with both bounds, 1e-5 with
equalities, 1e-3 under REGULARIZATION's perturbed optimum) and to the
JAX package's CompiledIPM on the same data: iterations equal, x within
1e-10.
"""

import numpy as np
import pytest
import torch_host  # noqa: F401  (this worker's share of the host)

from ipmzoo_tpu.formulations import (Bounds, EqualityHandling,
                                     InequalityHandling, Settings)
from ipmzoo_tpu.models import CompiledIPM as RefIPM
from ipmzoo_tpu.models import QPData as RefQPData
from ipmzoo_tpu_torch import CompiledIPM, QPData
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings

# min 1/2 x^T Q x + c^T x s.t. 0.5 <= x1 + 2 x2 <= 3, sum(x) = 2,
# -4 <= x <= 4
Q = np.array([[2.0, 0.5], [0.5, 1.0]])
C = np.array([-1.0, -2.0])


def raw(with_eq: bool):
    return dict(Q=Q, c=C, A_ineq=[[1.0, 2.0]], l_A_ineq=[0.5],
                u_A_ineq=[3.0], A_eq=np.ones((1, 2)) if with_eq else None,
                b_eq=[2.0] if with_eq else None, l_x=[-4.0, -4.0],
                u_x=[4.0, 4.0])


def scipy_opt(with_eq: bool):
    from scipy import optimize
    cons = [optimize.LinearConstraint([[1.0, 2.0]], [0.5], [3.0])]
    if with_eq:
        cons.append(optimize.LinearConstraint([[1.0, 1.0]], [2.0], [2.0]))
    res = optimize.minimize(
        lambda x: 0.5 * x @ Q @ x + C @ x,
        jac=lambda x: Q @ x + C, x0=np.zeros(2),
        bounds=optimize.Bounds([-4, -4], [4, 4]),
        constraints=cons, method="SLSQP",
        options={"ftol": 1e-14, "maxiter": 300})
    assert res.success
    return res.x


X_INEQ = scipy_opt(False)
X_EQ = scipy_opt(True)


def solve_both(settings, with_eq: bool):
    """The port's and the reference's solves of the QP; their iterations
    equal and x within 1e-10.  Returns the port's result."""
    m_eq = 1 if with_eq else 0
    port = CompiledIPM(port_settings(settings), n=2, m_ineq=1, m_eq=m_eq,
                       device="cpu").solve(
        QPData.make(**raw(with_eq), device="cpu"))
    ref = RefIPM(settings, n=2, m_ineq=1, m_eq=m_eq).solve(
        RefQPData.make(**raw(with_eq), dtype=np.float64))
    assert bool(port.converged) == bool(ref.converged)
    assert int(port.iterations) == int(ref.iterations)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10)
    return port


@pytest.mark.parametrize("ih", list(InequalityHandling))
@pytest.mark.parametrize("bounds", [Bounds.BOTH, Bounds.LOWER, Bounds.UPPER])
def test_inequality_formulations(ih, bounds):
    res = solve_both(Settings(inequalities=bounds, inequality_handling=ih),
                     False)
    assert bool(res.converged), (ih, bounds)
    if bounds == Bounds.BOTH:
        np.testing.assert_allclose(res.x.numpy(), X_INEQ, atol=1e-6)


@pytest.mark.parametrize("eh", [
    EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL,
    EqualityHandling.PENALTY_FUNCTION,
    EqualityHandling.REGULARIZATION,
])
def test_equality_handlings(eh):
    res = solve_both(Settings(
        equalities=True, equality_handling=eh,
        inequality_handling=InequalityHandling.SLACKED_SLACKS), True)
    assert bool(res.converged), eh
    atol = 1e-3 if eh == EqualityHandling.REGULARIZATION else 1e-5
    np.testing.assert_allclose(res.x.numpy(), X_EQ, atol=atol)


def test_naive_slacks_with_equalities():
    res = solve_both(Settings(
        equalities=True, equality_handling=EqualityHandling.NAIVE_SLACKS,
        inequality_handling=InequalityHandling.NAIVE_SLACKS), True)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x.numpy(), X_EQ, atol=1e-5)
