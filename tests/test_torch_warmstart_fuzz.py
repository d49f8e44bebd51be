"""The port's warm start and the randomized sweep of
tests/test_warmstart_fuzz.py on the CPU in float64, against the JAX
package's CompiledIPM on the same numpy data: the two warm-start cases
(a perturbed resolve from the previous solution's variables, and a
partial warm start of x alone) and 9 formulations of the lattice x 3
seeds (the indefinite one, EqualityHandling.NONE without inequalities,
on 'regldlt' by the 'auto' rule on both sides).

Each solve's converged, diverged and iterations equal the reference's
and x agrees within 1e-10, warm starts included; the cases' own claims
(fewer warm iterations, a clean end state, converged solves inside
their boxes) are held as the reference holds them.
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


def random_qp(n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    return dict(
        Q=M @ M.T / n + np.eye(n), c=rng.normal(size=n),
        A_ineq=rng.normal(size=(m, n)) if m else None,
        l_A_ineq=(-np.abs(rng.normal(size=m)) - 1) if m else None,
        u_A_ineq=(np.abs(rng.normal(size=m)) + 1) if m else None,
        l_x=-5 * np.ones(n), u_x=5 * np.ones(n))


class Pair:
    """The port's and the reference's solvers of one configuration."""

    def __init__(self, settings, n, m, m_eq=0, **kw):
        self.port = CompiledIPM(port_settings(settings), n=n, m_ineq=m,
                                m_eq=m_eq, device="cpu", **kw)
        self.ref = RefIPM(settings, n=n, m_ineq=m, m_eq=m_eq, **kw)

    def solve(self, raw, warm=None):
        """Both solves (warm from the port's and the reference's own
        variables of an earlier solve, ``warm`` = (port's, reference's));
        held to each other; returns the port's result and the
        reference's."""
        port = self.port.solve(QPData.make(**raw, device="cpu"),
                               warm_start=None if warm is None else warm[0])
        ref = self.ref.solve(RefQPData.make(**raw, dtype=np.float64),
                             warm_start=None if warm is None else warm[1])
        for f in ("converged", "diverged", "iterations"):
            assert int(getattr(port, f)) == int(getattr(ref, f)), f
        np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x),
                                   rtol=0, atol=1e-10)
        return port, ref


def warm_of(port, ref):
    return ({k: v for k, v in port.variables.items()},
            {k: v for k, v in ref.variables.items()})


class TestWarmStart:
    def test_warm_start_reduces_iterations(self):
        n, m = 10, 4
        raw = random_qp(n, m, 0)
        s = Pair(Settings(), n, m)
        r1 = s.solve(raw)
        assert bool(r1[0].converged)
        # perturb the linear term (receding-horizon style resolve)
        raw2 = dict(raw, c=raw["c"] + 0.01)
        cold, _ = s.solve(raw2)
        warm, _ = s.solve(raw2, warm_of(*r1))
        assert bool(warm.converged)
        assert int(warm.iterations) < int(cold.iterations)
        np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(),
                                   atol=1e-6)

    def test_warm_start_partial_dict(self):
        # warm starting only x is allowed; other variables default
        n = 6
        raw = random_qp(n, 0, 1)
        s = Pair(Settings(inequalities=Bounds.NONE), n, 0)
        p1, r1 = s.solve(raw)
        warm, _ = s.solve(raw, ({"x": p1.x}, {"x": r1.x}))
        assert bool(warm.converged)


FUZZ_SETTINGS = [
    Settings(),
    Settings(inequality_handling=InequalityHandling.SLACKS),
    Settings(inequality_handling=InequalityHandling.NAIVE_SLACKS),
    Settings(inequalities=Bounds.LOWER),
    Settings(inequalities=Bounds.UPPER,
             inequality_handling=InequalityHandling.SLACKS),
    Settings(inequalities=Bounds.NONE),
    Settings(equalities=True,
             equality_handling=EqualityHandling.REGULARIZATION),
    Settings(equalities=True,
             equality_handling=EqualityHandling.PENALTY_FUNCTION_WITH_EXTRA_DUAL),
    Settings(equalities=True, equality_handling=EqualityHandling.NONE,
             inequalities=Bounds.NONE),
]


@pytest.mark.parametrize("idx", range(len(FUZZ_SETTINGS)))
def test_fuzz_formulations_never_crash(idx):
    """Every solve ends clean (converged, max-iter or flagged divergence)
    as the reference's does, and converged solves satisfy their boxes."""
    settings = FUZZ_SETTINGS[idx]
    n, m = 7, 3
    m_eq = 1 if settings.equalities else 0
    s = Pair(settings, n, m, m_eq, tol=1e-8)
    for seed in range(3):
        rng = np.random.default_rng(100 * idx + seed)
        raw = random_qp(n, m, 100 * idx + seed)
        if m_eq:
            raw.update(A_eq=rng.normal(size=(1, n)),
                       b_eq=rng.normal(size=(1,)))
        res, _ = s.solve(raw)
        assert np.isfinite(float(res.objective)) or bool(res.diverged)
        if bool(res.converged):
            x = res.x.numpy()
            assert (x >= -5 - 1e-6).all() and (x <= 5 + 1e-6).all()
