"""The achievable convergence floor of the port's CompiledIPM against the
working dtype, on the CPU: the rows of tests/test_precision_floor.py's
table (TestFloorTable) that the port's options cover, on the same QP
class (48 random SPD box QPs with two-sided inequalities, n=16, m=8,
numpy seed 0).

| dtype | options    | achievable tol | not achievable |
|-------|------------|----------------|----------------|
| f64   | plain      | 1e-8 (parity)  | —              |
| f32   | plain      | 1e-6           | 3e-7           |
| f32   | gondzio=2  | 1e-6           |                |

Every row also holds that no instance diverged (the mu floor keeps the
float32 barrier terms finite).  If an f32 row improves after a solver
change, update the table; if f32 at 1e-6 starts failing, that is a
regression.
"""

import numpy as np
import pytest
import torch

from ipmzoo_tpu_torch import CompiledIPM, QPData, Settings

B, N, M = 48, 16, 8


@pytest.fixture(scope="module")
def qp_batch():
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, N, N)).astype(np.float32)
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / N + \
        np.eye(N, dtype=np.float32)
    return dict(
        Q=Q, c=rng.normal(size=(B, N)),
        A_ineq=rng.normal(size=(B, M, N)),
        l_A_ineq=-np.abs(rng.normal(size=(B, M))) - 1,
        u_A_ineq=np.abs(rng.normal(size=(B, M))) + 1,
        l_x=np.full((B, N), -5.0), u_x=np.full((B, N), 5.0))


def conv_frac(dtype, tol, data, **opts):
    d = QPData.make(**data, dtype=dtype, device="cpu")
    s = CompiledIPM(Settings(), n=N, m_ineq=M, dtype=dtype, tol=tol,
                    device="cpu", **opts)
    res = s.solve_batch(d)
    assert not bool(res.diverged.any()), \
        "divergence rollback tripped (the mu floor should prevent this)"
    return res.converged.double().mean().item()


def test_f64_reaches_reference_parity_tol(qp_batch):
    assert conv_frac(torch.float64, 1e-8, qp_batch) == 1.0


@pytest.mark.parametrize("gondzio", [0, 2])
def test_f32_reaches_1e6_with_no_rollback(qp_batch, gondzio):
    assert conv_frac(torch.float32, 1e-6, qp_batch, gondzio=gondzio) == 1.0


def test_f32_floor_is_real(qp_batch):
    """3e-7 is below the float32 factorisation floor on this class."""
    assert conv_frac(torch.float32, 3e-7, qp_batch) < 0.5
