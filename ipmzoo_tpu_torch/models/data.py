"""Problem data of the batched solver.

``QPData`` holds dense convex-QP data

    minimize    1/2 x^T Q x + c^T x
    subject to  l_A <= A_ineq x <= u_A
                A_eq x = b_eq
                l_x <= x <= u_x

as torch tensors, with an optional leading batch axis on every field
(counterpart of :class:`ipmzoo_tpu.models.data.QPData`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class QPData:
    Q: torch.Tensor         # ([B,] n, n) symmetric
    c: torch.Tensor         # ([B,] n)
    A_ineq: torch.Tensor    # ([B,] m_ineq, n)
    l_A_ineq: torch.Tensor  # ([B,] m_ineq)
    u_A_ineq: torch.Tensor  # ([B,] m_ineq)
    A_eq: torch.Tensor      # ([B,] m_eq, n)
    b_eq: torch.Tensor      # ([B,] m_eq)
    l_x: torch.Tensor       # ([B,] n)
    u_x: torch.Tensor       # ([B,] n)

    @property
    def n(self) -> int:
        return self.Q.shape[-1]

    @property
    def m_ineq(self) -> int:
        return self.A_ineq.shape[-2]

    @property
    def m_eq(self) -> int:
        return self.A_eq.shape[-2]

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.Q.shape[:-2])

    def to(self, device=None, dtype: Optional[torch.dtype] = None
           ) -> "QPData":
        """Every field moved to ``device`` and cast to ``dtype``."""
        return QPData(**{f.name: getattr(self, f.name).to(device=device,
                                                          dtype=dtype)
                         for f in dataclasses.fields(self)})

    @staticmethod
    def make(Q, c, A_ineq=None, l_A_ineq=None, u_A_ineq=None, A_eq=None,
             b_eq=None, l_x=None, u_x=None, *,
             dtype: torch.dtype = torch.float64,
             device=None) -> "QPData":
        """Build QPData with absent constraint groups as size-0 tensors,
        on ``device`` (default: the CUDA device)."""
        device = resolve_device(device)

        def arr(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        Q = arr(Q)
        n = Q.shape[-1]
        batch = tuple(Q.shape[:-2])

        def opt(v, tail):
            return (torch.zeros(batch + tail, dtype=dtype, device=device)
                    if v is None else arr(v))

        A_ineq = opt(A_ineq, (0, n))
        m_i = A_ineq.shape[-2]
        A_eq = opt(A_eq, (0, n))
        m_e = A_eq.shape[-2]
        return QPData(
            Q=Q, c=arr(c), A_ineq=A_ineq,
            l_A_ineq=opt(l_A_ineq, (m_i,)), u_A_ineq=opt(u_A_ineq, (m_i,)),
            A_eq=A_eq, b_eq=opt(b_eq, (m_e,)),
            l_x=opt(l_x, (n,)), u_x=opt(u_x, (n,)))


def validate(data: QPData) -> None:
    """Host-side sanity checks of the bounds (as the reference)."""
    if data.l_x.numel() and not bool((data.l_x < data.u_x).all()):
        raise ValueError("require l_x < u_x elementwise")
    if data.l_A_ineq.numel() and \
            not bool((data.l_A_ineq <= data.u_A_ineq).all()):
        raise ValueError("require l_A_ineq <= u_A_ineq elementwise")
