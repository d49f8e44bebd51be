"""Kernel T3 above augmented order 128 against the reference tool's
Pallas kernel.

The reference's ``tools/fused_phases.py:phase_kernel`` has no limit on
the order.  At ``Settings()`` with n=121, m_ineq=8 (augmented order 129,
where K1 and T3 take the block route) the same seeded numpy data, two
instances, goes through

(a) the reference kernel around the JAX ``FusedBatchedIPM`` in interpret
    mode (``test_torch_phases.reference_prefix``, bt=2),
(b) the port's plain prefix (``models/fused_phases.py:phase_plain``), and
(c) a g++ host build of T3's block route at one lane
    (``phase_block_source``),

at prefixes 1 (assembly) and 2 (the factor) in float64, within 1e-10
(the interpret-mode prefixes take ~1 and ~13 s here).  The higher
prefixes reach the reference through the plain version:
``test_torch_phases.py`` holds it at every prefix at the small points,
``test_torch_fused_wide.py`` holds K1's plain version at aug 129, and
``test_torch_phases_block.py`` holds the block and wide routes to the
plain version at every prefix.
"""

import functools

import jax.numpy as jnp
import pytest
import torch

from ipmzoo_tpu.formulations import Settings
from ipmzoo_tpu.models.fused import FusedBatchedIPM as RefFused
from ipmzoo_tpu_torch.models import fused_phases as fp
from ipmzoo_tpu_torch.models.convert import \
    settings_from_reference as port_settings
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.ops import cuda_fused

from test_torch_phases import numpy_data, reference_prefix, rel
from test_torch_phases import tool  # noqa: F401  (the reference T3 tool)
from test_torch_fused_team import gxx, host_build  # noqa: F401

N, M, BT = 121, 8, 2


@functools.lru_cache(maxsize=None)
def point():
    """The reference and port solvers at aug 129 (float64, tile 2), the
    numpy data and the port's SoA inputs."""
    ref = RefFused(Settings(), n=N, m_ineq=M, m_eq=0, bt=BT,
                   dtype=jnp.float64, tol=1e-5, max_iter=1)
    port = FusedBatchedIPM(port_settings(Settings()), n=N, m_ineq=M, m_eq=0,
                           bt=BT, dtype=torch.float64, tol=1e-5, max_iter=1,
                           device="cpu")
    data = numpy_data(N, M, 0, B=BT)
    soa, _ = port.soa_inputs(qpdata_from_numpy(data, device="cpu"))
    return ref, port, data, soa


@pytest.mark.parametrize("phase", [1, 2])
def test_block_route_prefix_three_ways_above_order_128(tool, host_build,
                                                       phase):
    ref, port, data, soa = point()
    assert port.aug_dim == 129 and fp.phase_route(port, BT) == "block"
    want = reference_prefix(tool, ref, data, phase)
    acc, sink = fp.phase(port, soa, phase)
    lib = host_build(fp.phase_block_source(port, phase))
    fn = cuda_fused.bind_phase(lib, port.dtype, "block")
    region = cuda_fused.region_values(lib, port.dtype, "block", 4, "phase")
    (hacc, hsink), err = cuda_fused.call_phase(fn, soa, port.kernel_params(),
                                               1, 0, None, region, 4)
    assert err == 0
    assert abs(want).max() > 0
    assert rel(acc.numpy(), want) <= 1e-10, phase
    assert rel(hacc.numpy(), want) <= 1e-10, phase
    assert rel(hsink.numpy(), sink.numpy()) <= 1e-10, phase
