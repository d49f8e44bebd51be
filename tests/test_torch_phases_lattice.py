"""Kernel T3's prefixes over the formulation lattice: three points
besides ``Settings()`` (no inequalities; equalities through slacked
slacks; equalities through the penalty function), each prefix held three
ways in float64 as ``test_torch_phases.py`` holds the fused slice's
formulation: the reference tool's kernel in interpret mode, the port's
plain prefix, and a g++ host build of the generated source.
"""

import pytest
import torch_host  # noqa: F401  (this worker's share of the host)

from test_torch_phases import (PHASES, hold_three_ways,  # noqa: F401
                               host_build, tool)


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("point", ["box_only", "equalities_slacked",
                                   "equalities_penalty"])
def test_prefix_over_the_lattice(tool, host_build, point, phase):
    hold_three_ways(tool, host_build, point, "float64", phase)
