"""Kernel T3 on K1's team route, against the reference tool's Pallas
kernel and the plain version.

The team route's T3 prefix (``models/fused_phases.py:phase_team_source``:
``csrc/fused_ipm.cuh`` + ``csrc/fused_team.cuh`` +
``csrc/fused_phases_team.cuh`` + the ``struct Form`` of
``models/codegen_team.py:CppTeam``) compiles for the host two ways, as
K1's team route does in ``test_torch_fused_team.py``: plain g++ (one lane
a team), and with IPMZOO_TEAM_EMULATE at 16 lanes (each team 16 host
threads, a barrier for each team barrier), which runs the lane-spread
code itself.  T2a's team route has the same tests in
``test_torch_roofline_team.py``, a file of its own so that neither runs
long.

On the same seeded numpy inputs both builds are held to the plain
version (``phase_plain``) and to the reference's kernel in interpret
mode (``tools/fused_phases.py:phase_kernel`` at the fused slice's point
of ``test_torch_phases.py``): float64 within 1e-10 and float32 within
1e-4, both outputs, the metrics nudge off and on.  The team route sums
each lane's entries and then the lanes, another order than the plain
version's.  The emulated build runs the first two instances of the
batch (a host barrier is slow).

The reference's interpret-mode runs take most of this file's time (3-7 s
a prefix), so the float32 prefixes meet it at prefix 2 (the factor) and
prefix 4, whose ``acc`` sums every phase's term; every float32 prefix is
held to the plain version, which ``test_torch_phases.py`` holds to the
reference at every prefix on the same data.
"""

import ctypes
import functools
import hashlib
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from ipmzoo_tpu_torch.models import fused_phases as fp
from ipmzoo_tpu_torch.models.convert import qpdata_from_numpy
from ipmzoo_tpu_torch.models.fused import FusedBatchedIPM
from ipmzoo_tpu_torch.models.fused_source import fused_team_source, team_lanes
from ipmzoo_tpu_torch.ops import cuda_fused, cuda_k1_measure

from test_torch_phases import (POINTS, numpy_data, reference_prefix, rel,
                               solvers)
from test_torch_phases import tool  # noqa: F401  (the reference T3 tool)

T3_TOL = {"float32": 1e-4, "float64": 1e-10}
PHASES = range(len(fp.PHASES))
EMULATE = ("-DIPMZOO_TEAM_EMULATE", "-pthread")
#: the float32 prefixes held to the reference directly: the factor (team_ldlt,
#: the part of the prefix most changed from the thread route) and the last,
#: whose acc sums every phase's term
F32_AT_REFERENCE = (2, 4)
#: instances the emulated builds run: every team barrier is a host
#: barrier of 16 threads, slow on a loaded host
EMULATED_B = 2


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Every host build this file uses, compiled at once: the five team
    prefixes of the fused slice, each one lane a team ("one") and emulated
    at 16 lanes ("emulated"); and the team route's measurement library,
    one lane a team ("measure")."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++) found to build the team "
                    "route's sources")
    root = tmp_path_factory.mktemp("t3team")
    _, port = solvers("slice", "float64")
    sources = {(p, kind): fp.phase_team_source(port, p)
               for p in PHASES for kind in ("one", "emulated")}
    sources[("measure", "one")] = cuda_k1_measure.team_source(port)

    def build(key):
        text = sources[key]
        emulated = key[1] == "emulated"
        name = hashlib.sha256((text + key[1]).encode()).hexdigest()[:16]
        src, lib = root / f"t-{name}.cc", root / f"t-{name}.so"
        src.write_text(text)
        proc = subprocess.run(
            [gxx, "-std=c++20" if emulated else "-std=c++17", "-O1",
             "-ffp-contract=off", "-shared", "-fPIC",
             *(EMULATE if emulated else ()), "-x", "c++", str(src), "-o",
             str(lib)], capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(6) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def first(tensors, b):
    return [t[..., :b].contiguous() for t in tensors]


def run_prefix(lib, port, soa, reps=1, perturb=0):
    fn = cuda_fused.bind_phase(lib, port.dtype, "team")
    outs, err = cuda_fused.call_phase(fn, soa, port.kernel_params(), reps,
                                      perturb)
    assert err == 0
    return outs


@functools.lru_cache(maxsize=None)
def slice_case(dtype):
    """The fused slice's point of test_torch_phases.py: the reference and
    port solvers, the numpy data and the port's SoA inputs."""
    ref, port = solvers("slice", dtype)
    _, n, m, e = POINTS["slice"]
    data = numpy_data(n, m, e)
    soa, _ = port.soa_inputs(qpdata_from_numpy(
        data, dtype=getattr(torch, dtype), device="cpu"))
    return ref, port, data, soa


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_team_prefix_three_ways(tool, libs, dtype, phase):
    ref, port, data, soa = slice_case(dtype)
    tol = T3_TOL[dtype]
    acc, sink = fp.phase(port, soa, phase, route="team")
    if dtype == "float64" or phase in F32_AT_REFERENCE:
        want = reference_prefix(tool, ref, data, phase)
        assert rel(acc.numpy(), want) <= tol, (dtype, phase)
    else:
        want = acc.numpy()
    part = first(soa, EMULATED_B)
    for kind, inputs in (("one", soa), ("emulated", part)):
        b = inputs[0].shape[-1]
        hacc, hsink = run_prefix(libs[(phase, kind)], port, inputs)
        assert bool(torch.isfinite(hsink).all())
        assert rel(hacc.numpy(), want[:, :b]) <= tol, (kind, dtype, phase)
        assert rel(hsink.numpy(), sink[:, :b].numpy()) <= tol, \
            (kind, dtype, phase)
        # the metrics nudge on, two repetitions: against the plain version
        pacc, psink = fp.phase_plain(port, inputs, phase, 2, 1)
        nacc, nsink = run_prefix(libs[(phase, kind)], port, inputs, 2, 1)
        assert rel(nacc.numpy(), pacc.numpy()) <= tol, (kind, dtype, phase)
        assert rel(nsink.numpy(), psink.numpy()) <= tol, (kind, dtype, phase)
        if phase == 0:
            assert not hacc.any() and not nacc.any()
    if phase == 4:
        # the nudge reaches all three metrics calls: 1e-6 k on call k
        one = fp.phase_plain(port, soa, phase, 1, 0)[0]
        nudged = fp.phase_plain(port, soa, phase, 1, 1)[0]
        hnudged = run_prefix(libs[(phase, "one")], port, soa, 1, 1)[0]
        assert not torch.equal(nudged, one)
        assert rel(hnudged.numpy(), nudged.numpy()) <= tol


def test_team_source_is_deterministic_and_keyed_by_lanes_and_prefix():
    _, port = solvers("slice", "float32")
    _, port64 = solvers("slice", "float64")
    broad = FusedBatchedIPM(port.settings, n=20, m_ineq=8, m_eq=0, bt=4,
                            dtype=torch.float32, device="cpu")
    assert team_lanes(port) == 16 and team_lanes(broad) == 32
    team = fused_team_source(port)
    form = team[team.index("struct Form {"):
                team.index("IPMZOO_FUSED_TEAM_ENTRY_POINTS(")]
    texts = [fp.phase_team_source(port, p) for p in PHASES]
    for p, text in enumerate(texts):
        assert text == fp.phase_team_source(port, p)
        assert text == fp.phase_team_source(port64, p)   # dtype-free
        assert form in text
        assert fp.PHASE_TEAM_CUH.read_text() in text
        assert "#define IPMZOO_TEAM_LANES 16" in text
        assert text.rstrip().endswith(
            f"IPMZOO_PHASE_TEAM_ENTRY_POINTS(ipmzoo_fused::Form, {p})")
        assert "IPMZOO_FUSED_TEAM_ENTRY_POINTS(ipmzoo_fused::Form)" \
            not in text
        assert text != fp.phase_source(port, p)
        # a variable block above 16 takes K1's 32 lanes, and T3's with it
        wide = fp.phase_team_source(broad, p)
        assert "#define IPMZOO_TEAM_LANES 32" in wide and wide != text
    assert len(set(texts)) == len(texts)
    with pytest.raises(ValueError, match="phase 5"):
        fp.phase_team_source(port, 5)


def test_team_layout_is_k1s_and_clocked_team_gives_its_bits(libs):
    """The prefixes run on K1's team layout (TeamLayout<Form> of the same
    Form, which the source test checks): K1's shape query gives its bytes
    a team; the team route's
    clocked kernel gives the team route's own outputs bit for bit, cold
    and with Gondzio rounds, and counts no cycles off the card."""
    _, port, _, soa = slice_case("float64")
    lib = libs[("measure", "one")]
    for dtype in (torch.float32, torch.float64):
        k1 = cuda_fused.team_shape(lib, dtype)
        assert k1["lanes"] == 1 and k1["threads"] == 64
        assert k1["team_bytes"] == (7104 if dtype == torch.float32
                                    else 14208)
    part = first(soa, 4)
    total = sum(port.var_sizes)
    team = cuda_fused.bind(lib, port.dtype, "team")
    for gondzio in (0, 2):
        want, err = cuda_fused.call(team, part, None, port.n, total, 30,
                                    gondzio, port.kernel_params())
        assert err == 0
        outs, cycles, err = cuda_k1_measure.clocked_team(
            lib, part, None, port.n, total, 30, gondzio,
            port.kernel_params())
        assert err == 0
        for x, y in zip(outs, want):
            assert torch.equal(x, y)
        assert cycles.shape == (2, 4) and not cycles.any()
        assert bool((want[2] > 0).all())


def test_default_route_cpu_counts_no_launch_and_cuda_entry_raises():
    _, port, _, soa = slice_case("float64")
    B = soa[0].shape[-1]
    assert fp.phase_route(port, B) == "team" == cuda_fused.k1_route(
        B, port.k1_sizes(), port.dtype)
    cuda_fused.reset_launch_counts()
    small = first(soa, 4)
    plain = fp.phase_plain(port, small, 3)
    for route in (None, "team", "thread"):
        out = fp.phase(port, small, 3, route=route)
        assert all(torch.equal(x, y) for x, y in zip(out, plain))
    assert cuda_fused.launches == {"fused": 0, "phase": 0}
    assert cuda_fused.phase_route_launches == {
        "phase thread": 0, "phase team": 0, "phase block": 0,
        "phase wide": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_fused.phase_soa(fp.phase_team_source(port, 0), small,
                             port.kernel_params(), route="team")
    with pytest.raises(ValueError, match="no route 'warp'"):
        fp.phase(port, small, 0, route="warp")
