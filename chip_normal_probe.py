#!/usr/bin/env python3
"""Piecewise timings of the n=1024 dense-QP iteration on one NVIDIA GPU
(the port's counterpart of tools/normal_probe.py).

    python3 chip_normal_probe.py [n] [m] [B]

Where does an iteration of CompiledIPM's kernel='block' / 'blockg' /
'normal' spend its time, and does binding the explicit H^-1 each
iteration (``block_inv=True``) pay?  The reference chose ``block_inv``
off ('auto') with this probe on a TPU; this script measures the same on
the card.  Defaults n=1024, m=128, B=8, float32 (TF32 off, as the port
sets on import).

1. The pieces as library calls, on the reference's data (numpy seed 0: M
   (B, n, n), H = M M^T / n + 2 I, A (B, m, n), one and m right-hand
   sides): the batched Cholesky, the triangular solve with 1 and with m
   right-hand sides, the explicit H^-1 (n right-hand sides forward and
   back: what ``block_inv=True`` binds), and ``A @ H``.  Each by CUDA
   events behind a leading call (device time), with its launches and its
   longest kernel under torch.profiler: the route the library takes.
2. One batched ``CompiledIPM._step_impl`` on
   ``models/convert.py::make_batch(B, n, m)`` for kernel='block' with
   ``block_inv=True`` and with ``block_inv=False``, 'blockg' and
   'normal', each at gondzio=2 and gondzio=0 (scale_tol=True, tol 1e-5):
   the wall by CUDA events (each run starts on an idle device: the
   caller pays the host's time; the eight rows timed in turns, so a drift
   of the host falls on all alike), instance-iterations a second, device
   ms, launches and host syncs a step, and K2's launches by route
   (``'normal'`` factors its reduced system by the blocked LDL^T, whose
   panels run on K2's block route).

Every line carries the card's name and power limit.  Exits 2 without a
CUDA device.
"""

import sys

import numpy as np

N, M, B, TOL = 1024, 128, 8, 1e-5
RUNS = 5
#: the step rows: (label, kernel, options), each at every GONDZIO
STEPS = (("block block_inv=True", "block", {"block_inv": True}),
         ("block block_inv=False", "block", {"block_inv": False}),
         ("blockg", "blockg", {}),
         ("normal", "normal", {}))
GONDZIO = (2, 0)


def problem(n, m, B):
    """tools/normal_probe.py's arrays (numpy seed 0, float32): H, A, the
    one right-hand side b1 and the m right-hand sides Bm."""
    rng = np.random.default_rng(0)
    Mx = rng.normal(size=(B, n, n)).astype(np.float32)
    H = np.einsum("bij,bkj->bik", Mx, Mx) / n + 2 * np.eye(n,
                                                          dtype=np.float32)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    b1 = rng.normal(size=(B, n)).astype(np.float32)
    Bm = rng.normal(size=(B, n, m)).astype(np.float32)
    return H, A, b1, Bm


def pieces(H, A, b1, Bm):
    """(label, fn) of the library pieces on torch tensors; the factor they
    solve with is computed once here."""
    import torch
    from torch.linalg import cholesky, solve_triangular
    L = cholesky(H)
    n, m = H.shape[-1], Bm.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device).expand_as(H)
    return [
        ("batched cholesky (B,n,n)", lambda: cholesky(H)),
        ("batched tri solve, 1 rhs",
         lambda: solve_triangular(L, b1[..., None], upper=False)),
        (f"batched tri solve, {m} rhs",
         lambda: solve_triangular(L, Bm, upper=False)),
        ("explicit H^-1 (n rhs fwd+bwd)",
         lambda: solve_triangular(L.mT, solve_triangular(L, eye,
                                                         upper=False),
                                  upper=True)),
        ("A @ H einsum (B,m,n,n)",
         lambda: torch.einsum("bmi,bin->bmn", A, H)),
    ]


def steps(n=N, m=M, B=B, dtype=None, device=None):
    """(label, gondzio, solver, fn) of every step row: ``fn()`` runs one
    batched ``_step_impl`` from the initial iterate of make_batch(B, n,
    m) and returns the new state."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    dtype = torch.float32 if dtype is None else dtype
    data = make_batch(B, n, m, dtype, device=device)
    out = []
    for label, kernel, options in STEPS:
        for gz in GONDZIO:
            s = CompiledIPM(Settings(), n=n, m_ineq=m, dtype=dtype, tol=TOL,
                            kernel=kernel, scale_tol=True, gondzio=gz,
                            device=device, **options)
            d = s._check_data(data)
            state = s.init_state(d)
            out.append((label, gz, s,
                        lambda s=s, st=state, d=d: s._step_impl(st, d)))
    return out


def time_piece(fn, runs=RUNS):
    """Device ms (CUDA events behind a leading call) and the profile of
    a call."""
    from ipmzoo_tpu_torch.utils.timer import cuda_time, device_calls
    return cuda_time(fn, runs=runs, lead=1), device_calls(fn, 2)


def time_steps(fns, runs=RUNS):
    """The steps' walls (CUDA events, each run from an idle device, the
    rows in turns) and, per step, its profile, host syncs, K2's launches
    by route and its x."""
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.utils.timer import (cuda_time_rounds, device_calls,
                                              host_syncs)
    walls, out = cuda_time_rounds(fns, runs), []
    for fn, t in zip(fns, walls):
        prof = device_calls(fn, 2)
        syncs = host_syncs(fn, 1)
        before = dict(cuda_ldlt.route_launches)
        x = fn().vars[0]
        k2 = {k: v - before[k] for k, v in cuda_ldlt.route_launches.items()
              if k.startswith("ldlt ") and v - before[k]}
        out.append((t, prof, syncs, k2, x))
    return out


def run(n=N, m=M, B=B, dtype=None, device=None, runs=RUNS):
    """Every piece and step row, printed; returns the rows as dicts (a
    step row with its step's x)."""
    import torch
    from ipmzoo_tpu_torch.utils import device as card
    dtype = torch.float32 if dtype is None else dtype
    name, rows = card.nvidia_smi(), []
    print(f"normal probe: n={n} m={m} B={B} "
          f"{str(dtype).replace('torch.', '')} on {device}; TF32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    H, A, b1, Bm = (torch.tensor(a).to(device) for a in problem(n, m, B))
    for label, fn in pieces(H.to(dtype), A.to(dtype), b1.to(dtype),
                            Bm.to(dtype)):
        t, prof = time_piece(fn, runs)
        top = prof.kernels[0][0] if prof.kernels else "-"
        rows.append({"row": label, "ms": t.ms, "spread": t.spread,
                     "device_ms": prof.ms, "launches": prof.launches,
                     "whole": prof.whole, "kernel": top, "card": name})
        print(f"  {label:34s}: {t.ms:9.3f} ms (spread {t.spread:.3f}), "
              f"launches {prof.launches:g}, longest kernel "
              f"{top[:60]}  [{name}]")
    rows_of = steps(n, m, B, dtype, device)
    timed = time_steps([fn for *_, fn in rows_of], runs)
    for (label, gz, _, _), (t, prof, syncs, k2, x) in zip(rows_of, timed):
        rows.append({"row": label, "gondzio": gz, "ms": t.ms,
                     "spread": t.spread, "inst_it_s": B / t.ms * 1e3,
                     "device_ms": prof.ms, "launches": prof.launches,
                     "whole": prof.whole, "syncs": syncs, "k2": k2, "x": x, "card": name})
        print(f"  step kernel={label} gondzio={gz}: {t.ms:.3f} ms (spread "
              f"{t.spread:.3f}) => {B / t.ms * 1e3:.0f} inst-it/s; device "
              f"{prof.ms:.3f} ms, launches {prof.launches:g}, host syncs "
              f"{syncs:g}, K2 by route {k2}  [{name}]")
    return rows


def main(argv=None):
    import torch
    from chip_roofline import banner
    argv = sys.argv[1:] if argv is None else argv
    n, m, b = (int(a) for a in (argv + [N, M, B][len(argv):])[:3])
    dev = banner("chip_normal_probe", "the pieces are timed")
    if dev is None:
        return 2
    run(n, m, b, torch.float32, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
