#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ipmzoo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one
                                 # CUDA card and nvcc

Steps, each reported on its own line:

1. refuse to run without a CUDA device (there is no CPU fallback);
2. print the card's name and power limit (nvidia-smi);
3. build the CUDA kernels from ipmzoo_tpu_torch/csrc/ and report the time;
4. hold kernels K2 (LDL^T factor) and K3 (LDL^T solve) against their
   plain torch versions on the card at n=24, B=10240: float32 within a
   relative difference of 1e-5, float64 within 1e-12 (largest absolute
   difference over the largest magnitude of the plain result), and an
   exactly-zero pivot replaced by the floor exactly in both;
5. solve the README's demo QP on the card (float64, tol 1e-8);
6. run the slice: CompiledIPM(Settings(), n=16, m_ineq=8, float32,
   tol=1e-6).solve_batch_compact on 10240 QPs of the benchmark workload,
   with >= 99% converged and both kernels launched by that run; time it
   with CUDA events (median of 3 runs after the first) and report useful
   IPM iterations/s (per-instance iterations summed over the batch);
7. check the slice's objectives against the port on the CPU in float64
   on the first 256 instances: |f_gpu - f_cpu| <= 1e-4 (1 + |f_cpu|);
8. time K2 and K3 against their plain versions at the slice's batch
   sizes (10240, 2560, 320) with CUDA events.

Any failed check raises, so the exit code is nonzero.  The line before
the last is a JSON object describing the kernels; the last line is the
JSON object {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

N_AUG, B_SLICE = 24, 10240
SCHEDULE_BATCHES = (10240, 2560, 320)
SOURCE = "ipmzoo_tpu_torch/csrc/ldlt.cu"
REPLACES = {"ldlt": "ipmzoo_tpu/ops/pallas_ldlt.py:79",
            "solve_ldlt": "ipmzoo_tpu/ops/pallas_ldlt.py:130"}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_diff(a, b):
    """Largest absolute difference over the largest magnitude of b."""
    return ((a - b).abs().max() / b.abs().max()).item()


def quasi_definite(B, n, dtype, device, seed):
    """Well-conditioned symmetric quasi-definite [[H, A^T], [A, -C]]
    with H, C positive definite (the shape of the IPM's systems)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n1 = (2 * n) // 3
    n2 = n - n1
    M = rng.normal(size=(B, n1, n1))
    K = np.zeros((B, n, n))
    K[:, :n1, :n1] = np.einsum("bij,bkj->bik", M, M) / n1 + np.eye(n1)
    A = rng.normal(size=(B, n2, n1))
    K[:, n1:, :n1] = A
    K[:, :n1, n1:] = np.swapaxes(A, 1, 2)
    K[:, n1:, n1:] = -np.einsum("bi,ij->bij",
                                np.abs(rng.normal(size=(B, n2))) + 0.5,
                                np.eye(n2))
    b = rng.normal(size=(B, n))
    return (torch.tensor(K).to(dtype).to(device),
            torch.tensor(b).to(dtype).to(device))


def time_cuda(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(dev):
    """Step 4: K2/K3 against their plain versions on the card."""
    import torch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import PIVOT_FLOOR, ldlt, solve_ldlt

    errs = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        K, b = quasi_definite(B_SLICE, N_AUG, dtype, dev, seed=1)
        L, D = cuda_ldlt.ldlt_auto(K)
        L0, D0 = ldlt(K)
        x0 = solve_ldlt(L0, D0, b)
        x = cuda_ldlt.solve_ldlt_auto(L0, D0, b)
        torch.cuda.synchronize()
        rl, rd, rx = rel_diff(L, L0), rel_diff(D, D0), rel_diff(x, x0)
        name = str(dtype).replace("torch.", "")
        print(f"kernels {name} n={N_AUG} B={B_SLICE}: K2 rel diff "
              f"L {rl:.3e} D {rd:.3e}, K3 rel diff x {rx:.3e} "
              f"(limit {tol:g})")
        check(max(rl, rd) <= tol, f"K2 disagrees with its plain version "
              f"in {name}: {max(rl, rd):.3e} > {tol:g}")
        check(rx <= tol, f"K3 disagrees with its plain version in {name}: "
              f"{rx:.3e} > {tol:g}")
        if dtype == torch.float32:
            errs["ldlt"] = max((L - L0).abs().max().item(),
                               (D - D0).abs().max().item())
            errs["solve_ldlt"] = (x - x0).abs().max().item()

    # exact-zero pivot: rows 0-1 form [[1, 1], [1, 1]], decoupled from
    # the rest, so the second pivot is 1 - 1*1*1 == 0 exactly
    K, _ = quasi_definite(B_SLICE, N_AUG, torch.float32, dev, seed=2)
    K[:, :2, :] = 0.0
    K[:, :, :2] = 0.0
    K[:, :2, :2] = 1.0
    L, D = cuda_ldlt.ldlt_auto(K)
    L0, D0 = ldlt(K)
    floor = torch.tensor(PIVOT_FLOOR, dtype=torch.float32)
    check(bool((D[:, 1].cpu() == floor).all()),
          "K2 did not put the pivot floor on an exactly-zero pivot")
    check(bool((D0[:, 1].cpu() == floor).all()),
          "plain LDL^T did not put the pivot floor on a zero pivot")
    rz = max(rel_diff(L, L0), rel_diff(D, D0))
    check(rz <= 1e-5, f"K2 disagrees on the zero-pivot case: {rz:.3e}")
    print(f"kernels zero pivot: D[:,1] == {PIVOT_FLOOR:g} exactly in both "
          f"for all {B_SLICE} instances; rel diff {rz:.3e}")
    return errs


def solve_demo(dev):
    """Step 5: the README's demo QP on the card."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, QPData, Settings
    data = QPData.make(Q=[[1.0, 0.0], [0.0, 0.5]], c=[-10.0, 2.0],
                       A_ineq=[[1.0, 1.0]], l_A_ineq=[1.0], u_A_ineq=[1.2],
                       l_x=[0.0, 0.0], u_x=[10.0, 10.0],
                       dtype=torch.float64, device=dev)
    res = CompiledIPM(Settings(), 2, 1, tol=1e-8, device=dev).solve(data)
    x = res.x.cpu().tolist()
    f = res.objective.item()
    print(f"demo QP on {dev}: converged={bool(res.converged)} "
          f"iterations={int(res.iterations)} x={x} f={f!r}")
    check(bool(res.converged), "demo QP did not converge")
    check(abs(x[0] - 1.2) <= 1e-8 and abs(x[1]) <= 1e-8,
          f"demo QP x={x}, expected (1.2, 0)")
    check(abs(f + 11.28) <= 1e-9 * 11.28, f"demo QP f={f}, expected -11.28")


def run_slice(dev):
    """Step 6: the 10240-QP slice on the card."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_ldlt

    data = make_batch(B_SLICE, 16, 8, torch.float32, device=dev)
    solver = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-6,
                         device=dev)
    cuda_ldlt.reset_launch_counts()
    solver.host_syncs = 0
    res = solver.solve_batch_compact(data, esc_cap=0)
    torch.cuda.synchronize()
    launches = dict(cuda_ldlt.launches)
    syncs = solver.host_syncs

    check(tuple(res.x.shape) == (B_SLICE, 16), f"x shape {res.x.shape}")
    check(bool(torch.isfinite(res.x).all()), "non-finite x")
    check(bool(torch.isfinite(res.objective).all()), "non-finite objective")
    conv = res.converged.float().mean().item()
    iters = int(res.iterations.sum().item())
    print(f"slice: {B_SLICE} QPs n=16 m=8 float32 tol=1e-6 schedule "
          f"{solver.default_schedule(B_SLICE)}: converged {conv:.6f}, "
          f"diverged {int(res.diverged.sum())}, iterations {iters}")
    print(f"slice: launches K2 {launches['ldlt']} K3 "
          f"{launches['solve_ldlt']}; host syncs {syncs}")
    check(conv >= 0.99, f"slice convergence {conv} < 0.99")
    for k in ("ldlt", "solve_ldlt"):
        check(launches[k] > 0, f"the slice never launched kernel {k}")

    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solver.solve_batch_compact(data, esc_cap=0)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    print(f"slice: wall ms per solve (CUDA events, 3 runs) "
          f"{[round(t, 3) for t in times]}, median {med:.3f}; "
          f"useful iterations/s {iters / (med / 1e3):.1f}")
    return data, res, launches


def compare_cpu(data, res):
    """Step 7: the slice's objectives against the port on the CPU, f64."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.state import tree_map

    k = 256
    sub = tree_map(lambda a: a[:k].to(device="cpu", dtype=torch.float64),
                   data)
    cres = CompiledIPM(Settings(), 16, 8, dtype=torch.float64,
                       tol=1e-8).solve_batch_compact(sub, esc_cap=0)
    f_cpu = cres.objective
    f_gpu = res.objective[:k].cpu().double()
    both = cres.converged & res.converged[:k].cpu()
    diff = (f_gpu - f_cpu).abs()
    bound = 1e-4 * (1.0 + f_cpu.abs())
    worst = (diff / (1.0 + f_cpu.abs()))[both].max().item()
    print(f"cpu f64 check: {int(both.sum())}/{k} instances converged in "
          f"both; largest |f_gpu - f_cpu| / (1 + |f_cpu|) = {worst:.3e} "
          f"(limit 1e-4)")
    check(bool(cres.converged.all()), "CPU f64 reference did not converge")
    check(int(both.sum()) >= 0.99 * k, "too few instances to compare")
    check(bool((diff <= bound)[both].all()),
          "slice objectives disagree with the CPU f64 port")


def time_kernels(dev):
    """Step 8: kernel vs plain times at the slice's shapes (float32), on
    the augmented KKT matrices of the slice's first iteration."""
    import torch
    from ipmzoo_tpu_torch import CompiledIPM, Settings
    from ipmzoo_tpu_torch.models.convert import make_batch
    from ipmzoo_tpu_torch.ops import cuda_ldlt
    from ipmzoo_tpu_torch.ops.ldlt import ldlt, solve_ldlt

    solver = CompiledIPM(Settings(), 16, 8, dtype=torch.float32, tol=1e-6,
                         device=dev)
    out = {}
    for B in SCHEDULE_BATCHES:
        data = make_batch(B, 16, 8, torch.float32, device=dev)
        st = solver.init_state(data)
        K = solver._assemble_kkt(solver._env(data, st.vars, st.mu), B)
        b = torch.randn((B, N_AUG), dtype=torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        K_t = K.permute(1, 2, 0).contiguous()
        L_t, D_t = cuda_ldlt.factor_soa(K_t)
        b_t = b.t().contiguous()
        L0, D0 = ldlt(K)
        t = {
            "K2": time_cuda(lambda: cuda_ldlt.factor_soa(K_t), 50),
            "K2_plain": time_cuda(lambda: ldlt(K), 5),
            "K3": time_cuda(lambda: cuda_ldlt.solve_soa(L_t, D_t, b_t), 50),
            "K3_plain": time_cuda(lambda: solve_ldlt(L0, D0, b), 5),
            "A_to_soa": time_cuda(
                lambda: K.permute(1, 2, 0).contiguous(), 50),
            "b_to_soa": time_cuda(lambda: b.t().contiguous(), 50),
            "K2_wrapper": time_cuda(lambda: cuda_ldlt.ldlt_auto(K), 50),
        }
        out[B] = t
        print(f"timing B={B} n={N_AUG} float32 (ms per call, CUDA events): "
              + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test "
              "runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}")

    from ipmzoo_tpu_torch.ops import _build, cuda_ldlt
    lib = _build.library_path("ldlt")
    cached = lib.exists()
    t0 = time.perf_counter()
    cuda_ldlt._lib()
    print(f"build: {SOURCE} ready in {time.perf_counter() - t0:.2f} s "
          f"({'reused' if cached else 'compiled'} {lib.name})")
    log = lib.with_suffix(".log")
    for line in log.read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: {line.strip()}")

    errs = check_kernels(dev)
    solve_demo(dev)
    data, res, launches = run_slice(dev)
    compare_cpu(data, res)
    times = time_kernels(dev)

    loaded = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "ipmzoo_tpu.models", "ipmzoo_tpu.ops", "ipmzoo_tpu.utils",
         "ipmzoo_tpu.parallel"))]
    check(not loaded, f"the port loaded JAX code: {loaded}")

    t = times[B_SLICE]
    kernels = [
        {"name": "K2 batched LDL^T factor", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES["ldlt"],
         "launches": launches["ldlt"], "max_abs_err": errs["ldlt"],
         "ms": t["K2"], "plain_ms": t["K2_plain"]},
        {"name": "K3 batched LDL^T solve", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES["solve_ldlt"],
         "launches": launches["solve_ldlt"],
         "max_abs_err": errs["solve_ldlt"],
         "ms": t["K3"], "plain_ms": t["K3_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
