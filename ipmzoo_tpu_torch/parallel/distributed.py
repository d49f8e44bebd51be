"""Multi-process initialisation and launch (counterpart of
:mod:`ipmzoo_tpu.parallel.distributed`).

Every process runs the same program; call :func:`initialize` once at
startup and every mesh built by :func:`.mesh.make_mesh` then spans the
process group.  With no arguments it reads torch's standard launch
variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
as ``torchrun`` sets them or a user exports them per process), the
counterpart of the reference's auto-detection.

The backend follows one rule: ``nccl`` where every local rank has a card
of its own, ``gloo`` on the CPU and where ranks share a card (NCCL
refuses two ranks on one GPU).  Ranks sharing one card time-slice it:
their times measure the mechanics, not scaling.

:func:`spawn` starts ``world`` fresh processes joined in one group, runs
a function in each and returns what each rank returned; a rank that
fails or overruns its deadline fails the call.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist


def backend(local_world: int) -> str:
    """``nccl`` where this host has a card for each of its
    ``local_world`` ranks, else ``gloo``."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= \
            local_world:
        return "nccl"
    return "gloo"


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group (a no-op for one process).

    With no arguments, the launch variables ``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` say it; arguments override them
    (``coordinator_address`` as ``host:port``, ``tcp://host:port`` or
    ``file://path``).  ``LOCAL_WORLD_SIZE`` (default: every rank on this
    host) decides the backend with :func:`backend`."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dist.init_process_group(backend(local),
                            init_method=_init_method(coordinator_address),
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world_rank():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_primary() -> bool:
    return _world_rank()[1] == 0


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) slice of a globally sharded batch that this
    process should materialise (for per-process data loading)."""
    world, rank = _world_rank()
    per = global_batch // world
    return slice(rank * per, rank * per + per)


# -- launch -----------------------------------------------------------------

def _rank_main(fn, rank, world, init, cpu, args, results):
    if cpu:
        # the ranks see no card, so the rule takes gloo
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    try:
        initialize(init, world, rank)
        results.put((rank, True, fn(*args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn(fn, world: int, *args, cpu: bool = False,
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` in ``world`` new processes joined in one process
    group (rendezvous through a file, so concurrent runs never share a
    port) and return each rank's result in rank order.

    ``fn`` must be importable by name and return something picklable.
    ``cpu``: the processes see no card (gloo, CPU devices).  Raises
    ``RuntimeError`` with the tracebacks where a rank fails, and
    ``TimeoutError`` where the ranks have not all finished after
    ``timeout`` seconds; the remaining processes are killed either way."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="ipmzoo_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, cpu, args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world and not errors:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(world)) - set(results))
                    raise TimeoutError(f"ranks {missing} of {world} did not "
                                       f"finish within {timeout:g} s")
                try:
                    rank, ok, value = out.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and p.exitcode not in (None, 0):
                            errors[r] = f"exited with code {p.exitcode}"
                    continue
                (results if ok else errors)[rank] = value
        finally:
            for p in procs:
                p.join(timeout=0 if errors else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("".join(f"\nrank {r} of {world} failed:\n{e}"
                                   for r, e in sorted(errors.items())))
    return [results[r] for r in range(world)]
