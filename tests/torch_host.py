"""The port's tests' share of the host, imported by every
``tests/test_torch_*.py`` file.

Under pytest-xdist each worker process gets ``cores // workers`` torch
intra-op threads (at least one), and its child processes the same through
``OMP_NUM_THREADS``.  torch's default is one thread a core in every
process: six workers on eight cores then run 48 OpenMP threads, and a
test of many small tensor operations (K1's plain version, say) waits on
its barriers for minutes instead of seconds.  Alone, without xdist, torch
keeps its default.

``BUILD_JOBS`` is how many g++ processes a test file runs at once for its
host builds: one inside an xdist worker (the other workers hold the other
cores), else six.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
CORES = len(os.sched_getaffinity(0))

if WORKERS:
    torch.set_num_threads(max(1, CORES // WORKERS))
    os.environ["OMP_NUM_THREADS"] = str(torch.get_num_threads())
BUILD_JOBS = 1 if WORKERS else 6


def build_all(build, keys):
    """``{key: build(key)}`` over ``keys``, ``BUILD_JOBS`` at a time."""
    keys = list(keys)
    with ThreadPoolExecutor(BUILD_JOBS) as pool:
        return dict(zip(keys, pool.map(build, keys)))
