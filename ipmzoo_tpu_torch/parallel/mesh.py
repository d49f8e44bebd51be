"""Device meshes over ``torch.distributed`` (counterpart of
:mod:`ipmzoo_tpu.parallel.mesh`).

The framework's scaling axes:

* ``dp`` — data parallelism over independent QP instances: every rank
  steps its slice of the batch (:func:`shard_batch`), with no
  communication on the hot path; :func:`gather_batch` reads the sharded
  result back.
* ``sp`` — structure parallelism over the blocks of one coupled QP
  (``SchurIPM.solve_sharded``): the coupling system is assembled with
  :func:`psum` of the ranks' contributions.

A mesh is one rank per process, each on its own device
(:func:`ipmzoo_tpu_torch.parallel.distributed.initialize` joins the
processes first).  A process that never joined a group gets a one-rank
mesh whose collectives are the identity, as the reference's
``make_mesh()`` works without ``jax.distributed``.  The port's own class
is used rather than ``torch.distributed.device_mesh.DeviceMesh``, which
needs a process group even at one rank.

Collectives on the ``gloo`` backend run on host tensors: a CUDA tensor
is staged through the host (ranks that share one card take gloo, since
NCCL refuses two ranks on one GPU), and each staging is counted in
``Mesh.host_syncs``.  The decision is taken from the backend, never by
catching an error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_ROADMAP_TP = "ROADMAP.md Queue 1 item 16b (multi-device: the tp axis)"


class PartitionSpec(tuple):
    """Names of the mesh axes each array axis is split over, as the
    reference's ``PartitionSpec``: ``PartitionSpec("dp")`` splits the
    leading axis over ``dp``; ``PartitionSpec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass
class Mesh:
    """Ranks laid out on named axes.

    ``devices`` holds one ``torch.device`` per rank, shaped by the axis
    sizes; ``rank`` is this process's rank and ``group`` the process
    group (None for one rank).  ``host_syncs`` counts the collectives
    staged through the host."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    rank: int = 0
    group: Optional[object] = None
    host_syncs: int = 0

    @property
    def shape(self) -> dict:
        """Axis name -> size, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.devices.flat[self.rank]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """An array's layout over a mesh: ``spec`` names the mesh axis of
    each array axis."""
    mesh: Mesh
    spec: PartitionSpec


def _world() -> Tuple[int, int, Optional[object]]:
    """(world size, rank, group) of this process; one rank and no group
    where no process group was joined."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    return 1, 0, None


def default_devices(world: int) -> list:
    """One CUDA device per rank, ``cuda:{rank % device_count}``; raises
    where the process has no card (the tests pass CPU devices)."""
    count = torch.cuda.device_count()
    if count == 0:
        # torch's own error on a machine without a card
        torch.empty(0, device="cuda")
    return [torch.device("cuda", r % count) for r in range(world)]


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp",),
              devices=None) -> Mesh:
    """A mesh over the ranks of the process group (one rank where none
    was joined).  With defaults, a 1-D data-parallel mesh over every
    rank, each on its card.

    ``devices``: one ``torch.device`` (or name) per rank, indexed by
    rank; ``None`` is :func:`default_devices`.  Raises, as the reference,
    when the axes need more ranks than the world has; a mesh spans every
    rank of the group, so fewer raise too."""
    world, rank, group = _world()
    if devices is None:
        devices = default_devices(world)
    devices = [torch.device(d) for d in devices]
    if axis_sizes is None:
        axis_sizes = (world,)
    axis_sizes, axis_names = tuple(axis_sizes), tuple(axis_names)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"axis sizes {axis_sizes} and names {axis_names} "
                         f"differ in length")
    n = int(np.prod(axis_sizes))
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh of {n} ranks in a world of {world}: a mesh "
                         f"spans every rank of the process group")
    if len(devices) < n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(axis_sizes), axis_names, rank,
                group if world > 1 else None)


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Layout that splits the leading (batch) axis across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# -- collectives over one mesh axis (the shard_map body's) -----------------

def _axis_group(mesh: Mesh, axis: str):
    """The process group of ``axis``: the whole group where every other
    axis has one rank."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no axis {axis!r} in mesh axes {mesh.axis_names}")
    if any(s > 1 for a, s in mesh.shape.items() if a != axis):
        raise NotImplementedError(
            f"a collective over axis {axis!r} of the mesh {mesh.shape} is "
            f"not ported: see {_ROADMAP_TP}")
    return mesh.group


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` goes through the host: CUDA tensors
    on the gloo backend."""
    return x.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op) -> torch.Tensor:
    group = _axis_group(mesh, axis)
    if group is None:
        return x
    if _staged(mesh, x):
        mesh.host_syncs += 1
        y = x.detach().cpu()
        dist.all_reduce(y, op=op, group=group)
        return y.to(x.device)
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``); every rank
    gets the same bits."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """Elementwise minimum over the ranks of ``axis`` (``lax.pmin``)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str = "dp") -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis`` (``lax.pmax``)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "dp",
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in rank order (``lax.all_gather``): stacked on
    a new leading axis, or concatenated along axis 0 where ``tiled``."""
    group = _axis_group(mesh, axis)
    if group is None:
        return x if tiled else x.unsqueeze(0)
    staged = _staged(mesh, x)
    src = x.detach().cpu() if staged else x.detach().contiguous()
    if staged:
        mesh.host_syncs += 1
    if src.dtype == torch.bool:
        # the backends move bytes, not booleans
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(device=x.device, dtype=x.dtype)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (nothing at one rank)."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


# -- sharded batches --------------------------------------------------------

def _leaves(tree):
    from ..models.state import tree_map
    out = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


def shard_slice(size: int, mesh: Mesh, axis: str = "dp") -> slice:
    """This rank's contiguous slice of a leading axis of ``size`` split
    over ``axis``; the size must divide, as under ``shard_map``."""
    ranks = mesh.shape[axis]
    if size % ranks:
        raise ValueError(f"a leading axis of {size} does not split over "
                         f"{ranks} ranks of axis {axis!r}")
    per = size // ranks
    index = np.unravel_index(mesh.rank, mesh.devices.shape)[
        mesh.axis_names.index(axis)]
    return slice(index * per, (index + 1) * per)


def shard_batch(tree, mesh: Mesh, axis: str = "dp"):
    """This rank's slice of every leaf's leading axis (the counterpart of
    ``jax.device_put(tree, batch_sharding(mesh, axis))``), on this rank's
    device; every leaf must have the same leading size."""
    from ..models.state import tree_map
    sizes = {t.shape[0] for t in _leaves(tree)}
    if len(sizes) != 1:
        raise ValueError(f"leaves of leading sizes {sorted(sizes)}")
    sl = shard_slice(sizes.pop(), mesh, axis)
    return tree_map(lambda t: t[sl].to(mesh.device), tree)


def gather_batch(tree, mesh: Mesh, axis: str = "dp"):
    """The whole batch on every rank from each rank's slice (reading a
    sharded result back): every leaf concatenated along its leading axis
    in rank order."""
    from ..models.state import tree_map
    return tree_map(lambda t: all_gather(t, mesh, axis, tiled=True), tree)
