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
* ``tp`` — one KKT system row-sharded over the ranks
  (:mod:`ipmzoo_tpu_torch.ops.sharded_ldlt`, ``CompiledIPM(kernel=
  'sharded')``): each panel's rows reach every rank by :func:`broadcast`.

A collective runs over one axis: on a mesh with more than one axis of
size above 1, every slice along an axis (the ranks that share every other
coordinate) has its own process group, made once by :func:`make_mesh`.

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
``Mesh.host_syncs``, its bytes (this rank's tensor) in
``Mesh.host_bytes``.  The decision is taken from the backend, never by
catching an error.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
    staged through the host, ``host_bytes`` the bytes of this rank's
    tensors they staged."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    rank: int = 0
    group: Optional[object] = None
    host_syncs: int = 0
    host_bytes: int = 0
    #: axis name -> the process group of this rank's slice along it,
    #: where the mesh has more than one axis of size above 1
    axis_groups: dict = dataclasses.field(default_factory=dict)

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

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return int(np.unravel_index(self.rank, self.devices.shape)[
            self.axis_names.index(axis)])

    def axis_rank(self, axis: str, index: int) -> int:
        """The rank at coordinate ``index`` along ``axis`` that shares
        every other coordinate with this rank."""
        coords = list(np.unravel_index(self.rank, self.devices.shape))
        coords[self.axis_names.index(axis)] = index
        return int(np.ravel_multi_index(coords, self.devices.shape))


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
    mesh = Mesh(arr.reshape(axis_sizes), axis_names, rank,
                group if world > 1 else None)
    if sum(s > 1 for s in axis_sizes) > 1:
        mesh.axis_groups = _slice_groups(mesh)
    return mesh


def _slice_groups(mesh: Mesh) -> dict:
    """This rank's process group along each axis of size above 1.  Every
    rank makes every slice's group, the slices of each axis in C order of
    the other coordinates, since ``new_group`` must be called by every
    rank of the world in the same order."""
    ranks = np.arange(mesh.size).reshape(mesh.devices.shape)
    mine = {}
    for a, (name, size) in enumerate(zip(mesh.axis_names,
                                         mesh.devices.shape)):
        if size == 1:
            continue
        slices = np.moveaxis(ranks, a, -1).reshape(-1, size)
        for members in slices:
            group = dist.new_group([int(r) for r in members])
            if mesh.rank in members:
                mine[name] = group
    return mine


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Layout that splits the leading (batch) axis across ``axis``."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# -- collectives over one mesh axis (the shard_map body's) -----------------

def _axis_group(mesh: Mesh, axis: str):
    """The process group of this rank's slice along ``axis``: None (the
    collective is the identity) at one rank or where the axis has size
    1, the whole group where every other axis has size 1."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no axis {axis!r} in mesh axes {mesh.axis_names}")
    if mesh.group is None or mesh.shape[axis] == 1:
        return None
    return mesh.axis_groups.get(axis, mesh.group)


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    """Whether a collective on ``x`` goes through the host (CUDA tensors
    on the gloo backend); counts it where it does."""
    staged = x.is_cuda and dist.get_backend(mesh.group) == "gloo"
    if staged:
        mesh.host_syncs += 1
        mesh.host_bytes += x.numel() * x.element_size()
    return staged


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op) -> torch.Tensor:
    group = _axis_group(mesh, axis)
    if group is None:
        return x
    if _staged(mesh, x):
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
    if src.dtype == torch.bool:
        # the backends move bytes, not booleans
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(device=x.device, dtype=x.dtype)


def broadcast(x: torch.Tensor, mesh: Mesh, axis: str,
              index: int) -> torch.Tensor:
    """The ``x`` of the rank at coordinate ``index`` along ``axis``, on
    every rank of this rank's slice, bit for bit.  The other ranks pass
    a tensor of the same shape and dtype, whose values are not read."""
    group = _axis_group(mesh, axis)
    if group is None:
        return x
    mine = mesh.axis_index(axis) == index
    if _staged(mesh, x):
        y = x.detach().contiguous().cpu() if mine else \
            torch.empty(x.shape, dtype=x.dtype)
        dist.broadcast(y, src=mesh.axis_rank(axis, index), group=group)
        return y.to(x.device)
    y = x.detach().contiguous() if mine else torch.empty_like(
        x, memory_format=torch.contiguous_format)
    dist.broadcast(y, src=mesh.axis_rank(axis, index), group=group)
    return y


def barrier(mesh: Mesh, axis: Optional[str] = None) -> None:
    """Wait for every rank of the mesh, or of this rank's slice along
    ``axis`` (nothing at one rank)."""
    group = mesh.group if axis is None else _axis_group(mesh, axis)
    if group is not None:
        dist.barrier(group=group)


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
    index = mesh.axis_index(axis)
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
