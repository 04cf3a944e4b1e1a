"""Device mesh with the canonical axis names (dp, pp, ep, sp, tp), over
``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. JAX's ``Mesh`` is a grid of
the devices of one process, and its arrays are global. Here the mesh is a
grid of ranks, one process and one device (a card, or the CPU where the
caller asks for it) per rank, and every tensor a rank holds is its own
block. Ranks map to coordinates row-major over :data:`AXES`, ``tp``
innermost, as the JAX package reshapes its device list.

Each axis of size > 1 has a process group per line of ranks along it, and so
has the product ``("dp", "sp")``, over which a sharded step sums its
gradients. Every rank builds every group, in one order, when the mesh is
made. A mesh of one rank needs no process group and takes the same code
path: its collectives are the identity.

The collectives here take a :class:`MeshAxis`. With the gloo backend a CUDA
tensor travels through pinned host buffers (``comm/allreduce.py``); with
nccl it goes as it is. The backend decides.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..comm.allreduce import _all_gather, _staged, _to_card, _to_host
from ..comm.allreduce import all_reduce_sum as _all_reduce_sum
from ..context import Context, gpu

__all__ = ["make_mesh", "auto_mesh", "data_sharding", "replicated", "AXES",
           "Mesh", "MeshAxis", "PartitionSpec", "P", "Sharding", "as_axis",
           "all_reduce_sum", "all_reduce_max", "all_gather", "ring_shift"]

AXES = ("dp", "pp", "ep", "sp", "tp")


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, the mesh axis
    it is split over or None; missing trailing entries are None."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshAxis:
    """The ranks along one axis, or a product of axes, seen from one rank:
    ``ranks`` (global ranks in axis order), this rank's ``index`` among
    them, and ``group``, their process group (None for one rank)."""

    def __init__(self, name, ranks, index, group):
        self.name = name
        self.ranks = tuple(int(r) for r in ranks)
        self.index = int(index)
        self.group = group

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self):
        return (f"MeshAxis({self.name!r}, ranks={self.ranks}, "
                f"index={self.index})")


def as_axis(group) -> MeshAxis:
    """A :class:`MeshAxis` from what the collectives of the port take: a
    MeshAxis, a process group, or None for the world (one rank where no
    process group was initialized)."""
    if isinstance(group, MeshAxis):
        return group
    if group is None and not dist.is_initialized():
        return MeshAxis("world", (0,), 0, None)
    if group is None or isinstance(group, dist.ProcessGroup):
        ranks = dist.get_process_group_ranks(group or dist.group.WORLD)
        return MeshAxis("group", ranks, dist.get_rank(group),
                        group if len(ranks) > 1 else None)
    raise TypeError(f"expected a MeshAxis, a ProcessGroup or None, got "
                    f"{type(group).__name__} (a mesh axis is "
                    "mesh.axis('sp'), not its name)")


def _device(devices) -> torch.device:
    if devices is None:
        local = os.environ.get("LOCAL_RANK")
        rank = int(local) if local is not None else (
            dist.get_rank() if dist.is_initialized() else 0)
        return gpu(rank).torch_device
    if isinstance(devices, Context):
        return devices.torch_device
    return torch.device(devices)


class Mesh:
    """A grid of ranks with named axes. ``shape`` maps each axis of
    :data:`AXES` to its size (a dict, as JAX's ``mesh.shape``), ``coords``
    this rank's index along each, ``device`` this rank's device;
    :meth:`axis` gives the ranks along one axis or a product of axes."""

    axis_names = AXES

    def __init__(self, sizes: dict, rank: int, device: torch.device):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self.size = math.prod(self.shape.values())
        self.rank = int(rank)
        self.device = torch.device(device)
        self._grid = np.arange(self.size).reshape(
            [self.shape[a] for a in AXES])
        self.coords = {a: int(c) for a, c in
                       zip(AXES, np.unravel_index(self.rank,
                                                  self._grid.shape))}
        self._axes = {}
        for names in [(a,) for a in AXES] + [("dp", "sp")]:
            self._build(names)

    def _build(self, names):
        """Every group along ``names`` (each line of ranks that differ only
        there), built by every rank in one order; keeps this rank's."""
        live = tuple(a for a in names if self.shape[a] > 1)
        if live in self._axes:
            self._axes[names] = self._axes[live]
            return
        moved = [AXES.index(a) for a in live]
        rest = [i for i in range(len(AXES)) if i not in moved]
        n = math.prod(self.shape[a] for a in live)
        lines = self._grid.transpose(rest + moved).reshape(-1, n)
        mine = None
        for line in lines:
            group = dist.new_group([int(r) for r in line]) if n > 1 else None
            if self.rank in line:
                mine = MeshAxis("x".join(names), line,
                                int(np.flatnonzero(line == self.rank)[0]),
                                group)
        self._axes[names] = self._axes[live] = mine

    def axis(self, *names) -> MeshAxis:
        """The ranks along ``names`` at this rank's other coordinates:
        ``axis("tp")``, or ``axis("dp", "sp")`` for the gradient sums (the
        products the mesh built its groups for)."""
        if names not in self._axes:
            raise ValueError(f"mesh axis {names}: one of {AXES}, or "
                             "('dp', 'sp')")
        return self._axes[names]

    def __repr__(self):
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"device={self.device})")


def make_mesh(dp=1, tp=1, sp=1, pp=1, ep=1, devices=None) -> Mesh:
    """This rank's view of a mesh with the named axes; the sizes must
    multiply to the world size (1 without a process group). ``devices``
    is this rank's device (a Context or torch.device); by default the card
    ``gpu(LOCAL_RANK)``, else ``gpu(rank)``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    sizes = {"dp": dp, "pp": pp, "ep": ep, "sp": sp, "tp": tp}
    total = int(np.prod(list(sizes.values())))
    if total != world:
        raise ValueError(f"mesh {sizes} needs {total} devices, have {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return Mesh(sizes, rank, _device(devices))


def auto_mesh(n_devices=None, tp=1, sp=1, pp=1, ep=1, devices=None) -> Mesh:
    """Mesh with dp filling whatever the fixed axes leave of the world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"auto_mesh: n_devices={n_devices}, but a mesh "
                         f"spans the world's {world} ranks")
    fixed = tp * sp * pp * ep
    if world % fixed:
        raise ValueError(f"{world} devices not divisible by "
                         f"tp*sp*pp*ep={fixed}")
    return make_mesh(dp=world // fixed, tp=tp, sp=sp, pp=pp, ep=ep,
                     devices=devices)


def local_mesh(device) -> Mesh:
    """The mesh of one rank on ``device``, with no process group: what a
    model takes for ``mesh=None``."""
    return Mesh({a: 1 for a in AXES}, 0, device)


# --------------------------------------------------------------------------
# collectives over one axis
# --------------------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """A new tensor: the sum of ``t`` over the ranks of ``axis``, the same
    bits on every one of them."""
    if axis.size == 1:
        return t.detach().clone()
    return _all_reduce_sum(t.contiguous(), axis.group)


def all_gather(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``(axis.size,) + t.shape``: every rank's ``t`` in axis order."""
    if axis.size == 1:
        return t.detach()[None].clone()
    return _all_gather(t.contiguous(), axis.group, axis.size)


def all_reduce_max(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``axis``."""
    return all_gather(t, axis).amax(0)


def ring_shift(tensors, axis: MeshAxis, reverse=False):
    """``lax.ppermute`` with ``perm = [(j, (j + 1) % n)]``: each tensor goes
    to the next rank along ``axis`` and the previous rank's comes back
    (``reverse``: the other way round). Every send and receive is posted
    before any is waited on: in a ring of two, the next and the previous
    rank are one peer, and blocking calls would deadlock."""
    tensors = [t.detach() for t in tensors]
    n = axis.size
    if n == 1:
        return tensors
    step = -1 if reverse else 1
    dst = axis.ranks[(axis.index + step) % n]
    src = axis.ranks[(axis.index - step) % n]
    staged = _staged(tensors[0], axis.group)
    sends = [_to_host(t) if staged else t.contiguous() for t in tensors]
    recvs = [torch.empty(s.shape, dtype=s.dtype, device=s.device,
                         pin_memory=staged) for s in sends]
    ops = [dist.P2POp(dist.isend, s, dst, axis.group, tag)
           for tag, s in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, r, src, axis.group, tag)
            for tag, r in enumerate(recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        return [_to_card(r, t.device) for r, t in zip(recvs, tensors)]
    return recvs


# --------------------------------------------------------------------------
# shardings: where a global array's blocks live
# --------------------------------------------------------------------------

def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return torch.from_numpy(np.array(x)).to(device)


class Sharding:
    """A global array cut over a mesh by ``spec`` (a :class:`P`): each
    dimension named there is split in equal contiguous blocks over that
    axis, block ``coords[axis]`` to each rank. With ``parts`` > 1 the split
    dimension is first cut into ``parts`` equal parts and each part is
    split over the axis: the transformer's fused ``(d, 3d)`` qkv weight
    split by heads, so that a rank holds q, k and v of its own heads.

    :meth:`shard` (no communication) gives this rank's block of a global
    array; :meth:`gather` (a collective over the spec's axes) gives the
    global array back, bitwise."""

    def __init__(self, mesh: Mesh, spec=P(), parts: int = 1):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)
        self.parts = int(parts)
        split = [a for a in self.spec if a is not None]
        for a in split:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r} in {self.spec}")
        if len(set(split)) != len(split):
            raise ValueError(f"{self.spec} splits over one axis twice")

    def _split_dims(self, ndim):
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the "
                             f"array's {ndim} dimensions")
        return [(i, a) for i, a in enumerate(self.spec) if a is not None]

    def local_shape(self, global_shape) -> tuple:
        shape = list(global_shape)
        for i, a in self._split_dims(len(shape)):
            n = self.mesh.shape[a]
            if shape[i] % (n * self.parts):
                raise ValueError(
                    f"dimension {i} of {tuple(global_shape)} is not a "
                    f"multiple of {self.parts} x {a}={n}")
            shape[i] //= n
        return tuple(shape)

    def shard(self, x) -> torch.Tensor:
        """This rank's block of the global array ``x`` (a tensor or a
        numpy-convertible array), a new tensor on the mesh's device."""
        t = x if isinstance(x, torch.Tensor) else _tensor(x, "cpu")
        self.local_shape(t.shape)
        for i, a in self._split_dims(t.dim()):
            n, j = self.mesh.shape[a], self.mesh.coords[a]
            part = t.shape[i] // self.parts
            t = t.unflatten(i, (self.parts, n, part // n)).select(i + 1, j)
            t = t.flatten(i, i + 1)
        return t.to(self.mesh.device, memory_format=torch.contiguous_format,
                    copy=True)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block (a collective: every
        rank along the spec's axes calls it)."""
        t = local
        for i, a in reversed(self._split_dims(t.dim())):
            blocks = all_gather(t, self.mesh.axis(a))
            m = t.shape[i] // self.parts
            t = torch.stack([b.unflatten(i, (self.parts, m)) for b in blocks],
                            dim=i + 1).flatten(i, i + 2)
        return t


def data_sharding(mesh: Mesh, extra_axis=None) -> Sharding:
    """Batch-dim sharding over dp (optionally dp+sp for sequence inputs)."""
    if extra_axis:
        return Sharding(mesh, P("dp", extra_axis))
    return Sharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, P())
