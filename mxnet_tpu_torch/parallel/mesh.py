"""Device mesh with the canonical axis names (dp, pp, ep, sp, tp), over
``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. JAX's ``Mesh`` is a grid of
the devices of one process, and its arrays are global. Here the mesh is a
grid of ranks, one process and one device (a card, or the CPU where the
caller asks for it) per rank, and every tensor a rank holds is its own
block. Ranks map to coordinates row-major over :data:`AXES`, ``tp``
innermost, as the JAX package reshapes its device list.

Each axis of size > 1 has a process group per line of ranks along it, and so
have the products a step sums over: ``("dp", "sp")`` (the sharded LM's
gradients), ``("dp", "ep")`` (the MoE LM's batch and its stage leaves'
gradients) and ``("dp", "pp", "ep")`` (its loss and its replicated
leaves' gradients). Every rank builds every group, in one order, when the
mesh is made. A mesh of one rank needs no process group and takes the same
code path: its collectives are the identity.

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

from ..comm.allreduce import (_all_gather, _all_to_all, _staged, _to_card,
                              _to_host)
from ..comm.allreduce import all_reduce_sum as _all_reduce_sum
from ..context import Context, gpu

__all__ = ["make_mesh", "auto_mesh", "data_sharding", "replicated", "AXES",
           "Mesh", "MeshAxis", "PartitionSpec", "P", "Sharding", "as_axis",
           "all_reduce_sum", "all_reduce_max", "all_gather", "ring_shift",
           "Shift", "all_to_all", "sum_gradients"]

AXES = ("dp", "pp", "ep", "sp", "tp")
# the products of axes a mesh builds groups for, besides each axis
PRODUCTS = (("dp", "sp"), ("dp", "ep"), ("dp", "pp", "ep"))


def _names(entry) -> tuple:
    """A spec entry or an axis product as a tuple of axis names."""
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, the mesh axis
    it is split over, a tuple of axes (split over their product, the first
    major), or None; missing trailing entries are None."""

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
        for names in [(a,) for a in AXES] + list(PRODUCTS):
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
        """The ranks along ``names`` at this rank's other coordinates, in
        :data:`AXES` order whatever the order of ``names`` (the first
        major): ``axis("tp")``, or one of the products of
        :data:`PRODUCTS` (``axis("dp", "sp")``, ...)."""
        key = tuple(sorted(names, key=lambda a: AXES.index(a)
                           if a in AXES else -1))
        if key not in self._axes:
            raise ValueError(f"mesh axis {names}: one of {AXES}, or one of "
                             f"{PRODUCTS}")
        return self._axes[key]

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


class Shift(torch.autograd.Function):
    """:func:`ring_shift` as an autograd function, ``Shift.apply(axis,
    *tensors)``: the gradients travel the ring the other way (ppermute's
    transpose)."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return tuple(ring_shift(tensors, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ring_shift(grads, ctx.axis, reverse=True))


def _exchange(t, axis, split_axis, concat_axis):
    n = axis.size
    if t.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(t.shape)} is not a multiple of {n}")
    # chunk i of the split dimension to rank i ...
    chunks = t.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
    got = _all_to_all(chunks, axis.group)
    # ... and the chunks received, in source order, along the concat one
    return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, split_axis, concat_axis):
        ctx.args = axis, concat_axis, split_axis
        return _exchange(t, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, *ctx.args), None, None, None


def all_to_all(t: torch.Tensor, axis: MeshAxis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(t, split_axis, concat_axis, tiled=True)`` over the
    ranks of ``axis``: dimension ``split_axis`` is cut into ``axis.size``
    chunks, chunk i goes to rank i, and the chunks received are concatenated
    along ``concat_axis`` in source order. Differentiable: the gradient
    takes the inverse exchange (split and concat swapped)."""
    if axis.size == 1:
        return t
    return _AllToAll.apply(t, axis, split_axis, concat_axis)


def sum_gradients(grads: dict, axes) -> dict:
    """Each gradient summed over the ranks that hold the same block: over
    ``axes``, one :class:`MeshAxis` for every leaf or a dict of one per
    leaf. One collective per axis, over the flattened f32 leaves that sum
    over it, in the order the leaves first name it (the same on every
    rank); unchanged on one rank."""
    by_leaf = axes if isinstance(axes, dict) else dict.fromkeys(grads, axes)
    groups = {}
    for k in grads:
        groups.setdefault(id(by_leaf[k]), (by_leaf[k], []))[1].append(k)
    out = {}
    for axis, names in groups.values():
        if axis.size == 1:
            out.update({k: grads[k].contiguous() for k in names})
            continue
        flat = all_reduce_sum(torch.cat([grads[k].reshape(-1)
                                         for k in names]), axis)
        off = 0
        for k in names:
            out[k] = flat[off:off + grads[k].numel()].view(grads[k].shape)
            off += grads[k].numel()
    return {k: out[k] for k in grads}


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
    axis, block ``coords[axis]`` to each rank; a dimension named by a tuple
    of axes (in :data:`AXES` order) over their product, the first major,
    as JAX lays out ``P(("dp", "ep"))``. With ``parts`` > 1 the split
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
        split = [a for e in self.spec if e is not None for a in _names(e)]
        for a in split:
            if a not in AXES:
                raise ValueError(f"unknown mesh axis {a!r} in {self.spec}")
        if len(set(split)) != len(split):
            raise ValueError(f"{self.spec} splits over one axis twice")
        for e in self.spec:
            if isinstance(e, (tuple, list)) and list(e) != sorted(
                    e, key=AXES.index):
                raise ValueError(f"{self.spec}: the axes of {e} must come "
                                 f"in the mesh's order {AXES}")

    def _split_dims(self, ndim):
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than the "
                             f"array's {ndim} dimensions")
        return [(i, _names(e)) for i, e in enumerate(self.spec)
                if e is not None]

    def _block(self, names):
        """The number of blocks over ``names`` and this rank's index."""
        n, j = 1, 0
        for a in names:
            n, j = n * self.mesh.shape[a], j * self.mesh.shape[a] + \
                self.mesh.coords[a]
        return n, j

    def local_shape(self, global_shape) -> tuple:
        shape = list(global_shape)
        for i, names in self._split_dims(len(shape)):
            n = self._block(names)[0]
            if shape[i] % (n * self.parts):
                raise ValueError(
                    f"dimension {i} of {tuple(global_shape)} is not a "
                    f"multiple of {self.parts} x {'*'.join(names)}={n}")
            shape[i] //= n
        return tuple(shape)

    def shard(self, x) -> torch.Tensor:
        """This rank's block of the global array ``x`` (a tensor or a
        numpy-convertible array), a new tensor on the mesh's device."""
        t = x if isinstance(x, torch.Tensor) else _tensor(x, "cpu")
        self.local_shape(t.shape)
        for i, names in self._split_dims(t.dim()):
            n, j = self._block(names)
            part = t.shape[i] // self.parts
            t = t.unflatten(i, (self.parts, n, part // n)).select(i + 1, j)
            t = t.flatten(i, i + 1)
        return t.to(self.mesh.device, memory_format=torch.contiguous_format,
                    copy=True)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block (a collective: every
        rank along the spec's axes calls it)."""
        t = local
        for i, names in reversed(self._split_dims(t.dim())):
            blocks = all_gather(t, self.mesh.axis(*names))
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
