"""Compressed gradient allreduce across ``torch.distributed`` ranks, or
across the replicas of one process.

Counterpart of ``mxnet_tpu/comm/allreduce.py``. Each rank calls these with
its own gradients, as each device runs the JAX package's functions inside
``shard_map``; the data axis is a process group (default: the world), and
``lax.all_to_all(tiled)`` / ``lax.all_gather`` become
``dist.all_to_all_single`` / ``dist.all_gather``. The decomposition:

    flatten grads -> one flat f32 vector (dict keys in sorted order, as
                     jax.tree_util flattens them)
    + error-feedback residual (lossy modes)
    reshape (ranks, per) -> encode rows          stage-1 quantize
    all_to_all            = reduce-scatter of the quantized payload:
                            rank i receives every peer's row i
    decode + sum          -> this rank's reduced shard, in f32
    encode shard          -> stage-2 quantize (twobit gathers in bf16)
    all_gather + decode   -> the full reduced vector on every rank

Error feedback: the residual (what quantization dropped) is returned to the
caller, who adds it to the next step's gradient. A rank's residual holds
the stage-1 error of every row it sent and the stage-2 error of the shard
it owns.

On the wire every payload is its raw bytes (``.view(torch.uint8)``), so
int8, uint8, bf16 and f32 payloads travel alike. With the gloo backend a
CUDA payload goes through pinned host buffers, copied by this module; with
nccl the CUDA tensors go as they are. The backend decides, never a caught
error.

A :class:`ReplicaGroup` is the data axis of one process that holds several
replicas (``FeedForward(ctx=[...])``), the JAX package's single-process
``dp`` mesh. Its members are the replicas, in ctx order, and every
function here then takes and returns one value a member (a list) where a
rank passes its own: ``all_to_all`` regroups the members' rows,
``all_gather`` stacks their payloads, ``all_reduce`` sums in member order
and ``broadcast`` copies member 0's. The quantize and dequantize stages
run once a member, on the member's own rows, exactly as each rank runs
them, so the same rows give the same bits either way. Members on one
device exchange by copies on that device; on several, by device-to-device
copies. Nothing goes through the host.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..base import ENV_OFF_VALUES, ENV_ON_VALUES, MXNetError
from .compression import CompressionSpec, decode, encode, quantization_unit
from .stats import collective_range

__all__ = ["CommKernelConfig", "ReplicaGroup", "compressed_allreduce",
           "error_feedback_allreduce", "compressed_exchange",
           "error_feedback_exchange", "flat_views", "init_error_feedback",
           "flat_size", "padded_flat_size", "all_reduce_sum", "broadcast_"]


class ReplicaGroup:
    """The replicas of one process as a data axis: one ``torch.device`` a
    member, in member order (several members may share a device). The
    module's functions take one tensor (or tree) a member in a list and
    return a list, in member order."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise MXNetError("ReplicaGroup needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"ReplicaGroup({[str(d) for d in self.devices]})"


def _replicas(group) -> bool:
    return isinstance(group, ReplicaGroup)


def _members(value, group) -> list:
    """The per-member values of a call: the list a ReplicaGroup's caller
    passes, or this rank's one value."""
    if not _replicas(group):
        return [value]
    value = list(value)
    if len(value) != group.size:
        raise MXNetError(f"{len(value)} values for a group of {group.size} "
                         "replicas: pass one a replica")
    return value


def _returned(values: list, group):
    """What a call returns: the list for a ReplicaGroup, else the one
    value."""
    return values if _replicas(group) else values[0]


def _member_rank(group, m: int) -> int:
    """Member ``m``'s index on the data axis."""
    return m if _replicas(group) else dist.get_rank(group)


class CommKernelConfig:
    """Route the quantize/dequantize stages through the fused kernels
    (``kernels/comm_kernels.py``) instead of the codecs. Same wire bits
    either way. ``block_elems`` is validated as the JAX package's VMEM
    block cap and changes no result here. Inside the kernel path the route
    is by device: CUDA tensors launch the kernels, CPU tensors take their
    plain versions."""

    def __init__(self, block_elems=None):
        self.block_elems = None if block_elems is None else int(block_elems)
        if self.block_elems is not None and self.block_elems <= 0:
            raise MXNetError("comm kernel block_elems must be positive")

    def __repr__(self):
        return f"CommKernelConfig(block_elems={self.block_elems})"

    def key(self):
        """Hashable identity (a component of a program's cache key), in the
        JAX package's form; its last slot, the Pallas interpret override,
        is None here: a CUDA kernel has no interpret mode."""
        return ("comm_kernels", self.block_elems, None)

    @classmethod
    def resolve(cls, value):
        """Normalize a user-facing ``comm_kernels`` argument: None -> env
        gate ``MXNET_TPU_COMM_KERNELS`` (unset/falsy = codec path, truthy =
        kernels, an integer = the block-element cap, anything else raises);
        True -> kernels with defaults; an int -> that cap; a config passes
        through. Returns None (codec path) or a CommKernelConfig."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_COMM_KERNELS",
                                 "").strip().lower()
            if raw in ("",) + ENV_OFF_VALUES:
                return None
            if raw in ENV_ON_VALUES:
                return cls()
            try:
                return cls(int(raw))
            except ValueError:
                raise MXNetError(
                    f"MXNET_TPU_COMM_KERNELS={raw!r} not understood "
                    "(use 1/0 or a block-element cap)") from None
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        return cls(int(value))


# stage-2 (all-gather) codec for twobit: the reduced shard holds sums in
# multiples of ±threshold, outside the 2-bit alphabet
_TWOBIT_GATHER = CompressionSpec("bf16")


def _gather_spec(spec: CompressionSpec) -> CompressionSpec:
    return _TWOBIT_GATHER if spec.mode == "twobit" else spec


# -- trees -------------------------------------------------------------------

def _tree_flatten(tree):
    """Leaves in jax.tree_util's order (dict keys sorted, sequences in
    order) and the structure to rebuild them."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_tree_flatten(tree[k]) for k in keys]
        return ([l for leaves, _ in parts for l in leaves],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_tree_flatten(v) for v in tree]
        return ([l for leaves, _ in parts for l in leaves],
                (type(tree), None, [s for _, s in parts]))
    return [tree], None


def _tree_unflatten(structure, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, children = s
        values = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, values))
        return kind(values)

    return build(structure)


def _tree_map(fn, tree):
    leaves, structure = _tree_flatten(tree)
    return _tree_unflatten(structure, [fn(l) for l in leaves])


def _flatten(tree):
    """One new flat f32 vector of the leaves (never a view of a leaf, so
    callers may write it) and what :func:`_unflatten` needs."""
    leaves, structure = _tree_flatten(tree)
    meta = [(tuple(l.shape), l.dtype) for l in leaves]
    flat = torch.cat([l.to(torch.float32).reshape(-1) for l in leaves])
    return flat, (structure, meta)


def _unflatten(flat, spec_meta):
    structure, meta = spec_meta
    out, off = [], 0
    for shape, dtype in meta:
        size = 1
        for d in shape:
            size *= int(d)
        out.append(flat[off:off + size].reshape(shape).to(dtype))
        off += size
    return _tree_unflatten(structure, out)


def flat_size(tree) -> int:
    """Total element count of a tree of tensors (the fused bucket length)."""
    return sum(int(l.numel()) for l in _tree_flatten(tree)[0])


def padded_flat_size(num_elements: int, spec: CompressionSpec,
                     axis_size: int) -> int:
    """Flat length after padding so every rank's row is a whole number of
    quantization units (int8 chunks / twobit nibbles)."""
    unit = quantization_unit(spec) * int(axis_size)
    return -(-int(num_elements) // unit) * unit


def _pad_flat(flat, spec, axis_size):
    L = flat.shape[0]
    Lp = padded_flat_size(L, spec, axis_size)
    if Lp > L:
        flat = torch.cat([flat, flat.new_zeros(Lp - L)])
    return flat, L


# -- the wire ----------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    """gloo takes CUDA payloads through pinned host buffers."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _buffer(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        return torch.empty(shape, dtype=torch.uint8, pin_memory=True)
    return torch.empty(shape, dtype=torch.uint8, device=like.device)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t``; returns once the copy is done."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _to_card(host: torch.Tensor, device) -> torch.Tensor:
    """``host`` back on ``device``, queued on the current stream."""
    return host.to(device, non_blocking=True)


def _wire(op: str, out: torch.Tensor, inp: torch.Tensor, group):
    """One collective on uint8 buffers of the backend's device: ``op`` is
    ``all_to_all`` (row i of ``inp`` to rank i, row j of ``out`` from rank
    j), ``all_gather`` (``inp`` of every rank into the rows of ``out``),
    ``all_reduce`` (sum in place, ``out`` is ``inp``) or ``broadcast``
    (from rank 0 in place)."""
    if op == "all_to_all":
        dist.all_to_all_single(out, inp, group=group)
    elif op == "all_gather":
        dist.all_gather(list(out.unbind(0)), inp, group=group)
    elif op == "all_reduce":
        dist.all_reduce(inp, op=dist.ReduceOp.SUM, group=group)
    elif op == "broadcast":
        dist.broadcast(inp, src=dist.get_global_rank(group, 0)
                       if group is not None else 0, group=group)
    else:
        raise ValueError(f"unknown collective {op!r}")


def _rows_bytes(t: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> its raw bytes as (n, row bytes) uint8."""
    return t.contiguous().reshape(t.shape[0], -1).view(torch.uint8)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_to_all(t, split_axis=0, concat_axis=0, tiled=True)``."""
    src = _rows_bytes(t)
    staged = _staged(t, group)
    if staged:
        src = _to_host(src)
    dst = _buffer(src.shape, t, staged)
    with collective_range("all-to-all", t.dtype, t.numel(),
                          dist.get_world_size(group)):
        _wire("all_to_all", dst, src, group)
    if staged:
        dst = _to_card(dst, t.device)
    return dst.view(t.dtype).reshape(t.shape)


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``lax.all_gather(t, axis=0, tiled=False)``: (n,) + t.shape."""
    src = _rows_bytes(t.reshape((1,) + tuple(t.shape)))[0]
    staged = _staged(t, group)
    if staged:
        src = _to_host(src)
    dst = _buffer((n, src.shape[0]), t, staged)
    with collective_range("all-gather", t.dtype, n * t.numel(), n):
        _wire("all_gather", dst, src, group)
    if staged:
        dst = _to_card(dst, t.device)
    return dst.view(t.dtype).reshape((n,) + tuple(t.shape))


def _all_to_all_members(ts: list, group) -> list:
    """:func:`_all_to_all` of each member's ``(n, ...)`` rows: member j
    receives row j of every member, in member order."""
    if not _replicas(group):
        return [_all_to_all(ts[0], group)]
    with collective_range("all-to-all", ts[0].dtype, ts[0].numel(),
                          group.size):
        return [torch.stack([t[j].to(dev) for t in ts])
                for j, dev in enumerate(group.devices)]


def _all_gather_members(ts: list, group, n: int) -> list:
    """:func:`_all_gather` of each member's tensor: every member receives
    all of them stacked, in member order (one stack a device, shared by
    the members on it)."""
    if not _replicas(group):
        return [_all_gather(ts[0], group, n)]
    stacks = {}
    with collective_range("all-gather", ts[0].dtype, n * ts[0].numel(), n):
        for dev in group.devices:
            if dev not in stacks:
                stacks[dev] = torch.stack([t.to(dev) for t in ts])
    return [stacks[dev] for dev in group.devices]


def all_reduce_sum(t, group=None):
    """A new tensor holding the sum of ``t`` over the ranks of ``group``;
    over a :class:`ReplicaGroup`, ``t`` is one tensor a replica and each
    gets the sum, taken in replica order, on its device."""
    if _replicas(group):
        ts = _members(t, group)
        with collective_range("all-reduce", ts[0].dtype, ts[0].numel(),
                              group.size):
            acc = ts[0].detach().clone(memory_format=torch.contiguous_format)
            for other in ts[1:]:
                acc = acc + other.detach().to(acc.device)
        return [acc if dev == acc.device and m == 0 else acc.to(dev, copy=True)
                for m, dev in enumerate(group.devices)]
    staged = _staged(t, group)
    buf = _to_host(t.detach()) if staged \
        else t.detach().clone(memory_format=torch.contiguous_format)
    with collective_range("all-reduce", t.dtype, t.numel(),
                          dist.get_world_size(group)):
        _wire("all_reduce", buf, buf, group)
    return _to_card(buf, t.device) if staged else buf


def broadcast_(t, group=None):
    """Overwrite ``t`` with the first rank's ``t`` (the first replica's,
    over a :class:`ReplicaGroup`), in place."""
    if _replicas(group):
        ts = _members(t, group)
        with torch.no_grad():
            for other in ts[1:]:
                other.copy_(ts[0])
        return ts
    staged = _staged(t, group)
    buf = _to_host(t.detach()) if staged else t.detach().contiguous()
    _wire("broadcast", buf, buf, group)
    if staged or buf.data_ptr() != t.data_ptr():
        with torch.no_grad():
            t.copy_(buf)
    return t


def _axis_size(group, axis_size) -> int:
    if _replicas(group):
        if axis_size is not None and int(axis_size) != group.size:
            raise MXNetError(f"axis_size={axis_size} but the replica group "
                             f"has {group.size} members")
        return group.size
    if axis_size is not None:
        axis_size = int(axis_size)
        if dist.is_initialized() and axis_size != dist.get_world_size(group):
            raise MXNetError(f"axis_size={axis_size} but the process group "
                             f"has {dist.get_world_size(group)} ranks")
        return axis_size
    if not dist.is_initialized():
        raise MXNetError("no process group: call "
                         "torch.distributed.init_process_group or pass "
                         "axis_size=1")
    return dist.get_world_size(group)


def _row_sum(rows: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in row order from zero, as XLA reduces it."""
    acc = torch.zeros_like(rows[0])
    for r in range(rows.shape[0]):
        acc = acc + rows[r]
    return acc


def _regroup(payloads: list, wire) -> list:
    """Each member's payload dict through ``wire`` (a function of the
    members' tensors of one key), back as one dict a member."""
    moved = {k: wire([p[k] for p in payloads]) for k in payloads[0]}
    return [{k: moved[k][m] for k in moved} for m in range(len(payloads))]


def _exchange(flats, spec, group, axis_size, kernels=None, feedback=False):
    """The quantized allreduce over padded flat vectors, one a member of
    ``group`` this process holds (this rank's, or every replica's).

    Returns four lists, one entry a member: the reduced vector and, with
    ``feedback``, what error feedback needs: the member's rows, the
    stage-1 error of each row (``rows - dq1``) and the stage-2 error of
    the shard it owns. With ``kernels`` (a CommKernelConfig) the
    quantize/dequantize stages run as the fused kernels; else as the
    codecs. Each stage runs once a member on that member's tensors."""
    Lp = flats[0].shape[0]
    per = Lp // axis_size
    rows = [f.reshape(axis_size, per) for f in flats]
    use_k = kernels is not None and spec.mode in ("int8", "twobit")
    if use_k:
        from ..kernels import comm_kernels as pk

    def stage1(r):
        if use_k:
            if feedback:
                # the kernel writes the stage-1 error itself, rounded as the
                # subtraction ``rows - dq1`` rounds it (twobit's has one
                # rounding)
                payload, _, err1 = pk.fused_quantize(
                    spec, r, want_error=True,
                    error_rounding="sub" if spec.mode == "int8" else None,
                    block_elems=kernels.block_elems)
                return payload, err1
            return pk.fused_quantize(spec, r,
                                     block_elems=kernels.block_elems)[0], None
        payload = encode(spec, r)
        # decode of OUR OWN payload: exactly what peers reconstruct
        return payload, (r - decode(spec, payload)) if feedback else None

    first = [stage1(r) for r in rows]
    recv = _regroup([p for p, _ in first], lambda ts: _all_to_all_members(
        ts, group))
    if use_k:
        shards = [pk.fused_dequant_sum(spec, rv,
                                       block_elems=kernels.block_elems)
                  for rv in recv]
    else:
        shards = [_row_sum(decode(spec, rv)) for rv in recv]
    gspec = _gather_spec(spec)
    fused2 = use_k and gspec.mode == spec.mode

    def stage2(shard):
        if fused2:
            # int8: the kernel writes the stage-2 error ``shard - dq2``
            # rounded once, as XLA contracts the product into the
            # subtraction (on the CPU, where the Pallas kernel is
            # interpreted inline)
            if feedback:
                payload2, _, err2 = pk.fused_quantize(
                    spec, shard, want_error=True,
                    block_elems=kernels.block_elems)
                return payload2, err2
            return pk.fused_quantize(spec, shard,
                                     block_elems=kernels.block_elems)
        # twobit gathers in bf16: a plain dtype convert, no kernel
        payload2 = encode(gspec, shard)
        return payload2, (shard - decode(gspec, payload2)) if feedback \
            else None

    second = [stage2(sh) for sh in shards]
    gathered = _regroup([p for p, _ in second],
                        lambda ts: _all_gather_members(ts, group, axis_size))
    if fused2:
        outs = [pk.fused_dequant(spec, g, block_elems=kernels.block_elems)
                .reshape(Lp) for g in gathered]
    else:
        outs = [decode(gspec, g).reshape(Lp) for g in gathered]
    return (outs, rows, [e for _, e in first], [e for _, e in second])


def compressed_exchange(flat, compression, group=None, axis_size=None,
                        kernels=None):
    """The sum over the ranks of a flat f32 vector already padded to
    :func:`padded_flat_size` (a new vector of the same length): one
    ``all_reduce`` for ``compression`` None/'none', else the quantized
    decomposition without feedback. Over a :class:`ReplicaGroup`,
    ``flat`` is a list of one vector a replica, and so is the result."""
    spec = CompressionSpec.resolve(compression)
    n = _axis_size(group, axis_size)
    if n == 1:
        return flat
    if spec is None:
        return all_reduce_sum(flat, group)
    outs, *_ = _exchange(_members(flat, group), spec, group, n,
                         kernels=CommKernelConfig.resolve(kernels))
    return _returned(outs, group)


def error_feedback_exchange(total, compression, group=None, axis_size=None,
                            kernels=None):
    """The error-feedback exchange of ``total``, this rank's padded flat
    gradient with its residual already added (``(Lp,)`` f32). Returns
    ``(out, new_residual)``: the reduced ``(Lp,)`` vector and this rank's
    ``(1, Lp)`` residual row for the next step. Over a
    :class:`ReplicaGroup`, ``total`` is a list of one vector a replica,
    and ``out`` and ``new_residual`` are lists of one a replica (the rows
    of the JAX package's ``(axis_size, Lp)`` state)."""
    spec = CompressionSpec.resolve(compression)
    n = _axis_size(group, axis_size)
    totals = _members(total, group)
    Lp = totals[0].shape[0]
    outs, _, new_rows, err2s = _exchange(
        totals, spec, group, n, kernels=CommKernelConfig.resolve(kernels),
        feedback=True)
    # stage-1 error: what OUR quantized rows dropped. Stage-2 error (the
    # reduced-shard re-quantization) is charged once, to the shard's owner.
    residuals = []
    for m, (rows, err2) in enumerate(zip(new_rows, err2s)):
        idx = _member_rank(group, m)
        rows[idx] = rows[idx] + err2
        residuals.append(rows.reshape(1, Lp))
    return _returned(outs, group), _returned(residuals, group)


def compressed_allreduce(tree, compression=None, group=None, axis_size=None,
                         average=True, kernels=None):
    """Allreduce a gradient tree over the ranks of ``group``.

    ``compression=None``/'none' is a per-leaf sum ``all_reduce``.
    Compressed modes fuse the tree into one flat bucket and run the
    quantized decomposition. ``axis_size`` defaults to the group's size;
    1 (one rank) is a no-op. ``kernels`` (a :class:`CommKernelConfig`, or
    anything its ``resolve`` accepts) routes the quantize stages through
    the fused kernels. Over a :class:`ReplicaGroup`, ``tree`` is a list
    of one tree a replica, and so is the result."""
    spec = CompressionSpec.resolve(compression)
    n = _axis_size(group, axis_size)
    if n == 1:
        # one rank: the sum is its own gradient; quantizing would only
        # inject error (allreduce.py:244-250)
        return tree
    trees = _members(tree, group)
    if spec is None:
        structure = _tree_flatten(trees[0])[1]
        # per leaf, one sum a member
        summed = [_members(all_reduce_sum(_returned(list(ls), group), group),
                           group)
                  for ls in zip(*(_tree_flatten(t)[0] for t in trees))]
        return _returned([_tree_unflatten(structure, [
            s[m] / n if average else s[m] for s in summed])
            for m in range(len(trees))], group)
    flats, meta = [], None
    for t in trees:
        flat, meta = _flatten(t)
        flats.append(_pad_flat(flat, spec, n))
    L = flats[0][1]
    outs = compressed_exchange(_returned([f for f, _ in flats], group), spec,
                               group, n, kernels)
    outs = [o[:L] for o in _members(outs, group)]
    return _returned([_unflatten(o / n if average else o, meta)
                      for o in outs], group)


def error_feedback_allreduce(tree, residual, compression, group=None,
                             axis_size=None, average=False, kernels=None):
    """Compressed allreduce with the residual threaded through.

    ``residual`` is this rank's ``(1, Lp)`` row of the JAX package's
    ``(axis_size, Lp)`` state (:func:`init_error_feedback`), or None for
    modes that need no feedback. Returns ``(reduced_tree, new_residual)``
    with ``new_residual`` shaped like ``residual``. Over a
    :class:`ReplicaGroup`, ``tree`` and ``residual`` are lists of one a
    replica, and so are both results."""
    spec = CompressionSpec.resolve(compression)
    if spec is None or not spec.error_feedback or residual is None:
        out = compressed_allreduce(tree, spec, group=group,
                                   axis_size=axis_size, average=average,
                                   kernels=kernels)
        return out, residual
    n = _axis_size(group, axis_size)
    if n == 1:
        # one rank: no wire, no quantization, no error to feed back
        return tree, residual
    totals, meta, L = [], None, None
    for t, r in zip(_members(tree, group), _members(residual, group)):
        flat, meta = _flatten(t)
        total, L = _pad_flat(flat, spec, n)
        if int(r.shape[-1]) != total.shape[0]:
            raise MXNetError(
                f"residual length {r.shape[-1]} != padded grad length "
                f"{total.shape[0]}; rebuild it with init_error_feedback")
        # the residual added in place into this call's own flat vector
        # (``flat + r`` is ``r + flat``: the same bits)
        totals.append(total.add_(r[0]))
    outs, new_residuals = error_feedback_exchange(
        _returned(totals, group), spec, group, n, kernels)
    out = [_unflatten(o[:L] / n if average else o[:L], meta)
           for o in _members(outs, group)]
    return _returned(out, group), new_residuals


def flat_views(flat, shapes: dict) -> dict:
    """Views of ``flat``'s leading elements as the tensors of ``shapes``
    (name -> shape), laid out in the order :func:`_flatten` lays out a dict
    of them (sorted names): the gradients of a flat buffer, no copy."""
    out, off = {}, 0
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        size = 1
        for d in shape:
            size *= int(d)
        out[name] = flat[off:off + size].view(shape)
        off += size
    return out


def init_error_feedback(params_or_size, compression, axis_size, dtype=None,
                        device=None):
    """Zero residual state for :func:`error_feedback_allreduce`: this
    rank's ``(1, Lp)`` float32 row (the JAX package returns all
    ``axis_size`` rows, sharded one per device; ``convert`` carries a
    row across), or None when the mode needs no feedback."""
    spec = CompressionSpec.resolve(compression)
    if spec is None or not spec.error_feedback:
        return None
    n = params_or_size if isinstance(params_or_size, int) \
        else flat_size(params_or_size)
    Lp = padded_flat_size(n, spec, axis_size)
    return torch.zeros((1, Lp), dtype=dtype or torch.float32, device=device)
