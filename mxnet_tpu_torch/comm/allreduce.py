"""Compressed gradient allreduce across ``torch.distributed`` ranks.

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
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..base import ENV_OFF_VALUES, ENV_ON_VALUES, MXNetError
from .compression import CompressionSpec, decode, encode, quantization_unit

__all__ = ["CommKernelConfig", "compressed_allreduce",
           "error_feedback_allreduce", "compressed_exchange",
           "error_feedback_exchange", "flat_views", "init_error_feedback",
           "flat_size", "padded_flat_size", "all_reduce_sum", "broadcast_"]


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
    _wire("all_gather", dst, src, group)
    if staged:
        dst = _to_card(dst, t.device)
    return dst.view(t.dtype).reshape((n,) + tuple(t.shape))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """A new tensor holding the sum of ``t`` over the ranks of ``group``."""
    staged = _staged(t, group)
    buf = _to_host(t.detach()) if staged \
        else t.detach().clone(memory_format=torch.contiguous_format)
    _wire("all_reduce", buf, buf, group)
    return _to_card(buf, t.device) if staged else buf


def broadcast_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Overwrite ``t`` with the first rank's ``t``, in place."""
    staged = _staged(t, group)
    buf = _to_host(t.detach()) if staged else t.detach().contiguous()
    _wire("broadcast", buf, buf, group)
    if staged or buf.data_ptr() != t.data_ptr():
        with torch.no_grad():
            t.copy_(buf)
    return t


def _axis_size(group, axis_size) -> int:
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


def _exchange(flat, spec, group, axis_size, kernels=None, feedback=False):
    """The quantized allreduce over a padded flat vector.

    Returns ``(out, rows, err1, err2)``: the reduced vector and, with
    ``feedback``, what error feedback needs: this rank's rows, the stage-1
    error of each row (``rows - dq1``) and the stage-2 error of the shard it
    owns. With ``kernels`` (a CommKernelConfig) the quantize/dequantize
    stages run as the fused kernels; else as the codecs."""
    Lp = flat.shape[0]
    per = Lp // axis_size
    rows = flat.reshape(axis_size, per)
    use_k = kernels is not None and spec.mode in ("int8", "twobit")
    err1 = None
    if use_k:
        from ..kernels import comm_kernels as pk

        if feedback:
            # the kernel writes the stage-1 error itself, rounded as the
            # subtraction ``rows - dq1`` rounds it (twobit's has one rounding)
            payload, _, err1 = pk.fused_quantize(
                spec, rows, want_error=True,
                error_rounding="sub" if spec.mode == "int8" else None,
                block_elems=kernels.block_elems)
        else:
            payload, _ = pk.fused_quantize(spec, rows,
                                           block_elems=kernels.block_elems)
    else:
        payload = encode(spec, rows)
        if feedback:
            # decode of OUR OWN payload: exactly what peers reconstruct
            err1 = rows - decode(spec, payload)
    recv = {k: _all_to_all(v, group) for k, v in payload.items()}
    if use_k:
        shard = pk.fused_dequant_sum(spec, recv,
                                     block_elems=kernels.block_elems)
    else:
        shard = _row_sum(decode(spec, recv))
    gspec = _gather_spec(spec)
    fused2 = use_k and gspec.mode == spec.mode
    if fused2:
        # int8: the kernel writes the stage-2 error ``shard - dq2`` rounded
        # once, as XLA contracts the product into the subtraction (on the
        # CPU, where the Pallas kernel is interpreted inline)
        if feedback:
            payload2, _, err2 = pk.fused_quantize(
                spec, shard, want_error=True, block_elems=kernels.block_elems)
        else:
            payload2, err2 = pk.fused_quantize(
                spec, shard, block_elems=kernels.block_elems)
    else:
        # twobit gathers in bf16: a plain dtype convert, no kernel
        payload2 = encode(gspec, shard)
        err2 = shard - decode(gspec, payload2) if feedback else None
    gathered = {k: _all_gather(v, group, axis_size)
                for k, v in payload2.items()}
    if fused2:
        out = pk.fused_dequant(spec, gathered,
                               block_elems=kernels.block_elems).reshape(Lp)
    else:
        out = decode(gspec, gathered).reshape(Lp)
    return out, rows, err1, err2


def compressed_exchange(flat, compression, group=None, axis_size=None,
                        kernels=None):
    """The sum over the ranks of a flat f32 vector already padded to
    :func:`padded_flat_size` (a new vector of the same length): one
    ``all_reduce`` for ``compression`` None/'none', else the quantized
    decomposition without feedback."""
    spec = CompressionSpec.resolve(compression)
    n = _axis_size(group, axis_size)
    if n == 1:
        return flat
    if spec is None:
        return all_reduce_sum(flat, group)
    out, *_ = _exchange(flat, spec, group, n,
                        kernels=CommKernelConfig.resolve(kernels))
    return out


def error_feedback_exchange(total, compression, group=None, axis_size=None,
                            kernels=None):
    """The error-feedback exchange of ``total``, this rank's padded flat
    gradient with its residual already added (``(Lp,)`` f32). Returns
    ``(out, new_residual)``: the reduced ``(Lp,)`` vector and this rank's
    ``(1, Lp)`` residual row for the next step."""
    spec = CompressionSpec.resolve(compression)
    n = _axis_size(group, axis_size)
    Lp = total.shape[0]
    out, rows, new_rows, err2 = _exchange(
        total, spec, group, n, kernels=CommKernelConfig.resolve(kernels),
        feedback=True)
    # stage-1 error: what OUR quantized rows dropped. Stage-2 error (the
    # reduced-shard re-quantization) is charged once, to the shard's owner.
    idx = dist.get_rank(group)
    new_rows[idx] = new_rows[idx] + err2
    return out, new_rows.reshape(1, Lp)


def compressed_allreduce(tree, compression=None, group=None, axis_size=None,
                         average=True, kernels=None):
    """Allreduce a gradient tree over the ranks of ``group``.

    ``compression=None``/'none' is a per-leaf sum ``all_reduce``.
    Compressed modes fuse the tree into one flat bucket and run the
    quantized decomposition. ``axis_size`` defaults to the group's size;
    1 (one rank) is a no-op. ``kernels`` (a :class:`CommKernelConfig`, or
    anything its ``resolve`` accepts) routes the quantize stages through
    the fused kernels."""
    spec = CompressionSpec.resolve(compression)
    n = _axis_size(group, axis_size)
    if spec is None:
        if n == 1:
            return tree
        summed = _tree_map(lambda g: all_reduce_sum(g, group), tree)
        if average:
            return _tree_map(lambda g: g / n, summed)
        return summed
    if n == 1:
        # one rank: the sum is its own gradient; quantizing would only
        # inject error (allreduce.py:244-250)
        return tree
    flat, meta = _flatten(tree)
    flat, L = _pad_flat(flat, spec, n)
    out = compressed_exchange(flat, spec, group, n, kernels)[:L]
    if average:
        out = out / n
    return _unflatten(out, meta)


def error_feedback_allreduce(tree, residual, compression, group=None,
                             axis_size=None, average=False, kernels=None):
    """Compressed allreduce with the residual threaded through.

    ``residual`` is this rank's ``(1, Lp)`` row of the JAX package's
    ``(axis_size, Lp)`` state (:func:`init_error_feedback`), or None for
    modes that need no feedback. Returns ``(reduced_tree, new_residual)``
    with ``new_residual`` shaped like ``residual``."""
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
    flat, meta = _flatten(tree)
    total, L = _pad_flat(flat, spec, n)
    if int(residual.shape[-1]) != total.shape[0]:
        raise MXNetError(
            f"residual length {residual.shape[-1]} != padded grad length "
            f"{total.shape[0]}; rebuild it with init_error_feedback")
    # the residual added in place into this call's own flat vector
    # (``flat + r`` is ``r + flat``: the same bits)
    total.add_(residual[0])
    out, new_residual = error_feedback_exchange(total, spec, group, n,
                                                kernels)
    out = out[:L]
    if average:
        out = out / n
    return _unflatten(out, meta), new_residual


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
