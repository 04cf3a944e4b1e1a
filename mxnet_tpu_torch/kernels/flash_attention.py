"""Flash attention, forward and backward (the transformer LM's path).

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``, in its layout
``[batch, heads, seq, head_dim]``. Three kernels, each a wrapper that counts
its launches:

- :func:`flash_fwd` returns ``(o, lse)``, lse the log-sum-exp of each query
  row's scaled scores;
- :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` return the gradients from
  the saved lse and ``delta = sum(do * o)``, which stays a torch expression
  (plain jnp outside the kernels in the JAX package too).

On CUDA tensors each launches its kernel in ``csrc/flash_attention.cu``:
bf16 forward and dk/dv launch the Hopper kernels (TMA, wgmma, warp
specialised), while f32 calls and dq launch the first design's CUDA-core
and ``mma.sync`` kernels. On CPU tensors it runs the plain version,
:func:`flash_fwd_plain` or :func:`flash_bwd_plain`: the blocked
online-softmax algorithm written step by step, rounding where the JAX
kernels round. The public functions are
:func:`flash_attention` (differentiable, a ``torch.autograd.Function`` where
JAX has a ``custom_vjp``), :func:`flash_attention_with_lse` and
:func:`flash_block_grads` (a block's gradients from a GLOBAL lse).

Tiles. The kernels work in 64-key tiles (the Hopper forward in blocks of
128 query rows, dk/dv of 128 keys, in 64-row halves). bf16 results depend
on the key tile up to rounding, because the online softmax rescales by a
running max; the query tile changes nothing (rows are independent, and a
skipped causal tile adds exactly nothing). So every function takes
``block_k``: ``None`` means the kernels' 64 on both devices, and on a CUDA
tensor any other value raises. The public functions also take
``block_q``, for the JAX package's signature only: anything but ``None``
raises. (The JAX package's defaults are 512 and 2048.)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._common import load_library, use_kernel
from .registry import KernelCost, register_kernel

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_block_grads",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_plain",
           "flash_bwd_plain", "attention_delta", "attention_entries",
           "kernel_attributes", "KERNEL_BLOCK", "NEG_INF"]

KERNEL_BLOCK = 64      # csrc/flash_attention.cu's kBlock
NEG_INF = -1e30        # flash_attention.py:34: masked scores, not -inf
MAX_HEAD_DIM = 128
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _scale(d: int) -> float:
    """``1 / sqrt(d)`` as the f32 the JAX kernels multiply by."""
    return float(np.float32(1.0 / (d ** 0.5)))


def _key_block(block_k, on_card: bool) -> int:
    """The key tile of one call: the kernels' 64 on the card, where any
    other raises; ``block_k`` (None: 64) for the plain version."""
    if on_card and block_k not in (None, KERNEL_BLOCK):
        raise ValueError(
            f"flash attention: the CUDA kernels work in {KERNEL_BLOCK}x"
            f"{KERNEL_BLOCK} tiles; got block_k={block_k} (pass None)")
    return KERNEL_BLOCK if block_k is None else int(block_k)


def _no_block_q(block_q):
    if block_q is not None:
        raise ValueError(
            f"flash attention: block_q={block_q}; the query tile changes no "
            "result (query rows are independent) and is taken for the JAX "
            "signature only: pass None")


def _check(q, k, v, *more):
    """Shapes and types the kernels take, on either device."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention: q, k, v must be [batch, heads, "
                         "seq, head_dim]")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    for t in (q, k, v, *more):
        if t.dtype not in _DTYPES:
            raise ValueError(f"flash attention: {t.dtype} is not taken "
                             "(bfloat16 or float32)")
        if t.dtype != q.dtype:
            raise ValueError("flash attention: operands of one call share "
                             "one type")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention: head_dim {d} must be a multiple "
                         f"of 8 in [8, {MAX_HEAD_DIM}]")
    if min(q.shape[2], k.shape[2]) < 1:
        raise ValueError("flash attention: empty sequence")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _mask(sq, k0, k1, causal, device):
    """[sq, k1 - k0] bool: the keys a query row may see in this tile."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    return qpos >= kpos


def flash_fwd_plain(q, k, v, causal=False, block_k=KERNEL_BLOCK):
    """The forward kernel's plain version, on any device: ``(o, lse)`` with
    o like q and lse ``[batch, heads, seq_q]`` f32 (flash_attention.py:70-112).
    Products of the input type accumulate in f32 (upcast operands: a bf16
    product is exact in f32)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = _scale(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:3] + (1,), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        mask = _mask(sq, k0, k1, causal, q.device)
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k1]
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def attention_delta(o, do):
    """``delta = sum(do * o)`` over head_dim in f32 (flash_attention.py:234),
    ``[batch, heads, seq_q]``."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_plain(q, k, v, do, lse, delta, causal=False,
                    block_k=KERNEL_BLOCK):
    """The backward kernels' plain version, on any device: ``(dq, dk, dv)``
    like q, k, v, from the saved (or global) ``lse`` and ``delta``, both
    ``[batch, heads, seq_q]`` f32 (flash_attention.py:151-226)."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    scale = _scale(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    lse_c, delta_c = lse.float()[..., None], delta.float()[..., None]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        kt, vt = kf[:, :, k0:k1], vf[:, :, k0:k1]
        s = (qf @ kt.transpose(-1, -2)) * scale
        p = torch.exp(s - lse_c)
        mask = _mask(sq, k0, k1, causal, q.device)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        dp = dof @ vt.transpose(-1, -2)
        ds = (p * (dp - delta_c) * scale).to(q.dtype).float()
        dq = dq + ds @ kt
        dks.append(ds.transpose(-1, -2) @ qf)
        dvs.append(p.to(do.dtype).float().transpose(-1, -2) @ dof)
    return (dq.to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

def _library():
    lib = load_library("flash_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [ptr, i32, i32, i32, i32, i32, i32, f32, i32, ptr]
    lib.mxtt_flash_fwd.argtypes = [ptr] * 5 + tail
    lib.mxtt_flash_bwd_dq.argtypes = [ptr] * 7 + tail
    lib.mxtt_flash_bwd_dkv.argtypes = [ptr] * 8 + tail
    for fn in (lib.mxtt_flash_fwd, lib.mxtt_flash_bwd_dq,
               lib.mxtt_flash_bwd_dkv):
        fn.restype = i32
    lib.mxtt_flash_error_string.argtypes = [i32]
    lib.mxtt_flash_error_string.restype = ctypes.c_char_p
    lib.mxtt_flash_kernel_attributes.argtypes = [i32, i32, i32, ptr]
    lib.mxtt_flash_kernel_attributes.restype = i32
    return lib


_WHICH = {"flash_fwd": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 2}


def kernel_attributes(name: str, dtype: torch.dtype, head_dim: int) -> dict:
    """What the compiled kernel a call of ``name`` at ``dtype`` and
    ``head_dim`` launches takes (``cudaFuncGetAttributes``): registers a
    thread, static and dynamic shared memory a block (bytes), threads a
    block and local memory a thread (bytes: spills). Builds the library."""
    out = (ctypes.c_int * 5)()
    lib = _library()
    err = lib.mxtt_flash_kernel_attributes(_WHICH[name], _DTYPES[dtype],
                                           head_dim, out)
    if err != 0:
        raise RuntimeError(f"{name}: kernel attributes: "
                           + lib.mxtt_flash_error_string(err).decode())
    return dict(zip(("registers", "static_smem_bytes", "dynamic_smem_bytes",
                     "threads", "local_bytes"), out))


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels can read it through its strides (unit
    stride along head_dim, 16-byte aligned rows: what a TMA tensor map
    takes); a contiguous copy otherwise. The transformer's q, k, v views
    of its packed qkv and its gradients need no copy."""
    size = t.element_size()
    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s > 0 and (s * size) % 16 == 0 for s in t.stride()[:3])):
        return t
    return t.contiguous()


def _call(name, fn, operands, counts, causal, d):
    """Launch ``fn`` on the operands' (batch, head, seq) strides."""
    q = operands[0]
    strides = (ctypes.c_longlong * (3 * len(operands)))(
        *[s for t in operands for s in t.stride()[:3]])
    b, h, sq = q.shape[:3]
    sk = operands[1].shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*[t.data_ptr() for t in counts], strides, b, h, sq, sk, d,
                 int(causal), _scale(d), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           + _library().mxtt_flash_error_string(err).decode())


def flash_fwd(q, k, v, causal=False, block_k=None):
    """``(o, lse)`` of one attention call through the forward kernel. On
    CUDA tensors it launches the kernel once and adds one to
    ``flash_fwd.launches``; o is returned as a ``[batch, heads, seq, d]``
    view of memory laid out ``[batch, seq, heads, d]``, so that merging the
    heads back into the model width is free. CPU tensors take the plain
    version at key tile ``block_k``."""
    _check(q, k, v)
    on_card = use_kernel(q, k, v)
    block = _key_block(block_k, on_card)
    if not on_card:
        return flash_fwd_plain(q, k, v, causal, block)
    q, k, v = map(_kernel_operand, (q, k, v))
    b, h, sq, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ops = (q, k, v, o)
    _call("flash_fwd", _library().mxtt_flash_fwd, ops, (*ops, lse), causal, d)
    flash_fwd.launches += 1
    return o, lse


def _bwd_route(q, k, v, do, lse, delta, block_k):
    """Checks the backward's operands; ``(on_card, key tile)``."""
    _check(q, k, v, do)
    if do.shape != q.shape:
        raise ValueError(f"flash attention: do {tuple(do.shape)} is not "
                         f"like q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"flash attention: {name} must be "
                             f"{tuple(q.shape[:3])} float32")
    on_card = use_kernel(q, k, v, do, lse, delta)
    return on_card, _key_block(block_k, on_card)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, block_k=None):
    """dq through its kernel (CUDA tensors: one launch, adds one to
    ``flash_bwd_dq.launches``), else from the plain version."""
    on_card, block = _bwd_route(q, k, v, do, lse, delta, block_k)
    if not on_card:
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, block)[0]
    q, k, v, do = map(_kernel_operand, (q, k, v, do))
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    ops = (q, k, v, do, dq)
    _call("flash_bwd_dq", _library().mxtt_flash_bwd_dq, ops,
          (q, k, v, do, lse.contiguous(), delta.contiguous(), dq), causal,
          q.shape[3])
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, block_k=None):
    """``(dk, dv)`` through their kernel (CUDA tensors: one launch, adds
    one to ``flash_bwd_dkv.launches``), else from the plain version."""
    on_card, block = _bwd_route(q, k, v, do, lse, delta, block_k)
    if not on_card:
        return flash_bwd_plain(q, k, v, do, lse, delta, causal, block)[1:]
    q, k, v, do = map(_kernel_operand, (q, k, v, do))
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ops = (q, k, v, do, dk, dv)
    _call("flash_bwd_dkv", _library().mxtt_flash_bwd_dkv, ops,
          (q, k, v, do, lse.contiguous(), delta.contiguous(), dk, dv),
          causal, q.shape[3])
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def _backward(q, k, v, o, lse, do, causal, block_k):
    delta = attention_delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, block_k)
    return (dq, *flash_bwd_dkv(q, k, v, do, lse, delta, causal, block_k))


class _FlashAttention(torch.autograd.Function):
    """``flash_attention``'s gradient: the backward kernels from the saved
    (o, lse), as ``_flash``'s custom VJP (flash_attention.py:298-328)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        o, lse = flash_fwd(q, k, v, causal, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.config = (causal, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, *ctx.config)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, block_q=None, block_k=None):
    """Blocked flash attention, differentiable. q, k, v: ``[batch, heads,
    seq, head_dim]`` (views with unit stride along head_dim are read in
    place). The same result as ``parallel.sequence.attention_reference`` up
    to rounding (flash_attention.py:391). ``block_q`` must be None (the
    JAX signature's; see the module's note on tiles)."""
    _no_block_q(block_q)
    return _FlashAttention.apply(q, k, v, causal, block_k)


def flash_attention_with_lse(q, k, v, causal=False, block_q=None,
                             block_k=None):
    """``(o, lse)``, lse ``[batch, heads, seq]``: what makes per-shard
    results mergeable across a ring (flash_attention.py:337). Not
    differentiable."""
    _no_block_q(block_q)
    with torch.no_grad():
        return flash_fwd(q, k, v, causal, block_k)


def flash_block_grads(q, k, v, o, lse, do, causal=False, block_q=None,
                      block_k=None):
    """``(dq, dk, dv)`` of one attention block given the GLOBAL ``(o,
    lse)``: p is recomputed as exp(s - lse) from the lse handed in, never
    from one computed here, so a ring backward is a sum of per-block calls
    (flash_attention.py:358)."""
    _no_block_q(block_q)
    with torch.no_grad():
        return _backward(q, k, v, o, lse, do, causal, block_k)


# --------------------------------------------------------------------------
# cost models (kernels/registry.py)
# --------------------------------------------------------------------------

def attention_entries(sq: int, sk: int, causal: bool) -> int:
    """Score entries one (batch, head) of attention needs: ``sq * sk``, or
    under the causal mask, query row i seeing keys 0..i, the sum over rows
    of ``min(i + 1, sk)``. Exact: no tile rounding, so the count belongs to
    the function, not to a kernel's tile size."""
    if not causal:
        return sq * sk
    full = max(sq - sk, 0)   # rows that see every key
    rows = sq - full
    return rows * (rows + 1) // 2 + full * sk


def _flash_cost(products: int):
    def cost(ins, outs, causal=False):
        q, k = ins[0], ins[1]
        b, h, sq, d = q.shape
        entries = b * h * attention_entries(sq, k.shape[2], causal)
        unit = "bf16" if q.dtype == torch.bfloat16 else "f32"
        return KernelCost(ops={unit: 2.0 * products * entries * d},
                          bytes=KernelCost.io_bytes(ins, outs))
    return cost


_SOURCE = "mxnet_tpu_torch/csrc/flash_attention.cu"
# QK^T and PV; the backward recomputes QK^T, then dP and dQ (3) or dV, dP
# and dK (4) products, each 2 * d operations a score entry the mask keeps
register_kernel("flash_fwd", _flash_cost(2), source=_SOURCE,
                replaces="mxnet_tpu/ops/pallas/flash_attention.py:120")
register_kernel("flash_bwd_dq", _flash_cost(3), source=_SOURCE,
                replaces="mxnet_tpu/ops/pallas/flash_attention.py:237")
register_kernel("flash_bwd_dkv", _flash_cost(4), source=_SOURCE,
                replaces="mxnet_tpu/ops/pallas/flash_attention.py:256")
