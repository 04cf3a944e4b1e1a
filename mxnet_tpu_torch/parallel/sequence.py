"""Sequence/context parallelism: ring attention over an 'sp' axis of ranks,
and the dense attention reference.

Counterpart of ``mxnet_tpu/parallel/sequence.py``. Keys and values rotate
around the ring (each rank sends its block to the next rank and receives the
previous rank's: ``lax.ppermute`` with ``perm = [(j, j + 1)]``) while each
rank accumulates its queries' attention with an online softmax, so the
sequence a rank holds is ``seq / sp``. Where the JAX functions run inside
``shard_map`` on an axis name, the port's run on every rank of a process
group and take this rank's block; :func:`ring_self_attention` takes this
rank's ``P("dp", "tp", "sp", None)`` block of q, k, v from a mesh.

:func:`attention_reference` is the transformer's ``attn_impl="dense"``
route and the tests' yardstick for flash attention.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.flash_attention import (NEG_INF, flash_attention_with_lse,
                                       flash_block_grads)
from .mesh import Shift, as_axis, ring_shift

__all__ = ["ring_attention", "ring_flash_attention", "ring_self_attention",
           "attention_reference"]


def attention_reference(q, k, v, causal=False):
    """Dense softmax attention; q, k, v: ``[batch, heads, seq, head_dim]``
    (sequence.py:30-40). Scores in f32, divided by ``sqrt(f32(d))`` (a
    divide, where the kernels multiply by ``1/sqrt(d)``), masked with
    ``-inf``; the result is cast to ``q.dtype``."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    # a 0-d tensor on the scores' device: a Python scalar would turn the
    # CUDA divide into a multiply by its reciprocal
    s = s / torch.tensor(np.sqrt(np.float32(d)), device=s.device)
    if causal:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ring_attention(q, k, v, group=None, causal=False):
    """Ring attention for sequence-sharded q, k, v (sequence.py:43-90), on
    every rank of ``group`` (the sp axis: a MeshAxis, a process group, or
    None for the world) with its block ``[batch, heads, seq/sp, head_dim]``.
    The same result as dense attention over the gathered sequence up to f32
    rounding; differentiable (the blocks' gradients ride the ring back)."""
    axis = as_axis(group)
    n, my = axis.size, axis.index
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dev = q.device
    scale = torch.tensor(np.float32(1.0) / np.sqrt(np.float32(d)), device=dev)
    qf = q.float()
    q_pos = my * sq + torch.arange(sq, device=dev)
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), float("-inf"), device=dev)
    l = torch.zeros((b, h, sq), device=dev)
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n   # which rank this k/v block came from
        s = torch.einsum("bhqd,bhkd->bhqk", qf, k_blk.float()) * scale
        if causal:
            kv_pos = src * skv + torch.arange(skv, device=dev)
            s = torch.where(q_pos[:, None] >= kv_pos[None, :], s,
                            float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # guard fully-masked rows (exp(-inf - -inf)): zero weight
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None])
        if causal:
            p = torch.where(torch.isfinite(s), p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                v_blk.float())
        m = m_new
        if i != n - 1:   # the last hop's blocks would be dead
            k_blk, v_blk = Shift.apply(axis, k_blk, v_blk)
    o = o / torch.clamp_min(l[..., None], 1e-30)
    return o.to(q.dtype)


def _merge(acc, denom, m, o_i, lse_i):
    """Fold one block's (o, lse) into the running stable combination
    (sequence.py:109-116), in f32."""
    m_new = torch.maximum(m, lse_i)
    w_prev = torch.exp(m - m_new)
    w_i = torch.exp(lse_i - m_new)
    acc = acc * w_prev[..., None] + o_i.float() * w_i[..., None]
    denom = denom * w_prev + w_i
    return acc, denom, m_new


def _computes(i, src, my, causal):
    """Whether hop ``i`` has work: the diagonal block, every block without
    the causal mask, and under it the blocks of earlier positions. A rank
    skips a later block outright where the JAX package merges zeros with
    lse = -1e30: that merge multiplies the running sums by exp(m - m) = 1
    and adds the block with weight exp(-1e30 - m) = 0, so skipping gives
    the same values."""
    return i == 0 or not causal or src < my


def _ring_flash_fwd(q, k, v, axis, causal):
    n, my = axis.size, axis.index
    b, h, sq, d = q.shape
    if k.shape[2] != sq:
        raise ValueError("ring_flash_attention needs equal q/kv shard sizes")
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        if _computes(i, (my - i) % n, my, causal):
            o_i, lse_i = flash_attention_with_lse(q, k_blk, v_blk,
                                                  causal=causal and i == 0)
            acc, denom, m = _merge(acc, denom, m, o_i, lse_i)
        if i != n - 1:
            k_blk, v_blk = ring_shift((k_blk, v_blk), axis)
    out = (acc / torch.clamp_min(denom[..., None], 1e-30)).to(q.dtype)
    lse_global = m + torch.log(torch.clamp_min(denom, 1e-30))
    return out, lse_global


def _ring_flash_bwd(q, k, v, out, lse_global, g, axis, causal):
    """Each hop's block gradients from the GLOBAL (out, lse); dk and dv
    accumulate in f32 and travel with their block on every hop, skipped
    ones too, so that after n hops each lands back on its owner
    (sequence.py:191-198)."""
    n, my = axis.size, axis.index
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=q.device)
    k_blk, v_blk = k, v
    for i in range(n):
        if _computes(i, (my - i) % n, my, causal):
            dq_i, dk_i, dv_i = flash_block_grads(
                q, k_blk, v_blk, out, lse_global, g, causal=causal and i == 0)
            dq += dq_i.float()
            dkv[0] += dk_i.float()
            dkv[1] += dv_i.float()
        if i != n - 1:
            k_blk, v_blk, dkv = ring_shift((k_blk, v_blk, dkv), axis)
        else:
            (dkv,) = ring_shift((dkv,), axis)
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """``ring_flash_attention``'s custom VJP (sequence.py:176-202)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        out, lse_global = _ring_flash_fwd(q, k, v, axis, causal)
        ctx.save_for_backward(q, k, v, out, lse_global)
        ctx.axis, ctx.causal = axis, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse_global = ctx.saved_tensors
        return (*_ring_flash_bwd(q, k, v, out, lse_global, g, ctx.axis,
                                 ctx.causal), None, None)


def ring_flash_attention(q, k, v, group=None, causal=False):
    """Ring attention whose per-block math runs in the flash kernels,
    forward and backward (sequence.py:93-202): each hop computes one flash
    forward returning (o, lse), and the blocks merge by the log-sum-exp
    identity in f32 (each hop's o is rounded to q's type first, as the
    kernel returns it). Backward runs the flash backward kernels per block
    against the global (out, lse). Same contract as :func:`ring_attention`,
    with equal q and kv block sizes. On CUDA tensors every block launches
    the Hopper kernels; on CPU tensors their plain versions run."""
    return _RingFlash.apply(q, k, v, as_axis(group), causal)


def ring_self_attention(mesh, q, k, v, causal=False, use_flash=False):
    """Ring attention over ``mesh``'s sp axis for this rank's
    ``P("dp", "tp", "sp", None)`` block of q, k, v; returns this rank's
    block of the output (sequence.py:205-222 takes and returns the global
    arrays through ``shard_map``). ``use_flash`` routes the per-block math
    through the flash kernels (:func:`ring_flash_attention`)."""
    fn = ring_flash_attention if use_flash else ring_attention
    return fn(q, k, v, mesh.axis("sp"), causal)
