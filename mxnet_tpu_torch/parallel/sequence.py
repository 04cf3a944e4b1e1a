"""Sequence parallelism: the dense attention reference, and ring attention's
entry points.

Counterpart of ``mxnet_tpu/parallel/sequence.py``. :func:`attention_reference`
is the transformer's ``attn_impl="dense"`` route and the tests' second
yardstick for flash attention. Ring attention rotates keys and values around
an ``sp`` axis of several cards; the port has no such mesh yet, so its entry
points raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ring_attention", "ring_flash_attention", "ring_self_attention",
           "attention_reference"]

_RING = ("ring attention over an 'sp' axis of several cards is not ported "
         "yet (ROADMAP.md A5: parallel/sequence.py ring attention)")


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


def ring_attention(q, k, v, axis_name="sp", causal=False):
    """Ring attention for sequence-sharded q, k, v (sequence.py:43)."""
    raise NotImplementedError(_RING)


def ring_flash_attention(q, k, v, axis_name="sp", causal=False):
    """Ring attention with flash blocks (sequence.py:94)."""
    raise NotImplementedError(_RING)


def ring_self_attention(mesh, q, k, v, causal=False, use_flash=False):
    """Ring attention over ``mesh``'s sp axis (sequence.py:205)."""
    raise NotImplementedError(_RING)
