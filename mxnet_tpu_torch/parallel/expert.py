"""Expert parallelism over an 'ep' axis of ranks (GShard/Switch-style MoE).

Counterpart of ``mxnet_tpu/parallel/expert.py``: a top-1 gated
mixture-of-experts FFN with a fixed expert capacity. Tokens go to their
expert's owner rank through an all-to-all, the expert products run batched,
and the results come back through the inverse all-to-all. Dispatch and
combine are the one-hot einsums of the JAX package, so the layer is
differentiable as it stands: the gradients take the inverse exchanges.

Call :func:`moe_ffn` on every rank of the ep axis with this rank's tokens
and its block of the expert weights (split on their leading expert
dimension).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..context import current_context
from .mesh import all_to_all, as_axis

__all__ = ["moe_ffn", "init_moe_params", "expert_capacity", "route"]


def init_moe_params(seed, d_model: int, d_ff: int, n_experts: int,
                    dtype=torch.float32, ctx=None):
    """Gate and stacked expert weights with the JAX package's scales
    (expert.py:24-33) on ``ctx`` (default ``current_context()``, the card),
    drawn from a CPU ``torch.Generator`` seeded with ``seed``: other numbers
    than the JAX package's for the same seed. Shard ``w1``/``w2`` on their
    expert dimension."""
    device = (ctx or current_context()).torch_device
    gen = torch.Generator().manual_seed(int(seed))
    s1, s2 = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).to(device)

    return {"gate": normal((d_model, n_experts), s1),
            "w1": normal((n_experts, d_model, d_ff), s1),
            "w2": normal((n_experts, d_ff, d_model), s2)}


def expert_capacity(capacity_factor: float, tokens: int,
                    n_experts: int) -> int:
    """Slots a rank gives each expert for its ``tokens``, in Python floats
    as the JAX package computes it."""
    return max(1, int(capacity_factor * tokens / n_experts))


def _one_hot(index, n):
    """``jax.nn.one_hot(index, n)`` in f32: a zero row where ``index`` is
    negative or at least ``n`` (``F.one_hot`` raises on both)."""
    return (index[..., None] == torch.arange(n, device=index.device)).float()


def route(xf, gate_w, capacity):
    """Top-1 routing of the f32 tokens ``xf`` ``[t, d]`` by the gate
    ``[d, E]`` (expert.py:142-153): the router probabilities ``[t, E]``,
    each token's gate (its expert's probability), the one-hot of its expert
    ``[t, E]`` and the dispatch ``[t, E, C]``, one at the token's expert
    and slot (its place among the expert's tokens, in order) where the slot
    is within ``capacity``, else a zero row (the token is dropped)."""
    n_experts = gate_w.shape[-1]
    probs = torch.softmax(xf @ gate_w.float(), dim=-1)
    expert = probs.argmax(dim=-1)        # ties: the first index, as JAX
    gate = probs.gather(-1, expert[:, None])[:, 0]
    onehot = _one_hot(expert, n_experts)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    keep = pos < capacity
    pos_oh = _one_hot(pos.long(), capacity) * keep[..., None]
    return probs, gate, onehot, onehot[..., None] * pos_oh


def _by_source(ye, ep):
    """The experts' outputs ``[e_local, ep * C, d]`` (capacity slots of each
    source rank in turn) as ``[ep * e_local, C, d]``, row ``s * e_local +
    e`` holding source ``s``'s slots of local expert ``e``: chunk ``s`` goes
    back to rank ``s``."""
    e_local, slots, d = ye.shape
    return ye.reshape(e_local, ep, slots // ep, d).transpose(0, 1).reshape(
        ep * e_local, slots // ep, d)


def moe_ffn(x, gate_w, w1, w2, group=None, capacity_factor: float = 2.0,
            return_aux: bool = False):
    """Top-1 MoE FFN on every rank of the ep axis ``group`` (a MeshAxis, a
    process group, or None for the world), where the JAX function runs in
    ``shard_map`` over an axis name.

    x:       ``[tokens_local, d]``, this rank's tokens
    gate_w:  ``[d, E]``, whole (E = total experts)
    w1, w2:  ``[E_local, d, ff]`` / ``[E_local, ff, d]``, this rank's experts

    Returns ``[tokens_local, d]``; with ``return_aux=True`` also the Switch
    load-balancing loss over the local tokens. Tokens over an expert's
    capacity are dropped (their output is zero; a residual carries them).
    Every product sums in f32."""
    axis = as_axis(group)
    ep = axis.size
    t_local, d = x.shape
    e_local = w1.shape[0]
    n_experts = ep * e_local
    capacity = expert_capacity(capacity_factor, t_local, n_experts)

    xf = x.float()
    probs, gate, onehot, dispatch = route(xf, gate_w, capacity)

    # this rank's buffers for every expert, then to the experts' owners:
    # chunk r of dim 0 (rank r's experts) to rank r, what arrives
    # concatenated on the slots in source order
    xe = torch.einsum("tec,td->ecd", dispatch, xf)           # [E, C, d]
    xe = all_to_all(xe, axis, split_axis=0, concat_axis=1)   # [e, ep*C, d]

    h = F.gelu(torch.bmm(xe, w1.float()), approximate="tanh")
    ye = torch.bmm(h, w2.float())
    # the inverse route: each source's slots back to it, stacked by
    # source so that row e is global expert e again
    ye = all_to_all(_by_source(ye, ep), axis, split_axis=0, concat_axis=0)

    y = (torch.einsum("tec,ecd->td", dispatch, ye) * gate[:, None]).to(x.dtype)
    if not return_aux:
        return y
    # Switch aux loss: fraction of tokens routed to e x mean router prob
    aux = n_experts * torch.sum(onehot.mean(0) * probs.mean(0))
    return y, aux
