"""Transformer language model on one card.

Counterpart of ``mxnet_tpu/models/transformer.py``: a decoder-only LM whose
parameters are a flat dict of f32 tensors under the JAX package's names and
layouts (``wqkv`` is ``(d, 3d)`` applied as ``x @ W``; ``lm_head`` is
``(d, vocab)``, not tied to ``embed``). Activations run in ``cfg["dtype"]``
with f32 master parameters. Attention takes the flash kernels
(``kernels/flash_attention.py``) or the dense reference, by ``attn_impl``.

Numerics follow the JAX model where it rounds: each einsum is one f32 sum
rounded once to ``dtype`` (every GEMM of the model, forward and gradient,
runs with cuBLAS's reduced-precision bf16 reduction switched off for its
call), bias adds run in ``dtype``, layernorm runs in f32 with the population
variance, gelu is the tanh form, ``sqrt(d_model)`` is rounded to ``dtype``
before it multiplies, and the logits are f32 sums of the bf16 operands,
never rounded to bf16. An f32 config follows torch's TF32 setting (off by
default).

The sharded step (a ``(dp, tp, sp)`` mesh) is not ported: a ``mesh`` other
than None raises ``NotImplementedError`` naming its ``ROADMAP.md`` item.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError
from ..context import current_context
from ..kernels.flash_attention import flash_attention
from ..parallel.sequence import attention_reference

__all__ = ["transformer_lm_config", "TransformerLM"]

_MESH = ("the sharded transformer step (a (dp, tp, sp) mesh, param_shardings, "
         "parallel/tensor_parallel.py) is not ported yet (ROADMAP.md A5)")
_LAYER_PARAMS = ("ln1_scale", "ln1_bias", "wqkv", "wo", "ln2_scale",
                 "ln2_bias", "w1", "b1", "w2", "b2")


def transformer_lm_config(vocab_size=32000, d_model=512, n_heads=8, n_layers=4,
                          d_ff=None, max_len=2048, dtype=torch.bfloat16,
                          attn_impl="auto", remat=False):
    """attn_impl: ``"flash"`` (the kernel module, which routes by device),
    ``"dense"`` (``attention_reference``), or ``"auto"``: flash on a CUDA
    tensor, dense on a CPU one, as the JAX package takes flash on its
    accelerator. ``remat``: recompute each layer in the backward
    (``torch.utils.checkpoint``) instead of saving its activations."""
    if attn_impl not in ("auto", "flash", "dense"):
        raise ValueError(f"attn_impl {attn_impl!r}: 'auto', 'flash' or 'dense'")
    return {
        "vocab_size": vocab_size,
        "d_model": d_model,
        "n_heads": n_heads,
        "n_layers": n_layers,
        "d_ff": d_ff or 4 * d_model,
        "max_len": max_len,
        "dtype": dtype,
        "attn_impl": attn_impl,
        "remat": remat,
    }


def _layernorm(x, scale, bias, eps=1e-5):
    """In f32 with the population variance, cast back (transformer.py:56)."""
    xf = x.float()
    c = xf - xf.mean(-1, keepdim=True)
    var = (c * c).mean(-1, keepdim=True)
    return (c * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


@contextlib.contextmanager
def _one_rounding():
    """cuBLAS's reduced-precision bf16 reduction off for the GEMMs inside,
    restored after, whatever the caller set (PyTorch's default is on)."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


class _Matmul(torch.autograd.Function):
    """``x @ w`` whose forward and gradient GEMMs each sum in f32 and round
    once to the operands' type: the model's own rounding, not a process
    flag's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with _one_rounding():
            return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        with _one_rounding():
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(dy, w.t())
            if ctx.needs_input_grad[1]:
                dw = x.reshape(-1, x.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])
        return dx, dw


def _dense(x, w, dtype):
    """``einsum(x, w.astype(dtype), preferred f32).astype(dtype)``."""
    return _Matmul.apply(x, w.to(dtype))


class TransformerLM:
    def __init__(self, config):
        self.cfg = dict(config)

    def _use_flash(self, x: torch.Tensor) -> bool:
        impl = self.cfg.get("attn_impl", "auto")
        if impl == "auto":
            return x.is_cuda
        return impl == "flash"

    # -- parameters -------------------------------------------------------
    def init_params(self, seed=0, ctx=None) -> dict:
        """Seeded f32 parameters on ``ctx`` (default ``current_context()``,
        the card), with the JAX package's scales (transformer.py:84-107).
        Drawn from a CPU ``torch.Generator``, so every device gets the same
        numbers; they are not the JAX package's numbers for the same seed."""
        device = (ctx or current_context()).torch_device
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(seed))

        def dense(shape, scale=None):
            scale = scale or 1.0 / math.sqrt(shape[0])
            return torch.randn(shape, generator=gen) * scale

        shapes = self.init_shapes()
        params = {}
        for name, shape in shapes.items():
            if name in ("embed", "pos_embed"):
                params[name] = dense(shape, 0.02)
            elif name.endswith("_scale"):
                params[name] = torch.ones(shape)
            elif name.endswith(("_bias", "_b1", "_b2")):
                params[name] = torch.zeros(shape)
            else:
                params[name] = dense(shape)
        return {k: v.to(device) for k, v in params.items()}

    def param_shardings(self, mesh):
        raise NotImplementedError(_MESH)

    def init_shapes(self):
        cfg = self.cfg
        d, ff, v = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
        shapes = {"embed": (v, d), "pos_embed": (cfg["max_len"], d),
                  "final_norm_scale": (d,), "final_norm_bias": (d,),
                  "lm_head": (d, v)}
        for i in range(cfg["n_layers"]):
            shapes.update({
                f"layer{i}_wqkv": (d, 3 * d), f"layer{i}_wo": (d, d),
                f"layer{i}_w1": (d, ff), f"layer{i}_b1": (ff,),
                f"layer{i}_w2": (ff, d), f"layer{i}_b2": (d,),
                f"layer{i}_ln1_scale": (d,), f"layer{i}_ln1_bias": (d,),
                f"layer{i}_ln2_scale": (d,), f"layer{i}_ln2_bias": (d,),
            })
        return shapes

    # -- forward ----------------------------------------------------------
    def _layer(self, x, lp):
        cfg = self.cfg
        dtype = cfg["dtype"]
        d, h = cfg["d_model"], cfg["n_heads"]
        b, seq = x.shape[:2]
        y = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
        # (b, s, 3, h, hd): the 3 is outside the heads (transformer.py:158);
        # q, k, v are strided views, which the kernels read in place
        qkv = _dense(y, lp["wqkv"], dtype).reshape(b, seq, 3, h, d // h)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        if self._use_flash(x):
            attn = flash_attention(q, k, v, causal=True)
        else:
            attn = attention_reference(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(b, seq, d)
        x = x + _dense(attn, lp["wo"], dtype)
        y = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
        u = _dense(y, lp["w1"], dtype) + lp["b1"].to(dtype)
        u = F.gelu(u, approximate="tanh")   # jax.nn.gelu's default form
        z = _dense(u, lp["w2"], dtype) + lp["b2"].to(dtype)
        return x + z

    def forward(self, params, tokens, mesh=None):
        """tokens ``[batch, seq]`` int -> logits ``[batch, seq, vocab]`` f32,
        on the parameters' device."""
        if mesh is not None:
            raise NotImplementedError(_MESH)
        cfg = self.cfg
        dtype = cfg["dtype"]
        d = cfg["d_model"]
        tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
        seq = tokens.shape[1]
        x = F.embedding(tokens, params["embed"]).to(dtype)
        # sqrt(d) rounded to dtype first (22.625 in bf16), then a dtype multiply
        x = x * float(torch.tensor(math.sqrt(d), dtype=dtype))
        x = x + params["pos_embed"][:seq].to(dtype)
        for i in range(cfg["n_layers"]):
            lp = {n: params[f"layer{i}_{n}"] for n in _LAYER_PARAMS}
            if cfg.get("remat"):
                x = checkpoint(self._layer, x, lp, use_reentrant=False)
            else:
                x = self._layer(x, lp)
        x = _layernorm(x, params["final_norm_scale"], params["final_norm_bias"])
        # f32 sums of the bf16 operands, never rounded to bf16
        # (transformer.py:217-219): the operands are upcast exactly
        return _Matmul.apply(x.float(), params["lm_head"].to(dtype).float())

    def loss(self, params, tokens, targets, mesh=None):
        """Mean next-token NLL of an f32 log-softmax (transformer.py:221)."""
        logits = self.forward(params, tokens, mesh=mesh)
        targets = torch.as_tensor(targets, device=logits.device).long()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))

    # -- train step -------------------------------------------------------
    def make_train_step(self, mesh=None, lr=None, optimizer=None):
        """``step(params, moms, tokens, targets) -> (params, moms, loss)``.
        ``optimizer=None`` is the built-in SGD-momentum(0.9): ``m = 0.9 m +
        g; w -= lr m``; any ``mxnet_tpu_torch.optimizer.Optimizer`` runs its
        ``apply`` over the flat dict (``Adam(fused=True)``: one ``fused_adam``
        launch on the card). Pass the matching state from
        ``init_sharded(optimizer=...)``.

        Where JAX donates params and state to its step, this step may update
        them in place: the built-in rule and the fused Adam write into the
        given tensors, so keep copies of anything needed afterwards.
        ``lr=None`` takes the optimizer's lr (1e-3 for the built-in).
        lr_schedulers are rejected, as the step carries no step counter."""
        if mesh is not None:
            raise NotImplementedError(_MESH)
        if optimizer is not None and optimizer.lr_scheduler is not None:
            raise MXNetError(
                "make_train_step: lr_scheduler is not consulted by the "
                "fused step (no step counter); pass explicit lr per phase "
                "or use FeedForward")
        if lr is None:
            lr = optimizer.lr if optimizer is not None else 1e-3

        def step(params, moms, tokens, targets):
            names = list(params)
            leaves = {k: params[k].detach().requires_grad_(True)
                      for k in names}
            loss = self.loss(leaves, tokens, targets)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            grads = {k: g.contiguous() for k, g in zip(names, grads)}
            with torch.no_grad():
                if optimizer is None:
                    for k in names:
                        moms[k].mul_(0.9).add_(grads[k])
                        params[k].sub_(lr * moms[k])
                    new_params, new_moms = params, moms
                else:
                    new_params, new_moms = optimizer.apply(params, grads,
                                                           moms, lr)
            return new_params, new_moms, loss.detach()

        return step

    def init_sharded(self, mesh=None, seed=0, optimizer=None, ctx=None):
        """Parameters and optimizer state (zero momentum for the built-in
        SGD, else ``optimizer.init_state_tree``) on ``ctx`` (default the
        card)."""
        if mesh is not None:
            raise NotImplementedError(_MESH)
        params = self.init_params(seed, ctx=ctx)
        if optimizer is None:
            return params, {k: torch.zeros_like(v) for k, v in params.items()}
        return params, optimizer.init_state_tree(params)
