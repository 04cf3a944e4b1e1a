"""Transformer language model, on one card or sharded over a (dp, tp, sp)
mesh of ranks.

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

The sharded step. The JAX package runs one GSPMD program over a mesh; the
port writes the same computation out per rank (``parallel/``), with the
same global result. A rank holds its blocks of the parameters
(:meth:`TransformerLM.param_shardings`) and its ``(dp, sp)`` block of the
tokens. Over tp the embedding is vocab-parallel (a masked lookup summed
over tp in f32), ``wqkv`` and ``w1`` are column-parallel (``wqkv`` split by
heads), ``wo`` and ``w2`` row-parallel, and the logits vocab-parallel into
a vocab-parallel log-softmax. Over sp, attention is a ring. Every gradient
is summed over the ranks that hold the same block (dp x sp); the leaves
replicated over tp get equal gradients on every tp rank without a sum.
``mesh=None`` is the mesh of one rank: the same code, whose collectives are
the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError
from ..context import cpu, current_context
from ..kernels.flash_attention import flash_attention
from ..kernels.fused_adam import LeafTable
from ..parallel.mesh import (Mesh, P, Sharding, all_reduce_max, local_mesh,
                             sum_gradients)
from ..parallel.sequence import attention_reference, ring_self_attention
from ..parallel.tensor_parallel import (column_parallel, column_parallel_f32,
                                        gather_from_axis, reduce_from_axis,
                                        row_parallel, transformer_param_specs)

__all__ = ["transformer_lm_config", "TransformerLM"]

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

    def param_shardings(self, mesh: Mesh) -> dict:
        """Each leaf's :class:`~mxnet_tpu_torch.parallel.mesh.Sharding` on
        ``mesh``: the JAX package's specs (``transformer_param_specs``),
        except ``wqkv``, which is split by heads (its q, k and v columns of
        this rank's ``n_heads / tp`` heads) where the JAX spec cuts the
        fused columns contiguously; ``wo`` is split by rows to match."""
        cfg, tp = self.cfg, self._mesh(mesh, None).shape["tp"]
        for what, n in (("n_heads", cfg["n_heads"]), ("d_ff", cfg["d_ff"]),
                        ("vocab_size", cfg["vocab_size"])):
            if n % tp:
                raise ValueError(f"{what}={n} is not a multiple of tp={tp}")
        specs = transformer_param_specs(cfg["n_layers"])
        return {k: Sharding(mesh, specs.get(k, P()),
                            parts=3 if k.endswith("_wqkv") else 1)
                for k in self.init_shapes()}

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
    def _mesh(self, mesh, params) -> Mesh:
        if mesh is None:
            return local_mesh(params["embed"].device)
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.make_mesh mesh or None, got "
                            f"{type(mesh).__name__}")
        return mesh

    def _attention(self, q, k, v, mesh):
        if mesh.shape["sp"] > 1:
            # flash blocks inside the ring on the card, dense on the CPU
            # under "auto" (transformer.py:163-166)
            return ring_self_attention(mesh, q, k, v, causal=True,
                                       use_flash=self._use_flash(q))
        if self._use_flash(q):
            return flash_attention(q, k, v, causal=True)
        return attention_reference(q, k, v, causal=True)

    def _layer(self, x, lp, mesh):
        d, h = self.cfg["d_model"], self.cfg["n_heads"]
        tp = mesh.axis("tp")
        b, seq = x.shape[:2]
        y = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
        # (b, s, 3, h/tp, hd): the 3 is outside the heads (transformer.py:
        # 158); q, k, v are strided views, which the kernels read in place
        qkv = column_parallel(y, lp["wqkv"], group=tp).reshape(
            b, seq, 3, h // tp.size, d // h)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        attn = self._attention(q, k, v, mesh)
        attn = attn.transpose(1, 2).reshape(b, seq, d // tp.size)
        x = x + row_parallel(attn, lp["wo"], group=tp)
        y = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
        u = column_parallel(y, lp["w1"], lp["b1"], group=tp)
        u = F.gelu(u, approximate="tanh")   # jax.nn.gelu's default form
        z = row_parallel(u, lp["w2"], lp["b2"], group=tp)
        return x + z

    def _embed(self, params, tokens, mesh):
        """The tokens' rows of ``embed`` in ``dtype``, scaled, plus their
        positions' rows of ``pos_embed`` (this rank's sp block starts at
        ``sp_index * seq``). Over tp a rank owns a block of vocab rows: it
        looks up the tokens it owns, zeros elsewhere, and the sum over tp,
        in f32, is exact (one rank is non-zero)."""
        dtype = self.cfg["dtype"]
        tp, embed = mesh.axis("tp"), params["embed"]
        if tp.size == 1:
            x = F.embedding(tokens, embed)
        else:
            rows = embed.shape[0]
            local = tokens - tp.index * rows
            own = (local >= 0) & (local < rows)
            x = F.embedding(local.clamp(0, rows - 1), embed)
            x = reduce_from_axis(torch.where(own[..., None], x, 0.0), tp)
        x = x.to(dtype)
        # sqrt(d) rounded to dtype first (22.625 in bf16), then a dtype multiply
        x = x * float(torch.tensor(math.sqrt(self.cfg["d_model"]),
                                   dtype=dtype))
        seq = tokens.shape[1]
        start = mesh.coords["sp"] * seq
        return x + params["pos_embed"][start:start + seq].to(dtype)

    def _local_logits(self, params, tokens, mesh):
        """This rank's ``(dp, sp)`` block of the logits, f32, over its
        block of the vocab."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=params["embed"].device).long()
        x = self._embed(params, tokens, mesh)
        for i in range(cfg["n_layers"]):
            lp = {n: params[f"layer{i}_{n}"] for n in _LAYER_PARAMS}
            if cfg.get("remat"):
                x = checkpoint(self._layer, x, lp, mesh, use_reentrant=False)
            else:
                x = self._layer(x, lp, mesh)
        x = _layernorm(x, params["final_norm_scale"], params["final_norm_bias"])
        # f32 sums of the bf16 operands, never rounded to bf16
        # (transformer.py:217-219)
        return column_parallel_f32(x, params["lm_head"],
                                   group=mesh.axis("tp"))

    def forward(self, params, tokens, mesh=None):
        """tokens ``[batch, seq]`` int -> logits ``[batch, seq, vocab]`` f32,
        on the parameters' device. With a mesh, ``params`` and ``tokens``
        are this rank's blocks, and so are the logits: its ``(dp, sp)``
        block with the whole vocab, gathered over tp (``P("dp", "sp",
        None)``, transformer.py:219)."""
        mesh = self._mesh(mesh, params)
        return gather_from_axis(self._local_logits(params, tokens, mesh),
                                mesh.axis("tp"))

    def _nll_sum(self, logits, targets, tp):
        """Sum of the next-token NLL of an f32 log-softmax over this rank's
        tokens; over tp a vocab-parallel log-softmax (the max, the sum of
        exps and the target's logit each combined over tp)."""
        if tp.size == 1:
            return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                   targets.reshape(-1), reduction="sum")
        width = logits.shape[-1]
        with torch.no_grad():   # log_softmax's max carries no gradient
            top = all_reduce_max(logits.amax(-1, keepdim=True), tp)
        shifted = logits - top
        sumexp = reduce_from_axis(torch.exp(shifted).sum(-1), tp)
        local = targets - tp.index * width
        own = (local >= 0) & (local < width)
        picked = shifted.gather(-1, local.clamp(0, width - 1)[..., None])
        picked = reduce_from_axis(torch.where(own, picked[..., 0], 0.0), tp)
        return (torch.log(sumexp) - picked).sum()

    def loss(self, params, tokens, targets, mesh=None):
        """Mean next-token NLL of an f32 log-softmax over every token of the
        mesh (transformer.py:221), the same value on every rank; with a
        mesh, each rank passes its blocks."""
        mesh = self._mesh(mesh, params)
        logits = self._local_logits(params, tokens, mesh)
        targets = torch.as_tensor(targets, device=logits.device).long()
        count = targets.numel() * mesh.shape["dp"] * mesh.shape["sp"]
        nll = self._nll_sum(logits, targets, mesh.axis("tp")) / count
        return reduce_from_axis(nll, mesh.axis("dp", "sp"))

    # -- train step -------------------------------------------------------
    def make_train_step(self, mesh=None, lr=None, optimizer=None):
        """``step(params, moms, tokens, targets) -> (params, moms, loss)``.
        ``optimizer=None`` is the built-in SGD-momentum(0.9): ``m = 0.9 m +
        g; w -= lr m``; any ``mxnet_tpu_torch.optimizer.Optimizer`` runs its
        ``apply`` over the flat dict (``Adam(fused=True)``: one ``fused_adam``
        launch on the card). Pass the matching state from
        ``init_sharded(optimizer=...)``.

        With a mesh every rank calls the step with its blocks of params,
        state, tokens and targets; each gradient is summed over the ranks
        that hold the same block (dp x sp) before the update, and the loss
        is the global mean on every rank.

        Where JAX donates params and state to its step (``jax.jit(step,
        donate_argnums=(0, 1))``), this step updates them in place: the
        built-in rule and the optimizer write into the given tensors, so
        keep copies of anything needed afterwards. ``lr=None`` takes the
        optimizer's lr (1e-3 for the built-in). lr_schedulers are
        rejected, as the step carries no step counter.

        On a card without a mesh the step is captured, the counterpart of
        that ``jit``: a CUDA graph a set of parameter and state tensors (by
        identity; a call with other tensors captures anew and counts a
        compile under ``lm_train_step`` in ``utils.compile``), whose first
        call runs eager. Each call copies ``tokens`` and ``targets`` into
        the graph's buffers, puts the optimizer's per-step values on the
        card (``Optimizer.step_vector``; the update is ``apply_inplace``,
        the same bits as ``apply``) and replays; it returns the updated
        ``params`` and ``moms`` themselves and a copy of the loss. The
        eager cases count their reason once a step function: the CPU, a
        mesh (its gradient sums are collectives), ``mark=`` and
        ``MXTPU_CUDA_GRAPHS=0``.

        ``step(..., mark=fn)`` calls ``fn(phase)`` as each phase of the step
        ends, in order ``"forward"``, ``"backward"``, ``"grad_sum"``,
        ``"update"``: a caller times the split of a step by recording a
        CUDA event in ``fn``; such a step runs eager."""
        from ..utils import compile as compile_mod

        if mesh is not None:
            self._mesh(mesh, None)
        if optimizer is not None and optimizer.lr_scheduler is not None:
            raise MXNetError(
                "make_train_step: lr_scheduler is not consulted by the "
                "fused step (no step counter); pass explicit lr per phase "
                "or use FeedForward")
        if lr is None:
            lr = optimizer.lr if optimizer is not None else 1e-3
        label = "lm_train_step"
        programs, seen, noted = {}, set(), set()

        def eager(params, moms, tokens, targets, mark=None):
            mark = mark or (lambda phase: None)
            names = list(params)
            leaves = {k: params[k].detach().requires_grad_(True)
                      for k in names}
            m = self._mesh(mesh, params)
            loss = self.loss(leaves, tokens, targets, m)
            mark("forward")
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            mark("backward")
            grads = sum_gradients(dict(zip(names, grads)), m.axis("dp", "sp"))
            mark("grad_sum")
            with torch.no_grad():
                if optimizer is None:
                    for k in names:
                        moms[k].mul_(0.9).add_(grads[k])
                        params[k].sub_(lr * moms[k])
                    new_params, new_moms = params, moms
                else:
                    new_params, new_moms = optimizer.apply(params, grads,
                                                           moms, lr)
            mark("update")
            return new_params, new_moms, loss.detach()

        def program(params, moms, tokens, targets):
            """The captured step over these tensors: static token, target,
            gradient and step-value buffers, and the update through
            ``apply_inplace`` with a leaf table of its own (the gradients'
            buffers stay where they are, so the table never changes)."""
            names = list(params)
            dev = params[names[0]].device
            static = {"tokens": torch.empty_like(tokens),
                      "targets": torch.empty_like(targets),
                      "grads": {k: torch.empty_like(params[k])
                                for k in names},
                      "scal": None}
            table = LeafTable()

            def body():
                leaves = {k: params[k].detach().requires_grad_(True)
                          for k in names}
                loss = self.loss(leaves, static["tokens"], static["targets"],
                                 self._mesh(None, params))
                grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                with torch.no_grad():
                    for k, g in zip(names, grads):
                        static["grads"][k].copy_(g)
                    if optimizer is None:
                        for k in names:
                            moms[k].mul_(0.9).add_(static["grads"][k])
                            params[k].sub_(lr * moms[k])
                    else:
                        optimizer.apply_inplace(params, static["grads"], moms,
                                                static["scal"], table=table)
                return loss.detach()

            static["table"] = table
            # body's closure holds the tensors the graph reads
            static["captured"] = compile_mod.CapturedProgram(
                body, dev, label, warmup=1)
            return static

        def captured(params, moms, tokens, targets):
            names = list(params)
            held = [params[k] for k in names] + [
                t for t in compile_mod._flat_tensors(moms)
                if t.device == params[names[0]].device]
            key = (tuple(id(t) for t in held), tuple(tokens.shape),
                   str(tokens.dtype), tuple(targets.shape),
                   str(targets.dtype))
            compile_mod.registry().see(label, key, seen)
            prog = programs.get(key)
            if prog is None:
                prog = programs[key] = program(params, moms, tokens, targets)
            prog["tokens"].copy_(tokens, non_blocking=True)
            prog["targets"].copy_(targets, non_blocking=True)
            if optimizer is not None:
                # the host part of the step (Adam's counters advance here)
                vec = torch.from_numpy(np.ascontiguousarray(
                    optimizer.step_vector(names, moms, lr), np.float32))
                if prog["scal"] is None:
                    prog["scal"] = torch.empty(vec.numel(),
                                               dtype=torch.float32,
                                               device=tokens.device)
                prog["scal"].copy_(vec.pin_memory(), non_blocking=True)
            loss = prog["captured"]()
            return params, moms, loss.clone()

        def step(params, moms, tokens, targets, mark=None):
            device = params[next(iter(params))].device
            if mesh is not None:
                reason = ("a mesh step (its gradient sums are collectives "
                          "across ranks)")
            elif mark is not None:
                reason = "mark= (the phases are timed on the host)"
            else:
                reason = compile_mod.eager_reason(device)
            if reason is None:
                return captured(params, moms, tokens, targets)
            if reason not in noted:
                noted.add(reason)
                compile_mod.note_eager(reason)
            return eager(params, moms, tokens, targets, mark)

        step.programs = programs
        return step

    def init_sharded(self, mesh=None, seed=0, optimizer=None, ctx=None):
        """Parameters and optimizer state (zero momentum for the built-in
        SGD, else ``optimizer.init_state_tree``). Without a mesh, on ``ctx``
        (default the card). With one, this rank's blocks on the mesh's
        device: the global parameters are drawn from the rank-independent
        generator of :meth:`init_params` and cut by
        :meth:`param_shardings`, so every rank's block is the one
        ``shard(init_params(seed))`` gives."""
        if mesh is None:
            params = self.init_params(seed, ctx=ctx)
        else:
            shardings = self.param_shardings(mesh)
            if ctx is not None and ctx.torch_device != mesh.device:
                raise ValueError(f"init_sharded: ctx {ctx} but the mesh's "
                                 f"device is {mesh.device}")
            params = {k: shardings[k].shard(v)
                      for k, v in self.init_params(seed, ctx=cpu()).items()}
        if optimizer is None:
            return params, {k: torch.zeros_like(v) for k, v in params.items()}
        return params, optimizer.init_state_tree(params)

