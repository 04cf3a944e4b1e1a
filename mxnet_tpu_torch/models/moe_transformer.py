"""MoE pipeline-parallel LM: dp + pp + ep in one train step, over a mesh of
ranks.

Counterpart of ``mxnet_tpu/models/moe_transformer.py``. The mesh axes are
(dp, pp, ep): GPipe microbatch pipelining over pp
(:func:`~mxnet_tpu_torch.parallel.pipeline.spmd_pipeline`), Switch-style
expert parallelism over ep (:func:`~mxnet_tpu_torch.parallel.expert.
moe_ffn`), the batch split over (dp, ep). Where the JAX model runs one
``shard_map`` and takes its gradient through it, every rank here runs the
same program on its blocks and autograd runs the backward pipeline and the
inverse expert routes through the shifts and all-to-alls.

Each pipeline stage is a pre-LN causal self-attention (the dense f32
reference) and an MoE FFN. Parameters, activations and every product are
f32. A stage other than the last computes no logits: their gradient is
zero there, and the loss masks them out (the JAX model computes and masks
them); it joins every collective all the same.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..context import cpu, current_context
from ..parallel.expert import moe_ffn
from ..parallel.mesh import Mesh, P, Sharding, local_mesh, sum_gradients
from ..parallel.pipeline import spmd_pipeline
from ..parallel.sequence import attention_reference
from ..parallel.tensor_parallel import reduce_from_axis
from .transformer import _layernorm

__all__ = ["MoEPipelineLM", "moe_pipeline_config"]

# the leaves of one stage, stacked on a leading stage dimension
STAGE_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "wqkv", "wo",
              "gate", "w1", "w2")
# the stage leaves also split over ep, on their expert dimension
EXPERT_KEYS = ("w1", "w2")


def moe_pipeline_config(vocab_size=1024, d_model=64, n_heads=4, d_ff=None,
                        n_experts=4, max_len=64, n_micro=4,
                        capacity_factor=2.0, aux_loss_coef=0.01):
    return {
        "vocab_size": vocab_size, "d_model": d_model, "n_heads": n_heads,
        "d_ff": d_ff or 4 * d_model, "n_experts": n_experts,
        "max_len": max_len, "n_micro": n_micro,
        "capacity_factor": capacity_factor, "aux_loss_coef": aux_loss_coef,
    }


class MoEPipelineLM:
    """One transformer block per pipeline stage; stage count = mesh pp
    size."""

    def __init__(self, config):
        self.cfg = dict(config)

    def _param_specs(self):
        """PartitionSpec per param (moe_transformer.py:50-63). Stage-stacked
        leaves lead with 'pp'; expert-stacked leaves also split 'ep'."""
        specs = {"embed": P(), "pos_embed": P(), "final_norm_scale": P(),
                 "final_norm_bias": P(), "lm_head": P()}
        for k in STAGE_KEYS:
            specs[k] = P("pp", "ep") if k in EXPERT_KEYS else P("pp")
        return specs

    def init_shapes(self, n_stages: int) -> dict:
        cfg = self.cfg
        d, ff, v, e = (cfg["d_model"], cfg["d_ff"], cfg["vocab_size"],
                       cfg["n_experts"])
        return {"embed": (v, d), "pos_embed": (cfg["max_len"], d),
                "final_norm_scale": (d,), "final_norm_bias": (d,),
                "lm_head": (d, v),
                "ln1_scale": (n_stages, d), "ln1_bias": (n_stages, d),
                "ln2_scale": (n_stages, d), "ln2_bias": (n_stages, d),
                "wqkv": (n_stages, d, 3 * d), "wo": (n_stages, d, d),
                "gate": (n_stages, d, e), "w1": (n_stages, e, d, ff),
                "w2": (n_stages, e, ff, d)}

    def init_params(self, seed=0, n_stages: int = 1, ctx=None) -> dict:
        """Seeded f32 parameters on ``ctx`` (default ``current_context()``,
        the card) with the JAX
        package's scales and layouts (moe_transformer.py:65-86), drawn from
        a CPU ``torch.Generator``: other numbers than the JAX package's for
        the same seed."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(int(seed))
        s = 1.0 / math.sqrt(cfg["d_model"])
        scales = {"embed": 0.02, "pos_embed": 0.02, "lm_head": s, "wqkv": s,
                  "wo": s, "gate": s, "w1": s,
                  "w2": 1.0 / math.sqrt(cfg["d_ff"])}
        params = {}
        for k, shape in self.init_shapes(n_stages).items():
            if k in scales:
                params[k] = torch.randn(shape, generator=gen) * scales[k]
            elif k.endswith("_scale"):
                params[k] = torch.ones(shape)
            else:
                params[k] = torch.zeros(shape)
        device = (ctx or current_context()).torch_device
        return {k: v.to(device) for k, v in params.items()}

    def param_shardings(self, mesh: Mesh) -> dict:
        """Each leaf's :class:`~mxnet_tpu_torch.parallel.mesh.Sharding` on
        ``mesh``: the JAX package's specs."""
        return {k: Sharding(mesh, spec)
                for k, spec in self._param_specs().items()}

    def init_sharded(self, mesh=None, seed=0, ctx=None):
        """This rank's blocks of the parameters and zero momentum:
        :meth:`init_params` of ``seed`` with ``pp`` stages, cut by
        :meth:`param_shardings` (every rank draws the same global numbers).
        On the mesh's device; without a mesh, the whole parameters of one
        stage on ``ctx`` (default ``current_context()``, the card)."""
        if mesh is None:
            params = self.init_params(seed, 1, ctx=ctx)
        else:
            mesh = self._mesh(mesh, None)
            if ctx is not None and ctx.torch_device != mesh.device:
                raise ValueError(f"init_sharded: ctx {ctx} but the mesh's "
                                 f"device is {mesh.device}")
            shardings = self.param_shardings(mesh)
            params = {k: shardings[k].shard(v) for k, v in self.init_params(
                seed, mesh.shape["pp"], ctx=cpu()).items()}
        return params, {k: torch.zeros_like(v) for k, v in params.items()}

    def _mesh(self, mesh, params) -> Mesh:
        if mesh is None:
            return local_mesh(params["embed"].device)
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh: a parallel.make_mesh mesh or None, got "
                            f"{type(mesh).__name__}")
        return mesh

    # -- forward + loss on this rank's blocks -------------------------------
    def _block(self, p, x, ep):
        """One stage on one microbatch (moe_transformer.py:103-125). ``p``
        leaves carry a leading stage dimension of 1 (this rank's slice); x:
        ``[mb, seq, d]``."""
        cfg = self.cfg
        h = cfg["n_heads"]
        mb, seq, d = x.shape
        y = _layernorm(x, p["ln1_scale"][0], p["ln1_bias"][0])
        qkv = (y @ p["wqkv"][0]).reshape(mb, seq, 3, h, d // h)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        attn = attention_reference(q, k, v, causal=True)
        attn = attn.transpose(1, 2).reshape(mb, seq, d)
        x = x + attn @ p["wo"][0]
        y = _layernorm(x, p["ln2_scale"][0], p["ln2_bias"][0])
        out, aux = moe_ffn(y.reshape(mb * seq, d), p["gate"][0], p["w1"][0],
                           p["w2"][0], group=ep,
                           capacity_factor=cfg["capacity_factor"],
                           return_aux=True)
        return x + out.reshape(mb, seq, d), aux

    def loss(self, mesh, params, tokens, targets):
        """The JAX package's loss (moe_transformer.py:127-172), the same
        value on every rank: the mean next-token NLL over every token of the
        batch, from the last stage, plus ``aux_loss_coef`` times the Switch
        aux summed over stages, averaged over microbatches and (dp, ep)
        shards. ``params`` are this rank's blocks and ``tokens`` /
        ``targets`` its ``P(("dp", "ep"), None)`` block of the batch (the
        same on every stage); ``mesh=None`` is the mesh of one rank."""
        cfg = self.cfg
        mesh = self._mesh(mesh, params)
        device = params["embed"].device
        tokens = torch.as_tensor(tokens, device=device).long()
        n_micro, d = cfg["n_micro"], cfg["d_model"]
        mb_total, seq = tokens.shape
        if mb_total % n_micro:
            raise ValueError(f"a rank's {mb_total} sequences do not split "
                             f"into n_micro={n_micro} microbatches")

        x = F.embedding(tokens, params["embed"]) * math.sqrt(d)
        x = x + params["pos_embed"][:seq]
        x_micro = x.reshape(n_micro, mb_total // n_micro, seq, d)
        pipe = spmd_pipeline(
            functools.partial(self._block, ep=mesh.axis("ep")), n_micro,
            mesh.axis("pp"), with_aux=True)
        outs, aux_sum = pipe({k: params[k] for k in STAGE_KEYS}, x_micro)

        pp = mesh.axis("pp")
        if pp.index == pp.size - 1:
            y = _layernorm(outs.reshape(mb_total, seq, d),
                           params["final_norm_scale"],
                           params["final_norm_bias"])
            logits = y @ params["lm_head"]
            targets = torch.as_tensor(targets, device=device).long()
            nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1), reduction="sum")
        else:   # outs are zeros here: the JAX model's masked logits
            nll = torch.zeros((), device=device)
        # the NLL over (pp, dp, ep) and the aux over pp, then (dp, ep), in
        # one sum over every rank
        shards = mesh.shape["dp"] * mesh.shape["ep"]
        total = reduce_from_axis(torch.stack([nll, aux_sum / n_micro]),
                                 mesh.axis("dp", "pp", "ep"))
        n = float(mb_total * seq * shards)
        return total[0] / n + cfg["aux_loss_coef"] * (total[1] / shards)

    def grad_axes(self, mesh) -> dict:
        """The ranks over which each leaf's gradient is summed: those that
        hold the same block. Replicated leaves over every rank, stage
        leaves over dp x ep, expert leaves over dp."""
        out = {}
        for k, spec in self._param_specs().items():
            if "ep" in spec:
                out[k] = mesh.axis("dp")
            elif "pp" in spec:
                out[k] = mesh.axis("dp", "ep")
            else:
                out[k] = mesh.axis("dp", "pp", "ep")
        return out

    def make_train_step(self, mesh=None, lr=0.1, momentum=0.9):
        """``step(params, moms, tokens, targets) -> (params, moms, loss)``:
        SGD with momentum (``m = momentum m + g; w -= lr m``) on this rank's
        blocks, every gradient summed over the ranks that hold the same
        block first (:meth:`grad_axes`). Where the JAX step donates params
        and momentum, this one updates them in place.

        ``step(..., mark=fn)`` calls ``fn(phase)`` as each phase ends, in
        order ``"forward"``, ``"backward"``, ``"grad_sum"``, ``"update"``."""
        if mesh is not None:
            self._mesh(mesh, None)

        def step(params, moms, tokens, targets, mark=None):
            mark = mark or (lambda phase: None)
            m = self._mesh(mesh, params)
            names = list(params)
            leaves = {k: params[k].detach().requires_grad_(True)
                      for k in names}
            loss = self.loss(m, leaves, tokens, targets)
            mark("forward")
            # a stage other than the last has no path to the head's leaves
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        allow_unused=True)
            grads = {k: torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(names, grads)}
            mark("backward")
            grads = sum_gradients(grads, self.grad_axes(m))
            mark("grad_sum")
            with torch.no_grad():
                for k in names:
                    moms[k].mul_(momentum).add_(grads[k])
                    params[k].sub_(lr * moms[k])
            mark("update")
            return params, moms, loss.detach()

        return step
