"""LSTM language model as functions of a parameter dict, the time loop in
torch.

Counterpart of ``mxnet_tpu/models/lstm_scan.py``, whose ``lax.scan`` runs
the cell over the sequence; here a Python loop over time steps runs it
eagerly, forward and (through autograd) backward. Parameters follow the
unrolled symbol's names (``embed_weight``, ``l{i}_i2h_*``,
``l{i}_h2h_*``, ``cls_*``), so they interchange with ``lstm_unroll``;
``convert.lstm_params_from_numpy`` carries the JAX package's across.
"""

from __future__ import annotations

import math

import torch

from ..context import current_context

__all__ = ["LSTMLM"]


class LSTMLM:
    def __init__(self, vocab, num_embed=64, num_hidden=128, num_layers=2,
                 dtype=torch.float32):
        self.vocab = vocab
        self.num_embed = num_embed
        self.num_hidden = num_hidden
        self.num_layers = num_layers
        self.dtype = dtype

    def init_params(self, seed=0, ctx=None):
        """f32 parameters on ``ctx`` (default ``current_context()``, the
        card): the JAX package's shapes and scales (U(±1/sqrt(fan_in)),
        zero biases), drawn from a ``torch.Generator`` seeded ``seed``."""
        dev = (ctx if ctx is not None else current_context()).torch_device
        gen = torch.Generator().manual_seed(int(seed))
        h, e, v = self.num_hidden, self.num_embed, self.vocab

        def mat(shape):
            scale = 1.0 / math.sqrt(shape[-1])
            return ((torch.rand(shape, generator=gen) * 2 - 1) * scale).to(dev)

        params = {"embed_weight": mat((v, e)), "cls_weight": mat((v, h)),
                  "cls_bias": torch.zeros(v, device=dev)}
        for i in range(self.num_layers):
            in_dim = e if i == 0 else h
            params[f"l{i}_i2h_weight"] = mat((4 * h, in_dim))
            params[f"l{i}_i2h_bias"] = torch.zeros(4 * h, device=dev)
            params[f"l{i}_h2h_weight"] = mat((4 * h, h))
            params[f"l{i}_h2h_bias"] = torch.zeros(4 * h, device=dev)
        return params

    def _cell(self, params, layer, x, c, h):
        """One step of one layer; gates in the order (i, g, f, o), as
        ``lstm_unroll``'s SliceChannel (in, transform, forget, out)."""
        gates = (x @ params[f"l{layer}_i2h_weight"].T
                 + params[f"l{layer}_i2h_bias"]
                 + h @ params[f"l{layer}_h2h_weight"].T
                 + params[f"l{layer}_h2h_bias"])
        i, g, f, o = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return c_new, h_new

    def forward(self, params, tokens, init_states=None):
        """tokens ``[batch, seq]`` int -> logits ``[batch, seq, vocab]`` and
        the final ``(c, h)`` of each layer."""
        b, s = tokens.shape
        dev = params["embed_weight"].device
        if init_states is None:
            init_states = [(torch.zeros(b, self.num_hidden, device=dev),
                            torch.zeros(b, self.num_hidden, device=dev))
                           for _ in range(self.num_layers)]
        embeds = params["embed_weight"][tokens.long()]  # [b, s, e]
        carry = list(init_states)
        hs = []
        for t in range(s):
            inp = embeds[:, t]
            for layer, (c, h) in enumerate(carry):
                carry[layer] = self._cell(params, layer, inp, c, h)
                inp = carry[layer][1]
            hs.append(inp)
        hs = torch.stack(hs, dim=1)  # [b, s, h]
        logits = hs @ params["cls_weight"].T + params["cls_bias"]
        return logits, carry

    def loss(self, params, tokens, targets):
        logits, _ = self.forward(params, tokens)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        return nll.mean()

    def init_optimizer(self, params):
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def make_train_step(self, lr=0.5, momentum=0.9, clip=None):
        """``step(params, moms, tokens, targets) -> (params, moms, loss)``:
        SGD with momentum, ``m = momentum * m + g``, ``w = w - lr * m``,
        written into ``params`` and ``moms`` in place (the JAX package
        donates them)."""
        def step(params, moms, tokens, targets):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in params.items()}
            loss = self.loss(leaves, tokens, targets)
            names = list(leaves)
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            with torch.no_grad():
                for k, g in zip(names, grads):
                    if clip is not None:
                        g = torch.clamp(g, -clip, clip)
                    moms[k].mul_(momentum).add_(g)
                    params[k].sub_(lr * moms[k])
            return params, moms, loss.detach()

        return step
