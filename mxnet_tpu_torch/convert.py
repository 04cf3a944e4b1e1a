"""Carry parameters between the JAX package and the port.

The JAX package keeps parameters as numpy-convertible arrays (NDArrays with
``.asnumpy()``, jax arrays, numpy arrays); the port keeps torch tensors. The
same numbers in both give the same computation, which is how the tests hold
the port to the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["to_tensor", "params_from_numpy", "random_params",
           "adam_state_from_numpy", "adam_state_to_numpy",
           "transformer_params_from_numpy", "moe_params_from_numpy",
           "lstm_params_from_numpy",
           "shard_transformer_params",
           "gather_transformer_params", "shard_optimizer_state",
           "gather_optimizer_state", "residual_rows_from_numpy",
           "residual_rows_to_numpy"]


def to_tensor(value, device) -> torch.Tensor:
    """One parameter as a tensor on ``device``: a torch tensor is moved, an
    NDArray or numpy-convertible array is copied."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if hasattr(value, "asnumpy"):
        value = value.asnumpy()
    return torch.from_numpy(np.array(value)).to(device)


def params_from_numpy(arg_params, aux_params, device):
    """``(arg_params, aux_params)`` of numpy-convertible arrays, as dicts of
    tensors on ``device``."""
    device = torch.device(device)
    return ({k: to_tensor(v, device) for k, v in arg_params.items()},
            {k: to_tensor(v, device) for k, v in (aux_params or {}).items()})


def transformer_params_from_numpy(params, device):
    """A transformer LM's flat parameter dict of numpy-convertible arrays
    (the JAX package's ``TransformerLM.init_params``) as f32 tensors on
    ``device``, under the same names and layouts: ``wqkv`` stays ``(d, 3d)``
    applied as ``x @ W``, ``lm_head`` stays ``(d, vocab)``. The built-in
    SGD-momentum state has the same layout and crosses the same way."""
    device = torch.device(device)
    return {k: to_tensor(v, device).float() for k, v in params.items()}


def lstm_params_from_numpy(params, device):
    """``LSTMLM``'s parameters (the JAX package's ``LSTMLM.init_params``, or
    ``lstm_unroll``'s arguments of the same names) as f32 tensors on
    ``device``, under the same names and layouts (``l{i}_i2h_weight`` is
    ``(4 * hidden, in)``, applied as ``x @ W.T``). Its momentum crosses the
    same way."""
    return transformer_params_from_numpy(params, device)


def moe_params_from_numpy(params, device):
    """The MoE pipeline LM's parameters in the JAX package's layout
    (``MoEPipelineLM.init_params``: stage leaves lead with the stage
    dimension, ``w1``/``w2`` with stage and expert) as f32 tensors on
    ``device``, under the same names and layouts; so is its momentum.
    :func:`shard_transformer_params` and :func:`gather_transformer_params`
    cut and join them by an ``MoEPipelineLM``'s ``param_shardings``."""
    return transformer_params_from_numpy(params, device)


def shard_transformer_params(params, mesh, model):
    """This rank's blocks (f32 tensors on the mesh's device) of a
    transformer LM's global parameters, numpy-convertible arrays in the
    JAX package's layout, cut by ``model.param_shardings(mesh)`` (a
    ``TransformerLM`` or an ``MoEPipelineLM``)."""
    shardings = model.param_shardings(mesh)
    return {k: shardings[k].shard(np.asarray(_host(v), np.float32))
            for k, v in params.items()}


def gather_transformer_params(local, mesh, model):
    """The global parameters as float32 numpy arrays from every rank's
    blocks: a collective, which every rank of the mesh calls. The exact
    inverse of :func:`shard_transformer_params`."""
    shardings = model.param_shardings(mesh)
    # a copy: a replicated leaf gathers to the rank's own tensor
    return {k: shardings[k].gather(v).cpu().numpy().copy()
            for k, v in local.items()}


def _map_state(states, shardings, fn):
    """``fn(sharding, leaf)`` on each leaf of an optimizer state: one
    tensor a parameter (SGD momentum) or a tuple (Adam's m, v, t)."""
    return {k: (tuple(fn(shardings[k], x) for x in s)
                if isinstance(s, (tuple, list)) else fn(shardings[k], s))
            for k, s in states.items()}


def shard_optimizer_state(states, mesh, model):
    """This rank's blocks of a transformer optimizer state of
    numpy-convertible arrays (``{name: m}`` for the built-in SGD,
    ``{name: (m, v, t)}`` for Adam): each leaf shaped like its parameter is
    cut like it, a step counter becomes the port's 0-d f32 CPU tensor."""
    def one(sharding, x):
        x = np.asarray(_host(x), np.float32)
        return sharding.shard(x) if x.ndim else torch.tensor(float(x))

    return _map_state(states, model.param_shardings(mesh), one)


def gather_optimizer_state(states, mesh, model):
    """The global optimizer state as float32 numpy arrays (a collective,
    like :func:`gather_transformer_params`)."""
    def one(sharding, x):
        if x.dim():
            return sharding.gather(x).cpu().numpy()
        return np.asarray(_host(x), np.float32)

    return _map_state(states, model.param_shardings(mesh), one)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x.asnumpy() if hasattr(x, "asnumpy") else x


def adam_state_from_numpy(states, device):
    """An Adam/AdamW state ``{name: (m, v, t)}`` of numpy-convertible
    arrays (the JAX package's ``init_state_tree`` layout) in the port's
    layout: the moments as float32 tensors on ``device``, the step counter
    as a 0-d float32 tensor on the CPU."""
    device = torch.device(device)
    return {k: (to_tensor(m, device).float(), to_tensor(v, device).float(),
                torch.tensor(float(np.asarray(t)), dtype=torch.float32))
            for k, (m, v, t) in states.items()}


def adam_state_to_numpy(states):
    """The port's Adam state as ``{name: (m, v, t)}`` of float32 numpy
    arrays, t 0-d, which the JAX package's optimizer takes as it is."""
    return {k: tuple(np.array(x.detach().cpu().numpy(), np.float32)
                     for x in (m, v, t))
            for k, (m, v, t) in states.items()}


def random_params(symbol, seed, **input_shapes):
    """Seeded numpy parameters for ``symbol`` at the given input shapes, for
    tests and smoke runs (either package's symbol: names and shapes agree).

    Conv weights are He-normal and FC weights are scaled by 1/sqrt(fan_in),
    so activations keep their scale through depth; biases are small; BN's
    gamma, beta and running stats lie near the identity, except the gamma of
    the last BN of each ResNet residual branch (``*_br3_bn_gamma``), which is
    0.1: the zero-gamma init of Goyal et al. (2017), kept above zero so the
    branch stays live. Without it each residual add doubles the activations'
    power, and after ResNet-50's 16 blocks the softmax is one-hot. Returns
    ``(arg_params, aux_params)`` of float32 arrays, without the inputs and
    the loss heads' labels.
    """
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in input_shapes or name.endswith("_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[1:]))
            gain = 2.0 if len(shape) == 4 else 1.0
            v = rng.standard_normal(shape) * np.sqrt(gain / fan_in)
        elif name.endswith("_br3_bn_gamma"):
            v = np.full(shape, 0.1)
        elif name.endswith("_gamma"):
            v = rng.uniform(0.8, 1.2, shape)
        else:  # biases and BN betas
            v = rng.standard_normal(shape) * 0.1
        args[name] = v.astype(np.float32)
    aux = {}
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        if name.endswith("_moving_var"):
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.standard_normal(shape) * 0.1
        aux[name] = v.astype(np.float32)
    return args, aux


def residual_rows_from_numpy(state, rank, device="cpu"):
    """Rank ``rank``'s ``(1, Lp)`` float32 error-feedback row from the JAX
    package's ``(axis_size, Lp)`` state (``comm.init_error_feedback``,
    sharded ``P("dp")`` so device ``rank`` holds row ``rank``), for
    ``comm.error_feedback_allreduce`` on that rank; ``rank=None`` gives
    every row, ``(axis_size, Lp)``, the state of the replicas of one
    process (``FeedForward(ctx=[...])``, whose residual ledgers a sharded
    checkpoint saves in this layout). A dict of such states (the
    per-bucket ledgers) maps name by name."""
    if isinstance(state, dict):
        return {k: residual_rows_from_numpy(v, rank, device)
                for k, v in state.items()}
    rows = np.asarray(state, np.float32)
    if rows.ndim != 2 or not (rank is None or 0 <= rank < rows.shape[0]):
        raise ValueError(f"residual state of shape {rows.shape} has no row "
                         f"{rank}")
    if rank is None:
        return torch.from_numpy(rows.copy()).to(device)
    return torch.from_numpy(rows[rank:rank + 1].copy()).to(device)


def residual_rows_to_numpy(rows):
    """The JAX package's ``(axis_size, Lp)`` float32 state from every
    rank's ``(1, Lp)`` row given in rank order, or from ``(R, Lp)`` blocks
    of rows (a replica group's); a dict of per-bucket ledgers maps name by
    name."""
    if isinstance(rows, dict):
        return {k: residual_rows_to_numpy(v) for k, v in rows.items()}
    if isinstance(rows, (torch.Tensor, np.ndarray)):
        rows = [rows]
    return np.concatenate([
        np.asarray(r.detach().cpu().numpy() if isinstance(r, torch.Tensor)
                   else r, np.float32).reshape(-1, r.shape[-1])
        for r in rows])
