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
           "transformer_params_from_numpy"]


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
