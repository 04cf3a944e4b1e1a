"""Random number generation with explicit generators.

Counterpart of ``mxnet_tpu/random.py``. Where the JAX package keeps one
splittable key, the port keeps one ``torch.Generator`` per device, created on
first use and seeded from the last :func:`seed` (0 before any call). Graph
nodes that draw (Dropout) take the executor's generator for their device;
the initializers draw from the CPU generator; :func:`uniform`,
:func:`normal` and :func:`randint` draw from the generator of the device
they place their result on. :func:`get_state` and :func:`set_state` save and
restore every generator, so draws after a restore repeat bitwise. torch and
JAX draw different numbers from the same seed.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "generator", "get_state", "set_state", "uniform",
           "normal", "gaussian", "randint"]

_LOCK = threading.Lock()
_SEED = [0]
_GENERATORS: dict[torch.device, torch.Generator] = {}


def _key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed(seed_state: int):
    """Seed every device's generator (reference: mx.random.seed)."""
    with _LOCK:
        _SEED[0] = int(seed_state)
        for gen in _GENERATORS.values():
            gen.manual_seed(_SEED[0])


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device``, created and seeded on first use."""
    key = _key(device)
    with _LOCK:
        gen = _GENERATORS.get(key)
        if gen is None:
            gen = _GENERATORS[key] = torch.Generator(device=key)
            gen.manual_seed(_SEED[0])
        return gen


def get_state() -> dict:
    """A snapshot of the seed and every generator's state, JSON-able:
    ``{"seed": int, "generators": {device: [state bytes]}}``."""
    with _LOCK:
        return {"seed": _SEED[0],
                "generators": {str(dev): gen.get_state().tolist()
                               for dev, gen in _GENERATORS.items()}}


def set_state(state: dict):
    """Restore a :func:`get_state` snapshot: generators it names take their
    saved states, any other is reseeded from its seed."""
    with _LOCK:
        _SEED[0] = int(state["seed"])
        saved = state["generators"]
        for dev, gen in _GENERATORS.items():
            if str(dev) not in saved:
                gen.manual_seed(_SEED[0])
    for dev, words in saved.items():
        generator(dev).set_state(torch.tensor(words, dtype=torch.uint8))


def _draw_target(shape, ctx, out, dtype):
    """(shape, ctx, torch dtype) of a draw: ``out``'s when it is given and
    ``shape`` is not."""
    from .context import current_context
    from .ndarray import _torch_dtype

    if out is not None and shape is None:
        shape, dtype, ctx = out.shape, out.dtype, out.context
    if isinstance(shape, int):
        shape = (shape,)
    return tuple(shape or ()), ctx or current_context(), _torch_dtype(dtype)


def _result(data, ctx, out):
    from .ndarray import NDArray

    if out is None:
        return NDArray(data, ctx)
    return out._set_data(data)


def uniform(low=0.0, high=1.0, shape=None, ctx=None, out=None,
            dtype=np.float32):
    """Samples uniform in [low, high), drawn in f32 on ``ctx``'s device and
    cast to ``dtype``; written into ``out`` when given."""
    shape, ctx, dtype = _draw_target(shape, ctx, out, dtype)
    dev = ctx.torch_device
    u = torch.rand(shape, generator=generator(dev), device=dev)
    return _result((low + (high - low) * u).to(dtype), ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, ctx=None, out=None,
           dtype=np.float32):
    """Gaussian samples ``loc + scale * N(0, 1)``, drawn in f32 on
    ``ctx``'s device and cast to ``dtype``."""
    shape, ctx, dtype = _draw_target(shape, ctx, out, dtype)
    dev = ctx.torch_device
    z = torch.randn(shape, generator=generator(dev), device=dev)
    return _result((z * scale + loc).to(dtype), ctx, out)


gaussian = normal


def randint(low, high, shape=None, ctx=None, dtype=np.int32):
    """Integers uniform in [low, high)."""
    shape, ctx, dtype = _draw_target(shape, ctx, None, dtype)
    dev = ctx.torch_device
    return _result(torch.randint(low, high, shape, generator=generator(dev),
                                 device=dev, dtype=dtype), ctx, None)
