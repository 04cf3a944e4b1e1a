"""Random number generation with explicit generators.

Counterpart of ``mxnet_tpu/random.py``. Where the JAX package keeps one
splittable key, the port keeps one ``torch.Generator`` per device, created on
first use and seeded from the last :func:`seed` (0 before any call). Graph
nodes that draw (Dropout) take the executor's generator for their device;
the initializers draw from the CPU generator. torch and JAX draw different
numbers from the same seed.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

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
