"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``init(name, arr)`` fills the
tensor ``arr`` in place according to what the parameter is, by the suffix of
its name (weight, bias, gamma, beta, moving statistics). Samples come from
the CPU generator of :mod:`mxnet_tpu_torch.random` when ``arr`` lies on the
CPU, else from its device's, so ``random.seed`` makes initialization
reproducible (torch draws other numbers than JAX from the same seed).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "One", "Zero", "Constant"]


class Initializer:
    """Base: routes parameters by name suffix, like the reference."""

    def __call__(self, name: str, arr: torch.Tensor):
        if not isinstance(name, str):
            raise TypeError("name must be str")
        with torch.no_grad():
            self._dispatch(name, arr)

    def _dispatch(self, name, arr):
        if name.endswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        elif name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif name.endswith("weight"):
            self._init_weight(name, arr)
        elif name.endswith("moving_mean"):
            self._init_zero(name, arr)
        elif name.endswith("moving_var"):
            self._init_one(name, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(name, arr)
        else:
            self._init_default(name, arr)

    def _init_zero(self, _name, arr):
        arr.fill_(0.0)

    def _init_one(self, _name, arr):
        arr.fill_(1.0)

    def _init_bias(self, _name, arr):
        arr.fill_(0.0)

    def _init_gamma(self, _name, arr):
        arr.fill_(1.0)

    def _init_beta(self, _name, arr):
        arr.fill_(0.0)

    def _init_bilinear(self, _name, arr):
        # bilinear upsampling kernel (reference keeps this for Deconvolution)
        shape = arr.shape
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr.copy_(torch.from_numpy(weight))

    def _init_weight(self, name, arr):
        raise NotImplementedError("virtual _init_weight")

    def _init_default(self, name, arr):
        raise MXNetError(
            f"Unknown parameter kind for {name!r}; initializer only handles "
            "names ending in weight/bias/gamma/beta/moving_{mean,var,avg}"
        )


def _uniform_(arr, low, high):
    arr.uniform_(low, high, generator=_random.generator(arr.device))


def _normal_(arr, loc, scale):
    arr.normal_(loc, scale, generator=_random.generator(arr.device))


class Uniform(Initializer):
    """U(-scale, scale) weights."""

    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, _name, arr):
        _uniform_(arr, -self.scale, self.scale)


class Normal(Initializer):
    """N(0, sigma²) weights."""

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, _name, arr):
        _normal_(arr, 0.0, self.sigma)


class Xavier(Initializer):
    """Glorot initialization, with the rnd_type/factor_type/magnitude
    extensions later MXNet added."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, _name, arr):
        shape = arr.shape
        fan_out = shape[0]
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _uniform_(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal_(arr, 0.0, scale)
        else:
            raise MXNetError(f"bad rnd_type {self.rnd_type}")


class One(Initializer):
    def _init_weight(self, _name, arr):
        arr.fill_(1.0)

    def _init_default(self, _name, arr):
        arr.fill_(1.0)


class Zero(Initializer):
    def _init_weight(self, _name, arr):
        arr.fill_(0.0)

    def _init_default(self, _name, arr):
        arr.fill_(0.0)


class Constant(Initializer):
    def __init__(self, value):
        self.value = value

    def _init_weight(self, _name, arr):
        arr.fill_(self.value)

    def _init_default(self, _name, arr):
        arr.fill_(self.value)
