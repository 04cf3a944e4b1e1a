"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``: the registry, SGD with momentum,
Test, Adam, AdamW (decoupled decay with a name filter), RMSProp and AdaGrad,
``create`` and ``get_updater``. Two surfaces, as in the JAX package:

  - ``apply(params, grads, states, lr) -> (params, states)`` over dicts of
    tensors, which ``FeedForward.fit`` calls under ``torch.no_grad()``. The
    per-leaf path returns new tensors. ``Adam(fused=True)`` takes the
    whole-tree pass instead, ``kernels/fused_adam.py``: one kernel launch on
    CUDA tensors, the kernel's plain version on CPU tensors. It updates the
    given tensors in place and returns them. Both give bitwise the same
    params and moments, in the same ``{name: (m, v, t)}`` state layout, so a
    run may switch paths between steps.
  - the imperative ``update(index, weight, grad, state)`` of the updater
    contract (``get_updater``), which writes into ``weight`` and the state.

``FeedForward``'s training step takes a third, in place and in two parts,
so that it can be captured into a CUDA graph: ``step_vector(names, states,
lr)`` runs on the host before each step (it advances the host's counters,
Adam's ``t``, and returns the step's values as f32: lr, then the
optimizer's per-leaf values), and ``apply_inplace(params,
grads, states, scal)`` runs on the device, reading those values from the
device copy ``scal`` of that vector and writing the parameters and the
state tensors in place. It computes what ``apply`` computes, bit for bit.

Every step rounds like the JAX package's f32 expressions, one operation at a
time: Python-float hyperparameters are rounded to f32 where they meet a
tensor. Adam's step counter ``t`` is a 0-d f32 tensor on the CPU, so the
bias corrections are computed on the host without waiting for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, Registry
from .kernels import fused_adam as kfa
from .kernels.fused_adam import (LeafTable, fused_adam, fused_adam_step,
                                 fused_adam_step_plain, fused_resolve,
                                 sqrt_rn)

__all__ = ["Optimizer", "SGD", "Test", "Adam", "AdamW", "RMSProp", "AdaGrad",
           "create", "get_updater"]

OPTIMIZERS = Registry("optimizer")


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def _bias_correction(beta, t: torch.Tensor) -> float:
    """``1 - beta**t`` in f32 for the 0-d f32 step counter ``t``: an f32
    ``pow`` and an f32 subtract, as the JAX package computes it (its bits
    agree with XLA's on the CPU; tests/test_torch_fused_adam.py)."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(t.item()))


def _lr(lr):
    """lr as the step uses it: a 0-d f32 device tensor as it is, a Python
    number rounded to f32 (where it meets a tensor, the same value)."""
    return lr if isinstance(lr, torch.Tensor) else _f32(lr)


def _write_tree(old, new):
    """Copy a new optimizer state into the old one's tensors."""
    if isinstance(old, torch.Tensor):
        old.copy_(new)
    elif isinstance(old, tuple):
        for o, n in zip(old, new):
            if isinstance(o, torch.Tensor) and o.dim():
                o.copy_(n)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device: a divisor that the CUDA divide
    takes as a tensor (a Python scalar turns it into a reciprocal multiply,
    which rounds differently)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


class Optimizer:
    """Base optimizer. Subclasses implement ``tree_state``, ``create_state``
    and ``_apply_one``."""

    def __init__(self, rescale_grad=1.0, lr=0.01, wd=0.0, clip_gradient=None,
                 lr_scheduler=None, arg_names=None, learning_rate=None):
        self.rescale_grad = rescale_grad
        # 'learning_rate' is the reference's kwarg name; 'lr' the short form
        self.lr = lr if learning_rate is None else learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.lr_scheduler = lr_scheduler
        self.num_update = 0
        self._index_update_count = {}
        self.arg_names = arg_names

    @staticmethod
    def create_optimizer(name, **kwargs):
        return OPTIMIZERS.create(name, **kwargs)

    # -- imperative path (updater contract) ------------------------------
    def create_state(self, index: int, weight: torch.Tensor):
        raise NotImplementedError

    def update(self, index: int, weight: torch.Tensor, grad: torch.Tensor,
               state):
        """One step of parameter ``index``, written into ``weight`` and the
        state tensors; returns the state."""
        # one "update" = one optimization step, not one per parameter
        self._index_update_count[index] = self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count.values())
        lr = self._get_lr()
        with torch.no_grad():
            new_w, new_s = self._apply_one(weight, grad, self._tree_of(state), lr)
            weight.copy_(new_w)
            return self._write_state(state, new_s)

    def _tree_of(self, state):
        """The ``_apply_one`` state from an imperative state."""
        return state

    def _write_state(self, state, new_state):
        if isinstance(state, torch.Tensor):
            state.copy_(new_state)
        return state

    def _get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def _apply_one(self, w, g, state, lr):
        raise NotImplementedError

    # -- pure path (the training step) -----------------------------------
    def init_state_tree(self, params: dict):
        return {k: self.tree_state(v) for k, v in params.items()}

    def tree_state(self, w):
        return None

    def init_comm_residual(self, params: dict, compression, num_devices):
        """The zero error-feedback state of a compressed gradient sync over
        ``num_devices``: ``(num_devices, Lp)`` f32 on the parameters'
        device, the JAX package's layout (a rank or replica holds its row,
        ``convert.residual_rows_from_numpy``), or None when the mode needs
        no feedback (mxnet_tpu/optimizer.py:71-82)."""
        from .comm import CompressionSpec, flat_size, padded_flat_size

        spec = CompressionSpec.resolve(compression)
        if spec is None or not spec.error_feedback:
            return None
        device = next(iter(params.values())).device if params else None
        return torch.zeros((int(num_devices), padded_flat_size(
            flat_size(params), spec, num_devices)), dtype=torch.float32,
            device=device)

    def apply(self, params: dict, grads: dict, states: dict, lr):
        """Per-leaf update over parameter dicts; returns new tensors."""
        new_p, new_s = {}, {}
        for k, w in params.items():
            new_p[k], new_s[k] = self._apply_one(w, grads[k], states[k], lr)
        return new_p, new_s

    # -- in-place path (the training step, eager or captured) ------------
    def step_vector(self, names, states, lr) -> np.ndarray:
        """The host part of one in-place step: the values the device part
        reads, ``[lr]`` here; subclasses append per-leaf values and advance
        their host counters in ``states``."""
        del names, states
        return np.array([lr], np.float32)

    def apply_inplace(self, params: dict, grads: dict, states: dict, scal,
                      table=None):
        """The device part of one step: the per-leaf update with lr read
        from ``scal[0]``, written into the parameters and state tensors.
        ``table`` is the fused kernel's leaf table where one is used (the
        optimizer's own by default)."""
        del table
        lr = scal[0]
        for k, w in params.items():
            new_w, new_s = self._apply_one(w, grads[k], states[k], lr)
            w.copy_(new_w)
            _write_tree(states[k], new_s)

    def _preprocess(self, w, g):
        g = g.float() * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g + self.wd * w.float()


@OPTIMIZERS.register("sgd")
class SGD(Optimizer):
    """SGD with momentum (reference: optimizer.py SGD)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight, dtype=torch.float32)

    def tree_state(self, w):
        return self.create_state(None, w)

    def _apply_one(self, w, g, state, lr):
        g = self._preprocess(w, g)
        if self.momentum == 0.0:
            return (w.float() - lr * g).to(w.dtype), state
        mom = self.momentum * state - lr * g
        return (w.float() + mom).to(w.dtype), mom


@OPTIMIZERS.register("test")
class Test(Optimizer):
    """Test-only optimizer (reference: optimizer.py:162 Test):
    w += rescale_grad * grad, and the state mirrors the weight."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight, dtype=torch.float32)

    def tree_state(self, w):
        return self.create_state(None, w)

    def _apply_one(self, w, g, state, lr):
        del lr
        new_w = (w.float() + g.float() * self.rescale_grad).to(w.dtype)
        return new_w, new_w.float()


@OPTIMIZERS.register("adam")
class Adam(Optimizer):
    """Adam. ``fused`` (None reads the env gate ``MXNET_TPU_FUSED_ADAM``)
    routes ``apply`` through the whole-tree pass of
    ``kernels/fused_adam.py``; the imperative path is unaffected."""

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8, lr=0.001,
                 fused=None, **kwargs):
        super().__init__(lr=lr, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.fused = fused
        self._leaf_table = LeafTable()  # the kernel's pointer tables

    def _fused_active(self) -> bool:
        return fused_resolve(self.fused)

    def _leaf_decay(self, name) -> float:
        """The decoupled decay of parameter ``name`` (AdamW); 0 for Adam."""
        return 0.0

    def apply(self, params, grads, states, lr):
        if self._fused_active():
            return self._fused_apply(params, grads, states, lr)
        return super().apply(params, grads, states, lr)

    def _fused_args(self, names, states):
        """What one whole-tree step takes besides the tensors: each leaf's
        new step counter, the per-leaf scalars (c1, c2, wd) computed on the
        host, and the hyperparameters (mxnet_tpu/ops/pallas/adam.py:141-165)."""
        t_new = {k: states[k][2] + 1.0 for k in names}
        decoupled = getattr(self, "weight_decay", None) is not None
        scalars = ([_bias_correction(self.beta1, t_new[k]) for k in names],
                   [_bias_correction(self.beta2, t_new[k]) for k in names],
                   [self._leaf_decay(k) for k in names])
        hyper = dict(beta1=self.beta1, beta2=self.beta2, eps=self.epsilon,
                     rescale_grad=self.rescale_grad,
                     clip_gradient=self.clip_gradient,
                     wd_l2=0.0 if decoupled else self.wd, decoupled=decoupled)
        return t_new, scalars, hyper

    def _fused_apply(self, params, grads, states, lr):
        """The whole-tree step (mxnet_tpu/ops/pallas/adam.py:111-194): one
        ``fused_adam`` call that updates params and moments in place."""
        names = list(params)
        t_new, scalars, hyper = self._fused_args(names, states)
        fused_adam([params[k] for k in names], [grads[k] for k in names],
                   [states[k][0] for k in names], [states[k][1] for k in names],
                   *scalars, lr=lr, table=self._leaf_table, **hyper)
        return dict(params), {k: (states[k][0], states[k][1], t_new[k])
                              for k in names}

    def step_vector(self, names, states, lr):
        """lr, then c1, c2 and wd per leaf (the fused kernel's layout);
        each leaf's ``t`` advances here, on the host."""
        t_new, (c1, c2, wd), _ = self._fused_args(names, states)
        for k in names:
            states[k] = (states[k][0], states[k][1], t_new[k])
        return kfa.step_vector(lr, c1, c2, wd)

    def apply_inplace(self, params, grads, states, scal, table=None):
        """The whole-tree step over ``scal``: the kernel when fused, else
        its plain version (one torch operation per arithmetic operation).
        ``table``: the kernel's :class:`LeafTable` (the optimizer's own by
        default; a captured step that keeps its own gradient buffers passes
        one of its own, so no other step moves its pointers)."""
        names = list(params)
        _, _, hyper = self._fused_args([], states)
        tensors = ([params[k] for k in names], [grads[k] for k in names],
                   [states[k][0] for k in names],
                   [states[k][1] for k in names], scal)
        if self._fused_active():
            fused_adam_step(*tensors, table=table if table is not None
                            else self._leaf_table, **hyper)
        else:
            fused_adam_step_plain(*tensors, **hyper)

    def create_state(self, index, weight):
        # per-parameter step counter (a shared one would corrupt the bias
        # correction of every parameter after the first)
        return (torch.zeros_like(weight, dtype=torch.float32),
                torch.zeros_like(weight, dtype=torch.float32), [0])

    def tree_state(self, w):
        return (torch.zeros_like(w, dtype=torch.float32),
                torch.zeros_like(w, dtype=torch.float32),
                torch.zeros((), dtype=torch.float32))

    def _tree_of(self, state):
        m, v, count = state
        count[0] += 1
        # the pure path adds one to t itself
        return m, v, torch.tensor(float(count[0] - 1), dtype=torch.float32)

    def _write_state(self, state, new_state):
        state[0].copy_(new_state[0])
        state[1].copy_(new_state[1])
        return state

    def _step_update(self, w32, mhat, vhat, lr):
        """The weight-update rule given bias-corrected moments (AdamW adds
        its decoupled decay)."""
        return w32 - (_lr(lr) * mhat) / (sqrt_rn(vhat) + self.epsilon)

    def _apply_one(self, w, g, state, lr):
        g = self._preprocess(w, g)
        m, v, t = state
        t = t + 1.0
        m = self.beta1 * m + (1 - self.beta1) * g
        v = self.beta2 * v + (1 - self.beta2) * (g * g)
        mhat = m / _scalar(_bias_correction(self.beta1, t), m)
        vhat = v / _scalar(_bias_correction(self.beta2, t), v)
        new_w = self._step_update(w.float(), mhat, vhat, lr).to(w.dtype)
        return new_w, (m, v, t)


@OPTIMIZERS.register("adamw")
class AdamW(Adam):
    """Adam with decoupled weight decay: the decay applies to the weight,
    scaled by lr, not through the gradient. ``decay_filter(name) -> bool``
    exempts the parameters it returns False for (None decays all)."""

    def __init__(self, weight_decay=0.01, decay_filter=None, **kwargs):
        if kwargs.get("wd"):
            raise MXNetError(
                "AdamW: use weight_decay (decoupled), not wd — passing wd "
                "would ALSO apply L2 through the gradient, double-"
                "regularizing")
        super().__init__(**kwargs)
        self.weight_decay = weight_decay
        self.decay_filter = decay_filter

    def _leaf_decay(self, name):
        if self.decay_filter is None or self.decay_filter(name):
            return self.weight_decay
        return 0.0

    def update(self, index, weight, grad, state):
        if self.decay_filter is None:
            return super().update(index, weight, grad, state)
        if not self.arg_names or not 0 <= index < len(self.arg_names):
            raise MXNetError(
                "AdamW.decay_filter needs parameter NAMES on the "
                "imperative path: set optimizer.arg_names (FeedForward "
                "does this) or drop the filter")
        wd = self.weight_decay
        try:
            self.weight_decay = self._leaf_decay(self.arg_names[index])
            return super().update(index, weight, grad, state)
        finally:
            self.weight_decay = wd

    def apply(self, params, grads, states, lr):
        if self._fused_active() or self.decay_filter is None:
            return super().apply(params, grads, states, lr)
        wd, new_p, new_s = self.weight_decay, {}, {}
        try:
            for k, w in params.items():
                self.weight_decay = wd if self.decay_filter(k) else 0.0
                new_p[k], new_s[k] = self._apply_one(w, grads[k], states[k], lr)
        finally:
            self.weight_decay = wd
        return new_p, new_s

    def _step_update(self, w32, mhat, vhat, lr):
        # (lr * wd) in f32, then times w, as the JAX package rounds it
        lr_wd = lr * _f32(self.weight_decay) if isinstance(lr, torch.Tensor) \
            else _f32(np.float32(_f32(lr)) * np.float32(_f32(self.weight_decay)))
        return super()._step_update(w32, mhat, vhat, lr) - lr_wd * w32


@OPTIMIZERS.register("rmsprop")
class RMSProp(Optimizer):
    def __init__(self, gamma=0.9, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.gamma, self.epsilon = gamma, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight, dtype=torch.float32)

    def tree_state(self, w):
        return self.create_state(None, w)

    def _apply_one(self, w, g, state, lr):
        g = self._preprocess(w, g)
        acc = self.gamma * state + (1 - self.gamma) * (g * g)
        new_w = w.float() - (_lr(lr) * g) / (torch.sqrt(acc) + self.epsilon)
        return new_w.to(w.dtype), acc


@OPTIMIZERS.register("adagrad")
class AdaGrad(Optimizer):
    def __init__(self, epsilon=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight, dtype=torch.float32)

    def tree_state(self, w):
        return self.create_state(None, w)

    def _apply_one(self, w, g, state, lr):
        g = self._preprocess(w, g)
        acc = state + g * g
        new_w = w.float() - (_lr(lr) * g) / (torch.sqrt(acc) + self.epsilon)
        return new_w.to(w.dtype), acc


def create(name, **kwargs) -> Optimizer:
    """Create an optimizer by registered name (reference: opt.create)."""
    return OPTIMIZERS.create(name, **kwargs)


def get_updater(optimizer: Optimizer):
    """Closure with per-index state, the updater contract (reference:
    optimizer.py get_updater)."""
    states = {}

    def updater(index, grad, weight):
        if index not in states:
            states[index] = optimizer.create_state(index, weight)
        new_state = optimizer.update(index, weight, grad, states[index])
        if new_state is not None:
            states[index] = new_state

    return updater
