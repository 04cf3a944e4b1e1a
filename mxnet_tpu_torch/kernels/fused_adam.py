"""Whole-tree Adam/AdamW step in one multi-tensor launch (training path).

Counterpart of ``mxnet_tpu/ops/pallas/adam.py``: :func:`fused_adam` updates
every parameter leaf and its two moments in place, with per-leaf bias
corrections ``c1 = 1 - beta1**t``, ``c2 = 1 - beta2**t`` and decay ``wd``
that the caller computes on the host, once per leaf per step. On CUDA tensors
it launches the hand-written kernel in ``csrc/fused_adam.cu`` once per call;
on CPU tensors it runs :func:`fused_adam_plain`, the plain PyTorch version
that defines what the kernel computes: the arithmetic of ``_adam_kernel``
(``adam.py:72-93``), in its order, one rounding per operation.

Unlike the JAX package, whose kernel returns new arrays, both update
``params``, ``ms`` and ``vs`` in place: the optimizer state of a full-width
model is three times its parameters, and a copy of each per step would be
as large as the step itself.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..base import ENV_OFF_VALUES, ENV_ON_VALUES, MXNetError
from ._common import load_library, use_kernel
from .registry import KernelCost, register_kernel

__all__ = ["fused_adam", "fused_adam_plain", "fused_resolve", "sqrt_rn",
           "LeafTable", "CHUNK"]

# elements of one leaf per work item; csrc/fused_adam.cu's kChunk
CHUNK = 256 * 4 * 16
# one leaf's per-step entry; csrc/fused_adam.cu's StepLeaf (24 bytes)
STEP_DTYPE = np.dtype([("g", "<i8"), ("c1", "<f4"), ("c2", "<f4"),
                       ("wd", "<f4"), ("g_aligned", "<i4")])


def fused_resolve(value) -> bool:
    """Normalize the ``fused=`` optimizer knob as the JAX package does: None
    reads the env gate ``MXNET_TPU_FUSED_ADAM`` (values it does not know
    raise), anything else is taken by truth value."""
    if value is None:
        raw = os.environ.get("MXNET_TPU_FUSED_ADAM", "").strip().lower()
        if raw in ("",) + ENV_OFF_VALUES:
            return False
        if raw in ENV_ON_VALUES:
            return True
        raise MXNetError(
            f"MXNET_TPU_FUSED_ADAM={raw!r} not understood (use 1/0)")
    return bool(value)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root on every device. torch's CPU
    ``sqrt`` (Sleef, within 0.5001 ulp) misses it in about 0.7% of values;
    the double square root rounded to f32 does not, and it is what the
    kernel's ``__fsqrt_rn`` and CUDA's ``sqrt`` compute."""
    return torch.sqrt(x.double()).float()


def fused_adam_plain(params, grads, ms, vs, c1, c2, wd, *, lr, beta1, beta2,
                     eps, rescale_grad, clip_gradient, wd_l2, decoupled):
    """The plain version of the kernel, on any device: the same step, leaf
    by leaf, one torch operation per arithmetic operation, in place."""
    lr_f = float(np.float32(lr))
    for w, g, m, v, c1_l, c2_l, wd_l in zip(params, grads, ms, vs, c1, c2, wd):
        # divisors as 0-d device tensors: a Python scalar would send the CUDA
        # divide to a multiply by its reciprocal, which rounds differently
        c1_t = torch.full((), c1_l, dtype=torch.float32, device=w.device)
        c2_t = torch.full((), c2_l, dtype=torch.float32, device=w.device)
        g = g * rescale_grad
        if clip_gradient is not None:
            g = torch.clamp(g, -clip_gradient, clip_gradient)
        g = g + wd_l2 * w
        m_new = beta1 * m + (1 - beta1) * g
        v_new = beta2 * v + (1 - beta2) * (g * g)
        w_new = w - (lr_f * (m_new / c1_t)) / (sqrt_rn(v_new / c2_t) + eps)
        if decoupled:
            w_new = w_new - float(np.float32(lr_f) * np.float32(wd_l)) * w
        w.copy_(w_new)
        m.copy_(m_new)
        v.copy_(v_new)


def _check(params, grads, ms, vs, c1, c2, wd):
    n = len(params)
    if not (len(grads) == len(ms) == len(vs) == len(c1) == len(c2)
            == len(wd) == n):
        raise ValueError("fused_adam: params, grads, moments and per-leaf "
                         "scalars must have one entry per leaf")
    for i, group in enumerate(zip(params, grads, ms, vs)):
        for name, t in zip(("param", "grad", "m", "v"), group):
            if t.dtype != torch.float32:
                raise ValueError(f"fused_adam: leaf {i} {name} is {t.dtype}, "
                                 "not float32")
            if t.shape != group[0].shape:
                raise ValueError(f"fused_adam: leaf {i} {name} has shape "
                                 f"{tuple(t.shape)}, param "
                                 f"{tuple(group[0].shape)}")
            if not t.is_contiguous():
                raise ValueError(f"fused_adam: leaf {i} {name} is not "
                                 "contiguous")


class LeafTable:
    """The device tables of one parameter set: per leaf the pointers of w, m
    and v, its size and whether they are 16-byte aligned, and the (leaf,
    chunk) work items. Rebuilt only when a parameter or moment moves or
    changes size (``builds`` counts the uploads); the optimizer keeps one
    across steps. What changes every step (the gradients' pointers and the
    per-leaf scalars) goes up in :func:`_step_table`."""

    def __init__(self):
        self._key = None
        self.leaves = self.items = None
        self.n_items = 0
        self.builds = 0

    def update(self, params, ms, vs, device):
        ptrs = [(w.data_ptr(), m.data_ptr(), v.data_ptr(), w.numel())
                for w, m, v in zip(params, ms, vs)]
        key = (device, tuple(ptrs))
        if key == self._key:
            return
        rows, items = [], []
        for i, (pw, pm, pv, n) in enumerate(ptrs):
            aligned = all(p % 16 == 0 for p in (pw, pm, pv))
            rows.append((pw, pm, pv, n, int(aligned)))
            items.extend((i, c) for c in range(-(-max(n, 1) // CHUNK)))
        host_leaves = torch.tensor(rows, dtype=torch.int64).reshape(-1, 5)
        host_items = torch.tensor(items, dtype=torch.int32).reshape(-1, 2)
        self.leaves = host_leaves.pin_memory().to(device, non_blocking=True)
        self.items = host_items.pin_memory().to(device, non_blocking=True)
        self.n_items = len(items)
        self._key = key
        self.builds += 1


def _step_table(grads, c1, c2, wd, device):
    """This step's per-leaf entries (gradient pointer and alignment, c1, c2,
    wd) on ``device``, through pinned memory."""
    host = np.empty(len(grads), STEP_DTYPE)
    host["g"] = [g.data_ptr() for g in grads]
    host["g_aligned"] = [g.data_ptr() % 16 == 0 for g in grads]
    host["c1"], host["c2"], host["wd"] = c1, c2, wd
    return torch.from_numpy(host.view(np.uint8)).pin_memory().to(
        device, non_blocking=True)


def _library():
    lib = load_library("fused_adam")
    fn = lib.mxtt_fused_adam
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 8 + [ctypes.c_int, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mxtt_fused_adam_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_fused_adam_error_string.restype = ctypes.c_char_p
    return lib


def _launch(params, grads, ms, vs, c1, c2, wd, table, *, lr, beta1, beta2,
            eps, rescale_grad, clip_gradient, wd_l2, decoupled):
    device = params[0].device
    lib = _library()
    table = table if table is not None else LeafTable()
    table.update(params, ms, vs, device)
    steps = _step_table(grads, c1, c2, wd, device)
    # a few resident blocks per SM; the grid strides over the work items
    grid = min(table.n_items,
               8 * torch.cuda.get_device_properties(device).multi_processor_count)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.mxtt_fused_adam(
            table.leaves.data_ptr(), steps.data_ptr(), table.items.data_ptr(),
            table.n_items, grid, lr, beta1, 1 - beta1, beta2, 1 - beta2, eps,
            rescale_grad, 0.0 if clip_gradient is None else clip_gradient,
            int(clip_gradient is not None), wd_l2, int(decoupled), stream)
    if err != 0:
        raise RuntimeError("fused_adam: kernel launch failed: "
                           + lib.mxtt_fused_adam_error_string(err).decode())
    fused_adam.launches += 1


def fused_adam(params, grads, ms, vs, c1, c2, wd, *, lr, beta1, beta2, eps,
               rescale_grad, clip_gradient, wd_l2, decoupled, table=None):
    """One Adam (``decoupled=False``, L2 decay ``wd_l2`` through the
    gradient) or AdamW (``decoupled=True``, per-leaf ``wd``) step over lists
    of float32 contiguous tensors, updating ``params``, ``ms`` and ``vs`` in
    place. ``c1``, ``c2`` and ``wd`` are per-leaf Python floats holding f32
    values. ``table`` is an optional :class:`LeafTable` kept across steps.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    and add one to ``fused_adam.launches``."""
    if not params:
        return
    _check(params, grads, ms, vs, c1, c2, wd)
    hyper = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                 rescale_grad=rescale_grad, clip_gradient=clip_gradient,
                 wd_l2=wd_l2, decoupled=decoupled)
    with torch.no_grad():  # parameters are autograd leaves
        if use_kernel(*params, *grads, *ms, *vs):
            _launch(params, grads, ms, vs, c1, c2, wd, table, **hyper)
        else:
            fused_adam_plain(params, grads, ms, vs, c1, c2, wd, **hyper)


fused_adam.launches = 0


def _adam_cost(ins, outs):
    # ins: params, grads, ms, vs (lists); outs: params, ms, vs after the step.
    # About 14 f32 operations per element (adam.py:197-201); each operand
    # read once and each result written once: 28 bytes per element.
    n = float(sum(w.numel() for w in ins[0]))
    flat_in = [t for group in ins for t in group]
    flat_out = [t for group in outs for t in group]
    return KernelCost(ops={"f32": 14.0 * n},
                      bytes=KernelCost.io_bytes(flat_in, flat_out))


register_kernel(
    "fused_adam", _adam_cost,
    source="mxnet_tpu_torch/csrc/fused_adam.cu",
    replaces="mxnet_tpu/ops/pallas/adam.py:171")
