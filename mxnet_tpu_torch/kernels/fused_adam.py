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
as large as the step itself. The kernel reads lr, c1, c2 and wd from a
device vector (:func:`step_vector`'s layout), so a launch captured into a
CUDA graph reads each replay's values (:func:`fused_adam_step`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..base import ENV_OFF_VALUES, ENV_ON_VALUES, MXNetError
from ._common import count_launch, load_library, use_kernel
from .registry import KernelCost, register_kernel

__all__ = ["fused_adam", "fused_adam_step", "fused_adam_step_plain",
           "fused_adam_plain", "fused_resolve", "sqrt_rn", "step_vector",
           "LeafTable", "CHUNK", "HEADER", "PER_LEAF"]

# elements of one leaf per work item; csrc/fused_adam.cu's kChunk
CHUNK = 256 * 4 * 16
# the per-step vector: lr, then (c1, c2, wd) per leaf; csrc/fused_adam.cu's
# kHeader and kPerLeaf
HEADER, PER_LEAF = 1, 3


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


def step_vector(lr, c1, c2, wd) -> np.ndarray:
    """The per-step values as the kernel reads them: ``[lr, c1_0, c2_0,
    wd_0, c1_1, ...]`` in f32."""
    out = np.empty(HEADER + PER_LEAF * len(c1), np.float32)
    out[0] = lr
    out[HEADER::PER_LEAF], out[HEADER + 1::PER_LEAF] = c1, c2
    out[HEADER + 2::PER_LEAF] = wd
    return out


def fused_adam_step_plain(params, grads, ms, vs, scal, *, beta1, beta2, eps,
                          rescale_grad, clip_gradient, wd_l2, decoupled):
    """The plain version of :func:`fused_adam_step` on any device, over the
    per-step vector ``scal`` (a f32 tensor on the tensors' device): one
    torch operation per arithmetic operation, in place. The divisors and lr
    are 0-d tensors: a Python scalar would send the CUDA divide to a
    multiply by its reciprocal, which rounds differently."""
    lr = scal[0]
    for i, (w, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        c1, c2, wd = (scal[HEADER + PER_LEAF * i + j] for j in range(3))
        g = g * rescale_grad
        if clip_gradient is not None:
            g = torch.clamp(g, -clip_gradient, clip_gradient)
        g = g + wd_l2 * w
        m_new = beta1 * m + (1 - beta1) * g
        v_new = beta2 * v + (1 - beta2) * (g * g)
        w_new = w - (lr * (m_new / c1)) / (sqrt_rn(v_new / c2) + eps)
        if decoupled:
            w_new = w_new - (lr * wd) * w
        w.copy_(w_new)
        m.copy_(m_new)
        v.copy_(v_new)


def fused_adam_plain(params, grads, ms, vs, c1, c2, wd, *, lr, beta1, beta2,
                     eps, rescale_grad, clip_gradient, wd_l2, decoupled):
    """The plain version of the kernel, on any device: the same step, leaf
    by leaf, one torch operation per arithmetic operation, in place."""
    if not params:
        return
    scal = torch.from_numpy(step_vector(lr, c1, c2, wd)).to(
        params[0].device)
    fused_adam_step_plain(params, grads, ms, vs, scal, beta1=beta1,
                          beta2=beta2, eps=eps, rescale_grad=rescale_grad,
                          clip_gradient=clip_gradient, wd_l2=wd_l2,
                          decoupled=decoupled)


def _check_scal(params, scal):
    n = len(params)
    if scal.dtype != torch.float32 or scal.dim() != 1 \
            or scal.numel() != HEADER + PER_LEAF * n \
            or scal.device != params[0].device:
        raise ValueError(f"fused_adam: the per-step vector must be "
                         f"{HEADER + PER_LEAF * n} f32 on "
                         f"{params[0].device}, got {tuple(scal.shape)} "
                         f"{scal.dtype} on {scal.device}")


def _check(params, grads, ms, vs):
    n = len(params)
    if not len(grads) == len(ms) == len(vs) == n:
        raise ValueError("fused_adam: params, grads and moments must have "
                         "one entry per leaf")
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


def _upload(rows, dtype, device):
    host = torch.tensor(rows, dtype=dtype)
    if torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "fused_adam: the leaf table would change inside a CUDA-graph "
            "capture (a parameter, moment or gradient moved since the "
            "warm-up step); keep them in persistent buffers")
    return host.pin_memory().to(device, non_blocking=True)


class LeafTable:
    """The device tables of one set of tensors: per leaf the pointers of w,
    m and v and its size, with the (leaf, chunk) work items, rebuilt only
    when one of those tensors moves or changes size (``builds``); and the
    gradients' pointers, uploaded again only when a gradient moves
    (``grad_uploads``). The optimizer keeps one across steps: a step whose
    gradients are views of one persistent buffer uploads them once, a step
    with fresh gradients uploads one pointer a leaf and leaves the rest as
    it is. An upload is a host copy, which a CUDA-graph capture cannot
    hold: under capture a table that would change raises."""

    def __init__(self):
        self._key = self._grad_key = None
        self.leaves = self.grads = self.items = None
        self.n_items = 0
        self.builds = self.grad_uploads = 0

    def update(self, params, grads, ms, vs, device):
        ptrs = [(w.data_ptr(), m.data_ptr(), v.data_ptr(), w.numel())
                for w, m, v in zip(params, ms, vs)]
        key = (device, tuple(ptrs))
        if key != self._key:
            items = [(i, c) for i, (*_, n) in enumerate(ptrs)
                     for c in range(-(-max(n, 1) // CHUNK))]
            self.leaves = _upload(ptrs, torch.int64, device).reshape(-1, 4)
            self.items = _upload(items, torch.int32, device).reshape(-1, 2)
            self.n_items = len(items)
            self._key = key
            self.builds += 1
        grad_key = (device, tuple(g.data_ptr() for g in grads))
        if grad_key != self._grad_key:
            self.grads = _upload(list(grad_key[1]), torch.int64, device)
            self._grad_key = grad_key
            self.grad_uploads += 1


def _library():
    lib = load_library("fused_adam")
    fn = lib.mxtt_fused_adam
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mxtt_fused_adam_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_fused_adam_error_string.restype = ctypes.c_char_p
    return lib


def _launch(params, grads, ms, vs, scal, table, *, beta1, beta2, eps,
            rescale_grad, clip_gradient, wd_l2, decoupled):
    device = params[0].device
    lib = _library()
    table.update(params, grads, ms, vs, device)
    # a few resident blocks per SM; the grid strides over the work items
    grid = min(table.n_items,
               8 * torch.cuda.get_device_properties(device).multi_processor_count)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.mxtt_fused_adam(
            table.leaves.data_ptr(), table.grads.data_ptr(), scal.data_ptr(),
            table.items.data_ptr(),
            table.n_items, grid, beta1, 1 - beta1, beta2, 1 - beta2, eps,
            rescale_grad, 0.0 if clip_gradient is None else clip_gradient,
            int(clip_gradient is not None), wd_l2, int(decoupled), stream)
    if err != 0:
        raise RuntimeError("fused_adam: kernel launch failed: "
                           + lib.mxtt_fused_adam_error_string(err).decode())
    count_launch(fused_adam)


def fused_adam_step(params, grads, ms, vs, scal, *, beta1, beta2, eps,
                    rescale_grad, clip_gradient, wd_l2, decoupled,
                    table=None):
    """One Adam/AdamW step over lists of float32 contiguous tensors, in
    place, reading lr, c1, c2 and wd from ``scal`` (:func:`step_vector`'s
    layout, on the tensors' device). Nothing of a step's values passes by
    value, so a CUDA-graph capture of this call replays with whatever the
    caller copied into ``scal`` before each replay. ``table`` is the
    :class:`LeafTable` kept across steps.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    and count one launch of ``fused_adam``."""
    if not params:
        return
    _check(params, grads, ms, vs)
    _check_scal(params, scal)
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 rescale_grad=rescale_grad, clip_gradient=clip_gradient,
                 wd_l2=wd_l2, decoupled=decoupled)
    with torch.no_grad():  # parameters are autograd leaves
        if use_kernel(*params, *grads, *ms, *vs, scal):
            _launch(params, grads, ms, vs, scal,
                    table if table is not None else LeafTable(), **hyper)
        else:
            fused_adam_step_plain(params, grads, ms, vs, scal, **hyper)


def fused_adam(params, grads, ms, vs, c1, c2, wd, *, lr, beta1, beta2, eps,
               rescale_grad, clip_gradient, wd_l2, decoupled, table=None):
    """One Adam (``decoupled=False``, L2 decay ``wd_l2`` through the
    gradient) or AdamW (``decoupled=True``, per-leaf ``wd``) step over lists
    of float32 contiguous tensors, updating ``params``, ``ms`` and ``vs`` in
    place. ``c1``, ``c2`` and ``wd`` are per-leaf Python floats holding f32
    values. The per-step vector goes up from the host here, so this form
    is for eager calls; a captured step calls :func:`fused_adam_step`.

    CPU tensors take the plain version; CUDA tensors launch the kernel once
    and add one to ``fused_adam.launches``."""
    if not params:
        return
    _check(params, grads, ms, vs)
    if not len(c1) == len(c2) == len(wd) == len(params):
        raise ValueError("fused_adam: params, grads, moments and per-leaf "
                         "scalars must have one entry per leaf")
    hyper = dict(beta1=beta1, beta2=beta2, eps=eps,
                 rescale_grad=rescale_grad, clip_gradient=clip_gradient,
                 wd_l2=wd_l2, decoupled=decoupled)
    if not use_kernel(*params, *grads, *ms, *vs):
        with torch.no_grad():
            fused_adam_plain(params, grads, ms, vs, c1, c2, wd, lr=lr,
                             **hyper)
        return
    if torch.cuda.is_current_stream_capturing():
        raise MXNetError("fused_adam: under capture, pass the per-step "
                         "values in a device vector (fused_adam_step)")
    host = torch.from_numpy(step_vector(lr, c1, c2, wd)).pin_memory()
    fused_adam_step(params, grads, ms, vs,
                    host.to(params[0].device, non_blocking=True),
                    table=table, **hyper)


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
