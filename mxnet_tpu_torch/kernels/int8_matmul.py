"""Int8 matmul with per-row activation and per-channel weight scales (serving
path).

Counterpart of ``mxnet_tpu/ops/pallas/matmul.py``: ``int8_matmul(x, w)``
computes ``x @ w.T`` with x quantized per row to int8 (scale max|row| times
the f32 reciprocal of 127, round half to even) and w quantized per output
channel, and returns ``(acc * sx) * sw`` in f32. On a CUDA tensor it
launches the hand-written kernel in ``csrc/int8_matmul.cu``; on a CPU tensor
it runs
:func:`int8_matmul_plain`, the plain PyTorch version that defines what the
kernel computes. ``FullyConnectedOp`` routes inference matmuls here inside
:func:`int8_predict_scope`, which ``Predictor(quantize="int8")`` arms.

Unlike the JAX package, the scope is the only switch: there is no
environment variable that arms it.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import NamedTuple

import torch

from ._common import count_launch, load_library, use_kernel
from .registry import KernelCost, register_kernel

__all__ = ["int8_matmul", "int8_matmul_plain", "quantize_channels",
           "QuantizedWeight", "int8_predict_scope", "int8_predict_active"]

# int32 accumulation stays exact while 127 * 127 * K < 2**31
MAX_K = (2 ** 31 - 1) // (127 * 127)

# The kernel's split of K (csrc/int8_matmul.cu): 64x64 output tiles, K in
# slabs of 256 bytes, at most 8 blocks (one cluster) on one tile, and about
# 128 blocks wanted in flight on the H100's 132 SMs.
TILE, SLAB, MAX_SPLIT, BLOCKS_WANTED = 64, 256, 8, 128

# Scales are max|.| times the f32 reciprocal of 127, not max|.| / 127: the
# JAX package's compiled programs (its Pallas kernel, and quantize_channels
# under jit in its Predictor) compute that, because XLA rewrites a divide by
# a constant into a multiply by its reciprocal. The two differ by one ulp in
# a few percent of scales.
INV_127 = 1.0 / 127.0

_SCOPE = contextvars.ContextVar("mxnet_tpu_torch_int8_predict", default=False)


@contextlib.contextmanager
def int8_predict_scope(enabled=True):
    """Arm (or explicitly disarm) the int8 inference matmul path for code run
    inside the scope."""
    token = _SCOPE.set(bool(enabled))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def int8_predict_active() -> bool:
    """Is the int8 serving path armed?"""
    return _SCOPE.get()


class QuantizedWeight(NamedTuple):
    """A weight quantized per output channel: ``wq (N, K) int8`` and
    ``scale (N,) f32``."""

    wq: torch.Tensor
    scale: torch.Tensor


def quantize_channels(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel int8 quantization of an FC weight
    ``(num_hidden, input_dim)``: one f32 scale per output channel."""
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=1) * INV_127, 1e-30)
    wq = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return QuantizedWeight(wq.to(torch.int8), scale)


def int8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                      sw: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel, on any device."""
    sx = torch.clamp_min(x.abs().amax(dim=1, keepdim=True) * INV_127, 1e-30)
    qx = torch.clamp(torch.round(x / sx), -127, 127)
    # The contraction in f64 is exact (|acc| <= 127 * 127 * K < 2**53) and
    # runs on both devices: torch has no int32 matmul on CUDA, and int8 @
    # int8 on the CPU returns int8 and overflows. The kernel sums in int32,
    # exactly too, so both round the same integer to f32.
    acc = (qx.double() @ wq.double().t()).float()
    return acc * sx * sw  # (acc * sx) * sw, mxnet_tpu/ops/pallas/matmul.py:100


def _check(x, wq, sw):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"int8_matmul: x must be 2-D float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if wq.dim() != 2 or wq.dtype != torch.int8 or wq.shape[1] != x.shape[1]:
        raise ValueError(f"int8_matmul: w must be (N, {x.shape[1]}) int8, "
                         f"got {tuple(wq.shape)} {wq.dtype}")
    if sw.shape != (wq.shape[0],) or sw.dtype != torch.float32:
        raise ValueError(f"int8_matmul: w_scale must be ({wq.shape[0]},) "
                         f"float32, got {tuple(sw.shape)} {sw.dtype}")
    if min(x.shape[0], x.shape[1], wq.shape[0]) < 1:
        raise ValueError("int8_matmul: empty operand")
    if x.shape[1] > MAX_K:
        raise ValueError(f"int8_matmul: K={x.shape[1]} > {MAX_K} would "
                         "overflow the int32 accumulator")


def _k_split(M: int, N: int, K: int) -> tuple[int, int]:
    """``(blocks on one output tile, slabs a block sums)``: split K until
    about :data:`BLOCKS_WANTED` blocks run, where the output tiles are too
    few to fill the card (small M); no split where they are not."""
    tiles = -(-M // TILE) * -(-N // TILE)
    slabs = -(-K // SLAB)
    want = min(slabs, MAX_SPLIT, max(1, BLOCKS_WANTED // tiles))
    per = -(-slabs // want)
    return -(-slabs // per), per


def _library():
    lib = load_library("int8_matmul")
    fn = lib.mxtt_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mxtt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, wq, sw):
    for name, t in (("x", x), ("w", wq), ("w_scale", sw)):
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    lib = _library()
    M, K = x.shape
    N = wq.shape[0]
    qx = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.mxtt_int8_matmul(
            x.data_ptr(), wq.data_ptr(), sw.data_ptr(), qx.data_ptr(),
            sx.data_ptr(), y.data_ptr(), M, N, K, _k_split(M, N, K)[1],
            stream)
    if err != 0:
        raise RuntimeError("int8_matmul: kernel launch failed: "
                           + lib.mxtt_cuda_error_string(err).decode())
    count_launch(int8_matmul)
    return y


def int8_matmul(x: torch.Tensor, w: torch.Tensor, *,
                w_scale: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ w.T`` through the int8 kernel. ``x`` is ``(M, K)`` float32;
    ``w`` is ``(N, K)`` float (quantized here per channel) or pre-quantized
    int8 with ``w_scale`` ``(N,)``. Returns ``(M, N)`` float32.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``int8_matmul.launches``."""
    if w.dtype == torch.int8:
        if w_scale is None:
            raise ValueError("int8_matmul: pre-quantized w needs w_scale=")
        wq, sw = w, w_scale.float()
    else:
        wq, sw = quantize_channels(w)
    _check(x, wq, sw)
    if use_kernel(x, wq, sw):
        return _launch(x, wq, sw)
    return int8_matmul_plain(x, wq, sw)


int8_matmul.launches = 0


def _int8_mm_cost(ins, outs):
    x, wq = ins[0], ins[1]
    m, k = x.shape
    n = wq.shape[0]
    # the contraction on the int8 tensor cores, the activation quantize
    # (abs, max, divide, round) in f32
    return KernelCost(ops={"int8": 2.0 * m * n * k, "f32": 4.0 * m * k},
                      bytes=KernelCost.io_bytes(ins, outs))


register_kernel(
    "int8_matmul", _int8_mm_cost,
    source="mxnet_tpu_torch/csrc/int8_matmul.cu",
    replaces="mxnet_tpu/ops/pallas/matmul.py:123")
