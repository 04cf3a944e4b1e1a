"""Fused gradient-compression kernels: quantize + scales in one pass, and
the dequantize passes of the exchange.

Counterpart of ``mxnet_tpu/ops/pallas/comm_kernels.py``, with its entry
points and signatures:

  fused_quantize      (R, L) f32 rows -> payload dict {q[, scale]}
                      (+ the decode round trip when ``want_dequant``)
  fused_dequant_sum   payload rows -> (L,) f32 column sums (the
                      reduce-scatter accumulate, decode fused in)
  fused_dequant       payload rows -> (R, L) f32 (the all-gather side)

Each runs one of six kernels (``csrc/comm_kernels.cu``): ``quant_int8``,
``quant_twobit``, ``dequant_sum_int8``, ``dequant_sum_twobit``,
``dequant_int8`` and ``dequant_twobit``. Each kernel has a wrapper of that
name here, which routes by device: CUDA tensors launch the kernel (and add
one to the wrapper's ``launches``), CPU tensors take the plain version of
the same name with ``_plain``. The payload is bit-identical to the codecs of
``comm/compression.py`` on every device, as in the JAX package; the sums
follow the JAX kernels' order: rows 0..R-1, int8 products fused into the
accumulation (``fma``), as XLA compiles the Pallas kernel on the CPU.
``quant_int8`` and ``quant_twobit`` launch one of two forms of their
kernels, picked by :func:`quant_int8_form` and :func:`quant_twobit_form`;
``dequant_sum_int8`` and ``dequant_int8`` one of three load widths each,
and ``dequant_sum_twobit`` one of two (:func:`dequant_sum_twobit_load_bytes`).
Every form gives the same bits and counts as a launch of its wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from ..comm.allreduce import _row_sum
from ..comm.compression import (CompressionSpec, decode, encode, int8_codes,
                                int8_quotients)
from ._common import count_launch, load_library, use_kernel
from .registry import KernelCost, register_kernel

__all__ = ["fused_quantize", "fused_dequant_sum", "fused_dequant",
           "pick_block", "quant_int8", "quant_twobit", "dequant_sum_int8",
           "dequant_sum_twobit", "dequant_int8", "dequant_twobit",
           "quant_int8_plain", "quant_twobit_plain", "dequant_sum_int8_plain",
           "dequant_sum_twobit_plain", "dequant_int8_plain",
           "dequant_twobit_plain", "dequant_sum_int8_load_bytes",
           "dequant_int8_load_bytes", "quant_int8_form", "quant_twobit_form",
           "dequant_sum_twobit_load_bytes", "fma_f32", "KERNELS"]

DEFAULT_BLOCK_ELEMS = 65536
# the chunks quant_int8's first form is built for (csrc/comm_kernels.cu)
QUANT_INT8_CHUNKS = tuple(range(128, 1025, 128))
# csrc/comm_kernels.cu's kThreads
THREADS = 256
# The new forms of the twobit kernels are taken only where they measured
# faster than the other form beyond the spread of their turns
# (kernel_ab.py's sweep, PERF.md §6); each threshold lies between the
# largest size where the two forms tied and the smallest where the new one
# won. quant_twobit's vector form: from this many elements (R x L) on
# (tied at 1,048,576, won at 2,048,000; the scalar form won at 137,920)
QUANT_TWOBIT_VECTOR_MIN = 3 << 19
# dequant_sum_twobit's four-byte form: from rows of this many code bytes on
# (tied at 131,072, won at 256,000; the one-byte form won at 98,752)
DQSUM_TWOBIT_FOUR_MIN = 3 << 16
SOURCE = "mxnet_tpu_torch/csrc/comm_kernels.cu"
_REPLACED = "mxnet_tpu/ops/pallas/comm_kernels.py"


def pick_block(length: int, unit: int, cap=None) -> int:
    """Largest block size that divides ``length``, is a multiple of
    ``unit`` and stays under ``cap`` elements: the JAX kernels' VMEM block.
    The CUDA kernels do not tile by it; it is computed for the same checks
    (a row length that is not a multiple of ``unit`` raises) and changes no
    result."""
    length, unit = int(length), int(unit)
    cap = DEFAULT_BLOCK_ELEMS if cap is None else int(cap)
    if length % unit:
        raise MXNetError(f"row length {length} not a multiple of the "
                         f"quantization unit {unit}")
    k = length // unit
    for m in range(min(k, max(cap // unit, 1)), 0, -1):
        if k % m == 0:
            return m * unit
    return unit


# --------------------------------------------------------------------------
# plain versions: what each kernel computes, on any device
# --------------------------------------------------------------------------

def fma_f32(product: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``fma(a, b, acc)`` in float32 for an exact float64 ``product = a*b``
    (an int8 times a float32 is exact in float64): the float64 sum, rounded
    to odd with its exact error (TwoSum), then rounded once to float32,
    which is the correctly rounded float32 of ``a*b + acc``."""
    acc64 = acc.double()
    s = product + acc64
    bb = s - product
    err = (product - (s - bb)) + (acc64 - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & torch.isfinite(s) & ((bits & 1) == 0),
                      bits + step, bits)
    return odd.view(torch.float64).float()


def _twobit_spec(threshold):
    return CompressionSpec("twobit", threshold=threshold)


def quant_int8_plain(rows: torch.Tensor, chunk: int, want_dq: bool,
                     err: str | None = None):
    """``(q int8 (R, L), scale (R, L/chunk), dq or None, err or None)``:
    the codec's payload, ``dq = q * scale`` from the quotients before the
    int8 cast (a -0.0 stays -0.0, as in the JAX kernel), and ``rows - dq``
    rounded once (``err="fma"``) or after the rounded product
    (``err="sub"``)."""
    R, L = rows.shape
    q, scale = int8_quotients(rows, chunk)
    dq = (q * scale[..., None]).reshape(R, L)
    e = None
    if err == "fma":
        product = q.double() * scale.double()[..., None]
        e = fma_f32(-product.reshape(R, L), rows)
    elif err == "sub":
        e = rows - dq
    return int8_codes(q).reshape(R, L), scale, dq if want_dq else None, e


def quant_twobit_plain(rows: torch.Tensor, threshold: float, want_dq: bool,
                       want_err: bool = False):
    """``(q uint8 (R, L/4), dq (R, L) or None, err (R, L) or None)``:
    the codec's payload, its decode, and ``rows - dq`` (one rounding: dq
    is t, -t or 0, with no product to round)."""
    payload = encode(_twobit_spec(threshold), rows)
    dq = decode(_twobit_spec(threshold), payload) \
        if want_dq or want_err else None
    err = rows - dq if want_err else None
    return payload["q"], dq if want_dq else None, err


def dequant_sum_int8_plain(q: torch.Tensor, scale: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """``acc = fma(q[r], scale[r], acc)`` over rows 0..R-1, from 0."""
    acc = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
    for r in range(q.shape[0]):
        product = q[r].double() * scale[r].double().repeat_interleave(chunk)
        acc = fma_f32(product, acc)
    return acc


def dequant_sum_twobit_plain(q: torch.Tensor,
                             threshold: float) -> torch.Tensor:
    """``acc = acc + value(code[r])`` over rows 0..R-1, from 0."""
    return _row_sum(decode(_twobit_spec(threshold), {"q": q}))


def dequant_int8_plain(q: torch.Tensor, scale: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    return decode(CompressionSpec("int8", chunk=chunk),
                  {"q": q, "scale": scale})


def dequant_twobit_plain(q: torch.Tensor, threshold: float) -> torch.Tensor:
    return decode(_twobit_spec(threshold), {"q": q})


# --------------------------------------------------------------------------
# the CUDA kernels
# --------------------------------------------------------------------------

_I64 = ctypes.c_longlong
_P = ctypes.c_void_p
_ARGTYPES = {
    "mxtt_quant_int8": [_P, _P, _P, _P, _P, ctypes.c_int, _I64, ctypes.c_int,
                        ctypes.c_int, _P],
    "mxtt_quant_int8_chunked": [_P, _P, _P, _P, _P, ctypes.c_int, _I64,
                                ctypes.c_int, _P],  # sizes its own grid
    "mxtt_quant_twobit": [_P, _P, _P, _P, _I64, ctypes.c_float,
                          ctypes.c_int, _P],  # the form, not a grid
    "mxtt_dequant_sum_int8": [_P, _P, _P, ctypes.c_int, _I64, ctypes.c_int,
                              ctypes.c_int, _P],  # load_bytes, not a grid
    "mxtt_dequant_sum_twobit": [_P, _P, ctypes.c_int, _I64, ctypes.c_float,
                                ctypes.c_int, _P],  # load_bytes, not a grid
    "mxtt_dequant_int8": [_P, _P, _P, _I64, ctypes.c_int, ctypes.c_int,
                          _P],  # load_bytes, not a grid
    "mxtt_dequant_twobit": [_P, _P, _I64, ctypes.c_float, ctypes.c_int, _P],
}


def _library():
    lib = load_library("comm_kernels")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mxtt_comm_error_string.argtypes = [ctypes.c_int]
    lib.mxtt_comm_error_string.restype = ctypes.c_char_p
    return lib


def _grid(threads_needed: int, device) -> int:
    """Blocks for ``threads_needed`` threads, at most 16 per SM (the
    kernels stride over the rest)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-threads_needed // THREADS), 16 * sms))


def _run(kernel: str, device, *args):
    """Launch ``mxtt_<kernel>`` on the current stream; raise if refused."""
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, f"mxtt_{kernel}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed: "
                           + lib.mxtt_comm_error_string(err).decode())


def _check(name, t, dtype, ndim=2):
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_chunk(L, chunk):
    if chunk <= 0 or chunk % 4 or L % chunk:
        raise ValueError(f"row length {L} is not a multiple of chunk {chunk}"
                         " (a positive multiple of 4)")


def quant_int8(rows: torch.Tensor, chunk: int, want_dq: bool = False,
               err: str | None = None):
    """Kernel ``quant_int8``: ``(q, scale, dq or None, err or None)`` of
    (R, L) f32 rows; ``err`` ("fma" or "sub") asks for ``rows - dq`` in
    that rounding (see ``quant_int8_plain``)."""
    _check("quant_int8: rows", rows, torch.float32)
    R, L = rows.shape
    _check_chunk(L, chunk)
    if err not in (None, "fma", "sub"):
        raise ValueError(f"quant_int8: err must be None, 'fma' or 'sub', "
                         f"got {err!r}")
    if not use_kernel(rows):
        return quant_int8_plain(rows, chunk, want_dq, err)
    q = torch.empty((R, L), dtype=torch.int8, device=rows.device)
    scale = torch.empty((R, L // chunk), dtype=torch.float32,
                        device=rows.device)
    dq = torch.empty_like(rows) if want_dq else None
    e = torch.empty_like(rows) if err else None
    n_chunks = R * (L // chunk)
    if n_chunks:
        args = (rows.data_ptr(), q.data_ptr(), scale.data_ptr(),
                dq.data_ptr() if want_dq else None,
                e.data_ptr() if err else None, int(err == "fma"), n_chunks,
                chunk)
        if quant_int8_form(rows, chunk) == "chunked":
            _run("quant_int8_chunked", rows.device, *args)
        else:
            _run("quant_int8", rows.device, *args,
                 _grid(32 * n_chunks, rows.device))
        count_launch(quant_int8)
    return q, scale, dq, e


def quant_int8_form(rows: torch.Tensor, chunk: int) -> str:
    """The form of the ``quant_int8`` kernel that takes ``rows``:
    ``"chunked"`` (the chunk a template parameter, 16-byte loads) where the
    chunk is one of ``QUANT_INT8_CHUNKS`` and the rows start 16-byte
    aligned, else ``"general"`` (any chunk that is a multiple of 4, scalar
    loads). Rows that are a view into a flat buffer may start anywhere."""
    if chunk in QUANT_INT8_CHUNKS and rows.data_ptr() % 16 == 0:
        return "chunked"
    return "general"


def quant_twobit(rows: torch.Tensor, threshold: float, want_dq: bool = False,
                 want_err: bool = False):
    """Kernel ``quant_twobit``: ``(q uint8 (R, L/4), dq or None, err or
    None)`` of (R, L) f32 rows, in the form :func:`quant_twobit_form`
    picks; ``err`` is ``rows - dq`` (see ``quant_twobit_plain``)."""
    _check("quant_twobit: rows", rows, torch.float32)
    R, L = rows.shape
    if L % 4:
        raise ValueError(f"quant_twobit: row length {L} not a multiple of 4")
    if not use_kernel(rows):
        return quant_twobit_plain(rows, threshold, want_dq, want_err)
    form = quant_twobit_form(rows)
    q = torch.empty((R, L // 4), dtype=torch.uint8, device=rows.device)
    dq = torch.empty_like(rows) if want_dq else None
    err = torch.empty_like(rows) if want_err else None
    n_bytes = R * (L // 4)
    if n_bytes:
        _run("quant_twobit", rows.device, rows.data_ptr(), q.data_ptr(),
             dq.data_ptr() if want_dq else None,
             err.data_ptr() if want_err else None, n_bytes, threshold,
             int(form == "vector"))
        count_launch(quant_twobit)
    return q, dq, err


def quant_twobit_form(rows: torch.Tensor) -> str:
    """The form of the ``quant_twobit`` kernel that takes ``rows``:
    ``"vector"`` (16-byte loads, the rows taken flat) where they start
    16-byte aligned and hold at least ``QUANT_TWOBIT_VECTOR_MIN``
    elements, else ``"scalar"`` (one code byte a thread from four scalar
    loads). A bucket view into the flat gradient buffer starts at a
    multiple of 8 elements, which is aligned."""
    if rows.data_ptr() % 16 == 0 and rows.numel() >= QUANT_TWOBIT_VECTOR_MIN:
        return "vector"
    return "scalar"


def dequant_sum_int8(q: torch.Tensor, scale: torch.Tensor,
                     chunk: int) -> torch.Tensor:
    """Kernel ``dequant_sum_int8``: (L,) f32 column sums of the decoded
    rows, fused multiply-add over rows in order."""
    _check("dequant_sum_int8: q", q, torch.int8)
    _check("dequant_sum_int8: scale", scale, torch.float32)
    R, L = q.shape
    _check_chunk(L, chunk)
    if tuple(scale.shape) != (R, L // chunk):
        raise ValueError(f"dequant_sum_int8: scale is {tuple(scale.shape)}, "
                         f"expected {(R, L // chunk)}")
    if not use_kernel(q, scale):
        return dequant_sum_int8_plain(q, scale, chunk)
    out = torch.empty(L, dtype=torch.float32, device=q.device)
    if L:
        _run("dequant_sum_int8", q.device, q.data_ptr(), scale.data_ptr(),
             out.data_ptr(), R, L, chunk, dequant_sum_int8_load_bytes(q))
        count_launch(dequant_sum_int8)
    return out


def dequant_sum_int8_load_bytes(q: torch.Tensor) -> int:
    """The bytes of codes one thread of the ``dequant_sum_int8`` kernel
    loads a row: 16 where every row starts 16-byte aligned (row length a
    multiple of 16 and q aligned), else 4, as one char4 where q is 4-byte
    aligned and as four bytes where it is not."""
    if q.shape[1] % 16 == 0 and q.data_ptr() % 16 == 0:
        return 16
    return 4 if q.data_ptr() % 4 == 0 else 1


def dequant_sum_twobit(q: torch.Tensor, threshold: float) -> torch.Tensor:
    """Kernel ``dequant_sum_twobit``: (4B,) f32 column sums of the decoded
    (R, B) packed rows, in row order, in the form
    :func:`dequant_sum_twobit_load_bytes` picks."""
    _check("dequant_sum_twobit: q", q, torch.uint8)
    R, B = q.shape
    if not use_kernel(q):
        return dequant_sum_twobit_plain(q, threshold)
    out = torch.empty(4 * B, dtype=torch.float32, device=q.device)
    if B:
        _run("dequant_sum_twobit", q.device, q.data_ptr(), out.data_ptr(), R,
             B, threshold, dequant_sum_twobit_load_bytes(q))
        count_launch(dequant_sum_twobit)
    return out


def dequant_sum_twobit_load_bytes(q: torch.Tensor) -> int:
    """The code bytes of a row that one thread of the
    ``dequant_sum_twobit`` kernel sums: 4 (its aligned word, joined with
    its neighbour's where the row is misaligned; blocks of 128) for rows
    of at least ``DQSUM_TWOBIT_FOUR_MIN`` bytes, else 1 (one byte load;
    blocks of 256). Both read rows at any byte alignment, so the pointer
    does not change the choice."""
    return 4 if q.shape[1] >= DQSUM_TWOBIT_FOUR_MIN else 1


def dequant_int8(q: torch.Tensor, scale: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Kernel ``dequant_int8``: (R, L) f32 ``q * scale``."""
    _check("dequant_int8: q", q, torch.int8)
    _check("dequant_int8: scale", scale, torch.float32)
    R, L = q.shape
    _check_chunk(L, chunk)
    if tuple(scale.shape) != (R, L // chunk):
        raise ValueError(f"dequant_int8: scale is {tuple(scale.shape)}, "
                         f"expected {(R, L // chunk)}")
    if not use_kernel(q, scale):
        return dequant_int8_plain(q, scale, chunk)
    out = torch.empty((R, L), dtype=torch.float32, device=q.device)
    if R * L:
        _run("dequant_int8", q.device, q.data_ptr(), scale.data_ptr(),
             out.data_ptr(), R * L, chunk, dequant_int8_load_bytes(q))
        count_launch(dequant_int8)
    return out


def dequant_int8_load_bytes(q: torch.Tensor) -> int:
    """The bytes of codes one thread of the ``dequant_int8`` kernel loads:
    16 where the codes, taken flat, split into 16-byte aligned groups of 16
    (their count a multiple of 16 and q aligned), else 4, as one char4
    where q is 4-byte aligned and as four bytes where it is not."""
    if q.numel() % 16 == 0 and q.data_ptr() % 16 == 0:
        return 16
    return 4 if q.data_ptr() % 4 == 0 else 1


def dequant_twobit(q: torch.Tensor, threshold: float) -> torch.Tensor:
    """Kernel ``dequant_twobit``: (R, 4B) f32 values of (R, B) packed
    rows."""
    _check("dequant_twobit: q", q, torch.uint8)
    R, B = q.shape
    if not use_kernel(q):
        return dequant_twobit_plain(q, threshold)
    out = torch.empty((R, 4 * B), dtype=torch.float32, device=q.device)
    if R * B:
        _run("dequant_twobit", q.device, q.data_ptr(), out.data_ptr(), R * B,
             threshold, _grid(R * B, q.device))
        count_launch(dequant_twobit)
    return out


KERNELS = (quant_int8, quant_twobit, dequant_sum_int8, dequant_sum_twobit,
           dequant_int8, dequant_twobit)
for _k in KERNELS:
    _k.launches = 0


# --------------------------------------------------------------------------
# the JAX package's entry points
# --------------------------------------------------------------------------

def fused_quantize(spec, rows, *, want_dequant=False, want_error=False,
                   block_elems=None, error_rounding=None):
    """Quantize ``rows`` ((R, L) f32, or (L,), L a multiple of the mode's
    unit) into the wire payload dict and, with ``want_dequant``, the decode
    round trip the error-feedback residual is built from. Returns
    ``(payload, dq)`` with ``dq=None`` unless requested; payload shapes
    match ``compression.encode``.

    ``want_error`` adds a third item, ``rows - dq``. For int8 it is
    rounded as the JAX kernel path's ``shard - dq2`` compiles on the CPU:
    when the Pallas kernel's grid is one step (one row in one block), XLA
    contracts its product into the subtraction (one rounding); over more
    steps the product is rounded first. ``error_rounding`` ("fma" or
    "sub") sets that rounding instead, as for the stage-1 error ``rows -
    dq1``, which is always the rounded product subtracted. For twobit dq is
    t, -t or 0, so the error has one rounding and ``error_rounding`` other
    than None raises."""
    rows = rows.to(torch.float32).contiguous()
    squeeze = rows.dim() == 1
    if squeeze:
        rows = rows[None]
    R, L = rows.shape
    err = None
    if spec.mode == "int8":
        block = pick_block(L, spec.chunk, block_elems)
        mode = None
        if want_error:
            mode = error_rounding or ("fma" if R == 1 and block == L
                                      else "sub")
        q, scale, dq, err = quant_int8(rows, spec.chunk, want_dequant, mode)
        payload = {"q": q, "scale": scale}
    elif spec.mode == "twobit":
        if error_rounding is not None:
            raise MXNetError("fused_quantize: twobit's error has one "
                             "rounding; error_rounding must be None, got "
                             f"{error_rounding!r}")
        pick_block(L, 4, block_elems)
        q, dq, err = quant_twobit(rows, spec.threshold, want_dequant,
                                  want_error)
        payload = {"q": q}
    else:
        raise MXNetError(f"fused_quantize: no kernel for mode {spec.mode!r} "
                         "(none/bf16 are plain converts)")
    if squeeze:
        payload = {k: v[0] for k, v in payload.items()}
        dq = dq[0] if want_dequant else None
        err = err[0] if want_error else None
    if want_error:
        return payload, dq, err
    return payload, dq


def fused_dequant_sum(spec, payload, *, block_elems=None):
    """Decode payload rows and accumulate their f32 sum in one pass (the
    reduce-scatter's ``sum(decode(recv), axis=0)`` with the JAX kernel's
    order). Returns ``(L,) float32``."""
    q = payload["q"].contiguous()
    if spec.mode == "int8":
        pick_block(q.shape[1], spec.chunk, block_elems)
        return dequant_sum_int8(q, payload["scale"].contiguous(), spec.chunk)
    if spec.mode == "twobit":
        pick_block(q.shape[1] * 4, 4, block_elems)
        return dequant_sum_twobit(q, spec.threshold)
    raise MXNetError(f"fused_dequant_sum: no kernel for mode {spec.mode!r}")


def fused_dequant(spec, payload, *, block_elems=None):
    """Decode payload rows back to float32 (the all-gather side); same
    values as ``compression.decode``."""
    q = payload["q"].contiguous()
    squeeze = q.dim() == 1
    if squeeze:
        payload = {k: v[None] for k, v in payload.items()}
        q = q[None]
    if spec.mode == "int8":
        pick_block(q.shape[1], spec.chunk, block_elems)
        out = dequant_int8(q, payload["scale"].contiguous(), spec.chunk)
    elif spec.mode == "twobit":
        pick_block(q.shape[1] * 4, 4, block_elems)
        out = dequant_twobit(q, spec.threshold)
    else:
        raise MXNetError(f"fused_dequant: no kernel for mode {spec.mode!r}")
    return out[0] if squeeze else out


# --------------------------------------------------------------------------
# registry cost models: elementwise f32 operations per slab element
# (comm_kernels.py:325-363), bytes as every operand read once and every
# result written once
# --------------------------------------------------------------------------

def _elemwise_cost(ops_per_elem):
    def cost(ins, outs):
        n = max((t.numel() for t in ins), default=0)
        return KernelCost(ops={"f32": float(ops_per_elem) * n},
                          bytes=KernelCost.io_bytes(ins, outs))
    return cost


def _dq_cost(ops_per_elem, unpack=1):
    # payload elements expand by `unpack` on decode (twobit: 4 per byte)
    def cost(ins, outs):
        n = max((t.numel() for t in outs), default=0)
        if not n and ins:
            n = ins[0].numel() * unpack
        return KernelCost(ops={"f32": float(ops_per_elem) * n},
                          bytes=KernelCost.io_bytes(ins, outs))
    return cost


for _name, _cost, _line in (
        ("quant_int8", _elemwise_cost(5), 135),
        ("quant_twobit", _elemwise_cost(5), 151),
        ("dequant_sum_int8", _dq_cost(3), 237),
        ("dequant_sum_twobit", _dq_cost(5, unpack=4), 255),
        ("dequant_int8", _dq_cost(2), 291),
        ("dequant_twobit", _dq_cost(4, unpack=4), 306)):
    register_kernel(_name, _cost, source=SOURCE,
                    replaces=f"{_REPLACED}:{_line}")
