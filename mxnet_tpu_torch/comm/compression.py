"""Gradient-compression codecs: CompressionSpec and quantize/dequantize.

Counterpart of ``mxnet_tpu/comm/compression.py``, on torch tensors. Modes
(``CompressionSpec.mode``):

  none    fp32 passthrough (4 bytes/elem on the wire)
  bf16    round to bfloat16 (2 bytes/elem)
  int8    per-chunk-scaled linear quantization (1 byte/elem + one f32
          scale per ``chunk`` elems)
  twobit  threshold ternarization, the reference's 2-bit scheme, four
          codes packed per byte (0.25 bytes/elem)

int8 and twobit need error feedback: the residual ``x - decode(encode(x))``
is added into the next step's gradient before quantizing
(``comm.error_feedback_allreduce``).

The arithmetic is the JAX package's compiled form, which is what its train
step and its Pallas kernels compute: the int8 scale is ``max|x|`` times the
f32 reciprocal of 127 (XLA rewrites ``/ 127.0`` under jit), the quotient
``x / scale`` is a true divide, rounding is half to even, and the int8 cast
of a NaN quotient is 0 (XLA's float-to-int conversion). These codecs are the
"codec path" of the exchange, taken when ``comm_kernels`` is off; the fused
kernels of ``kernels/comm_kernels.py`` emit the same payload bits.
"""

from __future__ import annotations

import os

import torch

from ..base import MXNetError

__all__ = ["CompressionSpec", "encode", "decode", "payload_nbytes",
           "payload_bytes_of", "quantization_unit"]

_OFF_VALUES = ("", "0", "off", "false", "no", "none")
_ON_VALUES = ("1", "on", "true", "yes")

# MXNet spelling ('2bit') and common synonyms
_MODE_ALIASES = {"2bit": "twobit", "fp32": "none", "float32": "none",
                 "bfloat16": "bf16", "fp16": "bf16"}

_BITS = {"none": 32, "bf16": 16, "int8": 8, "twobit": 2}

# 1/127, which a float32 tensor's multiply rounds to the f32 reciprocal
INV_127 = 1.0 / 127.0


class CompressionSpec:
    """What crosses the wire during gradient sync.

    ``mode``: none | bf16 | int8 | twobit (see module docstring).
    ``threshold``: the twobit ternarization threshold t.
    ``chunk``: int8 scaling-block size (elements per f32 scale); must be a
    multiple of 4 so one padded layout serves both int8 and twobit.
    """

    MODES = ("none", "bf16", "int8", "twobit")

    def __init__(self, mode="none", threshold=0.5, chunk=256):
        mode = _MODE_ALIASES.get(str(mode).lower(), str(mode).lower())
        if mode not in self.MODES:
            raise MXNetError(
                f"compression mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode
        self.threshold = float(threshold)
        self.chunk = int(chunk)
        if self.chunk <= 0 or self.chunk % 4:
            raise MXNetError("compression chunk must be a positive "
                             "multiple of 4")
        if mode == "twobit" and self.threshold <= 0:
            raise MXNetError("twobit compression needs threshold > 0")

    def __repr__(self):
        return (f"CompressionSpec(mode={self.mode!r}, "
                f"threshold={self.threshold}, chunk={self.chunk})")

    def key(self):
        """Hashable identity."""
        return ("compression", self.mode, self.threshold, self.chunk)

    @property
    def error_feedback(self) -> bool:
        """Lossy enough that the residual must re-enter the next step."""
        return self.mode in ("int8", "twobit")

    def bits(self) -> int:
        return _BITS[self.mode]

    @classmethod
    def resolve(cls, value):
        """Normalize a user-facing ``compression`` argument.

        None -> env gate ``MXNET_TPU_GRAD_COMPRESSION`` (unset/falsy = off,
        truthy = int8, else the mode name); True -> int8; str -> that mode;
        a dict uses the reference kvstore spelling
        ``{'type': '2bit', 'threshold': 0.5}``; a spec passes through.
        Returns None (off) or a CompressionSpec with mode != 'none'.
        """
        if value is None:
            raw = os.environ.get("MXNET_TPU_GRAD_COMPRESSION", "")
            raw = raw.strip().lower()
            if raw in _OFF_VALUES:
                return None
            value = "int8" if raw in _ON_VALUES else raw
        if value is False:
            return None
        if value is True:
            value = "int8"
        if isinstance(value, dict):
            kw = dict(value)
            mode = kw.pop("type", kw.pop("mode", "none"))
            spec = cls(mode, **kw)
        elif isinstance(value, cls):
            spec = value
        else:
            spec = cls(str(value))
        return None if spec.mode == "none" else spec


def quantization_unit(spec: CompressionSpec) -> int:
    """Flat-vector length granularity a mode needs (callers pad to it):
    int8 scales per ``chunk`` elems; twobit packs 4 elems per byte."""
    if spec.mode == "int8":
        return spec.chunk
    if spec.mode == "twobit":
        return 4
    return 1


def int8_quotients(x: torch.Tensor, chunk: int):
    """``(q, scale)``: per chunk of the last axis, ``scale = max(max|x| *
    fl(1/127), 1e-30)`` and the clipped, rounded quotients ``x / scale`` in
    float32 before the int8 cast, shaped ``(..., L/chunk, chunk)``. A
    quotient keeps the sign of a zero, which the cast drops."""
    m = x.shape[-1]
    xr = x.reshape(x.shape[:-1] + (m // chunk, chunk))
    # amax and clamp_min propagate NaN, as jnp.max and jnp.maximum do
    scale = torch.clamp_min(xr.abs().amax(dim=-1) * INV_127, 1e-30)
    return torch.clamp(torch.round(xr / scale[..., None]), -127, 127), scale


def int8_codes(q: torch.Tensor) -> torch.Tensor:
    """The int8 cast of clipped, rounded quotients: NaN becomes 0, as in
    XLA's float-to-int conversion (torch leaves it to the C++ cast)."""
    return torch.where(torch.isnan(q), torch.zeros_like(q), q).to(torch.int8)


def twobit_values(codes: torch.Tensor, threshold: float) -> torch.Tensor:
    """Codes to float32: 1 -> +t, 2 -> -t, 0 and 3 -> 0, as the sum
    ``where(c == 1, t, 0) + where(c == 2, -t, 0)`` of the reference."""
    t = torch.tensor(threshold, dtype=torch.float32, device=codes.device)
    zero = torch.zeros((), dtype=torch.float32, device=codes.device)
    return torch.where(codes == 1, t, zero) + torch.where(codes == 2, -t, zero)


def twobit_codes(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-element codes, inclusive at the boundary: ``x >= t`` -> 1,
    ``x <= -t`` -> 2, else 0 (NaN -> 0). Comparisons are against the f32
    threshold, as the reference's float32 arrays compare."""
    t = torch.tensor(threshold, dtype=torch.float32, device=x.device)
    return ((x >= t).to(torch.uint8) + 2 * (x <= -t).to(torch.uint8))


def encode(spec: CompressionSpec, x: torch.Tensor) -> dict:
    """Quantize ``x`` (float, last-axis length a multiple of
    ``quantization_unit``) into a dict of wire tensors."""
    x = x.to(torch.float32)
    if spec.mode == "none":
        return {"q": x}
    if spec.mode == "bf16":
        return {"q": x.to(torch.bfloat16)}
    m = x.shape[-1]
    if spec.mode == "int8":
        if m % spec.chunk:
            raise MXNetError(f"int8 encode: last axis {m} not a multiple "
                             f"of chunk {spec.chunk}")
        q, scale = int8_quotients(x, spec.chunk)
        return {"q": int8_codes(q).reshape(x.shape), "scale": scale}
    if m % 4:
        raise MXNetError(f"twobit encode: last axis {m} not a multiple of 4")
    c4 = twobit_codes(x, spec.threshold).reshape(x.shape[:-1] + (m // 4, 4))
    packed = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
              | (c4[..., 3] << 6))
    return {"q": packed}


def decode(spec: CompressionSpec, payload: dict) -> torch.Tensor:
    """Inverse of :func:`encode`, back to float32 (same shape encode saw)."""
    q = payload["q"]
    if spec.mode in ("none", "bf16"):
        return q.to(torch.float32)
    if spec.mode == "int8":
        scale = payload["scale"]
        m = q.shape[-1]
        qr = q.to(torch.float32).reshape(
            q.shape[:-1] + (m // spec.chunk, spec.chunk))
        return (qr * scale[..., None]).reshape(q.shape)
    codes = torch.stack([(q >> s) & 3 for s in (0, 2, 4, 6)], dim=-1)
    vals = twobit_values(codes, spec.threshold)
    return vals.reshape(q.shape[:-1] + (q.shape[-1] * 4,))


def payload_nbytes(spec: CompressionSpec, num_elements: int) -> int:
    """Wire bytes of an encoded ``num_elements``-long f32 vector."""
    n = int(num_elements)
    if spec.mode == "none":
        return 4 * n
    if spec.mode == "bf16":
        return 2 * n
    if spec.mode == "int8":
        return n + 4 * (n // spec.chunk)
    return n // 4


def payload_bytes_of(payload: dict) -> int:
    """Actual byte count of an encoded payload dict of tensors or numpy
    arrays (the host codec's). Bookkeeping entries (underscore-prefixed)
    don't cross the wire and are excluded."""
    return sum(int(v.nbytes) if not isinstance(v, torch.Tensor)
               else v.numel() * v.element_size()
               for k, v in payload.items() if not k.startswith("_"))
