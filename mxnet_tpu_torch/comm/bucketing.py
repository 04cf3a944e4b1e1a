"""Gradient bucketing and the host codec of the kvstore transports.

Counterpart of ``mxnet_tpu/comm/bucketing.py``. ``GradBucketer`` fuses a
keyed gradient set into a few size-capped flat f32 slabs (buckets), so a
transport pays per bucket instead of per key; ``HostCodec`` quantizes
those slabs on the host, in numpy, with a per-slab error-feedback residual
for the lossy modes, so a bucket crosses a socket as its payload.

The host codec is the JAX package's numpy codec (``compression.py`` with
``xp=np``) copied here: the int8 scale is ``max|x| / 127.0`` as a true
divide (numpy does not rewrite it into a multiply, as XLA does on the
device path), rounding is half to even, twobit compares against the
threshold in f32. bf16 payloads travel as the upper 16 bits of each f32
(``uint16``), rounded to nearest even, as ``ml_dtypes.bfloat16`` rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .compression import CompressionSpec, payload_bytes_of, quantization_unit

__all__ = ["GradBucketer", "HostCodec", "DEFAULT_BUCKET_BYTES",
           "decode_payload"]

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MB of f32, the DDP default


def _size(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def _new_bucket(name):
    return {"name": name, "keys": [], "shapes": [], "offsets": [],
            "size": 0}


def _append_key(bucket, key, shape):
    bucket["keys"].append(key)
    bucket["shapes"].append(tuple(int(d) for d in shape))
    bucket["offsets"].append(bucket["size"])
    bucket["size"] += _size(shape)


class GradBucketer:
    """Partition a keyed gradient set into size-capped fused flat slabs.

    ``shapes``: ordered ``{key: shape}`` (or ``[(key, shape), ...]``).
    A bucket closes when adding the next key would exceed ``max_bytes`` of
    f32 payload (a single oversized key gets its own bucket). The layout
    is a pure function of (shapes, max_bytes), so both ends of a transport
    rebuild it from :meth:`layout`."""

    def __init__(self, shapes, max_bytes=DEFAULT_BUCKET_BYTES):
        items = list(shapes.items()) if isinstance(shapes, dict) \
            else [(k, tuple(s)) for k, s in shapes]
        if not items:
            raise MXNetError("GradBucketer needs at least one key")
        self.max_bytes = int(max_bytes)
        self.buckets = []  # [{"name", "keys", "shapes", "offsets", "size"}]
        cur = None
        for key, shape in items:
            size = _size(shape)
            if cur is None or (cur["size"] and
                               4 * (cur["size"] + size) > self.max_bytes):
                cur = _new_bucket(f"bucket{len(self.buckets)}")
                self.buckets.append(cur)
            _append_key(cur, key, shape)
        self._index()

    def _index(self):
        self._by_key = {k: (b, i) for b in self.buckets
                        for i, k in enumerate(b["keys"])}

    @property
    def num_buckets(self):
        return len(self.buckets)

    @property
    def num_keys(self):
        return len(self._by_key)

    def layout(self):
        """Serializable layout: ``[(name, [(key, shape), ...]), ...]``."""
        return [(b["name"], list(zip(b["keys"], b["shapes"])))
                for b in self.buckets]

    @classmethod
    def from_layout(cls, layout):
        """Rebuild exactly the layout a peer serialized: bucket names and
        key-to-slab assignment as given; ``max_bytes`` is the largest
        rebuilt slab's f32 bytes."""
        if not layout:
            raise MXNetError("GradBucketer.from_layout needs a non-empty "
                             "layout")
        out = cls.__new__(cls)
        out.buckets = []
        for name, pairs in layout:
            b = _new_bucket(name)
            for k, s in pairs:
                _append_key(b, k, s)
            out.buckets.append(b)
        out.max_bytes = max(4 * b["size"] for b in out.buckets)
        out._index()
        return out

    def pack(self, kvs: dict) -> dict:
        """``{key: array}`` -> ``{bucket_name: flat f32 slab}``; every key
        of the layout must be present."""
        out = {}
        for b in self.buckets:
            flat = np.empty((b["size"],), np.float32)
            for key, shape, off in zip(b["keys"], b["shapes"], b["offsets"]):
                if key not in kvs:
                    raise MXNetError(f"pack: missing key {key!r}")
                flat[off:off + _size(shape)] = np.asarray(
                    kvs[key], np.float32).ravel()
            out[b["name"]] = flat
        return out

    def unpack(self, flats: dict) -> dict:
        """Inverse of :meth:`pack` (views of each slab)."""
        out = {}
        for b in self.buckets:
            flat = np.asarray(flats[b["name"]], np.float32)
            for key, shape, off in zip(b["keys"], b["shapes"], b["offsets"]):
                out[key] = flat[off:off + _size(shape)].reshape(shape)
        return out


# -- the numpy codec ------------------------------------------------------------

def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> the bf16 bit pattern (uint16), rounded to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def encode_np(spec: CompressionSpec, x) -> dict:
    """Quantize a numpy f32 array (last axis a multiple of the mode's
    unit) into a dict of numpy wire arrays, as the JAX package's
    ``encode(spec, x, xp=np)``."""
    x = np.asarray(x).astype(np.float32)
    if spec.mode == "none":
        return {"q": x}
    if spec.mode == "bf16":
        return {"q": _bf16_bits(x)}
    m = x.shape[-1]
    if spec.mode == "int8":
        if m % spec.chunk:
            raise MXNetError(f"int8 encode: last axis {m} not a multiple "
                             f"of chunk {spec.chunk}")
        xr = x.reshape(x.shape[:-1] + (m // spec.chunk, spec.chunk))
        scale = np.maximum(np.max(np.abs(xr), axis=-1) / 127.0, 1e-30)
        scale = scale.astype(np.float32)
        with np.errstate(invalid="ignore"):
            q = np.clip(np.round(xr / scale[..., None]), -127, 127)
            q = q.astype(np.int8)
        return {"q": q.reshape(x.shape), "scale": scale}
    if m % 4:
        raise MXNetError(f"twobit encode: last axis {m} not a multiple of 4")
    t = spec.threshold
    c = (np.where(x >= t, 1, 0) + np.where(x <= -t, 2, 0)).astype(np.uint8)
    c4 = c.reshape(x.shape[:-1] + (m // 4, 4))
    packed = (c4[..., 0] | (c4[..., 1] << 2) | (c4[..., 2] << 4)
              | (c4[..., 3] << 6))
    return {"q": packed.astype(np.uint8)}


def decode_np(spec: CompressionSpec, payload: dict) -> np.ndarray:
    """Inverse of :func:`encode_np`, back to f32."""
    q = np.asarray(payload["q"])
    if spec.mode == "none":
        return q.astype(np.float32)
    if spec.mode == "bf16":
        return (q.astype(np.uint32) << 16).view(np.float32)
    if spec.mode == "int8":
        scale = np.asarray(payload["scale"])
        m = q.shape[-1]
        qr = q.astype(np.float32).reshape(
            q.shape[:-1] + (m // spec.chunk, spec.chunk))
        return (qr * scale[..., None]).astype(np.float32).reshape(q.shape)
    t = spec.threshold
    codes = np.stack([(q >> s) & 3 for s in (0, 2, 4, 6)], axis=-1)
    vals = np.where(codes == 1, t, 0.0) + np.where(codes == 2, -t, 0.0)
    return vals.astype(np.float32).reshape(q.shape[:-1] + (q.shape[-1] * 4,))


def decode_payload(compression, payload: dict) -> np.ndarray:
    """Decode one host payload (from :meth:`HostCodec.encode`) without
    codec state, the receiving end of a transport. Records the payload's
    bytes as received in ``comm_stats()``, as the encoder records them as
    sent, so both ends of every transport are counted."""
    spec = CompressionSpec.resolve(compression)
    if spec is None:
        raise MXNetError("decode_payload needs an active compression mode")
    n = int(payload["_n"])
    flat = decode_np(spec, {k: v for k, v in payload.items() if k != "_n"})
    from .stats import registry

    registry().record_host_bytes(received=payload_bytes_of(payload))
    return np.asarray(flat, np.float32).ravel()[:n]


class HostCodec:
    """The numpy codec with per-slab error feedback for the lossy modes
    (the kvstore half of the reference's 2-bit gradient compression)."""

    def __init__(self, compression, error_feedback=True):
        spec = CompressionSpec.resolve(compression)
        if spec is None:
            raise MXNetError("HostCodec needs an active compression mode")
        self.spec = spec
        self._ef = bool(error_feedback) and spec.error_feedback
        self._residual: dict = {}   # slab name -> np residual
        self.bytes_encoded = 0      # payload bytes produced
        self.bytes_raw = 0          # f32 bytes the payloads replaced
        self.bytes_decoded = 0      # payload bytes consumed

    def _pad(self, flat):
        pad = (-flat.shape[0]) % quantization_unit(self.spec)
        if pad:
            flat = np.concatenate([flat, np.zeros((pad,), np.float32)])
        return flat

    def encode(self, name: str, flat) -> dict:
        """Encode one named slab, its residual fed back first."""
        flat = np.asarray(flat, np.float32).ravel()
        n = flat.shape[0]
        if self._ef:
            resid = self._residual.get(name)
            if resid is not None:
                flat = flat + resid
        padded = self._pad(flat)
        payload = encode_np(self.spec, padded)
        if self._ef:
            self._residual[name] = (
                padded - decode_np(self.spec, payload))[:n]
        payload["_n"] = np.int64(n)
        nbytes = payload_bytes_of(payload)
        self.bytes_encoded += nbytes
        self.bytes_raw += 4 * n
        from .stats import registry

        registry().record_host_bytes(sent=nbytes)
        return payload

    def reset_residuals(self):
        """Drop the error-feedback ledger: required whenever the slab
        layout changes (a residual compensates only its own slab)."""
        self._residual.clear()

    def decode(self, payload: dict) -> np.ndarray:
        self.bytes_decoded += payload_bytes_of(payload)
        return decode_payload(self.spec, payload)

    @property
    def ratio(self) -> float:
        """Raw bytes over encoded bytes of everything encoded so far."""
        return self.bytes_raw / self.bytes_encoded if self.bytes_encoded \
            else 1.0
