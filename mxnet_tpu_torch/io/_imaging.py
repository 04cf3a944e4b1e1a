"""The image operations of ``ImageRecordIter``, in numpy on the host.

The JAX package decodes and transforms images with PIL
(``mxnet_tpu/recordio.py:200-217``, ``mxnet_tpu/io/__init__.py:727-855``).
The port carries its own copy of each call it makes, so that it needs no
PIL, and each copy gives PIL's pixels bit for bit:

- a PNG codec: the decoder takes 8-bit gray, RGB and RGBA with all five
  row filters; the encoder writes every row with the Up filter, which the
  decoder undoes with one cumulative sum over the rows;
- ``resize``: Pillow's separable resample for 8-bit images (BICUBIC and
  BILINEAR): coefficients in double precision normalised to 22-bit fixed
  point, the horizontal pass over only the rows the vertical pass reads,
  each pass clipped to 8 bits, and PIL's same-size shortcut;
- ``rotate`` (``Image.rotate(angle, BILINEAR, fillcolor=...)``) and
  ``affine`` (``Image.transform(size, AFFINE, data, BILINEAR,
  fillcolor=...)``): Pillow's generic transform with its bilinear filter.

JPEG goes through PIL where PIL can be imported, and otherwise through the
port's own codec in the native library (``native/mxtpu_native.cc``), which
decodes to libjpeg's pixels and encodes libjpeg's bytes, bit for bit.
"""

from __future__ import annotations

import io as _pyio
import math
import struct
import zlib

import numpy as np

from ..base import MXNetError

__all__ = ["png_encode", "png_decode", "decode", "encode", "resize",
           "rotate", "affine", "BICUBIC", "BILINEAR"]

BILINEAR, BICUBIC = "bilinear", "bicubic"

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SOI = b"\xff\xd8"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples a pixel


# -- PNG ----------------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_encode(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit HW (gray), HWC RGB or HWC RGBA image as PNG bytes, each row
    written with the Up filter (row 0's prior row is zeros)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise MXNetError(f"png_encode: {c} channels (expected 1, 3 or 4)")
    rows = img.reshape(h, w * c)
    up = np.empty((h, w * c + 1), np.uint8)
    up[:, 0] = 2
    up[0, 1:] = rows[0]
    up[1:, 1:] = rows[1:] - rows[:-1]  # uint8 arithmetic wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), level))
            + _chunk(b"IEND", b""))


def _paeth_row(line, prior, bpp):
    out = bytearray(len(line))
    for i, v in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (v + pred) & 0xFF
    return out


def _average_row(line, prior, bpp):
    out = bytearray(len(line))
    for i, v in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (v + ((a + prior[i]) >> 1)) & 0xFF
    return out


def png_decode(buf: bytes) -> np.ndarray:
    """PNG bytes as an HWC uint8 array (gray as one channel). Takes 8-bit
    gray, RGB and RGBA, not interlaced, with any of the five row filters;
    a run of Up rows is undone with one cumulative sum."""
    if buf[:8] != _PNG_SIGNATURE:
        raise MXNetError("png_decode: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise MXNetError("png_decode: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise MXNetError(
            f"png_decode: bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} not supported (8-bit gray, RGB or RGBA, not "
            "interlaced)")
    c = _CHANNELS[ctype]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise MXNetError("png_decode: image data of the wrong size")
    raw = raw.reshape(h, stride + 1)
    filters, lines = raw[:, 0], raw[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    y = 0
    while y < h:
        f = int(filters[y])
        if f == 2:  # a run of Up rows: a cumulative sum seeded by the prior
            end = y
            while end < h and filters[end] == 2:
                end += 1
            run = np.cumsum(lines[y:end], axis=0, dtype=np.uint64)
            out[y:end] = (run + prior).astype(np.uint8)
            y = end
        else:
            line = lines[y]
            if f == 0:
                out[y] = line
            elif f == 1:  # Sub: a cumulative sum along the row per channel
                out[y] = np.cumsum(line.reshape(w, c), axis=0,
                                   dtype=np.uint64).astype(np.uint8).ravel()
            elif f == 3:
                out[y] = np.frombuffer(
                    _average_row(line.tobytes(), prior.tobytes(), c), np.uint8)
            elif f == 4:
                out[y] = np.frombuffer(
                    _paeth_row(line.tobytes(), prior.tobytes(), c), np.uint8)
            else:
                raise MXNetError(f"png_decode: unknown row filter {f}")
            y += 1
        prior = out[y - 1]
    return out.reshape(h, w, c)


def _to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of gray (replicated) and RGBA (alpha
    dropped)."""
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode(buf: bytes) -> np.ndarray:
    """An encoded image as HWC uint8 RGB, as ``np.asarray(Image.open(buf)
    .convert("RGB"))``: PNG here, JPEG through PIL, or through the native
    codec where PIL cannot be imported."""
    if buf[:8] == _PNG_SIGNATURE:
        return _to_rgb(png_decode(buf))
    if buf[:2] == _JPEG_SOI:
        Image = _pil_image()
        if Image is None:
            from .. import native

            return native.decode_jpeg(buf)
        return np.asarray(Image.open(_pyio.BytesIO(buf)).convert("RGB"))
    raise MXNetError("image record is neither PNG nor JPEG")


def encode(img: np.ndarray, img_fmt: str = ".png", quality: int = 95) -> bytes:
    """An HWC uint8 image as PNG (the port's encoder) or JPEG: PIL's, or
    the native codec's (the same bytes) where PIL cannot be imported."""
    if img_fmt.lower() not in (".jpg", ".jpeg"):
        return png_encode(img)
    Image = _pil_image()
    if Image is None:
        from .. import native

        return native.encode_jpeg(img, quality)
    buf = _pyio.BytesIO()
    Image.fromarray(np.asarray(img, np.uint8)).save(buf, format="JPEG",
                                                    quality=quality)
    return buf.getvalue()


# -- resample (Pillow's Resample.c, 8 bits a sample) --------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, filt):
    """``precompute_coeffs`` and ``normalize_coeffs_8bpc``: per output
    position the first input index, the tap count and the int32
    fixed-point taps (zero past the count)."""
    fn, support = filt
    scale = filterscale = float(in_size) / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    k = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):  # sequential sums, in C's order
        w = fn(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        w = np.where(x < xmax, w, 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    one = float(1 << _PRECISION_BITS)
    kk = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one))
    return xmin, xmax, kk.astype(np.int32), ksize


def _clip8(acc):
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img, axis, xmin, kk, ksize, in_size):
    """One separable pass over ``axis`` (1: columns, 0: rows) of an HWC
    uint8 image, with 22-bit fixed-point taps and rounding, clipped."""
    n = len(xmin)
    shape = list(img.shape)
    shape[axis] = n
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int32)
    for x in range(ksize):
        idx = np.minimum(xmin + x, in_size - 1)  # taps past the count are 0
        src = np.take(img, idx, axis=axis).astype(np.int32)
        tap = kk[:, x].reshape((n, 1, 1) if axis == 0 else (1, n, 1))
        acc += src * tap
    return _clip8(acc)


def resize(img: np.ndarray, size, resample: str = BICUBIC) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, resample))`` for an
    HWC (or HW) uint8 image; ``size`` is ``(width, height)`` as in PIL."""
    img = np.asarray(img, np.uint8)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w = img.shape[:2]
    out_w, out_h = int(size[0]), int(size[1])
    if (out_w, out_h) == (w, h):  # PIL's same-size shortcut: a copy
        out = img.copy()
        return out[:, :, 0] if squeeze else out
    filt = _FILTERS[resample]
    xmin_h, _xn, kk_h, ks_h = _coeffs(w, out_w, filt)
    ymin_v, ymax_v, kk_v, ks_v = _coeffs(h, out_h, filt)
    out = img
    if out_w != w:
        # the horizontal pass runs over the rows the vertical pass reads
        first = int(ymin_v[0])
        last = int(ymin_v[-1] + ymax_v[-1])
        out = _pass(img[first:last], 1, xmin_h, kk_h, ks_h, w)
        ymin_v = ymin_v - first
    if out_h != h:
        out = _pass(out, 0, ymin_v, kk_v, ks_v, out.shape[0])
    return out[:, :, 0] if squeeze else out


# -- affine transforms (Pillow's Geometry.c, bilinear filter) -----------------

def affine(img: np.ndarray, data, fillcolor) -> np.ndarray:
    """``Image.transform(img.size, AFFINE, data, BILINEAR,
    fillcolor=fillcolor)`` of an HWC uint8 image: each output pixel centre
    maps through ``data`` into the input, and takes the bilinear blend of
    its four neighbours (edges clamped), truncated to 8 bits; a centre that
    lands outside keeps ``fillcolor``."""
    img = np.asarray(img, np.uint8)
    h, w, c = img.shape
    a0, a1, a2, a3, a4, a5 = (float(v) for v in data[:6])
    xin = np.arange(w, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xx = a0 * xin + a1 * yin + a2
    yy = a3 * xin + a4 * yin + a5
    inside = (xx >= 0.0) & (xx < w) & (yy >= 0.0) & (yy < h)
    xx = xx - 0.5
    yy = yy - 0.5
    x = np.floor(xx).astype(np.int64)
    y = np.floor(yy).astype(np.int64)
    dx = (xx - x)[..., None]
    dy = (yy - y)[..., None]
    x0 = np.clip(x, 0, w - 1)
    x1 = np.clip(x + 1, 0, w - 1)
    y0 = np.clip(y, 0, h - 1)
    has_y1 = (y + 1 >= 0) & (y + 1 < h)
    y1 = np.clip(y + 1, 0, h - 1)
    src = img.astype(np.int64)

    def row(yi):
        a = src[yi, x0]
        return a + (src[yi, x1] - a) * dx

    v1 = row(y0)
    v2 = np.where(has_y1[..., None], row(y1), v1)
    v = v1 + (v2 - v1) * dy
    out = np.empty_like(img)
    out[...] = np.asarray(fillcolor, np.uint8).reshape(1, 1, -1)[..., :c]
    out[inside] = v[inside].astype(np.uint8)  # C's (UINT8) cast truncates
    return out


def rotate(img: np.ndarray, angle: float, fillcolor) -> np.ndarray:
    """``Image.rotate(angle, BILINEAR, fillcolor=fillcolor)`` of an HWC
    uint8 image: counter-clockwise by ``angle`` degrees about the centre,
    with PIL's exact quarter turns."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return affine(img, m, fillcolor)
