"""The port's RecordIO, PNG codec, resample and affine transforms against
the JAX package and PIL.

Every comparison here is bitwise (tolerance 0): the record format both
ways, the PNG codec against PIL's encoder and decoder, ``resize`` against
``Image.resize`` (BICUBIC and BILINEAR, up and down, odd sizes), and
``rotate`` / ``affine`` against ``Image.rotate`` / ``Image.transform``.
"""

import io

import numpy as np
import pytest
from PIL import Image

from mxnet_tpu import recordio as jrio
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import recordio as trio
from mxnet_tpu_torch.io import _imaging


def _gradient(rng, h, w):
    """A smooth gradient with a little noise: what resample sees in photos
    (and every PNG row filter wins somewhere)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    (x + 2 * y) * 3 % 256], -1)
    return np.clip(img + rng.randint(0, 24, img.shape), 0, 255).astype(np.uint8)


def _images(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = rng.randint(5, 49, 2)
        out.append(_gradient(rng, h, w) if i % 2 == 0 else
                   rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_cross_both_ways(tmp_path, writer):
    """Each package reads the other's records and index, bitwise: payloads
    of every length mod 8, scalar labels and label vectors."""
    path, idx = str(tmp_path / "t.rec"), str(tmp_path / "t.idx")
    w_mod, r_mod = (trio, jrio) if writer == "port" else (jrio, trio)
    rng = np.random.RandomState(3)
    payloads = [rng.bytes(n) for n in range(17)]
    headers = [w_mod.IRHeader(0, float(i) * 0.5, i, 7) if i % 3 else
               w_mod.IRHeader(3, rng.uniform(size=3).astype(np.float32), i, 0)
               for i in range(17)]
    w = w_mod.MXIndexedRecordIO(idx, path, "w")
    for i, (h, p) in enumerate(zip(headers, payloads)):
        w.write_idx(i, w_mod.pack(h, p))
    w.close()
    assert trio.scan_offsets(path) == jrio.scan_offsets(path)
    r = r_mod.MXIndexedRecordIO(idx, path, "r")
    assert r.keys == list(range(17))
    for i in (16, 3, 0, 9):
        header, payload = r_mod.unpack(r.read_idx(i))
        assert payload == payloads[i]
        assert header.flag == headers[i].flag and header.id == i
        np.testing.assert_array_equal(header.label, np.float32(
            headers[i].label))
    r.close()
    seq = r_mod.MXRecordIO(path, "r")
    with open(path, "rb") as f:
        for off in trio.scan_offsets(path):
            assert seq.read() == trio.read_record_at(f, off) \
                == jrio.read_record_at(f, off)
    assert seq.read() is None


def test_record_bytes_are_identical(tmp_path):
    """Both writers make the same file from the same records."""
    files = []
    for mod in (trio, jrio):
        path = str(tmp_path / f"{mod.__name__}.rec")
        with mod.MXRecordIO(path, "w") as w:
            for i in range(9):
                w.write(mod.pack(mod.IRHeader(2, [i, -i], i, 1), b"x" * i))
        files.append(open(path, "rb").read())
    assert files[0] == files[1]


def test_corrupt_record_raises(tmp_path):
    path = str(tmp_path / "c.rec")
    with trio.MXRecordIO(path, "w") as w:
        w.write(b"abcdefgh")
    raw = bytearray(open(path, "rb").read())
    raw[16] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(MXNetError, match="crc"):
        trio.MXRecordIO(path, "r").read()


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_reads_pil_bitwise(channels):
    """PIL's PNGs (adaptive filters: None, Sub, Up, Average and Paeth rows)
    decode to PIL's pixels."""
    seen = set()
    for img in _images(channels):
        img = img[:, :, 0] if channels == 1 else img
        if channels == 4:
            img = np.concatenate([img, img[:, :, :1] ^ 0x5A], axis=2)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        raw = buf.getvalue()
        ours = _imaging.png_decode(raw)
        np.testing.assert_array_equal(ours.reshape(img.shape), img)
        np.testing.assert_array_equal(
            _imaging.decode(raw),
            np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")))
        seen.update(_png_filters(raw))
    assert seen >= {1, 2, 4}  # the vector and the per-byte paths both ran


def _png_filters(raw):
    import struct
    import zlib

    pos, idat, hdr = 8, b"", None
    while pos < len(raw):
        n, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", raw[pos + 8:pos + 8 + n])
        if kind == b"IDAT":
            idat += raw[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, _, ctype = hdr[:4]
    c = {0: 1, 2: 3, 6: 4}[ctype]
    data = zlib.decompress(idat)
    return {data[y * (w * c + 1)] for y in range(h)}


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encoder_is_read_by_pil(channels):
    """The port's PNG (every row Up-filtered) decodes in PIL, and in the
    port, to the pixels written."""
    for img in _images(10 + channels):
        img = img[:, :, :channels] if channels < 4 else np.concatenate(
            [img, img[:, :, :1]], axis=2)
        raw = _imaging.png_encode(img)
        assert _png_filters(raw) == {2}
        pil = np.asarray(Image.open(io.BytesIO(raw)))
        np.testing.assert_array_equal(pil.reshape(img.shape), img)
        np.testing.assert_array_equal(_imaging.png_decode(raw), img.reshape(
            img.shape[0], img.shape[1], channels))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_pack_img_crosses_both_ways(writer):
    w_mod, r_mod = (trio, jrio) if writer == "port" else (jrio, trio)
    for i, img in enumerate(_images(20)):
        s = w_mod.pack_img(w_mod.IRHeader(0, float(i), i, 0), img,
                           img_fmt=".png")
        header, out = r_mod.unpack_img(s)
        assert header.label == float(i)
        np.testing.assert_array_equal(out, img)


def test_jpeg_goes_through_pil_and_raises_without_it(monkeypatch):
    """A JPEG record decodes through PIL as the JAX package's does; with
    PIL hidden (where the port used to raise) the native codec decodes it
    to the same pixels and encodes PIL's bytes, a progressive file decodes
    to PIL's pixels too, and a file the codec does not take (a truncated
    progressive one) raises an MXNetError."""
    img = _images(30, n=1)[0]
    s = jrio.pack_img(jrio.IRHeader(0, 1.0, 0, 0), img, quality=90,
                      img_fmt=".jpg")
    want = jrio.unpack_img(s)[1]
    np.testing.assert_array_equal(trio.unpack_img(s)[1], want)
    assert trio.unpack(trio.pack_img(trio.IRHeader(0, 1.0, 0, 0), img,
                                     quality=90))[1] == jrio.unpack(s)[1]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", progressive=True)
    progressive = trio.pack(trio.IRHeader(0, 1.0, 0, 0), buf.getvalue())
    want_progressive = np.asarray(Image.open(buf).convert("RGB"))
    truncated = trio.pack(trio.IRHeader(0, 1.0, 0, 0),
                          buf.getvalue()[:len(buf.getvalue()) // 2])
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(trio.unpack_img(s)[1], want)
    assert trio.pack_img(trio.IRHeader(0, 1.0, 0, 0), img, quality=90,
                         img_fmt=".jpg") == s
    np.testing.assert_array_equal(trio.unpack_img(progressive)[1],
                                  want_progressive)
    with pytest.raises(MXNetError, match="does not take"):
        trio.unpack_img(truncated)
    np.testing.assert_array_equal(  # PNG needs no PIL
        trio.unpack_img(trio.pack_img(trio.IRHeader(0, 1.0, 0, 0), img,
                                      img_fmt=".png"))[1], img)


_SIZES = [((40, 48), (24, 20)), ((40, 48), (96, 81)), ((37, 23), (23, 37)),
          ((5, 7), (64, 3)), ((300, 211), (256, 363)), ((48, 40), (48, 17)),
          ((48, 40), (31, 40)), ((33, 33), (33, 33)), ((1, 9), (4, 2))]


@pytest.mark.parametrize("resample", [_imaging.BICUBIC, _imaging.BILINEAR])
@pytest.mark.parametrize("src,dst", _SIZES)
def test_resize_is_pil_bitwise(resample, src, dst):
    """``Image.resize`` bit for bit: down, up, one axis only, the same size
    (PIL's copy shortcut), gray and RGB."""
    pil = {_imaging.BICUBIC: Image.BICUBIC,
           _imaging.BILINEAR: Image.BILINEAR}[resample]
    rng = np.random.RandomState(sum(src) + sum(dst))
    h, w = src
    for img in (_gradient(rng, h, w), rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8)):
        for arr in (img, img[:, :, 1]):
            want = np.asarray(Image.fromarray(arr).resize(dst, pil))
            np.testing.assert_array_equal(_imaging.resize(arr, dst, resample),
                                          want)


@pytest.mark.parametrize("seed", range(4))
def test_rotate_and_shear_are_pil_bitwise(seed):
    """``Image.rotate(angle, BILINEAR, fillcolor)`` and the AFFINE shear of
    ``_decode_one`` bit for bit, the quarter turns included."""
    rng = np.random.RandomState(seed)
    img = _gradient(rng, 40, 48)
    sq = img[:, :40]
    fill = (255, 255, 255) if seed % 2 else (7, 7, 7)
    for src in (img, sq):
        for angle in list(rng.uniform(-45, 45, 3)) + [90.0, 180.0, 270.0,
                                                      -90.0, 360.0]:
            want = np.asarray(Image.fromarray(src).rotate(
                angle, resample=Image.BILINEAR, fillcolor=fill))
            np.testing.assert_array_equal(
                _imaging.rotate(src, angle, fill), want)
        for s in rng.uniform(-0.6, 0.6, 3):
            want = np.asarray(Image.fromarray(src).transform(
                src.shape[1::-1], Image.AFFINE, (1, s, 0, 0, 1, 0),
                resample=Image.BILINEAR, fillcolor=fill))
            np.testing.assert_array_equal(
                _imaging.affine(src, (1, s, 0, 0, 1, 0), fill), want)
