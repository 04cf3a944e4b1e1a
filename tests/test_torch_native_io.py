"""The port's native data pipeline (``mxnet_tpu_torch/native``) against the
JAX package's (``mxnet_tpu/native``).

Both are built here, the JAX package's against the system's libjpeg and the
port's with its own baseline JPEG codec, and every comparison is bitwise
(tolerance 0): record offsets, every batch of the pipeline over a grid of
its parameters (layouts, dtypes, resize, mean and scale, random crop,
mirror, scale, size, contrast and illumination, shuffle, pads, label
vectors), ``ImageRecordIter``'s native route against the JAX package's
``MXNET_TPU_NATIVE_IO=1`` route, and the codec itself against PIL (which
links libjpeg-turbo) over subsamplings, qualities, restart intervals,
optimised Huffman tables and gray images, progressive files, and the
arithmetic-coded files that ``torch_arith_jpeg.py`` carries. Randomness is on only with one
worker thread: with more, which worker's stream serves which batch is a
race, in both packages alike.
"""

import io
import os
import subprocess
import sys

import hashlib

import numpy as np
import pytest
import torch
from PIL import Image

from mxnet_tpu import io as jio
from mxnet_tpu import native as jnative
from mxnet_tpu import recordio as jrio
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import native as tnative
from mxnet_tpu_torch import recordio as trio
import torch_arith_jpeg as arith

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference_lib():
    if jnative.get_lib() is None:  # as tests/test_native.py: no libjpeg
        pytest.skip("the JAX package's native library (libjpeg) is "
                    "unavailable")
    return jnative


def _image(rng, h, w, kind):
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 5 % 256, y * 7 % 256, (x * y) % 256], -1)
    return np.clip(img + rng.randint(0, 40, img.shape), 0, 255).astype(
        np.uint8)


def _jpeg_shard(path, n=19, label_width=1, seed=0, sides=(26, 61)):
    """``n`` JPEG records written by the JAX package (PIL), sides drawn
    from ``sides``, some 4:4:4 and some gray among the 4:2:0 ones."""
    rng = np.random.RandomState(seed)
    with jrio.MXRecordIO(path, "w") as w:
        for i in range(n):
            h, wd = rng.randint(*sides), rng.randint(*sides)
            img = _image(rng, h, wd, "noise" if i % 3 == 0 else "smooth")
            label = float(i) if label_width == 1 else \
                np.arange(label_width, dtype=np.float32) + i
            header = jrio.IRHeader(0 if label_width == 1 else label_width,
                                   label, i, 0)
            if i % 4 == 1:
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=85,
                                          subsampling=0)
                w.write(jrio.pack(header, buf.getvalue()))
            elif i % 5 == 2:
                buf = io.BytesIO()
                Image.fromarray(img[:, :, 0]).save(buf, format="JPEG")
                w.write(jrio.pack(header, buf.getvalue()))
            else:
                w.write(jrio.pack_img(header, img, quality=95,
                                      img_fmt=".jpg"))
    return path


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    return _jpeg_shard(str(tmp_path_factory.mktemp("jpeg") / "a.rec"))


@pytest.fixture(scope="module")
def shard_labels(tmp_path_factory):
    return _jpeg_shard(str(tmp_path_factory.mktemp("jpeg3") / "b.rec"),
                       n=10, label_width=3, seed=1)


def _epochs(pipe, epochs=2):
    out = []
    for _ in range(epochs):
        while True:
            try:
                data, labels, pad = pipe.next()
            except StopIteration:
                break
            out.append((np.asarray(data), np.asarray(labels), pad))
        pipe.reset()
    return out


def _assert_same(ref, got):
    assert len(ref) == len(got) and ref
    for (rd, rl, rp), (gd, gl, gp) in zip(ref, got):
        assert rp == gp
        assert rd.dtype == gd.dtype and rd.shape == gd.shape
        np.testing.assert_array_equal(rd, gd)
        np.testing.assert_array_equal(rl, gl)


def test_scan_offsets_matches_reference(reference_lib, shard, tmp_path):
    assert tnative.scan_offsets(shard) == reference_lib.scan_offsets(shard)
    assert tnative.scan_offsets(shard) == trio.scan_offsets(shard)
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"not a record file at all")
    assert tnative.scan_offsets(str(bad)) is None
    assert reference_lib.scan_offsets(str(bad)) is None


_GRID = [
    # (pipeline arguments, threads)
    (dict(), 4),
    (dict(nhwc=True), 4),
    (dict(out_u8=True), 4),
    (dict(nhwc=True, out_u8=True), 4),
    (dict(resize=40), 4),
    (dict(resize=36, mean=[120.5, 110.0, 99.25], scale=1 / 64), 4),
    (dict(nhwc=True, mean=[1.0, 2.0, 3.0], scale=0.5), 4),
    (dict(shuffle=True, seed=11), 4),
    (dict(round_batch=False), 4),
    (dict(mirror=True, resize=34), 4),
    (dict(rand_crop=True, seed=3), 1),
    (dict(rand_mirror=True, seed=4), 1),
    (dict(rand_crop=True, rand_mirror=True, shuffle=True, resize=40,
          seed=5), 1),
    (dict(rand_crop=True, rand_mirror=True, out_u8=True, nhwc=True,
          seed=6), 1),
    (dict(min_random_scale=0.8, max_random_scale=1.4, rand_crop=True,
          seed=7), 1),
    (dict(min_img_size=30.0, max_img_size=50.0, min_random_scale=0.5,
          max_random_scale=2.0, seed=8), 1),
    (dict(max_random_contrast=0.3, max_random_illumination=12.0,
          mean=[100.0, 100.0, 100.0], seed=9), 1),
    (dict(max_random_contrast=0.2, rand_crop=True, rand_mirror=True,
          shuffle=True, nhwc=True, scale=1 / 255, seed=10), 1),
]


@pytest.mark.parametrize("batch", [4, 5])
@pytest.mark.parametrize("kw,threads", _GRID)
def test_pipeline_matches_reference(reference_lib, shard, kw, threads,
                                    batch):
    """Two epochs of every batch (data, labels, pad) bitwise the JAX
    package's native pipeline's on the same records."""
    offsets = reference_lib.scan_offsets(shard)
    args = (shard, offsets, batch, (3, 24, 28))
    ref = reference_lib.NativePipeline(*args, num_threads=threads, **kw)
    got = tnative.NativePipeline(*args, num_threads=threads, **kw)
    assert got.batches_per_epoch == ref.batches_per_epoch
    _assert_same(_epochs(ref), _epochs(got))


def test_pipeline_label_vectors_and_pads(reference_lib, shard_labels):
    offsets = reference_lib.scan_offsets(shard_labels)
    for label_width in (1, 2, 3):
        args = (shard_labels, offsets, 4, (3, 20, 20))
        ref = reference_lib.NativePipeline(*args, label_width=label_width,
                                           num_threads=4)
        got = tnative.NativePipeline(*args, label_width=label_width,
                                     num_threads=4)
        batches = _epochs(got, 1)
        _assert_same(_epochs(ref, 1), batches)
        assert [p for _, _, p in batches] == [0, 0, 2]  # 10 records wrap


@pytest.mark.parametrize("knob", ["MXTPU_NATIVE_SKIP_DECODE",
                                  "MXTPU_NATIVE_SKIP_WORK"])
def test_skip_knobs_match_reference(reference_lib, shard, knob,
                                    monkeypatch):
    monkeypatch.setenv(knob, "1")
    offsets = reference_lib.scan_offsets(shard)
    args = (shard, offsets, 4, (3, 24, 28))
    _assert_same(_epochs(reference_lib.NativePipeline(*args, resize=30)),
                 _epochs(tnative.NativePipeline(*args, resize=30)))


def test_pipeline_refuses_u8_with_normalisation_and_non_jpeg(tmp_path):
    path = str(tmp_path / "png.rec")
    with trio.MXRecordIO(path, "w") as w:
        w.write(trio.pack_img(trio.IRHeader(0, 1.0, 0, 0),
                              np.zeros((30, 30, 3), np.uint8),
                              img_fmt=".png"))
    offsets = trio.scan_offsets(path)
    with pytest.raises(ValueError, match="uint8"):
        tnative.NativePipeline(path, offsets, 1, (3, 24, 24), out_u8=True,
                               scale=0.5)
    pipe = tnative.NativePipeline(path, offsets, 1, (3, 24, 24))
    with pytest.raises(MXNetError, match="does not take"):
        pipe.next()


_ITER_GRID = [
    dict(),
    dict(layout="NHWC", output_dtype="uint8"),
    dict(resize=40, mean_r=120.5, mean_g=110.0, mean_b=99.25, scale=1 / 64),
    dict(shuffle=True, seed=3, round_batch=False),
    dict(mirror=True, min_img_size=30.0, max_img_size=44.0),
]


@pytest.mark.parametrize("kw", _ITER_GRID)
def test_image_record_iter_native_route_matches_reference(shard, kw,
                                                          monkeypatch):
    """``ImageRecordIter`` takes the native route in both packages
    (``MXNET_TPU_NATIVE_IO=1``) and gives the same batches over two
    epochs (deterministic settings: the JAX iterator picks its threads)."""
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "1")
    args = dict(path_imgrec=shard, data_shape=(3, 24, 28), batch_size=4, **kw)
    ref, got = jio.ImageRecordIter(**args), tio.ImageRecordIter(**args)
    assert ref._native is not None and got._native is not None
    for _ in range(2):
        rb, gb = list(ref), list(got)
        # 19 records: 5 batches, the last padded, or 4 without round_batch
        assert len(rb) == len(gb) == (5 if kw.get("round_batch", True)
                                      else 4)
        for r, g in zip(rb, gb):
            assert r.pad == g.pad
            np.testing.assert_array_equal(r.data[0].asnumpy(),
                                          g.data[0].numpy())
            np.testing.assert_array_equal(r.label[0].asnumpy(),
                                          g.label[0].numpy())
        assert got.getpad() == ref.getpad()


def test_image_record_iter_threads_and_fallbacks(shard, tmp_path,
                                                 monkeypatch):
    """``preprocess_threads``, else ``MXNET_CPU_WORKER_NTHREADS``, else one
    less than the host's cores set the native route's threads; a Python-only
    augmenter, ``MXNET_TPU_NATIVE_IO=0`` and PNG records take the Python
    path, as the JAX package's do, and give its batches."""
    kw = dict(path_imgrec=shard, data_shape=(3, 24, 28), batch_size=4)
    monkeypatch.delenv("MXNET_CPU_WORKER_NTHREADS", raising=False)
    default = max(1, (os.cpu_count() or 2) - 1)
    assert tio.ImageRecordIter(**kw)._native.num_threads == default
    assert tio.ImageRecordIter(preprocess_threads=3,
                               **kw)._native.num_threads == 3
    monkeypatch.setenv("MXNET_CPU_WORKER_NTHREADS", "2")
    assert tio.ImageRecordIter(**kw)._native.num_threads == 2
    assert tio.ImageRecordIter(preprocess_threads=5,
                               **kw)._native.num_threads == 5
    it = tio.ImageRecordIter(max_rotate_angle=10, **kw)
    assert it._native is None
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "0")
    assert tio.ImageRecordIter(**kw)._native is None
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "1")
    png = str(tmp_path / "png.rec")
    rng = np.random.RandomState(2)
    with trio.MXRecordIO(png, "w") as w:
        for i in range(6):
            w.write(trio.pack_img(trio.IRHeader(0, float(i), i, 0),
                                  _image(rng, 30, 33, "smooth"),
                                  img_fmt=".png"))
    png_kw = dict(path_imgrec=png, data_shape=(3, 24, 28), batch_size=4)
    ref, got = jio.ImageRecordIter(**png_kw), tio.ImageRecordIter(**png_kw)
    assert ref._native is None and got._native is None
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r.data[0].asnumpy(), g.data[0].numpy())


def test_build_at_first_use_into_build_dir(tmp_path, monkeypatch):
    """Importing the package builds nothing; the first use builds the
    library into ``build/mxnet_tpu_torch/``, named by the source's hash."""
    code = ("import mxnet_tpu_torch, mxnet_tpu_torch.io, "
            "mxnet_tpu_torch.native as n; "
            "print(n._lib is None and n._error is None)")
    env = {**os.environ, "CXX": "/bin/false", "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr
    assert tnative.BUILD_DIR == \
        tnative.Path(REPO) / "build" / "mxnet_tpu_torch"
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_error", None)
    path = tnative.library_path()
    assert not path.exists()
    tnative.require_lib()
    assert path.exists() and path.parent == tmp_path / "b"
    assert path.name.startswith("libmxtpu_native-") and \
        path.name.endswith(".so")


def _pil_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("subsampling", [-1, 0, 1, 2])
@pytest.mark.parametrize("quality", [95, 75, 20])
@pytest.mark.parametrize("extra", [{}, {"optimize": True},
                                   {"restart_marker_blocks": 1},
                                   {"restart_marker_rows": 1}])
def test_codec_decodes_libjpeg_pixels(subsampling, quality, extra):
    """The port's decoder gives libjpeg's pixels (PIL's ``convert("RGB")``)
    bit for bit: odd sides, 1-2 pixel edges, noise and gradients."""
    rng = np.random.RandomState(quality + subsampling)
    for h, w in ((1, 1), (2, 9), (17, 3), (33, 47), (64, 80), (9, 130)):
        for kind in ("noise", "smooth"):
            img = _image(rng, h, w, kind)
            for im in (img, img[:, :, 1]):
                data = _pil_jpeg(im, quality=quality,
                                 subsampling=subsampling, **extra)
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                np.testing.assert_array_equal(tnative.decode_jpeg(data), want)


@pytest.mark.parametrize("quality", [95, 90, 50, 10])
def test_codec_encodes_pil_bytes(quality):
    """The port's encoder writes PIL's (libjpeg's) JPEG bytes for RGB and
    gray images, odd sides included."""
    rng = np.random.RandomState(quality)
    for h, w in ((1, 1), (7, 5), (16, 16), (31, 45), (50, 17)):
        for kind in ("noise", "smooth"):
            img = _image(rng, h, w, kind)
            for im in (img, img[:, :, 2]):
                assert tnative.encode_jpeg(im, quality) == \
                    _pil_jpeg(im, quality=quality)
    with pytest.raises(MXNetError, match="1 or 3"):
        tnative.encode_jpeg(np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("subsampling", [-1, 0, 1, 2])
@pytest.mark.parametrize("quality", [95, 75, 20])
@pytest.mark.parametrize("extra", [{}, {"optimize": True},
                                   {"restart_marker_blocks": 1},
                                   {"restart_marker_rows": 1}])
def test_codec_decodes_progressive_like_libjpeg(subsampling, quality, extra):
    """Progressive files (libjpeg's simple progression: DC first and
    refine, AC first with EOB runs and AC refine with correction bits,
    interleaved DC scans, restart intervals) give libjpeg's pixels, PIL's
    ``convert("RGB")``, bit for bit: odd sides, 1-2 pixel edges, noise and
    gradients, colour and gray."""
    rng = np.random.RandomState(quality + subsampling + 7)
    for h, w in ((1, 1), (2, 9), (17, 3), (33, 47), (64, 80), (9, 130)):
        for kind in ("noise", "smooth"):
            img = _image(rng, h, w, kind)
            for im in (img, img[:, :, 1]):
                data = _pil_jpeg(im, quality=quality, progressive=True,
                                 subsampling=subsampling, **extra)
                assert b"\xff\xc2" in data
                want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                np.testing.assert_array_equal(tnative.decode_jpeg(data), want)


def _segments_end(data, marker):
    """Offset just past the entropy data of the first scan that follows
    the first ``marker`` segment (the next marker's 0xFF)."""
    i = data.index(marker)
    i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    while not (data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF)
               and not 0xD0 <= data[i + 1] <= 0xD7):
        i += 1
    return i


def test_codec_latches_quantisers_at_first_scan():
    """A DQT between the scans of a progressive file redefines a table
    that the components already latched at their first scan: libjpeg
    (jdinput.c latch_quant_tables) keeps the latched one, and so does the
    port's codec; the pixels equal those of the file without it."""
    img = _image(np.random.RandomState(5), 40, 56, "smooth")
    for im in (img, img[:, :, 0]):
        data = _pil_jpeg(im, quality=80, progressive=True)
        cut = _segments_end(data, b"\xff\xda")
        dqt = b"\xff\xdb\x00\x43\x00" + bytes([1] * 64)
        later = data[:cut] + dqt + data[cut:]
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(later)).convert("RGB")), want)
        np.testing.assert_array_equal(tnative.decode_jpeg(later), want)


def test_codec_refuses_what_it_does_not_take():
    """Refused: a truncated progressive file (libjpeg would smooth the
    blocks whose bits are missing), an empty one, a baseline file cut in
    its headers, CMYK (libjpeg does not convert it to RGB either), and
    lossless and 12-bit frames (the 8-bit libjpeg refuses them too)."""
    img = _image(np.random.RandomState(0), 20, 20, "smooth")
    progressive = _pil_jpeg(img, progressive=True)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 4), np.uint8), "CMYK").save(buf, "JPEG")
    baseline = bytearray(_pil_jpeg(img))
    sof = baseline.index(b"\xff\xc0")
    lossless, twelve = bytearray(baseline), bytearray(baseline)
    lossless[sof + 1] = 0xC3
    twelve[sof + 4] = 12
    # and their arithmetic-coded kin: lossless (SOF11), hierarchical
    # (SOF13) and 12-bit SOF9 frames
    sof9 = arith.arith_jpegs()["sof9_420"]
    at = sof9.index(b"\xff\xc9")
    arith_bad = [sof9[:at + 1] + bytes([m]) + sof9[at + 2:]
                 for m in (0xCB, 0xCD)]
    arith_bad.append(sof9[:at + 4] + bytes([12]) + sof9[at + 5:])
    for data in (progressive[:len(progressive) // 2], progressive[:-2],
                 b"\xff\xd8\xff\xd9", bytes(baseline[:40]), buf.getvalue(),
                 bytes(lossless), bytes(twelve), *arith_bad):
        with pytest.raises(MXNetError, match="does not take"):
            tnative.decode_jpeg(data)


def test_pack_img_jpg_without_pil_decodes_alike_in_both(tmp_path,
                                                        monkeypatch):
    """Without PIL the port's ``pack_img(img_fmt=".jpg")`` encodes through
    the native library: PIL's own bytes, which both packages decode to the
    same pixels and the port's native pipeline reads."""
    rng = np.random.RandomState(5)
    imgs = [_image(rng, 37, 52, kind) for kind in ("smooth", "noise")]
    monkeypatch.setitem(sys.modules, "PIL", None)
    packed = [trio.pack_img(trio.IRHeader(0, float(i), i, 0), img,
                            quality=92, img_fmt=".jpg")
              for i, img in enumerate(imgs)]
    monkeypatch.undo()
    for img, rec in zip(imgs, packed):
        assert trio.unpack(rec)[1] == _pil_jpeg(img, quality=92)
        np.testing.assert_array_equal(trio.unpack_img(rec)[1],
                                      jrio.unpack_img(rec)[1])
    path = str(tmp_path / "nopil.rec")
    with trio.MXRecordIO(path, "w") as w:
        for rec in packed:
            w.write(rec)
    pipe = tnative.NativePipeline(path, trio.scan_offsets(path), 2,
                                  (3, 37, 52), nhwc=True, out_u8=True)
    data, labels, _ = pipe.next()
    for i, rec in enumerate(packed):
        np.testing.assert_array_equal(data[i].numpy(),
                                      jrio.unpack_img(rec)[1])
    np.testing.assert_array_equal(labels.numpy(), [0.0, 1.0])


def test_pinned_batches_only_with_a_card(shard):
    offsets = trio.scan_offsets(shard)
    pipe = tnative.NativePipeline(shard, offsets, 4, (3, 24, 28))
    data, labels, _ = pipe.next()
    card = torch.cuda.is_available()
    assert data.is_pinned() == card and labels.is_pinned() == card
    assert data.dtype == torch.float32
    it = tio.ImageRecordIter(path_imgrec=shard, data_shape=(3, 24, 28),
                             batch_size=4)
    assert it._native.pin_memory == card


def test_native_and_python_routes_agree_but_for_the_resize(tmp_path,
                                                            monkeypatch):
    """The two routes of ``ImageRecordIter`` on the same JPEG records, in
    both packages: without a resize (centre crops) their batches are equal
    bit for bit, and with one they differ alike in both packages, because
    the native route resizes with its own 16.16 fixed-point bilinear
    (align-corners) and the Python path with PIL's antialiased BILINEAR
    (``ROADMAP.md`` C.2)."""
    path = _jpeg_shard(str(tmp_path / "r.rec"), n=8, sides=(40, 64))
    gaps = {}
    for kw in (dict(), dict(resize=34)):
        args = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=8,
                    output_dtype="uint8", **kw)
        batches = {}
        for route in ("1", "0"):
            monkeypatch.setenv("MXNET_TPU_NATIVE_IO", route)
            got = tio.ImageRecordIter(**args)
            ref = jio.ImageRecordIter(**args)
            assert (got._native is None) == (ref._native is None) == \
                (route == "0")
            g = next(iter(got)).data[0].numpy().astype(np.int32)
            np.testing.assert_array_equal(
                g, next(iter(ref)).data[0].asnumpy().astype(np.int32))
            batches[route] = g
        gaps[kw.get("resize", -1)] = np.abs(batches["1"] - batches["0"])
    assert gaps[-1].max() == 0
    assert gaps[34].max() > 1


def _mixed_shard(path, n=14, first_progressive=6):
    """JPEG records written by the JAX package (PIL), baseline up to
    ``first_progressive`` and then every other record progressive: a
    progressive record past the first batches."""
    rng = np.random.RandomState(9)
    with jrio.MXRecordIO(path, "w") as w:
        for i in range(n):
            img = _image(rng, rng.randint(26, 61), rng.randint(26, 61),
                         "noise" if i % 3 == 0 else "smooth")
            prog = i >= first_progressive and i % 2 == 0
            data = _pil_jpeg(img, quality=90, progressive=prog,
                             subsampling=i % 3)
            w.write(jrio.pack(jrio.IRHeader(0, float(i), i, 0), data))
    return path


def test_image_record_iter_keeps_native_route_over_progressive(
        reference_lib, tmp_path, monkeypatch):
    """A shard that mixes baseline and progressive records, progressive
    ones after the first batch: the port's ``ImageRecordIter`` stays on the
    native route through two epochs (no fallback, no error mid-epoch) and
    its batches equal the JAX package's libjpeg route's and the records
    decoded one at a time, bitwise."""
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "1")
    path = _mixed_shard(str(tmp_path / "mixed.rec"))
    args = dict(path_imgrec=path, data_shape=(3, 24, 24), batch_size=4,
                output_dtype="uint8")
    ref, got = jio.ImageRecordIter(**args), tio.ImageRecordIter(**args)
    assert ref._native is not None and got._native is not None
    records = []
    with trio.MXRecordIO(path, "r") as r:
        while (item := r.read()) is not None:
            records.append(trio.unpack(item)[1])
    for _ in range(2):
        rb, gb = list(ref), list(got)
        assert len(rb) == len(gb) == 4 and got._native is not None
        for i, (r, g) in enumerate(zip(rb, gb)):
            np.testing.assert_array_equal(r.data[0].asnumpy(),
                                          g.data[0].numpy())
            for j in range(4 - g.pad):
                img = tnative.decode_jpeg(records[4 * i + j])
                h, w = img.shape[:2]
                y, x = (h - 24) // 2, (w - 24) // 2
                np.testing.assert_array_equal(
                    g.data[0][j].numpy(),
                    img[y:y + 24, x:x + 24].transpose(2, 0, 1))


# --------------------------------------------------------------------------
# arithmetic-coded JPEG (SOF9, SOF10): files carried in torch_arith_jpeg.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(arith.SOURCES))
def test_codec_decodes_arithmetic_like_libjpeg(name):
    """Each carried file (sequential and progressive, 4:2:0 and gray, with
    restarts, with non-default DAC conditioning) decodes to libjpeg's
    pixels, PIL's ``convert("RGB")``, bit for bit; the pixels are also
    those whose digest the module carries."""
    data = arith.arith_jpegs()[name]
    assert (b"\xff\xc9" if name.startswith("sof9_") else b"\xff\xca") \
        in data
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = tnative.decode_jpeg(data)
    assert got.shape == arith.SHAPE
    np.testing.assert_array_equal(got, want)
    assert hashlib.sha256(got.tobytes()).hexdigest() == \
        arith.PIXEL_SHA256[name]


@pytest.mark.parametrize("name", ["sof9_420", "sof9_gray", "sof9_420_dac"])
def test_codec_takes_libjpeg_defaults_without_dac(name):
    """Without its DAC segment a file is decoded with libjpeg's defaults
    (L = 0, U = 1, Kx = 5), as libjpeg decodes it: the same pixels where
    the file was written with those values, and other pixels, alike in
    both, where it was written with L = 2, U = 6, Kx = 12."""
    data = arith.arith_jpegs()[name]
    stripped = arith.strip_dac(data)
    assert b"\xff\xcc" in data and b"\xff\xcc" not in stripped
    want = np.asarray(Image.open(io.BytesIO(stripped)).convert("RGB"))
    got = tnative.decode_jpeg(stripped)
    np.testing.assert_array_equal(got, want)
    same = np.array_equal(got, tnative.decode_jpeg(data))
    assert same == (name != "sof9_420_dac")


def test_codec_meets_markers_in_arithmetic_data():
    """libjpeg's encoder drops the trailing zero bytes of an arithmetic
    scan, so the decoder reads into the next marker and feeds zeros, as
    libjpeg does: a file padded with fill bytes (0xFF) before its markers
    and one with an extra APP segment between its scans decode alike."""
    data = arith.arith_jpegs()["sof10_420"]
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    cut = _segments_end(data, b"\xff\xda")
    app = b"\xff\xe5\x00\x06note"
    for variant in (data[:cut] + b"\xff\xff\xff" + data[cut:],
                    data[:cut] + app + data[cut:]):
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(variant)).convert("RGB")), want)
        np.testing.assert_array_equal(tnative.decode_jpeg(variant), want)


def test_image_record_iter_keeps_native_route_over_arithmetic(
        reference_lib, tmp_path, monkeypatch):
    """A shard that mixes Huffman records (baseline and progressive, PIL's)
    with the carried arithmetic ones, from the second batch on: the port's
    ``ImageRecordIter`` stays on the native route through two epochs, and
    its batches equal the JAX package's libjpeg route's bitwise, also with
    a resize, a mean and a scale."""
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "1")
    rng = np.random.RandomState(21)
    arith_files = [v for _, v in sorted(arith.arith_jpegs().items())]
    path = str(tmp_path / "arith.rec")
    with jrio.MXRecordIO(path, "w") as w:
        for i in range(14):
            if i >= 4 and i % 2 == 0:
                data = arith_files[(i // 2 - 2) % len(arith_files)]
            else:
                img = _image(rng, rng.randint(30, 61), rng.randint(30, 61),
                             "smooth")
                data = _pil_jpeg(img, quality=90, progressive=i % 3 == 0)
            w.write(jrio.pack(jrio.IRHeader(0, float(i), i, 0), data))
    for kw in (dict(output_dtype="uint8"),
               dict(resize=32, mean_r=120.5, mean_g=110.0, mean_b=99.25,
                    scale=1 / 64)):
        args = dict(path_imgrec=path, data_shape=(3, 24, 24), batch_size=4,
                    **kw)
        ref, got = jio.ImageRecordIter(**args), tio.ImageRecordIter(**args)
        assert ref._native is not None and got._native is not None
        for _ in range(2):
            rb, gb = list(ref), list(got)
            assert len(rb) == len(gb) == 4 and got._native is not None
            for r, g in zip(rb, gb):
                assert r.pad == g.pad
                np.testing.assert_array_equal(r.data[0].asnumpy(),
                                              g.data[0].numpy())
                np.testing.assert_array_equal(r.label[0].asnumpy(),
                                              g.label[0].numpy())
