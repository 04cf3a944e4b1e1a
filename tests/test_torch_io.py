"""The port's iterators and host engine against the JAX package's.

Every iterator comparison is bitwise (tolerance 0): the same files (written
here, idx, CSV and RecordIO) through both packages give the same batches.
``ImageRecordIter`` runs over a grid of its parameters in both layouts and
both output dtypes; the JAX package runs its Python path
(``MXNET_TPU_NATIVE_IO=0``), which decodes PNG and JPEG through PIL, and
the port decodes PNG with its own codec and JPEG through PIL.
"""

import gzip
import os
import struct
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrio
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import engine as teng
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trio


@pytest.fixture(autouse=True)
def _python_image_path(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_NATIVE_IO", "0")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.numpy()


def _batches(it, n=None):
    out = []
    for i, b in enumerate(it):
        out.append(([_np(d) for d in b.data], [_np(lab) for lab in b.label],
                    b.pad))
        if n is not None and i + 1 == n:
            break
    return out


def _assert_same(jb, tb):
    assert len(jb) == len(tb)
    for (jd, jl, jp), (td, tl, tp) in zip(jb, tb):
        assert jp == tp
        for a, b in zip(jd + jl, td + tl):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def _write_idx(path, arr):
    dtype_code = {np.uint8: 0x08, np.int32: 0x0C, np.float32: 0x0D}[arr.dtype.type]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, dtype_code, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(arr.tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("kw", [
    dict(flat=True, batch_size=10),
    dict(flat=False, batch_size=7, shuffle=True, seed=3),
    dict(flat=False, batch_size=5, input_shape=(1, 14, 56)),
    dict(flat=True, batch_size=4, num_parts=3, part_index=1),
    dict(flat=True, batch_size=4, num_parts=3, part_index=2, shuffle=True)])
def test_mnist_iter_matches_jax(tmp_path, gz, kw):
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (50, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 50).astype(np.uint8)
    ext = ".idx.gz" if gz else ".idx"
    img, lbl = str(tmp_path / f"i{ext}"), str(tmp_path / f"l{ext}")
    _write_idx(img, images)
    _write_idx(lbl, labels)
    for _ in range(2):  # two epochs: the shuffle's second draw too
        _assert_same(_batches(jio.MNISTIter(image=img, label=lbl, **kw)),
                     _batches(tio.MNISTIter(image=img, label=lbl, **kw)))
    with pytest.raises(MXNetError, match="required"):
        tio.MNISTIter(image=img)


def test_csv_iter_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    data = rng.uniform(-1, 1, (23, 6)).astype(np.float32)
    label = rng.randint(0, 3, 23).astype(np.float32)
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, data, delimiter=",")
    np.savetxt(lpath, label, delimiter=",")
    for kw in (dict(data_shape=(6,), label_csv=lpath, batch_size=5),
               dict(data_shape=(2, 3), batch_size=8)):
        _assert_same(_batches(jio.CSVIter(data_csv=dpath, **kw)),
                     _batches(tio.CSVIter(data_csv=dpath, **kw)))


def test_prefetching_iter_matches_and_drains_on_reset():
    """A reset mid-epoch drains what is in flight and restarts at the
    head; every epoch equals the wrapped iterator's own."""
    data = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    ref = _batches(tio.NDArrayIter(data, np.arange(64.0), batch_size=8))
    pf = tio.PrefetchingIter(tio.NDArrayIter(data, np.arange(64.0),
                                             batch_size=8), depth=4)
    pf.reset()
    for _ in range(3):
        pf.next()
    assert len(pf._queue) > 0
    pf.reset()
    fresh = []
    while True:
        try:
            b = pf.next()
        except StopIteration:
            break
        fresh.append(([b.data[0].numpy()], [b.label[0].numpy()], b.pad))
    _assert_same(ref, fresh)
    _assert_same(ref, _batches(pf))
    jpf = jio.PrefetchingIter(jio.NDArrayIter(data, np.arange(64.0),
                                              batch_size=8))
    _assert_same([([d.astype(np.float32) for d in bd], bl, p)
                  for bd, bl, p in _batches(jpf)], ref)


def test_engine_orders_writes_after_reads():
    """Writers wait for every earlier task on the variable; readers since
    the last write run together; errors come back through the waits."""
    eng = teng.Engine(num_workers=4)
    var = eng.new_variable("v")
    log, lock = [], threading.Lock()

    def task(tag, sleep):
        def fn():
            time.sleep(sleep)
            with lock:
                log.append(tag)
            return tag
        return fn

    eng.push(task("w0", 0.05), write_vars=[var])
    reads = [eng.push(task(f"r{i}", 0.02), read_vars=[var]) for i in range(3)]
    w1 = eng.push(task("w1", 0.0), write_vars=[var])
    eng.push(task("r3", 0.0), read_vars=[var])
    eng.wait_for_var(var)
    assert log[0] == "w0" and set(log[1:4]) == {"r0", "r1", "r2"}
    assert log[4:] == ["w1", "r3"]
    assert [f.result() for f in reads] == ["r0", "r1", "r2"]
    assert w1.result() == "w1"

    def boom():
        raise ValueError("task failed")

    eng.push(boom, write_vars=[var])
    with pytest.raises(ValueError, match="task failed"):
        eng.wait_for_var(var)
    slow = eng.push(task("slow", 0.5), write_vars=[eng.new_variable()])
    with pytest.raises(MXNetError, match="deadline"):
        eng.wait_for_all(timeout=0.05)
    slow.result()
    naive = teng.naive_engine()
    assert naive.push(lambda: 5).done()
    with pytest.raises(MXNetError, match="unknown engine"):
        teng.set_engine_type("Bogus")


def test_engine_matches_a_serial_run():
    """A random workload of reads and writes over four variables, on more
    worker threads than cores and with a short switch interval, gives the
    values of running it in push order (a lost ordering would not)."""
    import sys

    rng = np.random.RandomState(0)
    eng = teng.Engine(num_workers=16)
    vars_ = [eng.new_variable() for _ in range(4)]
    state, serial = [0] * 4, [0] * 4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(400):
            i, j = rng.randint(0, 4, 2)
            k = int(rng.randint(1, 5))

            def fn(i=i, j=j, k=k):
                state[i] = state[i] * 3 % 1000003 + state[j] + k

            serial[i] = serial[i] * 3 % 1000003 + serial[j] + k
            eng.push(fn, read_vars=[vars_[j]] if j != i else [],
                     write_vars=[vars_[i]])
        eng.wait_for_all(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert state == serial


def _record_file(tmp_path, n=16, fmt=".png", label_width=1, seed=0):
    """``n`` images of about 40 x 48 (sides drawn), smooth gradients with
    noise, written by the port (PNG) or the JAX package (JPEG)."""
    rng = np.random.RandomState(seed)
    path = str(tmp_path / f"img{fmt.strip('.')}{label_width}.rec")
    mod = trio if fmt == ".png" else jrio
    w = mod.MXRecordIO(path, "w")
    for i in range(n):
        h, wd = rng.randint(34, 49), rng.randint(36, 53)
        y, x = np.mgrid[0:h, 0:wd]
        img = np.stack([x * 5 % 256, y * 5 % 256, (x * y) % 256], -1)
        img = np.clip(img + rng.randint(0, 40, img.shape), 0, 255).astype(
            np.uint8)
        label = float(i % 5) if label_width == 1 else \
            np.arange(label_width, dtype=np.float32) + i
        flag = 0 if label_width == 1 else label_width
        w.write(mod.pack_img(mod.IRHeader(flag, label, i, 0), img,
                             img_fmt=fmt))
    w.close()
    return path


_GRID = [
    dict(),
    dict(resize=40, rand_crop=True, rand_mirror=True, shuffle=True, seed=5),
    dict(resize=44, mean_r=120.5, mean_g=110.0, mean_b=99.25, scale=1 / 64),
    dict(max_random_contrast=0.3, max_random_illumination=20, scale=0.5,
         rand_mirror=True, seed=11),
    dict(max_rotate_angle=25, max_shear_ratio=0.2, fill_value=17, seed=2),
    dict(rotate_list="90,180,270", rand_crop=True, seed=4),
    dict(rotate=30, mirror=True),
    dict(min_random_scale=0.8, max_random_scale=1.3, min_img_size=30,
         max_img_size=60, rand_crop=True, seed=9),
    dict(max_aspect_ratio=0.25, min_crop_size=20, max_crop_size=30,
         rand_crop=True, seed=6),
    dict(random_h=20, random_s=30, random_l=25, seed=8),
    dict(round_batch=False, batch_size=5),
    dict(batch_size=5, shuffle=True, seed=3),  # the last batch wraps: pad 4
    dict(num_parts=3, part_index=2, batch_size=3, shuffle=True, seed=1),
]
_FLOAT_ONLY = ("mean_r", "scale", "max_random_contrast",
               "max_random_illumination")


@pytest.mark.parametrize("case,layout,dtype", [
    (case, layout, dtype) for case in range(len(_GRID))
    for layout in ("NCHW", "NHWC") for dtype in ("float32", "uint8")
    # uint8 output refuses normalisation (the next test)
    if dtype == "float32" or not any(k in _GRID[case] for k in _FLOAT_ONLY)])
def test_image_record_iter_matches_jax(tmp_path, case, layout, dtype):
    """PNG records: the port's batches equal the JAX package's bit for bit,
    two epochs, over resize, random and centre crop, mirror, mean, scale,
    contrast, illumination, rotation, shear, random scale and size clamps,
    aspect and random-size crops, HSL jitter, round_batch and sharding."""
    kw = dict(_GRID[case])
    path = _record_file(tmp_path)
    kw = {"batch_size": 4, "data_shape": (3, 32, 32), "layout": layout,
          "output_dtype": dtype, "prefetch_buffer": 2, **kw}
    jit, tit = (jio.ImageRecordIter(path_imgrec=path, **kw),
                tio.ImageRecordIter(path_imgrec=path, **kw))
    assert jit.provide_data == tit.provide_data
    assert jit.provide_label == tit.provide_label
    for _ in range(2):
        _assert_same(_batches(jit), _batches(tit))


def test_image_record_iter_uint8_refuses_normalisation(tmp_path):
    path = _record_file(tmp_path, n=4)
    for kw in (dict(mean_r=1.0), dict(scale=0.5), dict(max_random_contrast=0.1)):
        for mod in (jio, tio):
            with pytest.raises(Exception, match="raw pixels"):
                mod.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                                    batch_size=4, output_dtype="uint8", **kw)


def test_image_record_iter_mean_image_and_label_vectors(tmp_path):
    """The mean image computed over every record, cached in the NDArray
    format that either package loads, and label vectors."""
    path = _record_file(tmp_path, label_width=3)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
              label_width=3, resize=36, rand_crop=True, seed=3)
    jmean, tmean = str(tmp_path / "j.mean"), str(tmp_path / "t.mean")
    jit = jio.ImageRecordIter(mean_img=jmean, **kw)
    tit = tio.ImageRecordIter(mean_img=tmean, **kw)
    assert os.path.exists(jmean) and os.path.exists(tmean)
    np.testing.assert_array_equal(tit._mean, jit._mean)
    _assert_same(_batches(jit), _batches(tit))
    # each loads the other's cache
    _assert_same(_batches(jio.ImageRecordIter(mean_img=tmean, **kw)),
                 _batches(tio.ImageRecordIter(mean_img=jmean, **kw)))


def test_image_record_iter_waits_for_worker_zeros_mean(tmp_path, monkeypatch):
    """part_index > 0 waits for worker 0's cache; without one, or a marker,
    past the grace period it computes the mean itself."""
    path = _record_file(tmp_path, n=6)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=3,
              num_parts=2, part_index=1)
    mean = str(tmp_path / "m.mean")
    monkeypatch.setenv("MXNET_TPU_MEAN_WAIT_SEC", "0.2")
    it = tio.ImageRecordIter(mean_img=mean, **kw)
    ref = tio.ImageRecordIter(mean_img=str(tmp_path / "r.mean"),
                              path_imgrec=path, data_shape=(3, 32, 32),
                              batch_size=3)
    np.testing.assert_array_equal(it._mean, ref._mean)


def test_jpeg_records_through_pil_and_raise_without_it(tmp_path, monkeypatch):
    """JPEG records (the JAX package's) decode through PIL as its Python
    path does; with PIL hidden (where the port used to raise) its Python
    path decodes them with the native codec to the same batches."""
    path = _record_file(tmp_path, fmt=".jpg")
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
              resize=36, rand_crop=True, rand_mirror=True, seed=1)
    want = _batches(jio.ImageRecordIter(**kw))
    _assert_same(want, _batches(tio.ImageRecordIter(**kw)))
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    it = tio.ImageRecordIter(**kw)
    assert it._native is None  # MXNET_TPU_NATIVE_IO=0: the Python path
    _assert_same(want, _batches(it))


def test_image_record_iter_rejects_unknown_and_tolerates_reference_flags(
        tmp_path):
    path = _record_file(tmp_path, n=4)
    with pytest.raises(MXNetError, match="unknown parameter"):
        tio.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                            batch_size=4, bogus=1)
    with pytest.warns(UserWarning, match="verbose"):
        tio.ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                            batch_size=4, verbose=True)


def test_data_batch_num_valid():
    b = tio.DataBatch([torch.zeros(8, 3)], [], pad=3)
    assert b.num_valid == 5 and tio.DataBatch([], []).num_valid == 0


def test_uris_local_file_and_remote(tmp_path):
    """Plain paths and file:// open locally; other schemes go through
    fsspec (a RecordIO over its memory filesystem reads back as the JAX
    package's does); an unknown scheme raises naming the driver."""
    from mxnet_tpu import filesystem as jfs
    from mxnet_tpu_torch import filesystem as tfs

    for uri in ("a/b.rec", "file:///x", "s3://b/k", "memory://m"):
        assert tfs.is_remote_uri(uri) == jfs.is_remote_uri(uri)
    local = tmp_path / "x.bin"
    local.write_bytes(b"abc")
    with tfs.open_uri(f"file://{local}") as f:
        assert f.read() == b"abc"
    uri = "memory://torch_io/records.rec"
    with trio.MXRecordIO(uri, "w") as w:
        for i in range(5):
            w.write(trio.pack(trio.IRHeader(0, float(i), i, 0), b"z" * i))
    assert trio.scan_offsets(uri) == jrio.scan_offsets(uri)
    r = jrio.MXRecordIO(uri, "r")
    assert [jrio.unpack(r.read())[1] for _ in range(5)] == \
        [b"z" * i for i in range(5)]
    with pytest.raises(MXNetError, match="cannot open"):
        tfs.open_uri("nosuchscheme-xyz://bucket/key")
