"""The port's flat C API (``mxnet_tpu_torch/native/mxtpu_capi.cc``, built
by ``native.capi.build_capi``) driven as an external binding would: through
ctypes with C types only. tests/test_c_api.py's eleven cases run against
the port's library (hosted here: it joins this interpreter); the MLP's
training sequence runs through both packages' libraries loaded in one
process, with the same seeded initial weights, and their losses agree; a
fresh process that loads only the port's library imports neither JAX nor
the JAX package; the embedded host ``tests/torch_capi_host.cc`` trains on
dev_type 1 and prints the losses the same sequence gives here; a card
request without CUDA returns -1 with an error that names CUDA.

The JAX package's library is built from its source into a temporary
directory with g++ (its Makefile's flags), so the tests write nothing under
``mxnet_tpu/``. A failed build fails the tests, which need g++, zlib and
libpython."""

import ctypes
import os
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.native import capi  # noqa: E402

mx_uint = ctypes.c_uint
NDHandle = ctypes.c_void_p


@pytest.fixture(scope="module")
def lib():
    return cs.capi_load(capi.build_capi())


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's C API library, built like its Makefile's ``capi``
    target, into a temporary directory."""
    so = tmp_path_factory.mktemp("jax_capi") / "libmxtpu_capi.so"
    libdir = sysconfig.get_config_var("LIBDIR")
    r = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
         "-o", str(so), os.path.join(ROOT, "mxnet_tpu", "native",
                                     "mxtpu_capi.cc"),
         "-I" + sysconfig.get_paths()["include"], f"-L{libdir}",
         f"-Wl,-rpath,{libdir}",
         "-lpython" + sysconfig.get_config_var("LDVERSION")],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return cs.capi_load(so)


def check(lib, rc):
    assert rc == 0, lib.MXGetLastError().decode()


def make_ndarray(lib, arr, dev_type=1):
    return cs.capi_array(lib, np.asarray(arr).shape, dev_type,
                         np.asarray(arr, np.float32))


def test_ndarray_roundtrip_slice_context(lib):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    h = make_ndarray(lib, a)
    assert np.array_equal(cs.capi_read(lib, h), a)

    sl = NDHandle()
    check(lib, lib.MXNDArraySlice(h, 1, 3, ctypes.byref(sl)))
    assert np.array_equal(cs.capi_read(lib, sl), a[1:3])
    assert cs.capi_context(lib, h) == (1, 0)
    pinned = make_ndarray(lib, a, dev_type=3)
    assert cs.capi_context(lib, pinned) == (3, 0)
    check(lib, lib.MXNDArrayFree(sl))
    check(lib, lib.MXNDArrayFree(h))
    check(lib, lib.MXNDArrayFree(pinned))


def test_ndarray_save_load(lib, tmp_path):
    f = str(tmp_path / "arrays.nd").encode()
    a = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    h = make_ndarray(lib, a)
    keys = (ctypes.c_char_p * 1)(b"w")
    check(lib, lib.MXNDArraySave(f, 1, (NDHandle * 1)(h), keys))

    n = mx_uint()
    arrs = ctypes.POINTER(NDHandle)()
    nn = mx_uint()
    names = ctypes.POINTER(ctypes.c_char_p)()
    check(lib, lib.MXNDArrayLoad(f, ctypes.byref(n), ctypes.byref(arrs),
                                 ctypes.byref(nn), ctypes.byref(names)))
    assert n.value == 1 and nn.value == 1
    assert names[0] == b"w"
    loaded = NDHandle(arrs[0])
    assert np.array_equal(cs.capi_read(lib, loaded), a)
    assert cs.capi_context(lib, loaded) == (1, 0)


def test_functions_list_and_invoke(lib, jax_lib):
    def listed(library):
        n = mx_uint()
        fns = ctypes.POINTER(ctypes.c_void_p)()
        check(library, library.MXListFunctions(ctypes.byref(n),
                                               ctypes.byref(fns)))
        out = []
        for i in range(n.value):
            name, desc = ctypes.c_char_p(), ctypes.c_char_p()
            nargs = mx_uint()
            an, at, ad = (ctypes.POINTER(ctypes.c_char_p)() for _ in range(3))
            check(library, library.MXFuncGetInfo(
                ctypes.c_void_p(fns[i]), ctypes.byref(name),
                ctypes.byref(desc), ctypes.byref(nargs), ctypes.byref(an),
                ctypes.byref(at), ctypes.byref(ad)))
            out.append(name.value)
        return out

    names = listed(lib)
    assert len(names) >= 18  # the reference registers 18 (ndarray.cc:601-652)
    assert names == listed(jax_lib)

    fh = cs.capi_function(lib, "_plus")
    nuse, nsc, nmut, mask = mx_uint(), mx_uint(), mx_uint(), ctypes.c_int()
    check(lib, lib.MXFuncDescribe(fh, ctypes.byref(nuse), ctypes.byref(nsc),
                                  ctypes.byref(nmut), ctypes.byref(mask)))
    assert (nuse.value, nsc.value, nmut.value) == (2, 0, 1)

    a = make_ndarray(lib, np.ones((2, 2)))
    b = make_ndarray(lib, np.full((2, 2), 3.0))
    out = make_ndarray(lib, np.zeros((2, 2)))
    check(lib, lib.MXFuncInvoke(fh, (NDHandle * 2)(a, b), None,
                                (NDHandle * 1)(out)))
    assert np.array_equal(cs.capi_read(lib, out), np.full((2, 2), 4.0))


def test_symbol_compose_infer_json(lib):
    sm = cs.capi_mlp_symbol(lib)
    n = mx_uint()
    names = ctypes.POINTER(ctypes.c_char_p)()
    check(lib, lib.MXSymbolListArguments(sm, ctypes.byref(n),
                                         ctypes.byref(names)))
    args = [names[i].decode() for i in range(n.value)]
    assert args == ["data", "fc1_weight", "fc1_bias", "fc2_weight",
                    "fc2_bias", "softmax_label"]

    js = ctypes.c_char_p()
    check(lib, lib.MXSymbolSaveToJSON(sm, ctypes.byref(js)))
    back = ctypes.c_void_p()
    check(lib, lib.MXSymbolCreateFromJSON(js.value, ctypes.byref(back)))

    keys = (ctypes.c_char_p * 1)(b"data")
    ind = (mx_uint * 2)(0, 2)
    shp = (mx_uint * 2)(5, 3)
    in_n, out_n, aux_n = mx_uint(), mx_uint(), mx_uint()
    in_nd, out_nd, aux_nd = (ctypes.POINTER(mx_uint)() for _ in range(3))
    in_d, out_d, aux_d = (ctypes.POINTER(ctypes.POINTER(mx_uint))()
                          for _ in range(3))
    comp = ctypes.c_int()
    check(lib, lib.MXSymbolInferShape(
        back, 1, keys, ind, shp, ctypes.byref(in_n), ctypes.byref(in_nd),
        ctypes.byref(in_d), ctypes.byref(out_n), ctypes.byref(out_nd),
        ctypes.byref(out_d), ctypes.byref(aux_n), ctypes.byref(aux_nd),
        ctypes.byref(aux_d), ctypes.byref(comp)))
    assert comp.value == 1
    assert [in_d[1][j] for j in range(in_nd[1])] == [4, 3]
    assert [out_d[0][j] for j in range(out_nd[0])] == [5, 2]


def _train_mlp(lib):
    """tests/test_c_api.py's training FFI sequence: bind with gradients,
    forward/backward, SGD in C caller space. Returns each epoch's accuracy
    and each batch's mean cross-entropy."""
    rng = np.random.RandomState(0)
    sm = cs.capi_mlp_symbol(lib)
    X = rng.randn(40, 3).astype(np.float32)
    w_true = rng.randn(3)
    y = (X @ w_true > 0).astype(np.float32)
    shapes = {"data": (8, 3), "fc1_weight": (4, 3), "fc1_bias": (4,),
              "fc2_weight": (2, 4), "fc2_bias": (2,), "softmax_label": (8,)}
    arg_names = list(shapes)
    args, grads = [], []
    for name in arg_names:
        init = (rng.randn(*shapes[name]) * 0.3).astype(np.float32) \
            if "weight" in name else np.zeros(shapes[name], np.float32)
        args.append(make_ndarray(lib, init))
        grads.append(None if name in ("data", "softmax_label")
                     else make_ndarray(lib, np.zeros(shapes[name])))
    ex = cs.capi_bind(lib, sm, 1, args, grads,
                      [0 if g is None else 1 for g in grads])
    accuracy, losses = [], []
    for _ in range(15):
        correct = 0
        for i in range(0, 40, 8):
            xb, yb = X[i:i + 8], y[i:i + 8]
            cs.capi_copy_in(lib, args[0], xb)
            cs.capi_copy_in(lib, args[5], yb)
            check(lib, lib.MXExecutorForward(ex, 1))
            prob = cs.capi_read(lib, cs.capi_outputs(lib, ex)[0])
            correct += int(np.sum(np.argmax(prob, 1) == yb))
            losses.append(float(-np.mean(np.log(
                prob[np.arange(8), yb.astype(int)].astype(np.float64)))))
            check(lib, lib.MXExecutorBackward(ex, 0, None))
            for j, g in enumerate(grads):
                if g is None:
                    continue
                w = cs.capi_read(lib, args[j])
                w2 = (w - 0.5 * cs.capi_read(lib, g) / 8).astype(np.float32)
                cs.capi_copy_in(lib, args[j], w2)
        accuracy.append(correct / 40.0)
    return accuracy, losses


def test_executor_trains_through_c_api(lib, jax_lib):
    """The training FFI through the port's library converges, and the same
    sequence through the JAX package's library, loaded in this process
    beside it, gives the same losses within 1e-5."""
    accuracy, losses = _train_mlp(lib)
    assert accuracy[-1] >= 0.9, f"C-API training failed to converge: {accuracy}"
    _, jax_losses = _train_mlp(jax_lib)
    np.testing.assert_allclose(losses, jax_losses, rtol=0, atol=1e-5)


def test_kvstore_with_c_updater(lib):
    updater_t = ctypes.CFUNCTYPE(None, ctypes.c_int, NDHandle, NDHandle,
                                 ctypes.c_void_p)
    calls = []

    @updater_t
    def sgd_updater(key, recv, local, _):
        # ctypes delivers handle params as bare ints: re-wrap as c_void_p
        # before passing back (else they truncate to 32-bit C ints)
        recv, local = NDHandle(recv), NDHandle(local)
        w2 = (cs.capi_read(lib, local) - 0.1 * cs.capi_read(lib, recv)
              ).astype(np.float32)
        cs.capi_copy_in(lib, local, w2)
        calls.append(key)

    kv = ctypes.c_void_p()
    check(lib, lib.MXKVStoreCreate(b"local", ctypes.byref(kv)))
    t = ctypes.c_char_p()
    check(lib, lib.MXKVStoreGetType(kv, ctypes.byref(t)))
    assert t.value == b"local"
    check(lib, lib.MXKVStoreSetUpdater(kv, sgd_updater, None))

    wh = make_ndarray(lib, np.ones((4,), np.float32))
    keys = (ctypes.c_int * 1)(3)
    check(lib, lib.MXKVStoreInit(kv, 1, keys, (NDHandle * 1)(wh)))
    gh = make_ndarray(lib, np.full((4,), 2.0, np.float32))
    check(lib, lib.MXKVStorePush(kv, 1, keys, (NDHandle * 1)(gh), 0))
    out = make_ndarray(lib, np.zeros((4,), np.float32))
    check(lib, lib.MXKVStorePull(kv, 1, keys, (NDHandle * 1)(out), 0))
    assert calls == [3]
    np.testing.assert_allclose(cs.capi_read(lib, out), 1.0 - 0.1 * 2.0,
                               rtol=1e-7)

    rank, size = ctypes.c_int(), ctypes.c_int()
    check(lib, lib.MXKVStoreGetRank(kv, ctypes.byref(rank)))
    check(lib, lib.MXKVStoreGetGroupSize(kv, ctypes.byref(size)))
    assert (rank.value, size.value) == (0, 1)


def test_data_iter_through_c_api(lib, tmp_path):
    from mxnet_tpu_torch import recordio as rio

    rec = str(tmp_path / "it.rec")
    w = ctypes.c_void_p()
    check(lib, lib.MXRecordIOWriterCreate(rec.encode(), ctypes.byref(w)))
    rng = np.random.RandomState(0)
    for i in range(24):
        img = rng.randint(0, 255, (12, 12, 3), np.uint8)
        payload = rio.pack_img(rio.IRHeader(0, float(i % 3), i, 0), img,
                               img_fmt=".jpg")
        check(lib, lib.MXRecordIOWriterWriteRecord(w, payload, len(payload)))
    check(lib, lib.MXRecordIOWriterFree(w))

    r = ctypes.c_void_p()
    check(lib, lib.MXRecordIOReaderCreate(rec.encode(), ctypes.byref(r)))
    buf = ctypes.c_char_p()
    size = ctypes.c_size_t()
    check(lib, lib.MXRecordIOReaderReadRecord(r, ctypes.byref(buf),
                                              ctypes.byref(size)))
    assert size.value > 0
    check(lib, lib.MXRecordIOReaderFree(r))

    n = mx_uint()
    creators = ctypes.POINTER(ctypes.c_void_p)()
    check(lib, lib.MXListDataIters(ctypes.byref(n), ctypes.byref(creators)))
    target = None
    for i in range(n.value):
        name, desc = ctypes.c_char_p(), ctypes.c_char_p()
        na = mx_uint()
        an, at, ad = (ctypes.POINTER(ctypes.c_char_p)() for _ in range(3))
        check(lib, lib.MXDataIterGetIterInfo(
            ctypes.c_void_p(creators[i]), ctypes.byref(name),
            ctypes.byref(desc), ctypes.byref(na), ctypes.byref(an),
            ctypes.byref(at), ctypes.byref(ad)))
        if name.value == b"ImageRecordIter":
            target = ctypes.c_void_p(creators[i])
    assert target is not None

    keys = [b"path_imgrec", b"data_shape", b"batch_size"]
    vals = [rec.encode(), b"(3, 10, 10)", b"8"]
    it = ctypes.c_void_p()
    check(lib, lib.MXDataIterCreateIter(
        target, len(keys), (ctypes.c_char_p * 3)(*keys),
        (ctypes.c_char_p * 3)(*vals), ctypes.byref(it)))

    total, batches = 0, 0
    has = ctypes.c_int(1)
    while True:
        check(lib, lib.MXDataIterNext(it, ctypes.byref(has)))
        if not has.value:
            break
        data_h, label_h = NDHandle(), NDHandle()
        check(lib, lib.MXDataIterGetData(it, ctypes.byref(data_h)))
        check(lib, lib.MXDataIterGetLabel(it, ctypes.byref(label_h)))
        assert cs.capi_read(lib, data_h).shape == (8, 3, 10, 10)
        assert cs.capi_read(lib, label_h).shape == (8,)
        assert cs.capi_context(lib, data_h) == (1, 0)
        pad = ctypes.c_int()
        check(lib, lib.MXDataIterGetPadNum(it, ctypes.byref(pad)))
        total += 8 - pad.value
        batches += 1
    assert total == 24 and batches == 3
    check(lib, lib.MXDataIterBeforeFirst(it))
    check(lib, lib.MXDataIterNext(it, ctypes.byref(has)))
    assert has.value == 1


def test_random_seed_and_error_path(lib):
    check(lib, lib.MXRandomSeed(7))
    h = ctypes.c_void_p()
    rc = lib.MXSymbolCreateFromJSON(b"{not json", ctypes.byref(h))
    assert rc == -1
    assert len(lib.MXGetLastError()) > 0


def test_ndarray_raw_bytes_roundtrip(lib):
    a = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    h = make_ndarray(lib, a)
    size = ctypes.c_size_t()
    buf = ctypes.POINTER(ctypes.c_char)()
    check(lib, lib.MXNDArraySaveRawBytes(h, ctypes.byref(size),
                                         ctypes.byref(buf)))
    assert size.value > a.nbytes
    raw = ctypes.string_at(buf, size.value)
    h2 = NDHandle()
    check(lib, lib.MXNDArrayLoadFromRawBytes(raw, len(raw),
                                             ctypes.byref(h2)))
    assert np.array_equal(cs.capi_read(lib, h2), a)
    assert cs.capi_context(lib, h2) == (1, 0)


def test_symbol_internals_and_output_slice(lib):
    sm = cs.capi_mlp_symbol(lib)
    internals = ctypes.c_void_p()
    check(lib, lib.MXSymbolGetInternals(sm, ctypes.byref(internals)))
    n = mx_uint()
    names = ctypes.POINTER(ctypes.c_char_p)()
    check(lib, lib.MXSymbolListOutputs(internals, ctypes.byref(n),
                                       ctypes.byref(names)))
    outs = [names[i].decode() for i in range(n.value)]
    assert "fc1_output" in outs
    head = ctypes.c_void_p()
    check(lib, lib.MXSymbolGetOutput(internals, outs.index("fc1_output"),
                                     ctypes.byref(head)))
    n2 = mx_uint()
    check(lib, lib.MXSymbolListOutputs(head, ctypes.byref(n2),
                                       ctypes.byref(names)))
    assert n2.value == 1 and names[0] == b"fc1_output"


def test_wait_and_shutdown_and_getdata(lib):
    a = make_ndarray(lib, np.arange(6, dtype=np.float32).reshape(2, 3))
    check(lib, lib.MXNDArrayWaitToRead(a))
    check(lib, lib.MXNDArrayWaitToWrite(a))
    check(lib, lib.MXNDArrayWaitAll())
    p = ctypes.POINTER(ctypes.c_float)()
    check(lib, lib.MXNDArrayGetData(a, ctypes.byref(p)))
    assert [p[i] for i in range(6)] == [0, 1, 2, 3, 4, 5]
    check(lib, lib.MXNotifyShutdown())  # no-op, must not invalidate state
    b = make_ndarray(lib, np.ones((2, 2)))
    assert np.array_equal(cs.capi_read(lib, b), np.ones((2, 2), np.float32))


# -- the port's own checks ------------------------------------------------------

def test_library_names_differ_from_the_jax_package(lib, jax_lib):
    path = capi.build_capi()
    assert path.name == "libmxtpu_torch_capi.so"
    out = subprocess.run(["readelf", "-d", str(path)], capture_output=True,
                         text=True).stdout
    assert "Library soname: [libmxtpu_torch_capi.so]" in out
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        assert "libpython" in out


def test_card_request_without_cuda_returns_minus_one(lib):
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA (the card's case is "
                    "tests/test_torch_bindings_card.py)")
    h = ctypes.c_void_p()
    rc = lib.MXNDArrayCreate((mx_uint * 2)(2, 3), 2, 2, 0, 0,
                             ctypes.byref(h))
    assert rc == -1
    assert "CUDA" in lib.MXGetLastError().decode()
    sm = cs.capi_mlp_symbol(lib)
    shapes = [(8, 3), (4, 3), (4,), (2, 4), (2,), (8,)]
    args = [make_ndarray(lib, np.zeros(s)) for s in shapes]
    ex = ctypes.c_void_p()
    rc = lib.MXExecutorBind(sm, 2, 0, 6, (NDHandle * 6)(*args),
                            (NDHandle * 6)(), (mx_uint * 6)(), 0, None,
                            ctypes.byref(ex))
    assert rc == -1 and "CUDA" in lib.MXGetLastError().decode()


def test_fresh_process_imports_no_jax():
    """A process that loads only the port's library and trains through it
    has imported neither jax nor the JAX package."""
    script = (
        "import sys, json\n"
        "import chip_smoke as cs\n"
        "from mxnet_tpu_torch.native import capi\n"
        "lib = cs.capi_load(capi.build_capi())\n"
        "losses = cs.capi_mlp(lib, 1, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu'))\n"
        "print(json.dumps({'losses': losses, 'bad': bad}))\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr[-2000:]
    import json

    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert len(out["losses"]) == 3


def test_embedded_host_matches_hosted_sequence(lib, tmp_path):
    """tests/torch_capi_host.cc embeds Python through the library, trains on
    dev_type 1, exits 0, and prints the losses the same sequence gives in
    this process."""
    host = cs.capi_host_build(capi.build_capi(), tmp_path / "host")
    rc, losses, _, err = cs.capi_host_run(host, 1, cs.CAPI_MLP_STEPS)
    assert rc == 0, err[-2000:]
    assert len(losses) == cs.CAPI_MLP_STEPS and losses[-1] < losses[0]
    assert losses == cs.capi_mlp(lib, 1, cs.CAPI_MLP_STEPS)
