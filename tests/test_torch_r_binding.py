"""The C side of the R binding, the port's copies: the predict shim
(``mxnet_tpu_torch/bindings/r/mxtpu_shim.cc`` compiled with the port's
``native/mxtpu_predict.cc``) and the training shim (``mxtpu_r_train.cc``
linked against the port's flat C API, ``libmxtpu_torch_capi.so``). Each is
driven through ctypes with R's ``.C`` convention (every argument a pointer),
as tests/test_r_binding.py drives the JAX package's shims, and each case
runs the same seeded inputs through the JAX package's shim too (built from
``R-package/src`` into a temporary directory, over the JAX package's C API
built there as well), both loaded in this process.

The R scripts run only where R is installed: the one case that needs
``Rscript`` (the JAX package's LeNet training demo, run over the port's
training shim) skips where it is absent, as the JAX package's demo test
does."""

import ctypes
import os
import shutil
import subprocess
import sysconfig

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.symbol as S
from mxnet_tpu import ndarray as jnd
from mxnet_tpu.predictor import Predictor as JPredictor
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.native import capi
from mxnet_tpu_torch.predictor import Predictor as TPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_R = os.path.join(ROOT, "mxnet_tpu_torch", "bindings", "r")
SHIMS = ("torch", "jax")


def _gxx(args, what):
    r = subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                        *args], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{what} build failed: {r.stderr[-2000:]}"


@pytest.fixture(scope="module")
def shims(tmp_path_factory):
    """{package: predict shim}: each shim compiled with its package's
    native predictor."""
    tmp = tmp_path_factory.mktemp("rshim")
    out = {}
    for package, shim_src, predict_src in (
            ("torch", os.path.join(PORT_R, "mxtpu_shim.cc"),
             os.path.join(ROOT, "mxnet_tpu_torch", "native",
                          "mxtpu_predict.cc")),
            ("jax", os.path.join(ROOT, "R-package", "src", "mxtpu_shim.cc"),
             os.path.join(ROOT, "mxnet_tpu", "native", "mxtpu_predict.cc"))):
        so = str(tmp / f"mxtpu_rshim_{package}.so")
        _gxx([shim_src, predict_src, "-lz", "-o", so], f"{package} shim")
        out[package] = ctypes.CDLL(so)
    return out


@pytest.fixture(scope="module")
def train_shims(tmp_path_factory):
    """{package: training shim}: the port's linked against the port's C API
    library, the JAX package's against the JAX package's C API, built in a
    temporary directory like its Makefile's ``capi`` target."""
    tmp = tmp_path_factory.mktemp("rtrain")
    lib = capi.build_capi()
    port = str(tmp / "libmxtpu_r_train_torch.so")
    _gxx([os.path.join(PORT_R, "mxtpu_r_train.cc"), "-o", port,
          f"-L{lib.parent}", "-lmxtpu_torch_capi",
          f"-Wl,-rpath,{lib.parent}"], "port training shim")
    libdir = sysconfig.get_config_var("LIBDIR")
    jdir = tmp / "jax"
    jdir.mkdir()
    _gxx([os.path.join(ROOT, "mxnet_tpu", "native", "mxtpu_capi.cc"),
          "-o", str(jdir / "libmxtpu_capi.so"),
          "-I" + sysconfig.get_paths()["include"], f"-L{libdir}",
          f"-Wl,-rpath,{libdir}",
          "-lpython" + sysconfig.get_config_var("LDVERSION")],
         "JAX C API")
    jshim = str(tmp / "libmxtpu_r_train_jax.so")
    _gxx([os.path.join(ROOT, "R-package", "src", "mxtpu_r_train.cc"), "-o",
          jshim, f"-L{jdir}", "-lmxtpu_capi", f"-Wl,-rpath,{jdir}"],
         "JAX training shim")
    return {"torch": ctypes.CDLL(port), "jax": ctypes.CDLL(jshim)}


def _int(v):
    return ctypes.byref(ctypes.c_int(v))


def _bundles(tmp_path, jsym, params, input_names=("data",)):
    """{package: bundle path}: ``jsym`` with ``params`` exported by each
    package's Predictor; also the port Predictor, for expected outputs."""
    t_pred = TPredictor(tsym.load_json(jsym.tojson()), params, {}, ctx=cpu(),
                        input_names=list(input_names))
    j_pred = JPredictor(jsym, {k: jnd.array(v) for k, v in params.items()},
                        {}, input_names=list(input_names))
    paths = {"torch": str(tmp_path / "torch.mxtpu"),
             "jax": str(tmp_path / "jax.mxtpu")}
    t_pred.export(paths["torch"])
    j_pred.export(paths["jax"])
    return paths, t_pred


def _predict_roundtrip(shim, bundle, inp):
    path = ctypes.c_char_p(bundle.encode())
    pid, status = ctypes.c_int(0), ctypes.c_int(0)
    shim.mxtpu_r_create(ctypes.byref(path), ctypes.byref(pid),
                        ctypes.byref(status))
    assert status.value == 0, status.value
    assert pid.value > 0
    data = inp.astype(np.float64)
    name = ctypes.c_char_p(b"data")
    shape = (ctypes.c_int * 2)(*inp.shape)
    shim.mxtpu_r_set_input(
        ctypes.byref(ctypes.c_int(pid.value)), ctypes.byref(name),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), shape,
        _int(2), ctypes.byref(status))
    assert status.value == 0
    shim.mxtpu_r_forward(ctypes.byref(ctypes.c_int(pid.value)),
                         ctypes.byref(status))
    assert status.value == 0
    n = ctypes.c_int(0)
    shim.mxtpu_r_num_outputs(ctypes.byref(ctypes.c_int(pid.value)),
                             ctypes.byref(n))
    assert n.value == 1
    ndim = ctypes.c_int(0)
    oshape = (ctypes.c_int * 8)()
    shim.mxtpu_r_output_shape(ctypes.byref(ctypes.c_int(pid.value)),
                              _int(0), ctypes.byref(ndim), oshape)
    assert ndim.value == 2
    out_shape = tuple(oshape[:2])
    out_buf = np.zeros(int(np.prod(out_shape)), np.float64)
    shim.mxtpu_r_get_output(
        ctypes.byref(ctypes.c_int(pid.value)), _int(0),
        out_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _int(out_buf.size), ctypes.byref(status))
    assert status.value == 0
    shim.mxtpu_r_free(ctypes.byref(ctypes.c_int(pid.value)))
    shim.mxtpu_r_forward(ctypes.byref(ctypes.c_int(pid.value)),
                         ctypes.byref(status))
    assert status.value == -2  # bad handle after free
    return out_buf.reshape(out_shape)


def test_r_shim_roundtrip(shims, tmp_path):
    jsym = S.SoftmaxOutput(S.FullyConnected(data=S.Variable("data"),
                                            num_hidden=3, name="fc"),
                           name="softmax")
    rng = np.random.RandomState(0)
    params = {"fc_weight": rng.randn(3, 5).astype(np.float32),
              "fc_bias": rng.randn(3).astype(np.float32)}
    inp = rng.randn(2, 5).astype(np.float32)
    bundles, t_pred = _bundles(tmp_path, jsym, params)
    t_pred.forward(data=inp)
    expected = t_pred.get_output(0)
    for source, bundle in bundles.items():
        got = {p: _predict_roundtrip(shims[p], bundle, inp) for p in SHIMS}
        np.testing.assert_array_equal(got["torch"], got["jax"])
        np.testing.assert_allclose(got["torch"], expected, atol=2e-4,
                                   rtol=1e-3, err_msg=source)


@pytest.mark.parametrize("package", SHIMS)
def test_r_shim_bad_bundle(shims, tmp_path, package):
    path = ctypes.c_char_p(str(tmp_path / "nope.mxtpu").encode())
    pid, status = ctypes.c_int(0), ctypes.c_int(0)
    shims[package].mxtpu_r_create(ctypes.byref(path), ctypes.byref(pid),
                                  ctypes.byref(status))
    assert status.value == -1
    buf = ctypes.create_string_buffer(512)
    msg = ctypes.cast(buf, ctypes.c_char_p)
    shims[package].mxtpu_r_last_error(ctypes.byref(msg), _int(512))
    assert buf.value


def _r_call(shim, pid, fn, *args):
    status = ctypes.c_int(0)
    getattr(shim, fn)(ctypes.byref(ctypes.c_int(pid)), *args,
                      ctypes.byref(status))
    assert status.value == 0, f"{fn} failed: {status.value}"


def _batched_predict(shim, bundle, X, batch=4, classes=10):
    """R's mx.pred.predict: batches over the leading dim, the tail padded,
    outputs de-padded and stacked."""
    path = ctypes.c_char_p(bundle.encode())
    pid, status = ctypes.c_int(0), ctypes.c_int(0)
    shim.mxtpu_r_create(ctypes.byref(path), ctypes.byref(pid),
                        ctypes.byref(status))
    assert status.value == 0
    outs, i = [], 0
    while i < len(X):
        take = min(batch, len(X) - i)
        chunk = X[i:i + take]
        if take < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - take,) + X.shape[1:], X.dtype)])
        data = chunk.astype(np.float64)
        name = ctypes.c_char_p(b"data")
        shape = (ctypes.c_int * 4)(*chunk.shape)
        _r_call(shim, pid.value, "mxtpu_r_set_input", ctypes.byref(name),
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), shape,
                _int(4))
        _r_call(shim, pid.value, "mxtpu_r_forward")
        buf = np.zeros(batch * classes, np.float64)
        _r_call(shim, pid.value, "mxtpu_r_get_output", _int(0),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                _int(batch * classes))
        outs.append(buf.reshape(batch, classes)[:take])
        i += take
    shim.mxtpu_r_free(ctypes.byref(ctypes.c_int(pid.value)))
    return np.concatenate(outs)


def test_r_shim_lenet_batched_predict(shims, tmp_path):
    net = S.Convolution(data=S.Variable("data"), kernel=(3, 3), pad=(1, 1),
                        num_filter=8, name="c1")
    net = S.Activation(data=net, act_type="relu", name="a1")
    net = S.Pooling(data=net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="p1")
    net = S.FullyConnected(data=S.Flatten(data=net, name="flat"),
                           num_hidden=10, name="fc")
    jsym = S.SoftmaxOutput(data=net, name="softmax")
    rng = np.random.RandomState(1)
    params = {
        "c1_weight": rng.randn(8, 1, 3, 3).astype(np.float32) * 0.3,
        "c1_bias": np.zeros(8, np.float32),
        "fc_weight": rng.randn(10, 8 * 4 * 4).astype(np.float32) * 0.1,
        "fc_bias": np.zeros(10, np.float32)}
    X = rng.randn(10, 1, 8, 8).astype(np.float32)  # 10 samples, batch 4
    bundles, t_pred = _bundles(tmp_path, jsym, params)
    t_pred.forward(data=X)
    expected = t_pred.get_output(0)
    got = {p: _batched_predict(shims[p], bundles["torch"], X) for p in SHIMS}
    np.testing.assert_array_equal(got["torch"], got["jax"])
    np.testing.assert_allclose(got["torch"], expected, atol=2e-4, rtol=1e-3)


# -- the training shim over the flat C API -------------------------------------

def _p_int(*vals):
    return (ctypes.c_int * len(vals))(*vals)


def _p_str(*strs):
    return (ctypes.c_char_p * len(strs))(*[s.encode() for s in strs])


def _st(lib, status):
    if status[0] != 0:
        buf = ctypes.create_string_buffer(2048)
        pbuf = ctypes.cast(
            ctypes.pointer(ctypes.c_char_p(ctypes.addressof(buf))),
            ctypes.POINTER(ctypes.c_char_p))
        lib.mxr_last_error(pbuf, _p_int(2048))
        raise AssertionError(buf.value.decode(errors="replace"))


class Shim:
    """The training shim's .C calls, one method each."""

    def __init__(self, lib):
        self.lib = lib

    def call(self, fn, *args):
        st = _p_int(1)
        getattr(self.lib, fn)(*args, st)
        _st(self.lib, st)

    def nd_create(self, shape):
        out = _p_int(0)
        self.call("mxr_nd_create", _p_int(*shape), _p_int(len(shape)), out)
        return out[0]

    def nd_set(self, h, arr):
        arr = np.ascontiguousarray(arr, np.float64).ravel()
        self.call("mxr_nd_set", _p_int(h),
                  arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  _p_int(arr.size))

    def nd_get(self, h, n):
        buf = np.empty(n, np.float64)
        self.call("mxr_nd_get", _p_int(h),
                  buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                  _p_int(n))
        return buf

    def func(self, name, use, scalars, mutate):
        sc = (ctypes.c_double * max(1, len(scalars)))(*scalars)
        self.call("mxr_func_invoke", _p_str(name), _p_int(len(use)),
                  _p_int(*(use or [0])), _p_int(len(scalars)), sc,
                  _p_int(1), _p_int(mutate))

    def sym_atomic(self, opname, **params):
        out = _p_int(0)
        self.call("mxr_sym_atomic", _p_str(opname), _p_int(len(params)),
                  _p_str(*params.keys()),
                  _p_str(*[str(v) for v in params.values()]), out)
        return out[0]

    def sym_compose(self, sym, name, **inputs):
        self.call("mxr_sym_compose", _p_int(sym), _p_str(name),
                  _p_int(len(inputs)), _p_str(*inputs.keys()),
                  _p_int(*inputs.values()))

    def sym_variable(self, name):
        out = _p_int(0)
        self.call("mxr_sym_variable", _p_str(name), out)
        return out[0]

    def string_out(self, fn, *args, size=1 << 14):
        buf = ctypes.create_string_buffer(size)
        pbuf = ctypes.cast(
            ctypes.pointer(ctypes.c_char_p(ctypes.addressof(buf))),
            ctypes.POINTER(ctypes.c_char_p))
        self.call(fn, *args, pbuf, _p_int(size))
        return buf.value.decode()

    def nd_load(self, fname):
        n_out, ids = _p_int(0), (ctypes.c_int * 16)()
        buf = ctypes.create_string_buffer(1 << 12)
        pbuf = ctypes.cast(
            ctypes.pointer(ctypes.c_char_p(ctypes.addressof(buf))),
            ctypes.POINTER(ctypes.c_char_p))
        self.call("mxr_nd_load", _p_str(fname), _p_int(16), n_out, ids,
                  pbuf, _p_int(1 << 12))
        names = buf.value.decode().split("\n")
        return {names[i]: ids[i] for i in range(n_out[0])}

    def bind(self, sym, args, grads, reqs):
        ex = _p_int(0)
        self.call("mxr_exec_bind", _p_int(sym), _p_int(len(args)),
                  _p_int(*args), _p_int(*grads), _p_int(*reqs), _p_int(0),
                  _p_int(0), ex)
        return ex

    def outputs(self, ex):
        outs, n = (ctypes.c_int * 64)(), _p_int(0)
        self.call("mxr_exec_outputs", ex, outs, n)
        return list(outs[:n[0]])


def _train_mlp(lib):
    """The R demo's MLP through the shim: arguments, shapes, bind, 12 epochs
    of SGD over 64 rows. Returns (argument names, shapes, every step's
    probabilities, the last epoch's accuracy)."""
    sh = Shim(lib)
    data = sh.sym_variable("data")
    fc1 = sh.sym_atomic("FullyConnected", num_hidden=8)
    sh.sym_compose(fc1, "fc1", data=data)
    act = sh.sym_atomic("Activation", act_type="relu")
    sh.sym_compose(act, "relu1", data=fc1)
    fc2 = sh.sym_atomic("FullyConnected", num_hidden=2)
    sh.sym_compose(fc2, "fc2", data=act)
    sm = sh.sym_atomic("SoftmaxOutput")
    sh.sym_compose(sm, "softmax", data=fc2)
    arg_names = sh.string_out("mxr_sym_arguments", _p_int(sm)).split("\n")

    max_args = 256
    n_args, n_aux = _p_int(0), _p_int(0)
    arg_ndims = (ctypes.c_int * max_args)()
    arg_shapes = (ctypes.c_int * (max_args * 8))()
    aux_ndims = (ctypes.c_int * max_args)()
    aux_shapes = (ctypes.c_int * (max_args * 8))()
    sh.call("mxr_sym_infer_shapes", _p_int(sm), _p_str("data"),
            _p_int(16, 4), _p_int(2), _p_int(max_args), n_args, arg_ndims,
            arg_shapes, n_aux, aux_ndims, aux_shapes)
    shapes = [[arg_shapes[i * 8 + j] for j in range(arg_ndims[i])]
              for i in range(n_args[0])]

    rng = np.random.RandomState(0)
    X = rng.randn(64, 4)
    y = (X @ rng.randn(4) > 0).astype(np.float64)
    args, grads, reqs = [], [], []
    for i, name in enumerate(arg_names):
        args.append(sh.nd_create(shapes[i]))
        if name == "data" or "label" in name:
            grads.append(0)
            reqs.append(0)
        else:
            grads.append(sh.nd_create(shapes[i]))
            reqs.append(1)
            sh.nd_set(args[i], rng.randn(*shapes[i]) * 0.3
                      if "weight" in name else np.zeros(shapes[i]))
    ex = sh.bind(sm, args, grads, reqs)
    probs, acc = [], 0.0
    for _ in range(12):
        correct = 0
        for s in range(0, 64, 16):
            xb, yb = X[s:s + 16], y[s:s + 16]
            sh.nd_set(args[0], xb)
            sh.nd_set(args[5], yb)
            sh.call("mxr_exec_forward", ex, _p_int(1))
            prob = sh.nd_get(sh.outputs(ex)[0], 32).reshape(16, 2)
            probs.append(prob)
            correct += int(np.sum(np.argmax(prob, 1) == yb))
            sh.call("mxr_exec_backward", ex)
            for i in range(len(arg_names)):
                if reqs[i]:
                    n = int(np.prod(shapes[i]))
                    sh.nd_set(args[i], sh.nd_get(args[i], n)
                              - 0.5 * sh.nd_get(grads[i], n) / 16)
        acc = correct / 64.0
    return arg_names, shapes, np.stack(probs), acc


def test_r_train_shim_trains_mlp(train_shims):
    got = {p: _train_mlp(train_shims[p]) for p in SHIMS}
    names, shapes, probs, acc = got["torch"]
    assert names == ["data", "fc1_weight", "fc1_bias", "fc2_weight",
                     "fc2_bias", "softmax_label"]
    assert len(shapes) == 6 and shapes[1] == [8, 4]
    assert acc >= 0.9, f"R train shim failed to converge: {acc}"
    assert (names, shapes) == got["jax"][:2]
    np.testing.assert_allclose(probs, got["jax"][2], rtol=0, atol=1e-5)


def test_r_train_demo_under_rscript(train_shims, tmp_path):
    """The JAX package's R layer and LeNet demo (R-package/R, demo), copied
    into a temporary R-package tree whose src/libmxtpu_r_train.so is the
    port's training shim. Skips where Rscript is absent."""
    if shutil.which("Rscript") is None:
        pytest.skip("Rscript not installed in this image")
    tree = tmp_path / "R-package"
    for part in ("R", "demo"):
        shutil.copytree(os.path.join(ROOT, "R-package", part), tree / part)
    (tree / "src").mkdir()
    shutil.copy(train_shims["torch"]._name, tree / "src" /
                "libmxtpu_r_train.so")
    r = subprocess.run(["Rscript", str(tree / "demo" / "lenet_train.R")],
                       capture_output=True, text=True, timeout=1200,
                       env=capi.embedding_env(), cwd=str(tree))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "train accuracy" in (r.stdout + r.stderr)


def test_r_shim_nd_save_load_python_roundtrip(train_shims, tmp_path):
    """mx.model.save writes the container both packages' nd.load read, and
    the shim loads what either package's nd.save writes."""
    rng = np.random.RandomState(3)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    for package in SHIMS:
        sh = Shim(train_shims[package])
        hw, hb = sh.nd_create([4, 3]), sh.nd_create([3])
        sh.nd_set(hw, w)
        sh.nd_set(hb, b)
        fname = str(tmp_path / f"rsave-{package}.params")
        sh.call("mxr_nd_save", _p_str(fname), _p_int(2), _p_int(hw, hb),
                _p_str("arg:fc_weight", "arg:fc_bias"))
        for load in (tnd.load, lambda f: {k: v.asnumpy() for k, v in
                                          jnd.load(f).items()}):
            loaded = load(fname)
            assert set(loaded) == {"arg:fc_weight", "arg:fc_bias"}
            np.testing.assert_array_equal(np.asarray(loaded["arg:fc_weight"]), w)
            np.testing.assert_array_equal(np.asarray(loaded["arg:fc_bias"]), b)
        for writer in ("torch", "jax"):
            fname2 = str(tmp_path / f"{writer}-{package}.params")
            if writer == "torch":
                tnd.save(fname2, {"aux:mean": w, "arg:scale": b})
            else:
                jnd.save(fname2, {"aux:mean": jnd.array(w),
                                  "arg:scale": jnd.array(b)})
            by_name = sh.nd_load(fname2)
            np.testing.assert_array_equal(
                sh.nd_get(by_name["aux:mean"], 12).reshape(4, 3), w)
            np.testing.assert_array_equal(sh.nd_get(by_name["arg:scale"], 3),
                                          b)


def _momentum_sequence(lib):
    sh = Shim(lib)
    rng = np.random.RandomState(7)
    w, g = rng.randn(6), rng.randn(6)
    hw, hg = sh.nd_create([6]), sh.nd_create([6])
    hmom, hscratch = sh.nd_create([6]), sh.nd_create([6])
    sh.nd_set(hw, w)
    sh.nd_set(hg, g)
    sh.nd_set(hmom, np.zeros(6))
    for _ in range(3):
        sh.func("_mul_scalar", [hg], [1 / 16.0], hscratch)
        sh.func("_mul_scalar", [hscratch], [0.5], hscratch)
        sh.func("_mul_scalar", [hmom], [0.9], hmom)
        sh.func("_minus", [hmom, hscratch], [], hmom)
        sh.func("_plus", [hw, hmom], [], hw)
    sh.func("_set_value", [], [0.0], hscratch)
    return sh.nd_get(hw, 6), sh.nd_get(hmom, 6), sh.nd_get(hscratch, 6), w, g


def test_r_shim_func_invoke_optimizer_math(train_shims):
    """optimizer.R's SGD momentum through MXFuncInvoke: the numpy closed
    form, and the JAX package's shim exactly."""
    got = {p: _momentum_sequence(train_shims[p]) for p in SHIMS}
    hw, hmom, scratch, w, g = got["torch"]
    mom = np.zeros(6)
    for _ in range(3):
        mom = 0.9 * mom - 0.5 * (g / 16.0)
        w = w + mom
    np.testing.assert_allclose(hw, w, atol=1e-5)
    np.testing.assert_allclose(hmom, mom, atol=1e-5)
    np.testing.assert_array_equal(scratch, np.zeros(6))
    for a, b in zip(got["torch"][:3], got["jax"][:3]):
        np.testing.assert_array_equal(a, b)


def _kvstore_sequence(lib):
    sh = Shim(lib)
    kv = _p_int(0)
    sh.call("mxr_kv_create", _p_str("local"), kv)
    h0 = sh.nd_create([4])
    sh.nd_set(h0, np.arange(4.0))
    sh.call("mxr_kv_init", _p_int(kv[0]), _p_int(1), _p_int(3), _p_int(h0))
    ha, hb, hout = sh.nd_create([4]), sh.nd_create([4]), sh.nd_create([4])
    sh.nd_set(ha, np.ones(4))
    sh.nd_set(hb, 2 * np.ones(4))
    # one push with the key repeated: the C API groups and sums the group
    sh.call("mxr_kv_push", _p_int(kv[0]), _p_int(2), _p_int(3, 3),
            _p_int(ha, hb), _p_int(0))
    sh.call("mxr_kv_pull", _p_int(kv[0]), _p_int(1), _p_int(3), _p_int(hout),
            _p_int(0))
    rank, size = _p_int(-1), _p_int(-1)
    sh.call("mxr_kv_rank", _p_int(kv[0]), rank)
    sh.call("mxr_kv_size", _p_int(kv[0]), size)
    sh.call("mxr_kv_barrier", _p_int(kv[0]))
    sh.call("mxr_kv_free", _p_int(kv[0]))
    return sh.nd_get(hout, 4), rank[0], size[0]


def test_r_shim_kvstore(train_shims):
    got = {p: _kvstore_sequence(train_shims[p]) for p in SHIMS}
    pulled, rank, size = got["torch"]
    np.testing.assert_array_equal(pulled, 3 * np.ones(4))
    assert (rank, size) == (0, 1)
    np.testing.assert_array_equal(pulled, got["jax"][0])
    assert got["jax"][1:] == (0, 1)


def _load_bind_predict(lib, tmp_path, X):
    """R's mx.model.load -> mx.model.bind -> mx.model.predict on a
    checkpoint the JAX package's Python layer wrote."""
    sh = Shim(lib)
    with open(str(tmp_path / "m-symbol.json")) as f:
        js = f.read()
    sym_id = _p_int(0)
    sh.call("mxr_sym_fromjson", _p_str(js), sym_id)
    by_name = sh.nd_load(str(tmp_path / "m-0001.params"))
    h_data, h_label = sh.nd_create([4, 5]), sh.nd_create([4])
    ex = sh.bind(sym_id[0], [h_data, by_name["arg:fc_weight"],
                             by_name["arg:fc_bias"], h_label],
                 [0, 0, 0, 0], [0, 0, 0, 0])
    sh.nd_set(h_data, X)
    sh.call("mxr_exec_forward", ex, _p_int(0))
    return sh.nd_get(sh.outputs(ex)[0], 12).reshape(4, 3)


def test_r_shim_load_bind_predict_sequence(train_shims, tmp_path):
    from mxnet_tpu.model import save_checkpoint

    rng = np.random.RandomState(9)
    net = S.SoftmaxOutput(S.FullyConnected(
        data=S.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    w = rng.randn(3, 5).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    save_checkpoint(str(tmp_path / "m"), 1, net,
                    {"fc_weight": mx.nd.array(w), "fc_bias": mx.nd.array(b)},
                    {})
    X = rng.randn(4, 5)
    got = {p: _load_bind_predict(train_shims[p], tmp_path, X) for p in SHIMS}
    logits = X.astype(np.float32) @ w.T + b
    e = np.exp(logits - logits.max(1, keepdims=True))
    np.testing.assert_allclose(got["torch"], e / e.sum(1, keepdims=True),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=0, atol=1e-6)


def _random_layer(lib):
    sh = Shim(lib)

    def seed(s):
        sh.call("mxr_random_seed", _p_int(s))

    h = sh.nd_create([64])
    seed(11)
    sh.func("_random_uniform", [], [0.0, 1.0], h)
    first = sh.nd_get(h, 64)
    sh.func("_random_uniform", [], [0.0, 1.0], h)
    second = sh.nd_get(h, 64)
    seed(11)
    sh.func("_random_uniform", [], [0.0, 1.0], h)
    replay = sh.nd_get(h, 64)
    hg = sh.nd_create([4096])
    seed(5)
    sh.func("_random_gaussian", [], [3.0, 0.5], hg)
    draw = sh.nd_get(hg, 4096)
    seed(6)
    sh.func("_random_uniform", [], [10.0, 12.0], h)
    return first, second, replay, draw, sh.nd_get(h, 64)


def test_r_shim_random_layer(train_shims):
    """random.R's route: seeded samplers through the shim, reproducible,
    in range and with the right moments, in both packages (which draw from
    different generators); the port's shim draws what the port's own
    generator draws, so its calls reach the port's library."""
    for package in SHIMS:
        first, second, replay, draw, bounded = _random_layer(
            train_shims[package])
        assert 0.0 <= first.min() and first.max() < 1.0
        assert not np.allclose(first, second)
        np.testing.assert_array_equal(replay, first)
        assert abs(draw.mean() - 3.0) < 0.05 and abs(draw.std() - 0.5) < 0.05
        assert 10.0 <= bounded.min() and bounded.max() < 12.0
    first = _random_layer(train_shims["torch"])[0]
    trandom.seed(11)
    mine = trandom.uniform(0.0, 1.0, (64,), ctx=cpu()).asnumpy()
    np.testing.assert_array_equal(first, mine.astype(np.float64))


def _math_surface(lib, a, b, c):
    sh = Shim(lib)
    ha, hb, hout = sh.nd_create([3, 4]), sh.nd_create([3, 4]), \
        sh.nd_create([3, 4])
    sh.nd_set(ha, a)
    sh.nd_set(hb, b)
    out = {}
    for fname in ("_plus", "_minus", "_mul", "_div"):
        sh.func(fname, [ha, hb], [], hout)
        out[fname] = sh.nd_get(hout, 12).reshape(3, 4)
    for fname in ("_plus_scalar", "_minus_scalar", "_mul_scalar",
                  "_div_scalar", "_rminus_scalar", "_rdiv_scalar"):
        sh.func(fname, [ha], [2.5], hout)
        out[fname] = sh.nd_get(hout, 12).reshape(3, 4)
    sh.func("clip", [ha], [0.6, 1.1], hout)
    out["clip"] = sh.nd_get(hout, 12).reshape(3, 4)
    for fname in ("square", "sqrt", "exp", "log"):
        sh.func(fname, [ha], [], hout)
        out[fname] = sh.nd_get(hout, 12).reshape(3, 4)
    hn = sh.nd_create([1])
    sh.func("norm", [ha], [], hn)
    out["norm"] = sh.nd_get(hn, 1)
    hc, hd = sh.nd_create([4, 2]), sh.nd_create([3, 2])
    sh.nd_set(hc, c)
    sh.func("dot", [ha, hc], [], hd)
    out["dot"] = sh.nd_get(hd, 6).reshape(3, 2)
    return out


def test_r_shim_ndarray_math_surface(train_shims):
    """ndarray.R's Ops and math helpers against numpy, and each result
    within 1e-6 of the JAX package's shim."""
    rng = np.random.RandomState(2)
    a, b, c = rng.rand(3, 4) + 0.5, rng.rand(3, 4) + 0.5, rng.rand(4, 2)
    got = {p: _math_surface(train_shims[p], a, b, c) for p in SHIMS}
    a32, b32, c32 = (x.astype(np.float32).astype(np.float64)
                     for x in (a, b, c))
    want = {"_plus": a32 + b32, "_minus": a32 - b32, "_mul": a32 * b32,
            "_div": a32 / b32, "_plus_scalar": a32 + 2.5,
            "_minus_scalar": a32 - 2.5, "_mul_scalar": a32 * 2.5,
            "_div_scalar": a32 / 2.5, "_rminus_scalar": 2.5 - a32,
            "_rdiv_scalar": 2.5 / a32, "clip": np.clip(a32, 0.6, 1.1),
            "square": a32 * a32, "sqrt": np.sqrt(a32), "exp": np.exp(a32),
            "log": np.log(a32), "norm": [np.linalg.norm(a32)],
            "dot": a32 @ c32}
    for name, ref in want.items():
        np.testing.assert_allclose(got["torch"][name], ref, rtol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got["torch"][name], got["jax"][name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_port_shim_binds_the_port_library(train_shims):
    """Both C API libraries are loaded in this process; the port's shim
    resolves its MX* calls to libmxtpu_torch_capi.so (its DT_NEEDED) and
    the JAX package's to libmxtpu_capi.so."""
    for package, want, other in (("torch", "libmxtpu_torch_capi.so",
                                  "libmxtpu_capi.so"),
                                 ("jax", "libmxtpu_capi.so",
                                  "libmxtpu_torch_capi.so")):
        out = subprocess.run(["readelf", "-d", train_shims[package]._name],
                             capture_output=True, text=True).stdout
        assert f"[{want}]" in out and f"[{other}]" not in out
    maps = open(f"/proc/{os.getpid()}/maps").read()
    assert "libmxtpu_torch_capi.so" in maps and "libmxtpu_capi.so" in maps
