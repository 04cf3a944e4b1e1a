"""The port's native C++ predictor (``native/mxtpu_predict.cc`` through
``native.predict``) on exported bundles: tests/test_native_predict.py's
bundles, each built once in the JAX package and carried to the port by its
JSON, with the same seeded parameters. Each bundle is exported by both
packages' ``Predictor``; the port's native predictor on the port's bundle
agrees with the port's ``Predictor`` within the JAX file's tolerances, and
on either package's bundle it is bitwise equal to the JAX package's native
predictor on that bundle. The JAX package's predictor library is built from
its source into a temporary directory (its Makefile's flags), so nothing is
written under ``mxnet_tpu/``."""

import ast
import importlib.util
import os
import subprocess

import numpy as np
import pytest

import mxnet_tpu.symbol as S
from mxnet_tpu import ndarray as jnd
from mxnet_tpu.native import predict as jnative
from mxnet_tpu.predictor import Predictor as JPredictor
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.native import predict as tnative
from mxnet_tpu_torch.predictor import Predictor as TPredictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_predict_lib(tmp_path_factory):
    so = tmp_path_factory.mktemp("jax_predict") / "libmxtpu_predict.so"
    r = subprocess.run(
        ["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
         "-o", str(so), os.path.join(ROOT, "mxnet_tpu", "native",
                                     "mxtpu_predict.cc"), "-lz"],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return jnative.load_lib(str(so))


def _random_params(sym, input_shapes):
    """tests/test_native_predict.py's draw: numpy arrays by name."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**input_shapes)
    rng = np.random.RandomState(7)
    params, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in input_shapes or name.endswith("_label"):
            continue
        params[name] = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        if name.endswith("moving_var"):
            aux[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            aux[name] = rng.uniform(-0.1, 0.1, shape).astype(np.float32)
    return params, aux


def _mlp():
    x = S.Variable("data")
    h = S.FullyConnected(data=x, num_hidden=32, name="fc1")
    h = S.Activation(data=h, act_type="relu", name="relu1")
    h = S.FullyConnected(data=h, num_hidden=10, name="fc2")
    return S.SoftmaxOutput(data=h, name="softmax"), {"data": (4, 20)}


def _lenet():
    from mxnet_tpu.models import lenet

    return lenet(), {"data": (2, 1, 28, 28)}


def _conv_bn_concat_slice():
    x = S.Variable("data")
    c1 = S.Convolution(data=x, kernel=(3, 3), pad=(1, 1), num_filter=8,
                       name="c1")
    b1 = S.BatchNorm(data=c1, name="bn1")
    a1 = S.Activation(data=b1, act_type="tanh", name="t1")
    c2 = S.Convolution(data=x, kernel=(1, 1), num_filter=8, num_group=2,
                       name="c2")
    cat = S.Concat(a1, c2, name="cat")
    parts = S.SliceChannel(data=cat, num_outputs=2, name="slice")
    merged = parts[0] + parts[1]
    pool = S.Pooling(data=merged, kernel=(2, 2), stride=(2, 2),
                     pool_type="avg", name="pool")
    lrn = S.LRN(data=pool, nsize=3, name="lrn")
    flat = S.Flatten(data=lrn, name="flat")
    return S.LogisticRegressionOutput(data=flat, name="out"), \
        {"data": (2, 4, 8, 8)}


def _leakyrelu_elementwise():
    x = S.Variable("data")
    l1 = S.LeakyReLU(data=x, act_type="leaky", slope=0.1, name="lk")
    l2 = S.LeakyReLU(data=x, act_type="elu", slope=0.3, name="elu")
    return S.LinearRegressionOutput(data=l1 * l2 - x, name="out"), \
        {"data": (3, 6)}


def _resnet_block():
    x = S.Variable("data")
    c = S.Convolution(data=x, kernel=(3, 3), pad=(1, 1), num_filter=4,
                      no_bias=True, name="conv1")
    b = S.BatchNorm(data=c, name="bn1")
    r = S.Activation(data=b, act_type="relu", name="relu1")
    pool = S.Pooling(data=r + x, kernel=(4, 4), global_pool=True,
                     pool_type="avg", name="gap")
    fc = S.FullyConnected(data=S.Flatten(data=pool, name="flat"),
                          num_hidden=5, name="fc")
    return S.SoftmaxOutput(data=fc, name="softmax"), {"data": (2, 4, 8, 8)}


def _unary_reshape_transpose():
    x = S.Variable("data")
    u = S.Sqrt(data=S.Square(data=x))
    u = S.Log(data=S.Exp(data=u))
    r = S.Reshape(data=u, target_shape=(0, 2, -1))
    t = S.Transpose(data=r, axes=(0, 2, 1))
    return S.LinearRegressionOutput(data=S.Flatten(data=t), name="out"), \
        {"data": (3, 8)}


def _fix_gamma_batchnorm():
    b = S.BatchNorm(data=S.Variable("data"), fix_gamma=True, name="bn")
    return S.LinearRegressionOutput(data=S.Flatten(data=b), name="out"), \
        {"data": (2, 3, 4, 4)}


def _embedding():
    emb = S.Embedding(data=S.Variable("data"), input_dim=11, output_dim=6,
                      name="emb")
    return S.LinearRegressionOutput(data=S.Flatten(data=emb), name="out"), \
        {"data": (2, 3)}


CASES = {"mlp": _mlp, "lenet": _lenet,
         "conv_bn_concat_slice": _conv_bn_concat_slice,
         "leakyrelu_elementwise": _leakyrelu_elementwise,
         "resnet_block": _resnet_block,
         "unary_reshape_transpose": _unary_reshape_transpose,
         "fix_gamma_batchnorm": _fix_gamma_batchnorm,
         "embedding": _embedding}


def _case(name):
    jsym, shapes = CASES[name]()
    if name == "embedding":
        params = {"emb_weight": np.random.RandomState(1).randn(11, 6)
                  .astype(np.float32)}
        aux = {}
        inputs = {"data": np.array([[0, 3, 10], [5, 1, 7]], np.float32)}
        return jsym, params, aux, inputs, dict(atol=1e-5, rtol=1e-7)
    params, aux = _random_params(jsym, shapes)
    if name == "fix_gamma_batchnorm":
        # gamma != 1 in the stored params must be ignored under fix_gamma
        params["bn_gamma"] = np.full((3,), 2.0, np.float32)
    rng = np.random.RandomState(5 if name == "fix_gamma_batchnorm" else 3)
    inputs = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    return jsym, params, aux, inputs, dict(atol=2e-4, rtol=1e-3)


def _outputs(pred, n):
    return [pred.get_output(i) for i in range(n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_bundle(name, tmp_path, jax_predict_lib):
    jsym, params, aux, inputs, tol = _case(name)
    n_out = len(jsym.list_outputs())
    t_pred = TPredictor(tsym.load_json(jsym.tojson()), params, aux, ctx=cpu(),
                        input_names=list(inputs))
    t_pred.forward(**inputs)
    expected = _outputs(t_pred, n_out)
    j_pred = JPredictor(jsym, {k: jnd.array(v) for k, v in params.items()},
                        {k: jnd.array(v) for k, v in aux.items()},
                        input_names=list(inputs))
    j_pred.forward(**inputs)
    for got, want in zip(expected, _outputs(j_pred, n_out)):
        np.testing.assert_allclose(got, want, **tol)

    bundles = {"torch": str(tmp_path / "torch.mxtpu"),
               "jax": str(tmp_path / "jax.mxtpu")}
    t_pred.export(bundles["torch"])
    j_pred.export(bundles["jax"])
    for source, bundle in bundles.items():
        ours = tnative.NativePredictor(bundle)
        ours.forward(**inputs)
        theirs = jnative.NativePredictor(bundle, lib=jax_predict_lib)
        theirs.forward(**inputs)
        assert ours.num_outputs == theirs.num_outputs == n_out
        for got, want, ref in zip(_outputs(ours, n_out),
                                  _outputs(theirs, n_out), expected):
            assert got.shape == ref.shape, (source, got.shape, ref.shape)
            np.testing.assert_array_equal(got, want, err_msg=source)
            np.testing.assert_allclose(got, ref, **tol, err_msg=source)


def test_error_reporting(tmp_path):
    with pytest.raises(RuntimeError, match="failed to load bundle"):
        tnative.NativePredictor(str(tmp_path / "missing.mxtpu"))
    bad = tmp_path / "bad.mxtpu"
    bad.write_bytes(b"not a zip")
    with pytest.raises(RuntimeError, match="failed to load bundle"):
        tnative.NativePredictor(str(bad))


def test_library_is_built_from_the_port_source():
    lib = tnative.get_predict_lib()
    assert lib is not None
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "mxnet_tpu_torch"
    assert path.name.startswith("libmxtpu_predict-")


def test_standalone_predict_python_module(tmp_path):
    """mxnet_tpu_torch/bindings/mxtpu_predict.py drives a bundle with no
    import of either package (loaded as a plain module file), finds the
    port's library in its build directory, and gives the native
    predictor's output bitwise."""
    mod_path = os.path.join(ROOT, "mxnet_tpu_torch", "bindings",
                            "mxtpu_predict.py")
    with open(mod_path) as f:
        tree = ast.parse(f.read())
    imported = {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module.split(".")[0] if node.level == 0 else "."
                 for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    assert imported <= {"__future__", "ctypes", "glob", "os", "numpy"}, \
        imported
    tnative.get_predict_lib()  # the library it finds in the build directory
    spec = importlib.util.spec_from_file_location("mxtpu_predict", mod_path)
    standalone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(standalone)
    assert any(p.endswith(tnative.library_path().name)
               for p in standalone.find_lib_path())

    rng = np.random.RandomState(5)
    jsym = S.SoftmaxOutput(S.FullyConnected(data=S.Variable("data"),
                                            num_hidden=4, name="fc"),
                           name="softmax")
    params = {"fc_weight": rng.randn(4, 6).astype(np.float32),
              "fc_bias": rng.randn(4).astype(np.float32)}
    pred = TPredictor(tsym.load_json(jsym.tojson()), params, {}, ctx=cpu(),
                      input_names=["data"])
    inp = rng.randn(3, 6).astype(np.float32)
    pred.forward(data=inp)
    expected = pred.get_output(0)
    bundle = str(tmp_path / "m.mxtpu")
    pred.export(bundle)

    outs = standalone.Predictor(bundle).predict({"data": inp})
    assert len(outs) == 1
    np.testing.assert_allclose(outs[0], expected, atol=2e-4, rtol=1e-3)
    native = tnative.NativePredictor(bundle)
    native.forward(data=inp)
    np.testing.assert_array_equal(outs[0], native.get_output(0))
