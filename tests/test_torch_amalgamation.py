"""The port's amalgamation (``mxnet_tpu_torch/bindings/amalgamation.py``):
the native predictor as one C++ file, compiled fresh, running a bundle the
port's ``Predictor`` exported. Held to tests/test_amalgamation.py's
tolerances against the ``Predictor``, and bitwise to the port's native
predictor library and to the JAX package's amalgamated predictor on the
same bundle (``amalgamation/amalgamation.py`` of the JAX package's source,
written into a temporary directory)."""

import os
import subprocess
import sys

import numpy as np

from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.bindings import amalgamation
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.native import predict as tnative
from mxnet_tpu_torch.predictor import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from amalgamation import amalgamation as jamalgamation  # noqa: E402


def _compile(src, so):
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", src,
                    "-lz", "-o", so], check=True, timeout=600)
    return tnative.load_lib(so)


def test_amalgamated_predictor_roundtrip(tmp_path):
    src = amalgamation.amalgamate(output=str(tmp_path / "mxtpu_predict-all.cc"))
    text = open(src).read()
    assert "mxtpu_pred_create" in text
    assert '#include "' not in text  # fully inlined
    assert "mxnet_tpu_torch/native/mxtpu_predict.cc" in text
    lib = _compile(src, str(tmp_path / "libamalg.so"))

    x = tsym.Variable("data")
    h = tsym.Activation(tsym.FullyConnected(data=x, num_hidden=16,
                                            name="fc1"), act_type="relu")
    out = tsym.SoftmaxOutput(tsym.FullyConnected(data=h, num_hidden=4,
                                                 name="fc2"), name="softmax")
    rng = np.random.RandomState(0)
    params = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in [("fc1_weight", (16, 8)), ("fc1_bias", (16,)),
                           ("fc2_weight", (4, 16)), ("fc2_bias", (4,))]}
    pred = Predictor(out, params, {}, ctx=cpu(), input_names=["data"])
    inp = rng.randn(3, 8).astype(np.float32)
    pred.forward(data=inp)
    expected = pred.get_output(0)
    bundle = str(tmp_path / "m.mxtpu")
    pred.export(bundle)

    got = {}
    for route, route_lib in (
            ("amalgamated", lib), ("native", None),
            ("jax_amalgamated", _compile(
                jamalgamation.amalgamate(
                    output=str(tmp_path / "jax-all.cc")),
                str(tmp_path / "libjaxamalg.so")))):
        npred = tnative.NativePredictor(bundle, lib=route_lib)
        npred.forward(data=inp)
        got[route] = npred.get_output(0)
    np.testing.assert_allclose(got["amalgamated"], expected, atol=2e-4,
                               rtol=1e-3)
    np.testing.assert_array_equal(got["amalgamated"], got["native"])
    np.testing.assert_array_equal(got["amalgamated"], got["jax_amalgamated"])


def test_defaults_are_the_port_source_and_build_dir():
    assert amalgamation.DEFAULT_SOURCE == os.path.join(
        ROOT, "mxnet_tpu_torch", "native", "mxtpu_predict.cc")
    assert amalgamation.DEFAULT_OUTPUT == os.path.join(
        ROOT, "build", "mxnet_tpu_torch", "mxtpu_predict-all.cc")


def test_cli_writes_and_compiles(tmp_path):
    out = str(tmp_path / "cli-all.cc")
    r = subprocess.run([sys.executable, "-m",
                        "mxnet_tpu_torch.bindings.amalgamation", "-o", out,
                        "--compile"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"wrote {out}" in r.stdout and "built " in r.stdout
    lib = tnative.load_lib(out.replace(".cc", ".so"))
    assert lib.mxtpu_pred_create(b"/nonexistent.mxtpu") is None
    assert b"" != lib.mxtpu_pred_last_error()
