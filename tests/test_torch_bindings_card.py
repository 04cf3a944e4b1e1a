"""The bindings on the card (``-m cuda``; skipped without a card): phase
12b of ``chip_smoke.py`` at a small size, through its helpers.

- The flat C API on dev_type 2: a narrow ResNet (32x32, batch 4) trained 3
  steps through ``MX*`` calls, bitwise equal to the port's Python
  ``Executor`` on gpu(0) (TF32 off, cuDNN deterministic); its arrays report
  (2, 0); the stale-handle fault reads above ``CAPI_BOUND``.
- A KVStore whose C updater calls back into ``MX*`` on card arrays.
- ``MXNDArrayGetData`` of a card array: a host copy, whose writes do not
  reach the card.
- The embedded host on dev_type 2: exit 0 and the losses of the same
  sequence run hosted under the package's default precision.
- A bundle the card's ``Predictor`` exported, through the native
  predictor, the amalgamated build and the standalone module: bitwise
  equal to each other and within the JAX tests' tolerance of the card.

Run on the card with
``python3 -m pytest tests/test_torch_bindings_card.py -m cuda -q``.
"""

import ctypes
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.bindings import amalgamation  # noqa: E402
from mxnet_tpu_torch.convert import random_params  # noqa: E402
from mxnet_tpu_torch.models.resnet import resnet  # noqa: E402
from mxnet_tpu_torch.native import capi  # noqa: E402
from mxnet_tpu_torch.native import predict as tnative  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def lib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return cs.capi_load(capi.build_capi())


@pytest.fixture
def highest():
    saved = mt.get_matmul_precision()
    mt.set_matmul_precision("highest")
    yield
    mt.set_matmul_precision(saved)


def _small_case(batch=4):
    net = resnet((1, 1, 1, 1), 1000, filter_list=(16, 32, 32, 64))
    shape = (batch, 3, 32, 32)
    args, aux = random_params(net, 0, data=shape)
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal(shape, np.float32),
                rng.integers(0, 1000, batch).astype(np.float32))
               for _ in range(cs.CAPI_STEPS)]
    return net, args, aux, batches


def test_capi_training_on_card_matches_executor(lib, highest):
    net, args, aux, batches = _small_case()
    with cs.cudnn_deterministic(torch):
        c_steps, _, contexts = cs.capi_resnet_run(torch, mt, lib, net, args,
                                                  aux, batches)
        py_steps, _ = cs.python_resnet_run(torch, mt, net, args, aux,
                                           batches)
        stale = cs.capi_resnet_run(torch, mt, lib, net, args, aux, batches,
                                   fault="stale")[0]
    err, _, bitwise = cs.capi_errors(c_steps, py_steps)
    assert err <= cs.CAPI_BOUND and bitwise, err
    assert contexts == {"argument": (2, 0), "output": (2, 0)}
    assert cs.capi_errors(stale, py_steps)[0] > cs.CAPI_BOUND


def test_kvstore_c_updater_on_card_arrays(lib):
    calls, pulled, ctx = cs.capi_kvstore_on_card(lib)
    assert calls == [(3, (2, 0), (2, 0))] and ctx == (2, 0)
    np.testing.assert_array_equal(
        pulled, np.full(4, np.float32(1) - np.float32(0.1) * np.float32(2)))


def test_get_data_of_a_card_array_is_a_host_copy(lib):
    values = np.arange(6, dtype=np.float32)
    h = cs.capi_array(lib, (6,), 2, values)
    p = ctypes.POINTER(ctypes.c_float)()
    cs.capi_check(lib, lib.MXNDArrayGetData(h, ctypes.byref(p)),
                  "MXNDArrayGetData")
    assert [p[i] for i in range(6)] == values.tolist()
    p[0] = 42.0  # reaches the mirror only
    np.testing.assert_array_equal(cs.capi_read(lib, h), values)
    cs.capi_free(lib, h)


def test_embedded_host_on_card(lib, tmp_path):
    host = cs.capi_host_build(capi.build_capi(), tmp_path / "host")
    saved = mt.get_matmul_precision()
    mt.set_matmul_precision("default")  # the host's fresh process's
    try:
        hosted = cs.capi_mlp(lib, 2, 5)
    finally:
        mt.set_matmul_precision(saved)
    rc, losses, _, err = cs.capi_host_run(host, 2, 5)
    assert rc == 0, err[-2000:]
    assert losses == hosted


def test_native_predictor_on_a_card_bundle(tmp_path, highest):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    net, args, aux, batches = _small_case(batch=1)
    pred = mt.Predictor(net, args, aux, ctx=mt.gpu(0), input_names=["data"])
    x = batches[0][0]
    pred.forward(data=x)
    card = pred.get_output(0)
    bundle = str(tmp_path / "small.mxtpu")
    pred.export(bundle)
    so = amalgamation.compile_check(amalgamation.amalgamate(
        output=str(tmp_path / "all.cc")))
    assert tnative.get_predict_lib() is not None
    routes = cs.native_predictions(bundle, so, x, 1)
    outs = [v[0] for v in routes.values()]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    np.testing.assert_allclose(outs[0], card, **cs.PREDICT_TOL)
