"""The port's Predictor against the JAX package's, from the same weights.

Weights come from a numpy seed (``convert.random_params``) and reach both
packages as the same numbers. Both run on the CPU; the JAX side runs compiled
with Pallas in interpret mode, as its own tests run it. TF32 is off on the
torch side.

Tolerances, on the softmax outputs: f32 differs only by summation order in
the convolutions and matmuls (XLA against oneDNN), so 1e-5. The int8 path adds
one effect: a pooled feature that lands on a rounding boundary may take the
neighbouring int8 code in one package, moving a logit by one quantization
step (1/127 of the row's largest feature times a weight), hence 1e-3.
"""

import numpy as np
import pytest
import torch

from mxnet_tpu import models as jmodels
from mxnet_tpu.predictor import Predictor as JaxPredictor
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_numpy, random_params
from mxnet_tpu_torch.kernels import int8_matmul as k8

torch.set_num_threads(2)
mt.set_matmul_precision("highest")

TOL = {None: dict(rtol=1e-4, atol=1e-5), "int8": dict(rtol=1e-3, atol=1e-3)}
NARROW = dict(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
              num_classes=10)


def _narrow(layout):
    shape = (4, 3, 32, 32) if layout == "NCHW" else (4, 32, 32, 3)
    js = jmodels.resnet(layout=layout, **NARROW)
    ts = tmodels.resnet(layout=layout, **NARROW)
    args, aux = random_params(ts, 0, data=shape)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    return js, ts, args, aux, x


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_narrow_resnet_matches_jax(layout, quantize):
    js, ts, args, aux, x = _narrow(layout)
    want = JaxPredictor(js, args, aux, quantize=quantize) \
        .forward(data=x).get_output(0)
    t_args, t_aux = params_from_numpy(args, aux, "cpu")
    got = mt.Predictor(ts, t_args, t_aux, ctx=mt.cpu(), quantize=quantize) \
        .forward(data=x).get_output(0)
    assert got.shape == want.shape == (4, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL[quantize])
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_digits_mlp_matches_jax(quantize):
    js, ts = jmodels.mlp(), tmodels.mlp()
    args, aux = random_params(ts, 2, data=(32, 64))
    x = np.random.default_rng(3).standard_normal((32, 64)).astype(np.float32)
    want = JaxPredictor(js, args, aux, quantize=quantize) \
        .forward(data=x).get_output(0)
    got = mt.Predictor(ts, args, aux, ctx=mt.cpu(), quantize=quantize) \
        .forward(data=x).get_output(0)
    np.testing.assert_allclose(got, want, **TOL[quantize])


def test_int8_differs_from_f32_and_is_close():
    _, ts, args, aux, x = _narrow("NCHW")
    p32 = mt.Predictor(ts, args, aux, ctx=mt.cpu()).forward(data=x)
    p8 = mt.Predictor(ts, args, aux, ctx=mt.cpu(), quantize="int8") \
        .forward(data=x)
    o32, o8 = p32.get_output(0), p8.get_output(0)
    assert not np.array_equal(o8, o32)
    np.testing.assert_allclose(o8, o32, rtol=0.1, atol=0.05)


def test_bf16_compute_dtype_matches_jax():
    """compute_dtype casts parameters and inputs, in both packages. bf16
    keeps 8 bits of mantissa, and the two round at other places: 2e-2."""
    js, ts = jmodels.mlp(), tmodels.mlp()
    args, aux = random_params(ts, 4, data=(16, 64))
    x = np.random.default_rng(5).standard_normal((16, 64)).astype(np.float32)
    want = JaxPredictor(js, args, aux, compute_dtype="bfloat16") \
        .forward(data=x).get_output(0)
    got = mt.Predictor(ts, args, aux, ctx=mt.cpu(), compute_dtype="bfloat16") \
        .forward(data=x).get_output(0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("fuse", ["0", "1"])
def test_fusion_switch_matches_jax(monkeypatch, fuse):
    """MXNET_TPU_FUSE is read as in the JAX package, and both settings
    compute the same thing in both packages."""
    monkeypatch.setenv("MXNET_TPU_FUSE", fuse)
    js, ts, args, aux, x = _narrow("NCHW")
    want = JaxPredictor(js, args, aux).forward(data=x).get_output(0)
    got = mt.Predictor(ts, args, aux, ctx=mt.cpu()).forward(data=x) \
        .get_output(0)
    np.testing.assert_allclose(got, want, **TOL[None])


def test_fusion_plan_matches_jax():
    from mxnet_tpu.executor import _fusion_plan as jax_plan
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.executor import _fusion_plan as torch_plan
    from mxnet_tpu_torch.name import NameManager as TorchNames

    # fresh name counters: the residual adds are auto-named, and symbols that
    # other tests built earlier in this process advance each package's counter
    with JaxNames():
        js = jmodels.resnet50()
    with TorchNames():
        ts = tmodels.resnet50()

    def names(plan, sym):
        by_id = {id(n): n.name for n in sym._topo()}
        fused_bn, passthrough, skip_bn, fused_add = plan(sym)
        return ({by_id[i] for i in fused_bn}, {by_id[i] for i in passthrough},
                {by_id[i] for i in skip_bn},
                {by_id[i]: (bn.name, z) for i, (bn, z) in fused_add.items()})

    got, want = names(torch_plan, ts), names(jax_plan, js)
    assert got == want
    assert len(got[3]) == 16  # every bottleneck tail fuses BN + add + relu


def test_export_bundle_crosses_both_ways(tmp_path):
    js, ts, args, aux, x = _narrow("NHWC")
    jp = JaxPredictor(js, args, aux)
    tp = mt.Predictor(ts, args, aux, ctx=mt.cpu())
    want = jp.forward(data=x).get_output(0)

    jax_bundle = str(tmp_path / "from_jax.mxtpu")
    jp.export(jax_bundle)
    got = mt.Predictor.load(jax_bundle, ctx=mt.cpu()).forward(data=x) \
        .get_output(0)
    np.testing.assert_allclose(got, want, **TOL[None])

    torch_bundle = str(tmp_path / "from_torch.mxtpu")
    tp.export(torch_bundle)
    back = JaxPredictor.load(torch_bundle).forward(data=x).get_output(0)
    np.testing.assert_array_equal(back, want)  # the same weights, both JAX


def test_default_context_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts, args, aux, _ = _narrow("NCHW")
    with pytest.raises(MXNetError, match="CUDA"):
        mt.Predictor(ts, args, aux)
    with pytest.raises(MXNetError, match="CUDA"):
        mt.gpu(0)
    with mt.cpu():  # a with block sets the default, as in the JAX package
        assert mt.Predictor(ts, args, aux).ctx == mt.cpu()


def test_predictor_surface():
    _, ts, args, aux, x = _narrow("NCHW")
    pred = mt.Predictor(ts.tojson(), args, aux, ctx=mt.cpu())
    with pytest.raises(MXNetError, match="forward"):
        pred.get_output(0)
    with pytest.raises(MXNetError, match="quantize"):
        mt.Predictor(ts, args, aux, ctx=mt.cpu(), quantize="int4")
    pred.set_input("data", torch.from_numpy(x))
    out = pred.forward().get_output(0)
    np.testing.assert_allclose(out.sum(1), 1.0, rtol=1e-5)
    before = k8.int8_matmul.launches  # the CPU takes the plain version
    mt.Predictor(ts, args, aux, ctx=mt.cpu(), quantize="int8").forward(data=x)
    assert k8.int8_matmul.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_matches_cpu_and_launches_kernel(cuda_device):
    _, ts, args, aux, x = _narrow("NCHW")
    want = mt.Predictor(ts, args, aux, ctx=mt.cpu(), quantize="int8") \
        .forward(data=x).get_output(0)
    before = k8.int8_matmul.launches
    got = mt.Predictor(ts, args, aux, ctx=mt.gpu(0), quantize="int8") \
        .forward(data=x).get_output(0)
    assert k8.int8_matmul.launches == before + 1
    np.testing.assert_allclose(got, want, **TOL["int8"])
