"""The port's Executor against the JAX package's: simple_bind, a training
forward and backward on a small ResNet, from the same numpy-seeded weights,
images and labels.

Tolerances. Outputs within 1e-5. Running stats within 1e-5 (the batch sums
round in another order). Gradients, per parameter, within 1e-3 relative
Frobenius error: at batch 4 the last stage's BatchNorms normalise over 4
values each, and their backward divides small differences of sums by
small variances, which magnifies the f32 summation-order differences
between XLA and ATen; the worst reading is 1e-4.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

NARROW = dict(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
              num_classes=10)


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _case(layout):
    shape = (4, 3, 32, 32) if layout == "NCHW" else (4, 32, 32, 3)
    js = jmodels.resnet(layout=layout, **NARROW)
    ts = tmodels.resnet(layout=layout, **NARROW)
    args, aux = random_params(ts, 0, data=shape)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    label = rng.integers(0, 10, 4).astype(np.float32)
    return js, ts, shape, args, aux, x, label


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_train_forward_backward_matches_jax(layout):
    js, ts, shape, args, aux, x, label = _case(layout)
    je = js.simple_bind(mx.cpu(), data=shape)
    for k, v in args.items():
        je.arg_dict[k][:] = v
    for k, v in aux.items():
        je.aux_dict[k][:] = v
    je.forward(is_train=True, data=x, softmax_label=label)
    je.backward()
    te = ts.simple_bind(mt.cpu(), data=shape)
    te.copy_params_from(args, aux)
    te.forward(is_train=True, data=x, softmax_label=label)
    te.backward()
    np.testing.assert_allclose(te.outputs[0].numpy(), je.outputs[0].asnumpy(),
                               rtol=1e-5, atol=1e-5)
    assert set(te.grad_dict) == set(je.grad_dict)
    for k in args:
        err = _rel_fro(te.grad_dict[k].numpy(), je.grad_dict[k].asnumpy())
        assert err < 1e-3, (k, err)
    np.testing.assert_array_equal(te.grad_dict["softmax_label"].numpy(), 0)
    for k in aux:
        np.testing.assert_allclose(te.aux_dict[k].numpy(),
                                   je.aux_dict[k].asnumpy(), rtol=1e-5,
                                   atol=1e-5)
        assert not np.allclose(te.aux_dict[k].numpy(), aux[k])


def test_eval_forward_keeps_aux_and_backward_needs_train():
    _, ts, shape, args, aux, x, label = _case("NCHW")
    te = ts.simple_bind(mt.cpu(), data=shape)
    te.copy_params_from(args, aux)
    te.forward(is_train=False, data=x)
    for k in aux:
        np.testing.assert_array_equal(te.aux_dict[k].numpy(), aux[k])
    with pytest.raises(MXNetError, match="forward"):
        te.backward()


def _mlp_head():
    data = tsym.Variable("data")
    fc = tsym.FullyConnected(data=data, name="fc", num_hidden=3)
    return tsym.Activation(data=fc, name="act", act_type="tanh")


def test_grad_req_add_null_and_out_grads():
    """``add`` accumulates over backward calls, ``null`` leaves no gradient,
    and a head without a loss takes the given out_grads."""
    net = _mlp_head()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    cot = rng.standard_normal((5, 3)).astype(np.float32)
    te = net.simple_bind(mt.cpu(), grad_req={"fc_weight": "add",
                                             "fc_bias": "write"}, data=(5, 4))
    te.copy_params_from({"data": x, "fc_weight": w, "fc_bias": b})
    assert "data" not in te.grad_dict
    te.forward(is_train=True)
    te.backward(torch.from_numpy(cot))
    once = te.grad_dict["fc_weight"].clone()
    te.backward(torch.from_numpy(cot))
    torch.testing.assert_close(te.grad_dict["fc_weight"], 2 * once)
    # against the JAX executor with the same cotangent
    je = mx.symbol.load_json(net.tojson()).simple_bind(mx.cpu(), data=(5, 4))
    for k, v in (("data", x), ("fc_weight", w), ("fc_bias", b)):
        je.arg_dict[k][:] = v
    je.forward(is_train=True)
    je.backward(mx.nd.array(cot))
    np.testing.assert_allclose(once.numpy(), je.grad_dict["fc_weight"].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(te.grad_dict["fc_bias"].numpy(),
                               je.grad_dict["fc_bias"].asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_bind_with_given_arrays_and_missing_args():
    net = _mlp_head()
    args = {"data": np.ones((2, 4), np.float32),
            "fc_weight": np.ones((3, 4), np.float32),
            "fc_bias": np.zeros(3, np.float32)}
    ex = net.bind(mt.cpu(), args)
    (out,) = ex.forward()
    np.testing.assert_allclose(out.numpy(), np.tanh(4.0) * np.ones((2, 3)),
                               rtol=1e-6)
    with pytest.raises(MXNetError, match="missing arguments"):
        net.bind(mt.cpu(), {"data": args["data"]})


def test_dropout_in_executor_follows_the_seed():
    data = tsym.Variable("data")
    net = tsym.Dropout(data=data, name="drop", p=0.5)
    ex = net.simple_bind(mt.cpu(), grad_req="null", data=(64, 64))
    ex.arg_dict["data"].fill_(1.0)
    outs = []
    for _ in range(2):
        mt.random.seed(3)
        outs.append(ex.forward(is_train=True)[0].clone())
    assert torch.equal(outs[0], outs[1])
    assert 0.4 < (outs[0] == 0).float().mean().item() < 0.6
    assert torch.equal(ex.forward(is_train=False)[0], ex.arg_dict["data"])
