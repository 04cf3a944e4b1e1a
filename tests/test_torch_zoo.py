"""The zoo's LeNet, AlexNet and Inception-BN (CIFAR and ImageNet, both
layouts) in the port against the JAX package's: the same graph (names,
shape inference, serialised JSON) and the same forward through each
package's ``Executor``, from the same seeded weights (``random_params``).

Tolerances: the softmax outputs within 1e-5 relative Frobenius (f32 sums
of convolutions and FullyConnected layers in another order, XLA against
ATen, through up to 30 layers). In training mode (LeNet and the CIFAR
net: no Dropout, whose bits differ between torch and JAX) the gradients are
held to the port's own float64 run of the same step: the port's f32
gradients within 1e-4 of it (readings up to 1.3e-5) and the JAX package's
within 1e-2 (readings up to 5.4e-3: at batch 2 the CIFAR net's BatchNorms
normalise 98 values a channel at 7x7, and a few betas whose gradient
nearly cancels carry XLA's f32 rounding; LeNet's within 1e-6). The
convolution biases that feed a BatchNorm have an exact gradient of zero
(the normalisation removes a per-channel constant): both packages' are
held below 1e-5 of the whole gradient's norm instead.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import random_params

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

# model, kwargs, data shape (batch 2)
ZOO = [
    ("lenet", {}, (2, 1, 28, 28)),
    ("inception_bn_cifar", {}, (2, 3, 28, 28)),
    ("inception_bn_cifar", {"layout": "NHWC"}, (2, 28, 28, 3)),
    ("alexnet", {"num_classes": 10}, (2, 3, 224, 224)),
    ("inception_bn", {"num_classes": 10}, (2, 3, 224, 224)),
]
IDS = ["lenet", "inception_cifar", "inception_cifar_nhwc", "alexnet",
       "inception_bn"]


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _executors(name, kw, shape, seed=0):
    js, ts = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    args, aux = random_params(ts, seed, data=shape)
    je = js.simple_bind(mx.cpu(), data=shape)
    for k, v in args.items():
        je.arg_dict[k][:] = v
    for k, v in aux.items():
        je.aux_dict[k][:] = v
    te = ts.simple_bind(mt.cpu(), data=shape)
    te.copy_params_from(args, aux)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(shape).astype(np.float32)
    label = rng.integers(0, 10, shape[0]).astype(np.float32)
    return js, ts, je, te, args, x, label


@pytest.mark.parametrize("name,kw,shape", ZOO, ids=IDS)
def test_graph_matches_jax(name, kw, shape):
    """Arguments, outputs, auxiliary states, every inferred shape and the
    JSON (so each package loads the other's graph)."""
    js, ts = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    t_shapes = ts.infer_shape(data=shape)
    assert t_shapes == js.infer_shape(data=shape)
    assert t_shapes[1] == [(shape[0], kw.get("num_classes", 10))]
    assert ts.tojson() == js.tojson()
    assert mt.sym.load_json(js.tojson()).infer_shape(data=shape) == t_shapes


@pytest.mark.parametrize("name,kw,shape", ZOO, ids=IDS)
def test_eval_forward_matches_jax(name, kw, shape):
    _, _, je, te, _, x, _ = _executors(name, kw, shape)
    je.forward(is_train=False, data=x)
    te.forward(is_train=False, data=x)
    got, want = te.outputs[0].numpy(), je.outputs[0].asnumpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_fro(got, want) < 1e-5


def _f64_grads(ts, args, x, label, shape):
    """The port's training step in float64 on the same weights."""
    _, aux = random_params(ts, 0, data=shape)
    values = {k: v.astype(np.float64) for k, v in args.items()}
    values.update(data=x.astype(np.float64),
                  softmax_label=label.astype(np.float64))
    ex = ts.bind(mt.cpu(), values,
                 args_grad={k: np.zeros(v.shape) for k, v in args.items()},
                 grad_req={k: "write" if k in args else "null"
                           for k in ts.list_arguments()},
                 aux_states={k: v.astype(np.float64) for k, v in aux.items()})
    ex.forward(is_train=True)
    ex.backward()
    return {k: ex.grad_dict[k].numpy() for k in args}


@pytest.mark.parametrize("name,kw,shape,jax_bound",
                         [(*ZOO[0], 1e-6), (*ZOO[1], 1e-2)], ids=IDS[:2])
def test_train_forward_backward_matches_jax(name, kw, shape, jax_bound):
    _, ts, je, te, args, x, label = _executors(name, kw, shape)
    je.forward(is_train=True, data=x, softmax_label=label)
    je.backward()
    te.forward(is_train=True, data=x, softmax_label=label)
    te.backward()
    assert _rel_fro(te.outputs[0].numpy(), je.outputs[0].asnumpy()) < 1e-5
    exact = _f64_grads(ts, args, x, label, shape)
    whole = np.sqrt(sum(np.sum(g ** 2) for g in exact.values()))
    for k in args:
        got, want = te.grad_dict[k].numpy(), je.grad_dict[k].asnumpy()
        if np.linalg.norm(exact[k]) < 1e-9 * whole:  # a bias into a BN
            assert np.linalg.norm(got) < 1e-5 * whole, k
            assert np.linalg.norm(want) < 1e-5 * whole, k
            continue
        assert _rel_fro(got, exact[k]) < 1e-4, (k, _rel_fro(got, exact[k]))
        assert _rel_fro(want, exact[k]) < jax_bound, \
            (k, _rel_fro(want, exact[k]))
