"""Remat (``MXNET_TPU_REMAT``) in the port: the JAX package's segments, and
checkpointed steps that equal the plain ones.

The port runs each segment under ``torch.utils.checkpoint`` (non-reentrant:
the autograd graph is the plain one, its saved tensors recomputed), hands
the recompute the generator state its forward drew from, and keeps the
forward's auxiliary states. On the CPU a recompute repeats the forward's
arithmetic exactly, so a remat step is held bitwise to the plain step, with
BatchNorm (its moving statistics moved once a step) and with Dropout (the
recompute draws the forward's masks), in f32 and with bf16
``compute_dtype``. Against the JAX package's remat ``fit`` the bounds are
those of the plain ``fit`` comparison (``tests/test_torch_model.py``):
per-step cross-entropy within 1e-4 relative, parameters within 3e-4
absolute, running statistics within 1e-4.
"""

import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import executor as jexecutor
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor as texecutor
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.ops import nn as tnn

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

NARROW = dict(units=(2, 2, 1, 1), filter_list=(16, 32, 64, 128),
              num_classes=10)
RESNET_PATTERN = r"unit\d+_out$"
ALEXNET_PATTERN = r"norm\d$|relu6$"


def _dropout_net(pkg):
    """A narrow AlexNet-like net: LRN, and Dropout inside a remat segment
    that closes at ``relu7``."""
    s = pkg.sym
    x = s.Convolution(data=s.Variable("data"), kernel=(3, 3), num_filter=8,
                      name="conv1")
    x = s.Activation(data=x, act_type="relu", name="relu1")
    x = s.LRN(data=x, nsize=5, name="norm1")
    x = s.Pooling(data=x, kernel=(2, 2), stride=(2, 2), name="pool1")
    x = s.Flatten(data=x, name="flatten")
    x = s.FullyConnected(data=x, num_hidden=32, name="fc1")
    x = s.Activation(data=x, act_type="relu", name="relu6")
    x = s.Dropout(data=x, p=0.5, name="drop1")
    x = s.FullyConnected(data=x, num_hidden=32, name="fc2")
    x = s.Activation(data=x, act_type="relu", name="relu7")
    x = s.Dropout(data=x, p=0.5, name="drop2")
    x = s.FullyConnected(data=x, num_hidden=10, name="fc3")
    return s.SoftmaxOutput(data=x, name="softmax")


def _node(node):
    # auto-named nodes (ResNet's ``plus0``...) take each package's own
    # name counter, which other tests in the process have moved
    return "variable" if node.is_variable else node.op.name


def _segments(module, symbol, pattern, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_REMAT", pattern)
    segs = module._remat_segments(symbol._topo())
    return [(seg[0], seg[1], _node(seg[2])) if seg[0] == "inline"
            else (seg[0], [(i, _node(n)) for i, n in seg[1]]) for seg in segs]


@pytest.mark.parametrize("model,pattern", [
    ("resnet", RESNET_PATTERN), ("alexnet", ALEXNET_PATTERN),
    ("inception_bn_cifar", r"concat$")])
def test_remat_segments_match_jax(model, pattern, monkeypatch):
    kw = NARROW if model == "resnet" else {}
    js, ts = getattr(jmodels, model)(**kw), getattr(tmodels, model)(**kw)
    want = _segments(jexecutor, js, pattern, monkeypatch)
    assert _segments(texecutor, ts, pattern, monkeypatch) == want
    assert sum(seg[0] == "blk" for seg in want) >= 3


def test_remat_off_without_the_variable(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_REMAT", raising=False)
    assert texecutor._remat_segments(tmodels.alexnet()._topo()) is None
    monkeypatch.setenv("MXNET_TPU_REMAT", "")
    assert texecutor._remat_segments(tmodels.alexnet()._topo()) is None


def _fit(net, args, aux, X, Y, pattern, monkeypatch, **kw):
    if pattern is None:
        monkeypatch.delenv("MXNET_TPU_REMAT", raising=False)
    else:
        monkeypatch.setenv("MXNET_TPU_REMAT", pattern)
    mt.random.seed(7)
    model = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=1, optimizer="adam",
                           fused=True, learning_rate=0.01, arg_params=args,
                           aux_params=aux, **kw)
    losses = []
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=4, shuffle=False),
              eval_metric="ce", batch_end_callback=lambda p: losses.append(
                  p.eval_metric.sum_metric))
    return model, losses


def _case(net, shape, seed=0):
    args, aux = random_params(net, seed, data=shape)
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((8,) + shape[1:]).astype(np.float32)
    Y = rng.integers(0, 10, 8).astype(np.float32)
    return args, aux, X, Y


@pytest.mark.parametrize("graph", ["resnet_batchnorm", "dropout"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_remat_fit_equals_plain_bitwise(graph, dtype, monkeypatch):
    """Two steps of ``fit`` with fused Adam: losses, parameters and
    auxiliary states bitwise the plain run's; the segments really
    recomputed (each BatchNorm and Dropout ran twice a step), and the
    moving statistics moved once a step all the same."""
    if graph == "dropout":
        net, shape, pattern = _dropout_net(mt), (4, 3, 12, 12), \
            ALEXNET_PATTERN + "|relu7$"
        op, hook = tnn.DropoutOp, "fwd"
    else:
        # 32x32: at 16x16 the last stage's stride-2 3x3 convolution sees a
        # 1x1 input, and ATen's bf16 weight gradient on the CPU returns
        # garbage there, differently from call to call
        net, shape, pattern = tmodels.resnet(**NARROW), (4, 3, 32, 32), \
            RESNET_PATTERN
        op, hook = tnn.BatchNormOp, "_fwd_impl"
    args, aux, X, Y = _case(net, shape)
    plain, plain_losses = _fit(net, args, aux, X, Y, None, monkeypatch,
                               compute_dtype=dtype)
    calls = [0]
    original = getattr(op, hook)

    def counted(self, *a, **kw):
        calls[0] += 1
        return original(self, *a, **kw)

    monkeypatch.setattr(op, hook, counted)
    remat, remat_losses = _fit(net, args, aux, X, Y, pattern, monkeypatch,
                               compute_dtype=dtype)
    n_ops = sum(not n.is_variable and isinstance(n.op, op)
                for n in net._topo())
    assert calls[0] > 2 * n_ops  # two steps, and recomputes besides
    assert remat_losses == plain_losses
    for k in args:
        assert torch.equal(remat.arg_params[k], plain.arg_params[k]), k
        assert not torch.equal(remat.arg_params[k],
                               torch.from_numpy(args[k])), k
    for k in aux:
        assert torch.equal(remat.aux_params[k], plain.aux_params[k]), k


def test_moving_stats_move_once_a_step(monkeypatch):
    """One remat training forward and backward: the moving statistics are
    the plain step's, ``m * moving + (1 - m) * batch``, and moved."""
    net = tmodels.resnet(**NARROW)
    args, aux, X, Y = _case(net, (4, 3, 16, 16))
    out = {}
    for pattern in (None, RESNET_PATTERN):
        if pattern:
            monkeypatch.setenv("MXNET_TPU_REMAT", pattern)
        fn = texecutor._build_graph_fn(net, is_train=True)
        params = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in args.items()}
        values = {**params, "data": torch.from_numpy(X[:4]),
                  "softmax_label": torch.from_numpy(Y[:4])}
        outs, new_aux = fn(values, {k: torch.from_numpy(v)
                                    for k, v in aux.items()})
        torch.autograd.backward(outs[0].sum(), inputs=list(params.values()))
        out[pattern] = new_aux
    for k in aux:
        assert torch.equal(out[None][k], out[RESNET_PATTERN][k]), k
        assert not torch.equal(out[None][k], torch.from_numpy(aux[k])), k


def test_remat_fit_matches_jax_remat(monkeypatch):
    """The JAX package's remat ``fit`` (``jax.checkpoint``) and the port's,
    from the same weights, 2 steps of fused Adam (epsilon 1e-3, as the
    plain comparison)."""
    js, ts = jmodels.resnet(**NARROW), tmodels.resnet(**NARROW)
    args, aux, X, Y = _case(ts, (4, 3, 16, 16))
    monkeypatch.setenv("MXNET_TPU_REMAT", RESNET_PATTERN)
    kw = dict(optimizer="adam", fused=True, learning_rate=0.01, epsilon=1e-3)
    jm = mx.FeedForward(js, ctx=mx.cpu(), num_epoch=1,
                        arg_params={k: mx.nd.array(v) for k, v in args.items()},
                        aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                        **kw)
    tm = mt.FeedForward(ts, ctx=mt.cpu(), num_epoch=1, arg_params=args,
                        aux_params=aux, **kw)
    sums = {}
    for name, pkg, m in (("jax", mx, jm), ("port", mt, tm)):
        sums[name] = []
        m.fit(pkg.io.NDArrayIter(X, Y, batch_size=4, shuffle=False),
              eval_metric="ce", batch_end_callback=lambda p, s=sums[name]:
              s.append(p.eval_metric.sum_metric))
    np.testing.assert_allclose(sums["port"], sums["jax"], rtol=1e-4)
    for k in args:
        np.testing.assert_allclose(tm.arg_params[k].numpy(),
                                   jm.arg_params[k].asnumpy(), rtol=0,
                                   atol=3e-4, err_msg=k)
    for k in aux:
        np.testing.assert_allclose(tm.aux_params[k].numpy(),
                                   jm.aux_params[k].asnumpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert os.environ["MXNET_TPU_REMAT"] == RESNET_PATTERN
