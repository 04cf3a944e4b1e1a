"""``NumpyOp`` and the ``_Native`` op of the port against the JAX package's:
a numpy softmax head's forward and its numpy backward through autograd
within 1e-6, the registry's 35 names, and a fit through such a graph, which
runs eager and says why."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.ops import OPS as JOPS
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OPS as TOPS
from mxnet_tpu_torch.utils import compile as tcm

torch.set_num_threads(1)
mt.set_matmul_precision("highest")


def _softmax_op(base):
    class NumpySoftmax(base):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            y = out_data[0]
            y[:] = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            dx = in_grad[0]
            dx[:] = out_data[0]
            dx[np.arange(lab.shape[0]), lab] -= 1.0

    return NumpySoftmax()


def _net(pkg, base, name="nps"):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, name="fc", num_hidden=5)
    return _softmax_op(base)(data=net, name=name)


def test_numpy_softmax_forward_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
    w = rng.standard_normal((5, 6)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    lab = np.array([0, 1, 2, 4], np.float32)
    out = {}
    for pkg, base in ((mx, mx.operator.NumpyOp), (mt, mt.operator.NumpyOp)):
        net = _net(pkg, base)
        exe = net.simple_bind(pkg.cpu(), data=(4, 6), nps_label=(4,))
        for name, v in (("data", x), ("fc_weight", w), ("fc_bias", b),
                        ("nps_label", lab)):
            exe.arg_dict[name][:] = v if pkg is mx else torch.from_numpy(v)
        (o,) = exe.forward(is_train=True)
        exe.backward()
        host = (lambda a: a.asnumpy()) if pkg is mx else \
            (lambda a: a.detach().cpu().numpy())
        out[pkg.__name__] = (host(o), host(exe.grad_dict["fc_weight"]),
                             host(exe.grad_dict["fc_bias"]),
                             host(exe.grad_dict["data"]))
    for a, b_ in zip(out["mxnet_tpu"], out["mxnet_tpu_torch"]):
        np.testing.assert_allclose(b_, a, rtol=0, atol=1e-6)
    e = np.exp(x @ w.T + b - (x @ w.T + b).max(axis=1, keepdims=True))
    np.testing.assert_allclose(out["mxnet_tpu_torch"][0],
                               e / e.sum(axis=1, keepdims=True), atol=1e-6)


def test_registry_has_every_name():
    assert len(TOPS._entries) == len(JOPS._entries) == 35
    assert set(TOPS._entries) == set(JOPS._entries)
    assert "_native" in TOPS._entries


def test_native_graph_cannot_serialize():
    net = _net(mt, mt.operator.NumpyOp)
    with pytest.raises(MXNetError, match="serialized"):
        net.tojson()
    assert mt.utils.compile.graph_fingerprint(net) == \
        mx.utils.compile.graph_fingerprint(_net(mx, mx.operator.NumpyOp))


def test_fit_through_a_numpy_head_runs_eager_with_its_reason():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((40, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32) + 2 * (X[:, 1] > 0)
    tcm.reset_compile_stats()
    model = mt.FeedForward(_net(mt, mt.operator.NumpyOp, "softmax"),
                           ctx=mt.cpu(), num_epoch=20, learning_rate=0.1,
                           momentum=0.9, initializer=mt.init.Xavier())
    model.fit(X, y, batch_size=20)
    assert tcm.compile_stats()["eager"] == {"cpu context": 1}
    acc = (model.predict(X, batch_size=20).argmax(axis=1) == y).mean()
    assert acc > 0.8, acc


def test_native_reason_on_a_card(monkeypatch):
    """The reason a card trainer gives for a graph with a _Native node (the
    device check comes first, so the CPU's is patched past)."""
    model = mt.FeedForward(_net(mt, mt.operator.NumpyOp), ctx=mt.cpu())
    monkeypatch.setattr(mt.FeedForward, "_device",
                        property(lambda self: torch.device("cuda", 0)))
    assert "_Native" in model._eager_reason()
