"""Custom numpy operator as a network head, the port's counterpart of
``examples/numpy_ops/numpy_softmax.py`` (rewrite of the reference
example/numpy-ops/numpy_softmax.py: a softmax loss written entirely in
numpy via the NumpyOp bridge, trained end-to-end).

The op runs on the host: the port's ``NumpyOp`` hands the user's numpy code
host copies of its inputs and copies its outputs back to the tensors'
device (the card unless ``--cpu`` is given). The backward is the user's
numpy code too (need_top_grad=False because it is a loss head producing its
own gradient).

    python -m mxnet_tpu_torch.examples.numpy_ops.numpy_softmax [--cpu]
"""

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.operator import NumpyOp

from .. import cpu_parser, example_context


class NumpySoftmax(NumpyOp):
    """Softmax output layer in pure numpy (reference semantics)."""

    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["prob"]

    def infer_shape(self, in_shape):
        return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

    def forward(self, in_data, out_data):
        x = in_data[0]
        y = out_data[0]
        y[:] = np.exp(x - x.max(axis=1, keepdims=True))
        y /= y.sum(axis=1, keepdims=True)

    def backward(self, out_grad, in_data, out_data, in_grad):
        label = in_data[1].astype(np.int64)
        y = out_data[0]
        dx = in_grad[0]
        dx[:] = y
        dx[np.arange(label.shape[0]), label] -= 1.0


def dataset():
    rng = np.random.RandomState(0)
    n, dim, classes = 600, 20, 4
    centers = rng.randn(classes, dim) * 2.0
    y = rng.randint(0, classes, n).astype(np.float32)
    X = (centers[y.astype(int)] + 0.5 * rng.randn(n, dim)).astype(np.float32)
    return X, y, classes


def build_net(classes):
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, name="fc1", num_hidden=64)
    net = sym.Activation(data=net, name="relu1", act_type="relu")
    net = sym.FullyConnected(data=net, name="fc2", num_hidden=classes)
    return NumpySoftmax()(data=net, name="softmax")


def train(ctx, num_epoch=10, arg_params=None):
    """The JAX script's fit; returns ``(model, X, y)``."""
    X, y, classes = dataset()
    model = mx.FeedForward(build_net(classes), ctx=ctx, num_epoch=num_epoch,
                           learning_rate=0.2, momentum=0.9,
                           initializer=mx.init.Xavier(), arg_params=arg_params)
    model.fit(X, y, batch_size=50)
    return model, X, y


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        model, X, y = train(ctx)
        preds = model.predict(X, batch_size=50)
    acc = (preds.argmax(axis=1) == y).mean()
    print(f"train accuracy with numpy softmax head: {acc:.3f}")
    assert acc > 0.9, acc
    return acc


if __name__ == "__main__":
    main()
