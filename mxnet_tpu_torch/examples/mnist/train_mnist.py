"""MNIST training, the port's counterpart of
``examples/mnist/train_mnist.py`` (reference:
example/mnist/{mlp.py,lenet.py,train_mnist.py}).

Runs on real MNIST idx files (--data-dir with train-images-idx3-ubyte etc.,
gzip ok) or, by default, on a synthetic MNIST-shaped dataset that converges
the same way (the JAX script's arrays, byte for byte).

    python -m mxnet_tpu_torch.examples.mnist.train_mnist --network mlp
    python -m mxnet_tpu_torch.examples.mnist.train_mnist --network lenet \\
        --lr 0.05 [--api module] [--cpu]

The model lives on the card unless ``--cpu`` is given; ``--num-devices n``
trains on ``n`` contexts (card ``i % cards``: one card gives one replica).
"""

import logging
import os

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context, example_contexts


def synthetic_mnist(n=2048, num_classes=10, seed=0):
    """Digit-like data: each class is a fixed random stroke pattern + noise."""
    rng = np.random.RandomState(seed)
    protos = rng.rand(num_classes, 28, 28) > 0.8
    X = np.zeros((n, 28, 28), np.float32)
    y = np.zeros((n,), np.float32)
    for i in range(n):
        cls = i % num_classes
        X[i] = protos[cls] * (0.7 + 0.3 * rng.rand()) + 0.1 * rng.rand(28, 28)
        y[i] = cls
    order = rng.permutation(n)
    return X[order], y[order]


def parser():
    ap = cpu_parser(__doc__)
    ap.add_argument("--network", choices=["mlp", "lenet"], default="mlp")
    ap.add_argument("--data-dir", default=None,
                    help="dir with MNIST idx files")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--num-epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--kv-store", default="local")
    ap.add_argument("--num-devices", type=int, default=1)
    ap.add_argument("--api", choices=["feedforward", "module"],
                    default="feedforward",
                    help="estimator API: FeedForward (reference parity) or "
                         "Module (the BASELINE north star's module.fit())")
    return ap


def data_iters(args, flat):
    """The train and validation iterators of the JAX script."""
    if args.data_dir:
        train = mx.io.MNISTIter(
            image=os.path.join(args.data_dir, "train-images-idx3-ubyte"),
            label=os.path.join(args.data_dir, "train-labels-idx1-ubyte"),
            batch_size=args.batch_size, shuffle=True, flat=flat)
        val = mx.io.MNISTIter(
            image=os.path.join(args.data_dir, "t10k-images-idx3-ubyte"),
            label=os.path.join(args.data_dir, "t10k-labels-idx1-ubyte"),
            batch_size=args.batch_size, flat=flat)
        return train, val
    logging.info("no --data-dir; using synthetic MNIST-shaped data")
    X, y = synthetic_mnist()
    X = X.reshape(len(X), -1) if flat else X[:, None]
    split = int(0.9 * len(X))
    train = mx.io.NDArrayIter(X[:split], y[:split],
                              batch_size=args.batch_size, shuffle=True)
    val = mx.io.NDArrayIter(X[split:], y[split:], batch_size=args.batch_size)
    return train, val


def train(args, arg_params=None):
    """The JAX script's fit. Returns ``(model, val)``: a ``Module`` under
    ``--api module``, else a ``FeedForward``. ``arg_params`` starts from
    given weights instead of Xavier's."""
    from mxnet_tpu_torch.models import lenet, mlp

    flat = args.network == "mlp"
    net = mlp() if flat else lenet()
    train_it, val = data_iters(args, flat)
    if args.api == "module":
        if args.num_devices > 1:
            logging.warning("--api module is single-device; use "
                            "--api feedforward for multi-device dp "
                            "(--num-devices ignored)")
        kv = mx.kv.create(args.kv_store) if "dist" in args.kv_store else None
        mod = mx.mod.Module(net, context=example_context(args.cpu))
        if arg_params is not None:
            mod.bind(data_shapes=train_it.provide_data,
                     label_shapes=train_it.provide_label)
            mod.init_params(arg_params=arg_params)
        mod.fit(train_it, eval_data=val, num_epoch=args.num_epochs,
                initializer=mx.init.Xavier(), kvstore=kv,
                optimizer_params={"learning_rate": args.lr,
                                  "momentum": args.momentum,
                                  "rescale_grad": 1.0 / args.batch_size})
        return mod, val

    ctx = example_contexts(args.cpu, args.num_devices)
    model = mx.FeedForward(net, ctx=ctx, num_epoch=args.num_epochs,
                           initializer=mx.init.Xavier(), arg_params=arg_params,
                           lr=args.lr, momentum=args.momentum)
    model.fit(train_it, eval_data=val, kvstore=args.kv_store,
              batch_end_callback=mx.callback.Speedometer(args.batch_size, 50))
    return model, val


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with example_context(args.cpu):
        model, val = train(args)
        if args.api == "module":
            acc = model.score(val)[1]
        else:
            acc = model.score(val)
    print("final val accuracy:", acc)
    return acc


if __name__ == "__main__":
    main()
