"""Low-level training with ``simple_bind`` (notebook-style walkthrough),
the port's counterpart of ``examples/notebooks/simple_bind.py``.

Reference counterpart: example/notebooks/simple_bind.ipynb — bypassing the
FeedForward model wrapper to drive an Executor by hand: bind, initialize
weights directly, write a custom SGD update, and run the train loop
yourself. Useful when you need full control (custom updates, inspection of
every gradient, research schedules).

    python -m mxnet_tpu_torch.examples.notebooks.simple_bind [--cpu]

Data: scikit-learn's scanned-digit set (the JAX script's stand-in for the
notebook's MNIST download), read from the port's copy of its file
(``examples/_digits.py``). The port's executor holds torch tensors on its
context, the card unless ``--cpu`` is given: the script writes them in
place and reads its outputs back with ``.cpu()``.
"""

import numpy as np
import torch

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context
from .._digits import load_digits

batch_size = 100
NUM_ROUND = 6


def build_net():
    """A one-hidden-layer BatchNorm MLP, exactly as in the notebook."""
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=128)
    bn1 = mx.sym.BatchNorm(data=fc1, name="bn1")
    act1 = mx.sym.Activation(data=bn1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=10)
    return mx.sym.SoftmaxOutput(data=fc2, name="softmax")


def SGD(key, weight, grad, lr=0.1, grad_norm=batch_size):
    """A custom SGD update rule over the raw (weight, grad) pairs."""
    if key.startswith("data") or key.startswith("softmax"):
        return
    weight[:] = weight - lr * (grad / grad_norm)


def Accuracy(label, pred_prob):
    pred = np.argmax(pred_prob, axis=1)
    return float(np.sum(label == pred)) / len(label)


def digits():
    """8x8 scanned digits, flattened to 64 features, split train/val."""
    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    return (X[:1500], y[:1500]), (X[1500:], y[1500:])


def train(ctx, num_round=NUM_ROUND, init=None):
    """The hand-rolled loop. Returns ``{"train_acc", "val_acc": [per
    epoch], "probs": [each training batch's softmax output]}``; ``init``
    ({name: array}) replaces the notebook's uniform draw."""
    softmax = build_net()
    # simple_bind allocates argument/gradient arrays from inferred shapes
    # and returns a ready Executor (FeedForward wraps exactly this
    # machinery, plus a kvstore; at this level you own the update rule)
    executor = softmax.simple_bind(ctx=ctx, data=(batch_size, 64),
                                   softmax_label=(batch_size,))
    # name -> array maps, in the argument order of the symbol
    args = dict(zip(softmax.list_arguments(), executor.arg_arrays))
    grads = dict(zip(softmax.list_arguments(), executor.grad_arrays))
    print("bound executor:")
    print(" args:", list(args))

    # Initialize weights by writing into the bound arrays (the notebook's
    # Init helper); the bound arrays are tensors, written in place.
    mx.random.seed(0)
    with torch.no_grad():
        for key, arr in args.items():
            if init is not None and key in init:
                arr.copy_(torch.as_tensor(init[key]))
            elif "weight" in key:
                arr.copy_(mx.random.uniform(-0.07, 0.07, arr.shape,
                                            ctx=ctx).data)
            elif "gamma" in key:
                arr.fill_(1.0)
            elif key.endswith(("bias", "beta")):
                arr.fill_(0.0)

    (X_train, y_train), (X_val, y_val) = digits()
    keys = softmax.list_arguments()
    out = {"train_acc": [], "val_acc": [], "probs": []}
    for epoch in range(num_round):
        train_acc = []
        for i in range(0, len(X_train) - batch_size + 1, batch_size):
            with torch.no_grad():
                args["data"][:] = torch.from_numpy(X_train[i:i + batch_size])
                args["softmax_label"][:] = torch.from_numpy(
                    y_train[i:i + batch_size])
            executor.forward(is_train=True)
            # the notebook scores each batch on the host: the read is the point
            pred_prob = executor.outputs[0].cpu().numpy()  # mxlint: disable=MX309
            executor.backward()
            with torch.no_grad():
                for key in keys:
                    SGD(key, args[key], grads[key])
            out["probs"].append(pred_prob)
            train_acc.append(Accuracy(y_train[i:i + batch_size], pred_prob))

        # validation: forward-only on the bound executor
        val_acc = []
        for i in range(0, len(X_val) - batch_size + 1, batch_size):
            with torch.no_grad():
                args["data"][:] = torch.from_numpy(X_val[i:i + batch_size])
                args["softmax_label"][:] = torch.from_numpy(
                    y_val[i:i + batch_size])
            executor.forward(is_train=False)
            # scored on the host, as above
            probs = executor.outputs[0].cpu().numpy()  # mxlint: disable=MX309
            val_acc.append(Accuracy(y_val[i:i + batch_size], probs))
        out["train_acc"].append(float(np.mean(train_acc)))
        out["val_acc"].append(float(np.mean(val_acc)))
        print("epoch %d: train acc %.3f, val acc %.3f"
              % (epoch, np.mean(train_acc), np.mean(val_acc)))
    return out


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        out = train(ctx)
    assert out["val_acc"][-1] > 0.85, "low-level training failed to converge"
    print("simple_bind training converged.")
    return out


if __name__ == "__main__":
    main()
