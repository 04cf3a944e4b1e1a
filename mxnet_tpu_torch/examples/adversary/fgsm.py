"""Fast-gradient-sign adversarial examples, the port's counterpart of
``examples/adversary/fgsm.py`` (rewrite of the reference
example/adversary/adversary_generation.ipynb): train a classifier, then
bind an executor with a gradient buffer on the INPUT and perturb images by
the sign of dLoss/dInput.

Demonstrates the raw bind/forward/backward API surface: grad_req on data,
backward() populating input gradients — the same mechanics the reference
notebook uses through simple_bind.

    python -m mxnet_tpu_torch.examples.adversary.fgsm [--cpu]

Data: scikit-learn's scanned digits, read from the port's copy of its file
(``examples/_digits.py``). The model and the executor live on the card
unless ``--cpu`` is given.
"""

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import symbol as sym

from .. import cpu_parser, example_context
from .._digits import load_digits


def build_mlp(classes):
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, name="fc1", num_hidden=64)
    net = sym.Activation(data=net, name="relu1", act_type="relu")
    net = sym.FullyConnected(data=net, name="fc2", num_hidden=classes)
    return sym.SoftmaxOutput(data=net, name="softmax")


def digits():
    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    return X, y


def attack(ctx, eps=0.15, num_epoch=20, arg_params=None):
    """Train, then perturb every full batch by eps * sign(dL/dx). Returns
    ``{"clean_acc", "adv_acc", "model", "adv", "first_grad"}``."""
    X, y = digits()
    net = build_mlp(10)
    model = mx.FeedForward(net, ctx=ctx, num_epoch=num_epoch,
                           learning_rate=0.1, momentum=0.9,
                           initializer=mx.init.Xavier(), arg_params=arg_params)
    model.fit(X, y, batch_size=50)
    clean_acc = (model.predict(X, batch_size=50).argmax(axis=1) == y).mean()

    # bind with a gradient buffer on the input only
    batch = 50
    exe = net.simple_bind(ctx=ctx, grad_req={"data": "write"},
                          data=(batch, X.shape[1]),
                          softmax_label=(batch,))
    exe.copy_params_from(model.arg_params, model.aux_params)

    adv = np.empty_like(X)
    first_grad = None
    for i in range(0, len(X) - batch + 1, batch):
        xb, yb = X[i:i + batch], y[i:i + batch]
        exe.forward(is_train=True, data=xb, softmax_label=yb)
        exe.backward()  # loss head injects prob - onehot
        # the attack perturbs the host's images: the read is the point
        g = exe.grad_dict["data"].cpu().numpy()  # mxlint: disable=MX309
        if first_grad is None:
            first_grad = g.copy()
        adv[i:i + batch] = np.clip(xb + eps * np.sign(g), 0.0, 1.0)
    n_done = (len(X) // batch) * batch
    adv[n_done:] = X[n_done:]

    adv_acc = (model.predict(adv, batch_size=50).argmax(axis=1) == y).mean()
    return {"clean_acc": float(clean_acc), "adv_acc": float(adv_acc),
            "model": model, "adv": adv, "first_grad": first_grad}


def main(argv=None, eps=0.15):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        out = attack(ctx, eps)
    clean_acc, adv_acc = out["clean_acc"], out["adv_acc"]
    print(f"clean accuracy: {clean_acc:.3f}   "
          f"adversarial (eps={eps}): {adv_acc:.3f}")
    assert clean_acc > 0.95
    assert adv_acc < clean_acc - 0.3, "FGSM should break the classifier"
    return out


if __name__ == "__main__":
    main()
