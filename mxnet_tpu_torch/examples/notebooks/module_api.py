"""Module API walkthrough (notebook-style; successor-API counterpart of
simple_bind — the BASELINE north star's module.fit()), the port's
counterpart of ``examples/notebooks/module_api.py``.

Three levels of control over one model, all the same machinery:

1. high:   mod.fit(train_iter)
2. middle: bind / init_params / init_optimizer + forward/backward/update
3. low:    simple_bind executors (see simple_bind)

    python -m mxnet_tpu_torch.examples.notebooks.module_api [--cpu]

The JAX script pins JAX to the host's CPU; here the modules run on the
card unless ``--cpu`` is given.
"""

import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context


def dataset(n=512, dim=16, seed=7):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1.0,
                        rng.randn(n // 2, dim) - 1.0]).astype(np.float32)
    y = np.concatenate([np.ones(n // 2), np.zeros(n // 2)]).astype(np.float32)
    p = rng.permutation(n)
    return X[p], y[p]


def net():
    s = mx.symbol.Variable("data")
    s = mx.symbol.FullyConnected(data=s, num_hidden=32, name="fc1")
    s = mx.symbol.Activation(data=s, act_type="relu", name="relu1")
    s = mx.symbol.FullyConnected(data=s, num_hidden=2, name="fc2")
    return mx.symbol.SoftmaxOutput(data=s, name="softmax")


OPT = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 32.0}


def level1(ctx, train, val, arg_params=None, num_epoch=4):
    """``mod.fit``: one call; ``arg_params`` starts from given weights."""
    mod = mx.mod.Module(net(), context=ctx)
    if arg_params is not None:
        mod.bind(data_shapes=train.provide_data,
                 label_shapes=train.provide_label)
        mod.init_params(arg_params=arg_params)
    mod.fit(train, eval_data=val, num_epoch=num_epoch,
            initializer=mx.init.Xavier(), optimizer_params=dict(OPT))
    return mod


def level2(ctx, train, arg_params=None, num_epoch=4, on_batch=None):
    """The explicit lifecycle: you own the step. ``on_batch(mod)`` runs
    after each update (to read the outputs). Returns the module and the
    last epoch's training accuracy."""
    mod2 = mx.mod.Module(net(), context=ctx)
    mod2.bind(data_shapes=train.provide_data,
              label_shapes=train.provide_label)
    mod2.init_params(mx.init.Xavier(), arg_params=arg_params)
    mod2.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    metric = mx.metric.create("accuracy")
    for epoch in range(num_epoch):
        train.reset()
        metric.reset()
        for batch in train:
            mod2.forward(batch, is_train=True)   # you own the step
            mod2.backward()
            mod2.update()
            mod2.update_metric(metric, batch.label,
                               pad=getattr(batch, "pad", 0))
            if on_batch is not None:
                on_batch(mod2)
        print(f"epoch {epoch}: train {metric.get()[1]:.3f}")
    return mod2, metric.get()[1]


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        X, y = dataset()
        train = mx.io.NDArrayIter(X, y, batch_size=32, shuffle=True)
        val = mx.io.NDArrayIter(X, y, batch_size=32)

        # ---- level 1: one call ----------------------------------------
        mod = level1(ctx, train, val)
        name, acc = mod.score(val)
        print(f"fit(): {name}={acc:.3f}")
        assert acc > 0.95

        # ---- level 2: explicit lifecycle ------------------------------
        _, acc2 = level2(ctx, train)
        assert acc2 > 0.95

        # ---- checkpoints interoperate with FeedForward ----------------
        prefix = os.path.join(tempfile.mkdtemp(), "mod")
        mod.save_checkpoint(prefix, 4)
        ff = mx.model.FeedForward.load(prefix, 4)
        agree = (ff.predict(X).argmax(1) == mod.predict(val).argmax(1)).mean()
        print(f"FeedForward.load on the Module checkpoint agrees: {agree:.3f}")
        assert agree > 0.99
    return {"fit_accuracy": acc, "lifecycle_accuracy": acc2,
            "agree": float(agree)}


if __name__ == "__main__":
    main()
