"""CIFAR-10 recipe (notebook-style walkthrough), the port's counterpart of
``examples/notebooks/cifar_recipe.py``.

Reference counterpart: example/notebooks/cifar-recipe.ipynb — the full
training recipe in one place: component factories, a simplified Inception
net, the augmented RecordIO data pipeline, FeedForward training with
callbacks, save/load (both pickle and the checkpoint format), prediction,
and internal-feature extraction via ``get_internals``.

    python -m mxnet_tpu_torch.examples.notebooks.cifar_recipe \\
        [--num-epochs 2] [--cpu]

Data: synthetic CIFAR-shaped JPEG RecordIO shards generated on the fly
(class-coded prototypes + noise; the JAX script's bytes), same scheme as
``cifar10/train_cifar10``. The models live on the card unless ``--cpu`` is
given.
"""

import argparse
import logging
import os
import pickle
import tempfile

import numpy as np

import mxnet_tpu_torch as mx

from .. import example_context


# ----------------------------------------------------------------------------
# Component factories (same idea as composite_symbol, smaller net).

def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                act_type="relu"):
    conv = mx.symbol.Convolution(data=data, num_filter=num_filter,
                                 kernel=kernel, stride=stride, pad=pad)
    bn = mx.symbol.BatchNorm(data=conv)
    return mx.symbol.Activation(data=bn, act_type=act_type)


def DownsampleFactory(data, ch_3x3):
    conv = ConvFactory(data=data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       num_filter=ch_3x3)
    pool = mx.symbol.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                             pad=(1, 1), pool_type="max")
    return mx.symbol.Concat(conv, pool)


def SimpleFactory(data, ch_1x1, ch_3x3):
    conv1x1 = ConvFactory(data=data, kernel=(1, 1), pad=(0, 0),
                          num_filter=ch_1x1)
    conv3x3 = ConvFactory(data=data, kernel=(3, 3), pad=(1, 1),
                          num_filter=ch_3x3)
    return mx.symbol.Concat(conv1x1, conv3x3)


def build_net(num_classes=10):
    data = mx.symbol.Variable(name="data")
    conv1 = ConvFactory(data=data, kernel=(3, 3), pad=(1, 1), num_filter=32)
    in3a = SimpleFactory(conv1, 16, 16)
    in3b = SimpleFactory(in3a, 16, 16)
    in3c = DownsampleFactory(in3b, 32)
    in4a = SimpleFactory(in3c, 32, 32)
    in4b = DownsampleFactory(in4a, 32)
    in5a = SimpleFactory(in4b, 32, 32)
    pool = mx.symbol.Pooling(data=in5a, global_pool=True, kernel=(7, 7),
                             pool_type="avg", name="global_avg")
    flatten = mx.symbol.Flatten(data=pool, name="flatten")
    fc = mx.symbol.FullyConnected(data=flatten, num_hidden=num_classes,
                                  name="fc")
    return mx.symbol.SoftmaxOutput(data=fc, name="softmax")


# ----------------------------------------------------------------------------
# Synthetic CIFAR-shaped RecordIO data (no network egress needed).

def make_synthetic_rec(path, n, num_classes=10, seed=0):
    from mxnet_tpu_torch import recordio as rio

    rng = np.random.RandomState(seed)
    protos = rng.randint(0, 255, (num_classes, 32, 32, 3), np.uint8)
    w = rio.MXRecordIO(path, "w")
    for i in range(n):
        cls = i % num_classes
        noise = rng.randint(-30, 30, (32, 32, 3), np.int16)
        img = np.clip(protos[cls].astype(np.int16) + noise, 0,
                      255).astype(np.uint8)
        w.write(rio.pack_img(rio.IRHeader(0, float(cls), i, 0), img,
                             img_fmt=".jpg"))
    w.close()
    return path


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: this worker's card)")
    return ap


def iters(train_rec, val_rec, batch_size, **train_kw):
    """The augmented train pipeline (random crop + mirror, mean
    subtraction) and the plain validation one; ``train_kw`` overrides the
    train iterator's arguments."""
    kw = dict(path_imgrec=train_rec, data_shape=(3, 28, 28),
              batch_size=batch_size, rand_crop=True, rand_mirror=True,
              shuffle=True, mean_r=128, mean_g=128, mean_b=128,
              scale=1.0 / 128)
    kw.update(train_kw)
    train_iter = mx.io.ImageRecordIter(**kw)
    val_iter = mx.io.ImageRecordIter(
        path_imgrec=val_rec, data_shape=(3, 28, 28),
        batch_size=batch_size, rand_crop=False, rand_mirror=False,
        mean_r=128, mean_g=128, mean_b=128, scale=1.0 / 128)
    return train_iter, val_iter


def fit(ctx, train_iter, val_iter, num_epochs, batch_size, arg_params=None,
        aux_params=None, eval_metric="accuracy"):
    """The notebook's training; ``arg_params``, ``aux_params`` and
    ``eval_metric`` pin or observe the run to compare."""
    softmax = build_net()
    model = mx.model.FeedForward(
        symbol=softmax, ctx=ctx, num_epoch=num_epochs,
        learning_rate=0.05, momentum=0.9, wd=0.0001,
        initializer=mx.init.Uniform(0.07), arg_params=arg_params,
        aux_params=aux_params)
    # Speedometer prints samples/sec every 10 batches, as in the notebook.
    model.fit(X=train_iter, eval_data=val_iter, eval_metric=eval_metric,
              batch_end_callback=mx.callback.Speedometer(batch_size, 10))
    return softmax, model


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = example_context(args.cpu)
    with ctx:
        return recipe(ctx, args)


def recipe(ctx, args):
    tmp = tempfile.mkdtemp(prefix="cifar_recipe_")
    train_rec = make_synthetic_rec(os.path.join(tmp, "train.rec"), 1536,
                                   seed=0)
    val_rec = make_synthetic_rec(os.path.join(tmp, "val.rec"), 512, seed=1)
    train_iter, val_iter = iters(train_rec, val_rec, args.batch_size)
    softmax, model = fit(ctx, train_iter, val_iter, args.num_epochs,
                         args.batch_size)

    # ------------------------------------------------------------------
    # Saving and loading. pickle works on the whole model; save/load uses
    # the prefix-symbol.json + prefix-%04d.params checkpoint format (the
    # recommended path — it is readable from any process).
    smodel = pickle.dumps(model)
    model2 = pickle.loads(smodel)

    prefix = os.path.join(tmp, "cifar")
    model.save(prefix)
    model3 = mx.model.FeedForward.load(prefix, model.num_epoch)

    # Both restored models predict identically:
    prob2 = model2.predict(val_iter)
    prob3 = model3.predict(val_iter)
    assert np.allclose(prob2, prob3, atol=1e-5)
    pred = np.argmax(prob3, axis=1)
    labels = np.concatenate(
        [np.asarray(b.label[0].cpu()) for b in iter(val_iter)])[:len(pred)]
    acc = float(np.mean(pred == labels))
    print("restored-model val accuracy: %.3f" % acc)

    # ------------------------------------------------------------------
    # Internal-feature extraction: any internal output is itself a symbol
    # that can head a forward-only model (transfer-learning workflow).
    internals = softmax.get_internals()
    print("some internals:", internals.list_outputs()[-6:])
    fea_symbol = internals["global_avg_output"]
    feature_extractor = mx.model.FeedForward(
        ctx=ctx, symbol=fea_symbol, arg_params=model.arg_params,
        aux_params=model.aux_params, allow_extra_params=True)
    features = feature_extractor.predict(val_iter)
    print("extracted feature maps:", features.shape)
    assert features.shape[1:] == (64, 1, 1)
    print("cifar recipe complete.")
    return {"accuracy": acc, "features": tuple(features.shape),
            "probs": prob3}


if __name__ == "__main__":
    main()
