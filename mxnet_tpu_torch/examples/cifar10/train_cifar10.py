"""CIFAR-10 Inception-BN training, the port's counterpart of
``examples/cifar10/train_cifar10.py`` (reference: example/cifar10/cifar10.py,
the 'local' kvstore baseline config in BASELINE.md).

Data: a RecordIO file packed by im2rec (--data-rec), or synthetic
CIFAR-shaped JPEG records generated on the fly (default; the JAX script's
bytes, so a shard either package wrote serves both).

    python -m mxnet_tpu_torch.examples.cifar10.train_cifar10 \\
        --num-epochs 2 [--bf16] [--cpu]

``--bf16`` trains in ``torch.bfloat16`` over f32 masters
(``FeedForward(compute_dtype=)``). The model lives on the card unless
``--cpu`` is given.
"""

import logging
import os
import tempfile

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context, example_contexts


def make_synthetic_rec(path, n=2048, num_classes=10, seed=0):
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
    ap = cpu_parser(__doc__)
    ap.add_argument("--data-rec", default=None)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--kv-store", default="local")
    ap.add_argument("--num-devices", type=int, default=1)
    ap.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    return ap


def train(args, arg_params=None, aux_params=None, eval_metric="accuracy",
          **iter_kw):
    """The JAX script's fit; returns the model. ``arg_params`` and
    ``aux_params`` start from given weights; ``iter_kw`` overrides the
    iterator's arguments (augmentation and shuffle off, to compare) and
    ``eval_metric`` the fit's (a recorder of each batch's outputs)."""
    import torch

    from mxnet_tpu_torch.models import inception_bn_cifar

    rec = args.data_rec
    if rec is None:
        rec = os.path.join(tempfile.gettempdir(), "cifar_synth.rec")
        if not os.path.exists(rec):
            logging.info("generating synthetic CIFAR rec at %s", rec)
            make_synthetic_rec(rec)

    kw = dict(path_imgrec=rec, data_shape=(3, 28, 28),
              batch_size=args.batch_size, rand_crop=True, rand_mirror=True,
              shuffle=True, mean_r=128, mean_g=128, mean_b=128,
              scale=1 / 128.0)
    kw.update(iter_kw)
    train_it = mx.io.ImageRecordIter(**kw)

    net = inception_bn_cifar()
    ctx = example_contexts(args.cpu, args.num_devices)
    model = mx.FeedForward(
        net, ctx=ctx, num_epoch=args.num_epochs,
        initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2),
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        arg_params=arg_params, aux_params=aux_params,
        lr=args.lr, momentum=0.9, wd=1e-4)
    model.fit(train_it, kvstore=args.kv_store, eval_metric=eval_metric,
              batch_end_callback=mx.callback.Speedometer(args.batch_size, 10))
    return model


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with example_context(args.cpu):
        return train(args)


if __name__ == "__main__":
    main()
