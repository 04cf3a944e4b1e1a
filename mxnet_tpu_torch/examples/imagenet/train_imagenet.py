"""ImageNet-scale training, the port's counterpart of
``examples/imagenet/train_imagenet.py`` (reference: example/imagenet/ —
AlexNet and Inception-BN with ImageRecordIter; here plus ResNet-50, the
BASELINE.json north-star model).

Data: RecordIO shards from im2rec (--data-rec), or synthetic 256x256 JPEG
records (default: ``MXTPU_SYNTH_IMAGES`` of them, 512, the JAX script's
bytes) cropped to 224x224. ``--num-devices n`` trains on ``n`` contexts
(card ``i % cards``); multi-process data parallelism with ``--kv-store
dist_sync`` under the repo's launcher, each worker reading its part of the
shard, rank 0 writing the shard and the checkpoints:

    python -m mxnet_tpu_torch.examples.imagenet.train_imagenet \\
        --network resnet-50 --bf16 [--cpu]
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.imagenet.train_imagenet --network alexnet \\
        --kv-store dist_sync [--cpu]

Launched workers that share one card sum their gradients over gloo
(``kv.create("dist_sync")``). The model lives on the card unless ``--cpu``
is given.
"""

import logging
import os
import tempfile
import time

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context, example_contexts


def make_synthetic_rec(path, n=512, num_classes=100, size=256, seed=0):
    from mxnet_tpu_torch import recordio as rio

    rng = np.random.RandomState(seed)
    # write-then-rename: under the launcher several workers may race to
    # create the same shard; os.replace makes the publish atomic so a
    # reader never sees a half-written file
    tmp = f"{path}.w{os.getpid()}"
    w = rio.MXRecordIO(tmp, "w")
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), np.uint8)
        w.write(rio.pack_img(rio.IRHeader(0, float(i % num_classes), i, 0),
                             img, img_fmt=".jpg", quality=85))
    w.close()
    os.replace(tmp, path)
    return path


def _network(name):
    from mxnet_tpu_torch import models

    return {"alexnet": models.alexnet, "inception-bn": models.inception_bn,
            "resnet-50": models.resnet50}[name]


NETWORKS = {name: (lambda n, name=name: _network(name)(n))
            for name in ("alexnet", "inception-bn", "resnet-50")}


def parser():
    ap = cpu_parser(__doc__)
    ap.add_argument("--network", choices=sorted(NETWORKS),
                    default="resnet-50")
    ap.add_argument("--data-rec", default=None)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--num-epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--kv-store", default="device")
    ap.add_argument("--num-devices", type=int, default=1)
    ap.add_argument("--bf16", action="store_true")
    return ap


def synthetic_rec_path():
    """The default shard's path: keyed on its size, so a cached shard of
    another size is never reused."""
    n_synth = int(os.environ.get("MXTPU_SYNTH_IMAGES", "512"))
    return os.path.join(tempfile.gettempdir(),
                        f"imagenet_synth_{n_synth}.rec"), n_synth


def train(args, arg_params=None, aux_params=None, eval_metric="accuracy",
          **iter_kw):
    """The JAX script's fit; returns the model. ``arg_params`` and
    ``aux_params`` start from given weights; ``iter_kw`` overrides the
    iterator's arguments (augmentation and shuffle off, to compare) and
    ``eval_metric`` the fit's (a recorder of each batch's outputs)."""
    import torch

    ctx = example_contexts(args.cpu, args.num_devices)
    # dist kvstore first: the iterator shards by worker rank (reference:
    # ImageRecordIter num_parts/part_index from kvstore rank, so each
    # worker reads only its slice)
    kv = mx.kv.create(args.kv_store, ctx=ctx[0]) \
        if "dist" in args.kv_store else args.kv_store
    num_parts, part_index = (kv.num_workers, kv.rank) \
        if "dist" in args.kv_store else (1, 0)

    rec = args.data_rec
    if rec is None:
        args.num_classes = 100
        rec, n_synth = synthetic_rec_path()
        if not os.path.exists(rec):
            if part_index == 0:
                # rank 0 generates, the rest wait for the atomic publish
                logging.info("generating synthetic ImageNet rec at %s", rec)
                make_synthetic_rec(rec, n=n_synth)
            else:
                deadline = time.time() + 600
                while not os.path.exists(rec):
                    if time.time() > deadline:
                        raise RuntimeError(f"timed out waiting for {rec}")
                    time.sleep(0.5)

    kw = dict(path_imgrec=rec, data_shape=(3, 224, 224),
              batch_size=args.batch_size, rand_crop=True, rand_mirror=True,
              shuffle=True, resize=256, mean_r=123.68, mean_g=116.78,
              mean_b=103.94, scale=1 / 58.8, num_parts=num_parts,
              part_index=part_index)
    kw.update(iter_kw)
    train_it = mx.io.ImageRecordIter(**kw)

    net = NETWORKS[args.network](args.num_classes)
    model = mx.FeedForward(
        net, ctx=ctx, num_epoch=args.num_epochs,
        initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2),
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        arg_params=arg_params, aux_params=aux_params,
        lr=args.lr, momentum=0.9, wd=1e-4)
    # checkpoint from rank 0 only: every rank holds the same BSP-synced
    # weights, and two ranks writing one prefix would race
    callbacks = mx.callback.do_checkpoint(
        os.path.join(tempfile.gettempdir(), args.network)) \
        if part_index == 0 else None
    model.fit(train_it, kvstore=kv, eval_metric=eval_metric,
              batch_end_callback=mx.callback.Speedometer(args.batch_size, 10),
              epoch_end_callback=callbacks)
    return model


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    with example_context(args.cpu):
        return train(args)


if __name__ == "__main__":
    main()
