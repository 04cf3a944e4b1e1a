"""Shared dataset and runner for the launched LeNet tiers, the port's
counterpart of ``examples/distributed/lenet_dist_common.py`` (reference:
tests/python/multi-node/common.py — one module the sync and async conv-net
scripts both import, randomness fixed so every worker and every run sees
identical data)."""

import numpy as np

from .. import cpu_parser, example_context


def make_dataset(n=512, seed=42):
    """Deterministic 4-class 28x28 images: a bright square in one of the
    four quadrants identifies the class."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 1, 28, 28).astype(np.float32) * 0.1
    y = rng.randint(0, 4, (n,)).astype(np.float32)
    corners = {0: (2, 2), 1: (2, 16), 2: (16, 2), 3: (16, 16)}
    for i in range(n):
        r, c = corners[int(y[i])]
        X[i, 0, r:r + 10, c:c + 10] += 1.0
    return X, y


def run_tier(kv_type, lr, tag, threshold=0.9, argv=None, doc=None):
    """The whole launched-worker body both tiers share: create the store,
    shard rows by rank, train LeNet on the worker's card (or the CPU with
    ``--cpu``), score on the FULL set, assert."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import lenet

    args = cpu_parser(doc).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        kv = mx.kv.create(kv_type, ctx=ctx)
        rank, nworker = kv.rank, kv.num_workers
        X, y = make_dataset()
        Xs, ys = X[rank::nworker], y[rank::nworker]

        model = mx.model.FeedForward(
            symbol=lenet(num_classes=4), ctx=ctx, num_epoch=6,
            learning_rate=lr, momentum=0.9, initializer=mx.init.Xavier())
        model.fit(Xs, ys, batch_size=32, kvstore=kv)

        acc = model.score(X, y=y)
        print(f"worker {rank}/{nworker}: {tag} accuracy = {acc:.4f}")
        assert acc > threshold, f"worker {rank}: accuracy too low: {acc}"
        kv.barrier()
        close = getattr(kv, "close", None)
        if close is not None:
            close()
