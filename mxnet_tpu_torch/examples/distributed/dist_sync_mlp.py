"""Distributed data-parallel MLP training, the port's counterpart of
``examples/distributed/dist_sync_mlp.py``: each worker trains on its shard,
gradients BSP-synced every batch, final accuracy asserted.

Run under the launcher:
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_sync_mlp [--cpu]

Each process joins the ``torch.distributed`` world (``kv.create(
"dist_sync")`` wires it up from the launcher's variables) and the
FeedForward trainer sums every batch's gradients over the ranks: with nccl
where each rank has a card of its own, with gloo through host buffers where
the ranks share one card or run on the CPU. The model lives on the
worker's card unless ``--cpu`` is given.
"""

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context


def make_dataset(n=1024, dim=16, seed=42):
    """Deterministic two-class blobs — identical on every worker
    (reference: multi-node/common.py disables iterator randomness)."""
    rng = np.random.RandomState(seed)
    half = n // 2
    X = np.concatenate([rng.randn(half, dim) + 1.5,
                        rng.randn(half, dim) - 1.5]).astype(np.float32)
    y = np.concatenate([np.zeros(half), np.ones(half)]).astype(np.float32)
    perm = rng.permutation(n)
    return X[perm], y[perm]


def mlp_symbol():
    net = mx.symbol.Variable("data")
    net = mx.symbol.FullyConnected(data=net, num_hidden=32, name="fc1")
    net = mx.symbol.Activation(data=net, act_type="relu", name="relu1")
    net = mx.symbol.FullyConnected(data=net, num_hidden=2, name="fc2")
    return mx.symbol.SoftmaxOutput(data=net, name="softmax")


def train(kv, ctx, arg_params=None):
    """The worker's fit on its shard; returns the model and the full set.
    ``arg_params`` starts from given weights instead of Xavier's."""
    rank, nworker = kv.rank, kv.num_workers
    X, y = make_dataset()
    # shard rows by rank (≙ num_parts/part_index sharding in the iterators)
    Xs, ys = X[rank::nworker], y[rank::nworker]
    model = mx.model.FeedForward(
        symbol=mlp_symbol(), ctx=ctx, num_epoch=5, learning_rate=0.1,
        momentum=0.9, initializer=mx.init.Xavier(), arg_params=arg_params)
    model.fit(Xs, ys, batch_size=32, kvstore=kv)
    return model, X, y


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        kv = mx.kv.create("dist_sync", ctx=ctx)
        rank, nworker = kv.rank, kv.num_workers
        model, X, y = train(kv, ctx)
        acc = model.score(X, y=y)
        print(f"worker {rank}/{nworker}: dist_sync_mlp accuracy = {acc:.4f}")
        assert acc > 0.95, f"worker {rank}: accuracy too low: {acc}"
        kv.barrier()


if __name__ == "__main__":
    main()
