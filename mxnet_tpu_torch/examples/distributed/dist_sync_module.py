"""Distributed data-parallel training through the Module API, the port's
counterpart of ``examples/distributed/dist_sync_module.py``: gradients
round through a dist_sync store each step (push/pull, summed across
workers), rank 0's initialization is broadcast so replicas start
identical, and the rescale folds num_workers — every worker must converge
to the same accurate model.

Run under the launcher:
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_sync_module [--cpu]

Each rank seeds the port's generators (``mx.random.seed``, which the
initializer draws from) differently on purpose, and numpy's as the JAX
script does: only the rank-0 broadcast makes the replicas equal.
"""

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context
from .dist_sync_mlp import make_dataset


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        kv = mx.kv.create("dist_sync", ctx=ctx)
        rank, nworker = kv.rank, kv.num_workers
        X, y = make_dataset()
        Xs, ys = X[rank::nworker], y[rank::nworker]

        net = mx.symbol.Variable("data")
        net = mx.symbol.FullyConnected(data=net, num_hidden=32, name="fc1")
        net = mx.symbol.Activation(data=net, act_type="relu", name="relu1")
        net = mx.symbol.FullyConnected(data=net, num_hidden=2, name="fc2")
        net = mx.symbol.SoftmaxOutput(data=net, name="softmax")

        # per-process seeds differ on purpose: the rank-0 broadcast in
        # fit(kvstore=...) must still produce identical replicas
        np.random.seed(1234 + rank)
        mx.random.seed(1234 + rank)
        it = mx.io.NDArrayIter(Xs, ys, batch_size=32)
        mod = mx.mod.Module(net, context=ctx)
        mod.fit(it, num_epoch=5, initializer=mx.init.Xavier(), kvstore=kv,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "rescale_grad": 1 / 32.0})

        name, acc = mod.score(mx.io.NDArrayIter(X, y, batch_size=32))
        # replicas must agree: print a weight digest every rank can compare
        w = mod.get_params()[0]["fc1_weight"].numpy()
        print(f"worker {rank}/{nworker}: dist_sync_module accuracy = "
              f"{acc:.4f} wsum = {float(np.abs(w).sum()):.6f}")
        assert acc > 0.95, f"worker {rank}: accuracy too low: {acc}"
        kv.barrier()


if __name__ == "__main__":
    main()
