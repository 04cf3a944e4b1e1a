"""Asynchronous distributed MLP training, the port's counterpart of
``examples/distributed/dist_async_mlp.py`` (reference:
tests/python/multi-node/dist_async_mlp.py — workers train against the
parameter server at their own pace, no BSP rounds, final accuracy
asserted).

Run under the launcher:
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_async_mlp [--cpu]

fit(kvstore='dist_async') runs update-on-kvstore semantics: the optimizer
executes on the parameter host (rank 0 hosts it); every batch each worker
pushes its gradients (applied on arrival — unbounded staleness) and pulls
the current weights. There is no cross-worker collective anywhere in the
step. The model lives on the worker's card unless ``--cpu`` is given.
"""

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context
from .dist_sync_mlp import make_dataset, mlp_symbol


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        kv = mx.kv.create("dist_async")
        rank, nworker = kv.rank, kv.num_workers
        X, y = make_dataset()
        Xs, ys = X[rank::nworker], y[rank::nworker]

        model = mx.model.FeedForward(
            symbol=mlp_symbol(), ctx=ctx, num_epoch=5, learning_rate=0.1,
            momentum=0.9, initializer=mx.init.Xavier())
        model.fit(Xs, ys, batch_size=32, kvstore=kv)

        acc = model.score(X, y=y)
        print(f"worker {rank}/{nworker}: dist_async_mlp accuracy = "
              f"{acc:.4f}")
        assert acc > 0.95, f"worker {rank}: accuracy too low: {acc}"
        kv.barrier()
        kv.close()


if __name__ == "__main__":
    main()
