"""Asynchronous distributed conv-net training, the port's counterpart of
``examples/distributed/dist_async_lenet.py`` (reference:
tests/python/multi-node/dist_async_lenet.py — LeNet against the async
parameter server, workers at their own pace, accuracy asserted).

Run under the launcher:
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_async_lenet [--cpu]

Completes the multi-node matrix: {sync, async} x {mlp, lenet}. The conv and
pool gradients travel to the update-on-arrival host (rank 0; reference:
kvstore_dist_server.h:194-202) rather than through a collective. The
worker body lives in lenet_dist_common.run_tier (shared with the sync
tier; only the kv type and lr differ).
"""

from .lenet_dist_common import run_tier


def main(argv=None):
    run_tier("dist_async", lr=0.05, tag="dist_async_lenet", argv=argv,
             doc=__doc__)


if __name__ == "__main__":
    main()
