"""Distributed data-parallel conv-net training to asserted accuracy, the
port's counterpart of ``examples/distributed/dist_sync_lenet.py``
(reference: tests/python/multi-node/dist_sync_lenet.py — LeNet across
launched workers, BSP gradient sync every batch).

Run under the launcher:
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_sync_lenet [--cpu]

Against dist_sync_mlp this tier adds the convolutional stack: conv and
pool gradients summed over the ranks, not just dense products. The worker
body lives in lenet_dist_common.run_tier (shared with the async tier).
"""

from .lenet_dist_common import run_tier


def main(argv=None):
    run_tier("dist_sync", lr=0.1, tag="dist_sync_lenet", argv=argv,
             doc=__doc__)


if __name__ == "__main__":
    main()
