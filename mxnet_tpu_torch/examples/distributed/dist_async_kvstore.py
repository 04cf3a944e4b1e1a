"""dist_async semantics test, the port's counterpart of
``examples/distributed/dist_async_kvstore.py`` (reference:
tests/python/multi-node's dist_async tier; server behaviour
kvstore_dist_server.h:194-202).

What distinguishes async from BSP dist_sync: a worker's push applies
immediately and its pull observes its own updates WITHOUT any other worker
pushing — under dist_sync the push would block until all workers arrive.

Run under the launcher:
    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_async_kvstore [--cpu]

The arrays live on the worker's card unless ``--cpu`` is given; the host
(rank 0's process) keeps the values in host memory.
"""

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context

SHAPE = (4,)
KEY = 11


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        kv = mx.kv.create("dist_async")
        rank, nworker = kv.rank, kv.num_workers
        assert kv.type == "dist_async"
        kv.init(KEY, mx.nd.zeros(SHAPE))
        kv.set_optimizer(mx.optimizer.create("test"))  # w += g on the host

        if rank == 0:
            # Staleness: three pushes and a pull while the other workers
            # are idle at the barrier. Under BSP this would deadlock
            # waiting for worker 1's pushes; update-on-arrival must apply
            # each immediately.
            for _ in range(3):
                kv.push(KEY, [mx.nd.ones(SHAPE)])
            out = mx.nd.empty(SHAPE)
            kv.pull(KEY, out=out)
            np.testing.assert_allclose(out.asnumpy(), np.full(SHAPE, 3.0))
        kv.barrier()
        # after the barrier every worker observes rank 0's async updates
        out = mx.nd.empty(SHAPE)
        kv.pull(KEY, out=out)
        np.testing.assert_allclose(out.asnumpy(), np.full(SHAPE, 3.0))
        kv.barrier()  # all pulls above land before anyone's next push
        # now every worker pushes once; total becomes 3 + nworker regardless
        # of arrival order (sum is order-independent; no BSP rounds involved)
        kv.push(KEY, [mx.nd.ones(SHAPE)])
        kv.barrier()
        kv.pull(KEY, out=out)
        np.testing.assert_allclose(out.asnumpy(),
                                   np.full(SHAPE, 3.0 + nworker))
        print(f"worker {rank}/{nworker}: dist_async semantics OK "
              f"(value = {3 + nworker})")
        # the host's process waits here until every worker has stopped
        kv.close()


if __name__ == "__main__":
    main()
