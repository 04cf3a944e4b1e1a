"""Distributed KVStore semantics test, the port's counterpart of
``examples/distributed/dist_sync_kvstore.py``.

Two modes:
  - under tools/launch.py (MXTPU_WORKER_RANK set): each process is a worker
    of a ``torch.distributed`` world that ``kv.create("dist_sync")`` joins;
  - standalone: 4 in-process workers on threads against the BSP server
    group — same accumulate-until-N semantics, one command:
      python -m mxnet_tpu_torch.examples.distributed.dist_sync_kvstore

    python tools/launch.py -n 2 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_sync_kvstore [--cpu]

The arrays live on the worker's card unless ``--cpu`` is given.
"""

import os
import threading

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context

SHAPE = (4, 4)
KEYS = [3, 5, 7]
BIG_SHAPE = (1200,)  # ≙ the reference's striped "big array" key
BIG_KEY = 99


def check(kv, nworker):
    # init (rank 0) then one BSP push round per key
    kv.init(KEYS, [mx.nd.ones(SHAPE)] * len(KEYS))
    kv.init(BIG_KEY, mx.nd.ones(BIG_SHAPE))
    rank = kv.rank
    kv.push(KEYS, [[mx.nd.ones(SHAPE) * (rank + 1)]] * len(KEYS))
    kv.push(BIG_KEY, [mx.nd.ones(BIG_SHAPE) * (rank + 1)])
    expected = sum(r + 1 for r in range(nworker))
    outs = [mx.nd.empty(SHAPE) for _ in KEYS]
    kv.pull(KEYS, out=outs)
    for o in outs:
        np.testing.assert_allclose(o.asnumpy(), np.ones(SHAPE) * expected)
    big = mx.nd.empty(BIG_SHAPE)
    kv.pull(BIG_KEY, out=big)
    np.testing.assert_allclose(big.asnumpy(), np.ones(BIG_SHAPE) * expected)
    kv.barrier()
    print(f"worker {rank}/{nworker}: dist_sync semantics OK "
          f"(reduced value = {expected})")


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        if "MXTPU_WORKER_RANK" in os.environ:
            kv = mx.kv.create("dist_sync", ctx=ctx)
            check(kv, kv.num_workers)
            return
        n = 4
        stores = mx.kv.create_group(n)
        errors = []

        def worker(rank):
            try:
                with ctx:
                    check(stores[rank], n)
            except Exception as e:  # noqa: BLE001
                errors.append((rank, e))

        threads = [threading.Thread(target=worker, args=(r,), daemon=True)
                   for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors:
            raise SystemExit(f"FAILED: {errors}")
        print("all workers passed")


if __name__ == "__main__":
    main()
