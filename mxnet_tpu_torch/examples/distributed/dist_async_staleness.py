"""dist_async staleness characterization, the port's counterpart of
``examples/distributed/dist_async_staleness.py``: workers at deliberately
skewed speeds (reference semantics: kvstore_dist_server.h:194-202 — update
on arrival, unbounded staleness).

Run under the launcher:
    python tools/launch.py -n 4 python -m \\
        mxnet_tpu_torch.examples.distributed.dist_async_staleness [--cpu]

Each worker trains the same tiny logistic-regression objective but sleeps
rank*SKEW seconds per batch, so fast workers lap slow ones — under BSP this
would stall the fleet at the slowest worker; under dist_async every push is
applied immediately. Asserts:
  * every worker completes all of its batches (no worker gated on another),
  * the server applied exactly sum(batches) update batches (update_count),
  * the final model still converges despite stale gradients.
The workers compute their gradients in numpy on the host, as the JAX
script does; the store's initial value is made on the worker's card unless
``--cpu`` is given.
"""

import time

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context

BATCHES = 12
SKEW = 0.05  # seconds of extra per-batch latency per rank


def make_dataset(n=1024, dim=8, seed=7):
    rng = np.random.RandomState(seed)
    w = rng.randn(dim).astype(np.float32)
    X = rng.randn(n, dim).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    return X, y, w


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    ctx = example_context(args.cpu)
    with ctx:
        kv = mx.kv.create("dist_async")
        rank, nworker = kv.rank, kv.num_workers
        X, y, _ = make_dataset()
        dim = X.shape[1]

        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5))
        # all ranks call init (rank 0 sends the value, init barriers
        # internally)
        kv.init(0, mx.nd.zeros((dim,)))

        batch = 64
        rng = np.random.RandomState(100 + rank)
        t0 = time.monotonic()
        for _ in range(BATCHES):
            idx = rng.randint(0, len(X), size=batch)
            xb, yb = X[idx], y[idx]
            w = kv.pull_many([0])[0]
            # logistic-regression gradient on this worker's (stale) weights
            p = 1.0 / (1.0 + np.exp(-(xb @ w)))
            grad = xb.T @ (p - yb) / batch
            kv.push_pull({0: grad.astype(np.float32)})
            time.sleep(rank * SKEW)  # skew: rank 3 runs ~4x slower than 0
        elapsed = time.monotonic() - t0
        print(f"worker {rank}/{nworker}: completed {BATCHES} batches "
              f"in {elapsed:.2f}s")

        kv.barrier()
        if rank == 0:
            stats = kv.stats()
            expect = BATCHES * nworker
            assert stats["update_count"] == expect, \
                f"server applied {stats['update_count']} updates, " \
                f"expected {expect}"
            w = kv.pull_many([0])[0]
            p = 1.0 / (1.0 + np.exp(-(X @ w)))
            acc = float(np.mean((p > 0.5) == (y > 0.5)))
            print(f"dist_async_staleness OK: updates={stats['update_count']} "
                  f"acc={acc:.4f}")
            assert acc > 0.9, \
                f"stale-gradient training failed to converge: {acc}"
        kv.barrier()
        kv.close()


if __name__ == "__main__":
    main()
