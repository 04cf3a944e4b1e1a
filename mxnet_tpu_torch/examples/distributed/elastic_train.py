"""Elastic training demonstration, the port's counterpart of
``examples/distributed/elastic_train.py``.

An 8-replica data-parallel run loses 2 workers mid-epoch, keeps training
on the 6 survivors, and re-absorbs the capacity two epochs later — all in
ONE process, no relaunch. The ElasticCoordinator owns membership; fit()
polls it every step and, on a change, quiesces, restores the newest
snapshot onto the new world, re-derives the wire plans and resumes. The
downtime is priced into the per-epoch Goodput line as `resize` badput.

    python -m mxnet_tpu_torch.examples.distributed.elastic_train \\
        /tmp/elastic_ckpt [--cpu]

The eight replicas are ``[gpu(0)] * 8``, aliases of the one card each a
replica of its own (an elastic fit makes one replica a ctx entry), and the
gradients cross them int8-compressed through the comm kernels, overlapped
with the backward. With ``--cpu`` they are ``[cpu(i) for i in range(8)]``
and the kernels' plain versions run.
"""

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.resilience import ElasticCoordinator

from .. import cpu_parser, example_context

WORLD = 8


def main(argv=None):
    """Train, print the resizes and the final accuracy; returns the
    coordinator and the accuracy."""
    ap = cpu_parser(__doc__)
    ap.add_argument("ckpt_dir", nargs="?", default="/tmp/elastic_ckpt")
    args = ap.parse_args(argv)
    ctx = example_context(args.cpu)
    ctxs = [mx.cpu(i) for i in range(WORLD)] if args.cpu else [ctx] * WORLD

    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(240, 8) + 1.0,
                        rng.randn(240, 8) - 1.0]).astype(np.float32)
    y = np.concatenate([np.ones(240), np.zeros(240)]).astype(np.float32)
    order = rng.permutation(480)  # mixed-class batches; the ITERATOR stays
    X, y = X[order], y[order]     # unshuffled so every epoch replays bitwise

    co = ElasticCoordinator(WORLD, min_world=4)

    def churn(param):
        # a real deployment calls kill() from heartbeat expiry or a
        # kvstore MembershipTimeout; here the schedule is scripted
        if param.epoch == 1 and param.nbatch == 3 and co.world_size == 8:
            print(">>> losing ranks", co.kill(), "and", co.kill())
        if param.epoch == 3 and param.nbatch == 2 and co.world_size == 6:
            print(">>> capacity returned:", co.join_all())

    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=16)
    net = mx.sym.Activation(data=net, name="relu1", act_type="relu")
    net = mx.sym.FullyConnected(data=net, name="fc2", num_hidden=2)
    net = mx.sym.SoftmaxOutput(data=net, name="softmax")
    model = mx.FeedForward(
        net, ctx=ctxs, num_epoch=5, optimizer="sgd", learning_rate=0.1)
    model.fit(mx.io.NDArrayIter(X, y, batch_size=48, shuffle=False),
              batch_size=48, elastic=co, sharded_checkpoint_dir=args.ckpt_dir,
              batch_end_callback=churn, compression="int8", overlap=True,
              telemetry=True)

    print("resizes:", co.resizes)
    for h in co.history:
        print(f"  {h['from']} -> {h['to']}  downtime {h['downtime_s']:.2f}s"
              f"  ({h['reason']})")
    acc = model.score(X, y=y)
    print("final accuracy:", acc)
    return co, acc


if __name__ == "__main__":
    main()
