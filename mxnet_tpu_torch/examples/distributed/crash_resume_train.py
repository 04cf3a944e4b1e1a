"""Failure recovery demonstration, the port's counterpart of
``examples/distributed/crash_resume_train.py``: checkpoint/restore plus a
relaunch (reference anchors: the kStopServer teardown in kvstore_dist.h and
callback.do_checkpoint).

Run once with MXTPU_CRASH_AFTER_EPOCH=2: the process hard-dies (os._exit,
no cleanup — simulating a preemption/OOM kill) right after epoch 2's
sharded checkpoint lands. Run again without it: fit() auto-resumes from
the newest complete step in the checkpoint dir and trains to completion.
The variable is this script's, not the package's.

    MXTPU_CRASH_AFTER_EPOCH=2 python -m \\
        mxnet_tpu_torch.examples.distributed.crash_resume_train /tmp/ckpt \\
        [--cpu] || true
    python -m mxnet_tpu_torch.examples.distributed.crash_resume_train \\
        /tmp/ckpt [--cpu]     # resumes at epoch 2

The model trains on the card unless ``--cpu`` is given.
"""

import os

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import mlp

from .. import cpu_parser, example_context


def main(argv=None):
    ap = cpu_parser(__doc__)
    ap.add_argument("ckpt_dir")
    args = ap.parse_args(argv)
    ctx = example_context(args.cpu)
    crash_after = int(os.environ.get("MXTPU_CRASH_AFTER_EPOCH", "0"))

    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(128, 8) + 1.0,
                        rng.randn(128, 8) - 1.0]).astype(np.float32)
    y = np.concatenate([np.ones(128), np.zeros(128)]).astype(np.float32)

    def maybe_crash(epoch, symbol, arg_params, aux_params):
        if crash_after and epoch + 1 >= crash_after:
            print(f"simulated preemption after epoch {epoch}", flush=True)
            # hard kill: no atexit, no flush, like the real thing
            os._exit(137)

    model = mx.FeedForward(mlp(num_classes=2, hidden=(16,)), ctx=ctx,
                           num_epoch=5, optimizer="sgd", learning_rate=0.1,
                           initializer=mx.init.Xavier())
    model.fit(X, y, batch_size=32, sharded_checkpoint_dir=args.ckpt_dir,
              epoch_end_callback=maybe_crash)

    acc = model.score(X, y=y)
    print(f"crash_resume final accuracy = {acc:.4f} "
          f"(resumed from epoch {model.begin_epoch})")
    assert acc > 0.95, acc


if __name__ == "__main__":
    main()
