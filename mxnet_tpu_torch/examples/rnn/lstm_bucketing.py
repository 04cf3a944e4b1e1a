"""Bucketed LSTM language model, the port's counterpart of
``examples/rnn/lstm_bucketing.py`` (reference capability:
example/rnn/lstm.py's executor-per-seq-len binding; here one executor a
bucket over shared weights, each replaying a captured step on the card —
see mxnet_tpu_torch/bucketing.py).

Generates a synthetic corpus of variable-length token sequences, buckets
them, and trains with Adam. Swap ``_corpus`` for a PTB loader to reproduce
the reference's rnn example end to end.

    python -m mxnet_tpu_torch.examples.rnn.lstm_bucketing [--cpu]

Adam takes the hand-written whole-tree kernel (``csrc/fused_adam.cu``, one
launch a batch) where the package's gate says so: ``MXNET_TPU_FUSED_ADAM=1``
(the script, as the JAX one, passes no ``fused``). The model lives on the
card unless ``--cpu`` is given.
"""

import logging

import numpy as np

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context

VOCAB = 64
HIDDEN = 64
EMBED = 32
LAYERS = 1
BATCH = 32
BUCKETS = [8, 16, 32]
EPOCHS = 5


def _corpus(n=2000, seed=0):
    """Synthetic text: arithmetic token cycles with random stride/length."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(rng.randint(4, BUCKETS[-1] + 1))
        start = int(rng.randint(1, VOCAB))
        stride = int(rng.choice([1, 2, 3]))
        out.append([(start + i * stride - 1) % (VOCAB - 1) + 1
                    for i in range(length)])
    return out


def init_states():
    return [(f"l{i}_init_{s}", (BATCH, HIDDEN))
            for i in range(LAYERS) for s in "ch"]


def sym_gen(seq_len):
    from mxnet_tpu_torch.models import lstm_unroll

    return lstm_unroll(LAYERS, seq_len, VOCAB, HIDDEN, EMBED, VOCAB)


def batches_per_epoch(corpus=None):
    """The batches of one epoch: each bucket's sentences in batches of
    BATCH, the last one padded."""
    counts = {b: 0 for b in BUCKETS}
    for sent in _corpus() if corpus is None else corpus:
        bucket = next((b for b in BUCKETS if len(sent) <= b), None)
        if bucket is not None:
            counts[bucket] += 1
    return sum(-(-n // BATCH) for n in counts.values())


def train(ctx, corpus=None, num_epoch=EPOCHS, arg_params=None,
          eval_metric="accuracy"):
    """The JAX script's fit; returns ``(model, iterator)``. ``corpus``,
    ``num_epoch`` and ``arg_params`` cut or pin the run to compare, and
    ``eval_metric`` replaces the fit's (a recorder of each batch's
    outputs)."""
    train_it = mx.BucketSentenceIter(
        _corpus() if corpus is None else corpus, BUCKETS, BATCH,
        init_states=init_states(), shuffle=True)
    model = mx.BucketingFeedForward(
        sym_gen, default_bucket_key=train_it.default_bucket_key, ctx=ctx,
        num_epoch=num_epoch, optimizer="adam", learning_rate=0.01,
        initializer=mx.init.Xavier(), arg_params=arg_params)
    model.fit(train_it, batch_size=BATCH, eval_metric=eval_metric)
    return model, train_it


def main(argv=None):
    args = cpu_parser(__doc__).parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = example_context(args.cpu)
    with ctx:
        model, _ = train(ctx)
    return model


if __name__ == "__main__":
    main()
