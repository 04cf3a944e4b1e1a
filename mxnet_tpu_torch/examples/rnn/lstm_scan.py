"""LSTM language model with the time loop in torch, the port's counterpart
of ``examples/rnn/lstm_scan.py`` (the fast path for the same model as
``lstm_ptb``; SURVEY.md §5: the reference's only sequence story is full
graph unrolling).

The JAX script's ``lax.scan`` compiles the recurrence once for every
sequence length; the port's ``models.lstm_scan.LSTMLM`` runs the cell in a
Python loop over time steps, eagerly, so there is no per-length bind either.
Its parameters come from an explicit ``torch.Generator`` seeded 0 (the JAX
script's ``jax.random.PRNGKey(0)`` has no torch counterpart).

    python -m mxnet_tpu_torch.examples.rnn.lstm_scan --seq-len 64 [--cpu]

The model lives on the card unless ``--cpu`` is given.
"""

import logging
import time

import numpy as np
import torch

from .. import cpu_parser, example_context
from .lstm_ptb import synthetic_text


def parser():
    ap = cpu_parser(__doc__)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-hidden", type=int, default=128)
    ap.add_argument("--num-embed", type=int, default=64)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.5)
    return ap


def train(args, ctx, params=None):
    """The JAX script's steps. Returns ``{"losses": [per step],
    "final_perplexity": p, "tokens_per_s": r}``; ``params`` starts from
    given parameters (tensors on ``ctx``) instead of the seeded draw."""
    from mxnet_tpu_torch.models.lstm_scan import LSTMLM

    vocab = 32
    stream = synthetic_text(n_chars=100000, vocab=vocab)

    model = LSTMLM(vocab=vocab, num_embed=args.num_embed,
                   num_hidden=args.num_hidden, num_layers=args.num_layers)
    if params is None:
        params = model.init_params(0, ctx=ctx)
    states = model.init_optimizer(params)
    step = model.make_train_step(lr=args.lr, clip=5.0)

    seq, bs = args.seq_len, args.batch_size
    usable = (len(stream) - 1) // (seq * bs) * (seq * bs)
    data = stream[:usable].reshape(bs, -1, seq).transpose(1, 0, 2) \
        .astype(np.int32)
    labels = stream[1:usable + 1].reshape(bs, -1, seq).transpose(1, 0, 2) \
        .astype(np.int32)
    dev = ctx.torch_device
    data = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    labels = torch.from_numpy(np.ascontiguousarray(labels)).to(dev)

    losses = []
    tic = time.time()
    n = min(args.steps, data.shape[0])
    for i in range(n):
        params, states, loss = step(params, states, data[i], labels[i])
        losses.append(loss)
        if i % 20 == 0:
            # the JAX script's progress line, every 20 steps
            logging.info("step %d ppl=%.2f", i,
                         float(np.exp(float(loss))))  # mxlint: disable=MX309
    if dev.type == "cuda":
        torch.cuda.synchronize()
    losses = [float(v) for v in torch.stack(losses).cpu()]
    final = float(np.exp(losses[-1]))
    dt = time.time() - tic
    rate = n * bs * seq / dt
    logging.info("final perplexity=%.2f  |  %.0f tokens/sec", final, rate)
    return {"losses": losses, "final_perplexity": final,
            "tokens_per_s": rate}


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = example_context(args.cpu)
    with ctx:
        return train(args, ctx)


if __name__ == "__main__":
    main()
