"""Unrolled-LSTM language model, the port's counterpart of
``examples/rnn/lstm_ptb.py`` (reference: example/rnn/lstm.py + the PTB
bucketing-executor config in BASELINE.json).

Like the reference, this drives the *Executor API directly* (bind once per
sequence length, per-step data variables, forward/backward + manual SGD) —
exercising weight sharing across the unrolled graph. Data is a synthetic
character stream by default (--text for a real corpus file).

    python -m mxnet_tpu_torch.examples.rnn.lstm_ptb [--seq-len 16] [--cpu]

The scan-style path for the same model is ``lstm_scan``; this script is
the API-parity path. The executor lives on the card unless ``--cpu`` is
given.
"""

import logging
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx

from .. import cpu_parser, example_context


def synthetic_text(n_chars=20000, vocab=32, seed=0):
    """A char stream with learnable structure (repeated motifs + noise)."""
    rng = np.random.RandomState(seed)
    motifs = [rng.randint(0, vocab, rng.randint(3, 8)) for _ in range(8)]
    out = []
    while len(out) < n_chars:
        m = motifs[rng.randint(len(motifs))]
        out.extend(m.tolist())
        if rng.rand() < 0.1:
            out.append(rng.randint(vocab))
    return np.array(out[:n_chars], np.float32)


def parser():
    ap = cpu_parser(__doc__)
    ap.add_argument("--text", default=None, help="path to a text corpus")
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-hidden", type=int, default=128)
    ap.add_argument("--num-embed", type=int, default=64)
    ap.add_argument("--num-layers", type=int, default=2)
    ap.add_argument("--num-epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.5)
    return ap


def train(args, ctx, arg_params=None, max_batches=None):
    """The JAX script's loop. Returns ``{"nll": [per-batch NLL sums],
    "perplexity": [per epoch], "vocab": V}``; ``arg_params`` starts from
    given weights instead of Xavier's, ``max_batches`` stops each epoch
    early."""
    from mxnet_tpu_torch.models import lstm_unroll

    if args.text:
        with open(args.text, "rb") as f:
            raw = f.read()
        vocab_map = {b: i for i, b in enumerate(sorted(set(raw)))}
        stream = np.array([vocab_map[b] for b in raw], np.float32)
        vocab = len(vocab_map)
    else:
        vocab = 32
        stream = synthetic_text(vocab=vocab)

    seq, bs = args.seq_len, args.batch_size
    sym = lstm_unroll(args.num_layers, seq, vocab, args.num_hidden,
                      args.num_embed, vocab)

    shapes = {}
    for t in range(seq):
        shapes[f"t{t}_data"] = (bs,)
        shapes[f"t{t}_label"] = (bs,)
    for layer in range(args.num_layers):
        shapes[f"l{layer}_init_c"] = (bs, args.num_hidden)
        shapes[f"l{layer}_init_h"] = (bs, args.num_hidden)

    exe = sym.simple_bind(ctx, **shapes)
    init = mx.init.Xavier()
    mx.random.seed(0)
    for name, arr in exe.arg_dict.items():
        if name in shapes:
            continue
        if arg_params is not None:
            arr.copy_(torch.as_tensor(arg_params[name]))
            continue
        init(name if name.endswith(("weight", "bias"))
             else name + "_weight", arr)

    opt = mx.optimizer.create("sgd", lr=args.lr, momentum=0.9,
                              rescale_grad=1.0 / (bs * seq), clip_gradient=5.0)
    updater = mx.optimizer.get_updater(opt)
    param_names = [n for n in exe.arg_dict if n not in shapes]

    # batch the stream: [n_batches, seq, bs]
    usable = (len(stream) - 1) // (seq * bs) * (seq * bs)
    data = stream[:usable].reshape(bs, -1, seq).transpose(1, 2, 0)
    labels = stream[1:usable + 1].reshape(bs, -1, seq).transpose(1, 2, 0)

    batch_nll, ppls = [], []
    rows = torch.arange(bs)
    n_batches = data.shape[0] if max_batches is None \
        else min(max_batches, data.shape[0])
    for epoch in range(args.num_epochs):
        epoch_nll, count = [], 0
        tic = time.time()
        for b in range(n_batches):
            kwargs = {}
            for t in range(seq):
                kwargs[f"t{t}_data"] = mx.nd.array(data[b, t], ctx=ctx)
                kwargs[f"t{t}_label"] = mx.nd.array(labels[b, t], ctx=ctx)
            outs = exe.forward(is_train=True, **kwargs)
            exe.backward()
            for i, name in enumerate(param_names):
                updater(i, exe.grad_dict[name], exe.arg_dict[name])
            # perplexity from the per-step softmax outputs, summed on the
            # executor's device and read once an epoch
            nll = 0.0
            for t in range(seq):
                idx = torch.from_numpy(labels[b, t].astype(np.int64)) \
                    .to(outs[t].device)
                p = outs[t][rows.to(outs[t].device), idx]
                nll = nll - torch.log(p + 1e-8).sum()
                count += bs
            epoch_nll.append(nll)
        epoch_nll = [float(v) for v in torch.stack(epoch_nll).cpu()]
        batch_nll.extend(epoch_nll)
        total_nll = sum(epoch_nll)
        ppl = float(np.exp(total_nll / count))
        ppls.append(ppl)
        logging.info("Epoch[%d] perplexity=%.2f (%.1fs) [vocab=%d]",
                     epoch, ppl, time.time() - tic, vocab)
    return {"nll": batch_nll, "perplexity": ppls, "vocab": vocab}


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    ctx = example_context(args.cpu)
    with ctx:
        return train(args, ctx)


if __name__ == "__main__":
    main()
