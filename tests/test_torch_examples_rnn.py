"""The port's LSTM examples (``mxnet_tpu_torch/examples/rnn``) on the CPU,
against the JAX package's scripts under ``examples/rnn``.

- The same data and symbols: ``synthetic_text``'s stream, the bucketing
  corpus, and ``lstm_unroll``'s ``tojson()``, arguments and shapes.
- The same training, from one set of weights (f32, TF32 off; the JAX side
  at "highest" precision): ``lstm_ptb``'s first 5 batch NLLs through a
  bound ``Executor`` and the manual updater; ``lstm_scan``'s first 5 step
  losses, the JAX ``LSTMLM``'s ``PRNGKey(0)`` parameters carried across by
  ``convert.lstm_params_from_numpy``; ``lstm_bucketing``'s first 5 batch
  losses and its parameters after an epoch under Adam, on the same bucketed
  batches: each within 1e-4.
- Each script's own ``main(["--cpu", ...])`` at reduced arguments.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import random_params
from torch_examples_util import (two_threads,  # noqa: F401
                                 BOUND, BatchLosses, assert_close,
                                 fresh_names, jax_example, jax_params,
                                 port_params)

mt.set_matmul_precision("highest")

PTB_ARGV = ["--seq-len", "6", "--batch-size", "8", "--num-hidden", "16",
            "--num-embed", "8", "--num-layers", "2", "--num-epochs", "1"]


# -- lstm_ptb ------------------------------------------------------------------

def test_synthetic_text_is_the_jax_scripts():
    from mxnet_tpu_torch.examples.rnn import lstm_ptb as tex

    jex = jax_example("rnn/lstm_ptb.py")
    for kw in ({}, {"n_chars": 100000}):
        got, want = tex.synthetic_text(**kw), jex.synthetic_text(**kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def jax_ptb_nll(jex, args, arg_params, batches):
    """The JAX script's loop (examples/rnn/lstm_ptb.py:80-119) through the
    JAX package's Executor, from given weights: each batch's NLL sum."""
    vocab = 32
    stream = jex.synthetic_text(vocab=vocab)
    seq, bs = args.seq_len, args.batch_size
    sym = mx.models.lstm_unroll(args.num_layers, seq, vocab, args.num_hidden,
                                args.num_embed, vocab)
    shapes = {}
    for t in range(seq):
        shapes[f"t{t}_data"] = (bs,)
        shapes[f"t{t}_label"] = (bs,)
    for layer in range(args.num_layers):
        shapes[f"l{layer}_init_c"] = (bs, args.num_hidden)
        shapes[f"l{layer}_init_h"] = (bs, args.num_hidden)
    exe = sym.simple_bind(mx.cpu(), **shapes)
    for name, arr in exe.arg_dict.items():
        if name not in shapes:
            arr[:] = arg_params[name]
    opt = mx.optimizer.create("sgd", lr=args.lr, momentum=0.9,
                              rescale_grad=1.0 / (bs * seq), clip_gradient=5.0)
    updater = mx.optimizer.get_updater(opt)
    param_names = [n for n in exe.arg_dict if n not in shapes]
    usable = (len(stream) - 1) // (seq * bs) * (seq * bs)
    data = stream[:usable].reshape(bs, -1, seq).transpose(1, 2, 0)
    labels = stream[1:usable + 1].reshape(bs, -1, seq).transpose(1, 2, 0)
    out = []
    for b in range(batches):
        kwargs = {}
        for t in range(seq):
            kwargs[f"t{t}_data"] = mx.nd.array(data[b, t])
            kwargs[f"t{t}_label"] = mx.nd.array(labels[b, t])
        outs = exe.forward(is_train=True, **kwargs)
        exe.backward()
        for i, name in enumerate(param_names):
            updater(i, exe.grad_dict[name], exe.arg_dict[name])
        nll = 0.0
        for t in range(seq):
            p = outs[t].asnumpy()
            idx = labels[b, t].astype(int)
            nll -= np.log(p[np.arange(bs), idx] + 1e-8).sum()
        out.append(float(nll))
    return out


def test_lstm_ptb_matches_jax():
    from mxnet_tpu_torch.examples.rnn import lstm_ptb as tex

    jex = jax_example("rnn/lstm_ptb.py")
    args = tex.parser().parse_args(["--cpu", *PTB_ARGV])
    shapes = {f"t{t}_data": (8,) for t in range(6)}
    shapes.update({f"l{i}_init_{s}": (8, 16) for i in range(2) for s in "ch"})
    with fresh_names(mt):
        tsym = mt.models.lstm_unroll(2, 6, 32, 16, 8, 32)
    with fresh_names(mx):
        jsym = mx.models.lstm_unroll(2, 6, 32, 16, 8, 32)
    assert tsym.tojson() == jsym.tojson()
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.infer_shape(**shapes) == jsym.infer_shape(**shapes)
    params, _ = random_params(tsym, 21, **shapes)

    got = tex.train(args, mt.cpu(), arg_params=params, max_batches=5)
    want = jax_ptb_nll(jex, args, params, 5)
    assert got["vocab"] == 32 and len(got["nll"]) == 5
    np.testing.assert_allclose(got["nll"], want, rtol=BOUND, atol=BOUND)
    assert got["nll"][-1] < got["nll"][0]


def test_lstm_ptb_main_logs_its_perplexity(caplog):
    import logging

    from mxnet_tpu_torch.examples.rnn import lstm_ptb as tex

    with caplog.at_level(logging.INFO):
        out = tex.main(["--cpu", *PTB_ARGV[:-2], "--num-epochs", "2"])
    assert len(out["perplexity"]) == 2
    assert out["perplexity"][1] < out["perplexity"][0] < 32
    assert len([r for r in caplog.records
                if r.getMessage().startswith("Epoch[")]) == 2


# -- lstm_scan -----------------------------------------------------------------

SCAN_ARGV = ["--seq-len", "8", "--batch-size", "4", "--num-hidden", "16",
             "--num-embed", "8", "--steps", "5"]


def test_lstm_scan_matches_jax():
    """The JAX script's steps from the JAX ``LSTMLM``'s ``PRNGKey(0)``
    parameters: the first 5 losses within 1e-4."""
    import jax

    from mxnet_tpu.models.lstm_scan import LSTMLM as JaxLSTMLM
    from mxnet_tpu_torch.convert import lstm_params_from_numpy
    from mxnet_tpu_torch.examples.rnn import lstm_scan as tex

    args = tex.parser().parse_args(["--cpu", *SCAN_ARGV])
    jex = jax_example("rnn/lstm_ptb.py")
    model = JaxLSTMLM(vocab=32, num_embed=8, num_hidden=16, num_layers=2)
    params = model.init_params(jax.random.PRNGKey(0))
    host_params = {k: np.asarray(v) for k, v in params.items()}
    states = model.init_optimizer(params)
    step = model.make_train_step(lr=0.5, clip=5.0)
    stream = jex.synthetic_text(n_chars=100000, vocab=32)
    usable = (len(stream) - 1) // (8 * 4) * (8 * 4)
    data = stream[:usable].reshape(4, -1, 8).transpose(1, 0, 2) \
        .astype(np.int32)
    labels = stream[1:usable + 1].reshape(4, -1, 8).transpose(1, 0, 2) \
        .astype(np.int32)
    want = []
    for i in range(5):
        params, states, loss = step(params, states, data[i], labels[i])
        want.append(float(loss))

    got = tex.train(args, mt.cpu(),
                    params=lstm_params_from_numpy(host_params, "cpu"))
    np.testing.assert_allclose(got["losses"], want, rtol=BOUND, atol=BOUND)


def test_lstm_scan_main_draws_from_a_seeded_generator():
    """Without given parameters the script draws them from a
    ``torch.Generator`` seeded 0: two runs agree bitwise."""
    from mxnet_tpu_torch.examples.rnn import lstm_scan as tex

    a = tex.main(["--cpu", *SCAN_ARGV[:-1], "20"])
    b = tex.main(["--cpu", *SCAN_ARGV[:-1], "20"])
    assert a["losses"] == b["losses"] and len(a["losses"]) == 20
    assert np.isfinite(a["final_perplexity"])
    assert a["losses"][-1] < a["losses"][0]


# -- lstm_bucketing ------------------------------------------------------------

def test_bucketing_corpus_and_symbols_are_the_jax_scripts():
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as tex

    jex = jax_example("rnn/lstm_bucketing.py")
    assert tex._corpus() == jex._corpus()
    for name in ("VOCAB", "HIDDEN", "EMBED", "LAYERS", "BATCH", "BUCKETS"):
        assert getattr(tex, name) == getattr(jex, name), name
    for b in tex.BUCKETS:
        with fresh_names(mt):
            t = tex.sym_gen(b)
        with fresh_names(mx):
            j = mx.models.lstm_unroll(jex.LAYERS, b, jex.VOCAB, jex.HIDDEN,
                                      jex.EMBED, jex.VOCAB)
        assert t.tojson() == j.tojson()
        assert t.list_arguments() == j.list_arguments()


def test_lstm_bucketing_matches_jax():
    """240 sentences of the JAX script's corpus, one epoch of Adam at the
    script's rate, from one set of weights, on the same bucketed batches
    (``BucketSentenceIter``'s own seeded shuffle, alike in both): the first
    5 batch losses within 1e-4, every parameter after the epoch too."""
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as tex

    jex = jax_example("rnn/lstm_bucketing.py")
    corpus = jex._corpus()[:240]
    shapes = {f"t{t}_data": (32,) for t in range(32)}
    shapes.update(dict(tex.init_states()))
    params, _ = random_params(tex.sym_gen(32), 22, **shapes)

    tl, jl = BatchLosses(mt.metric), BatchLosses(mx.metric)
    tmodel, _ = tex.train(mt.cpu(), corpus=corpus, num_epoch=1,
                          arg_params=port_params(params),
                          eval_metric=tl.metric)

    init_states = [(f"l{i}_init_{s}", (jex.BATCH, jex.HIDDEN))
                   for i in range(jex.LAYERS) for s in "ch"]
    it = mx.BucketSentenceIter(corpus, jex.BUCKETS, jex.BATCH,
                               init_states=init_states, shuffle=True)

    def sym_gen(seq_len):
        return mx.models.lstm_unroll(jex.LAYERS, seq_len, jex.VOCAB,
                                     jex.HIDDEN, jex.EMBED, jex.VOCAB)

    jmodel = mx.BucketingFeedForward(
        sym_gen, default_bucket_key=it.default_bucket_key, num_epoch=1,
        optimizer="adam", learning_rate=0.01, initializer=mx.init.Xavier(),
        arg_params=jax_params(params), ctx=mx.cpu())
    jmodel.fit(it, batch_size=jex.BATCH, eval_metric=jl.metric)
    # one loss a time step's output (the unrolled net has a head a step)
    assert len(tl.losses) == len(jl.losses) > tex.batches_per_epoch(corpus)
    np.testing.assert_allclose(tl.losses, jl.losses, rtol=BOUND, atol=BOUND)
    assert_close(tmodel.arg_params, jmodel.arg_params, start=params)


def test_lstm_bucketing_main_trains(capsys):
    """The script as it runs, on the CPU: five epochs of the 2,000-sentence
    corpus under Adam (its plain update: the fused kernel is the card's)."""
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as tex

    model = tex.main(["--cpu"])
    assert model.num_epoch == tex.EPOCHS
    for k, v in model.arg_params.items():
        assert torch.isfinite(v).all(), k


@pytest.mark.parametrize("n", [240, 2000])
def test_bucketing_batches_per_epoch(n):
    """``batches_per_epoch`` (the count the card phase derives the
    ``fused_adam`` launches from) is what the iterator yields, in either
    package."""
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as tex

    corpus = tex._corpus()[:n]
    derived = tex.batches_per_epoch(corpus)
    for pkg in (mt, mx):
        it = pkg.BucketSentenceIter(corpus, tex.BUCKETS, tex.BATCH,
                                    init_states=tex.init_states(),
                                    shuffle=True)
        assert sum(1 for _ in it) == derived
    assert derived > n // tex.BATCH
