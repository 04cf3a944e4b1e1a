"""The port's BucketSentenceIter and BucketingFeedForward against the JAX
package's.

The iterator's batches are bitwise the JAX package's (tolerance 0).
BucketingFeedForward's parameters after 3 SGD steps over two buckets stay
within 1e-5 of each leaf's largest magnitude of the JAX package's (f32
GEMMs in another summation order).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models import lstm_unroll as jlstm_unroll
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import random_params

VOCAB, HIDDEN, EMBED, BATCH = 12, 16, 8, 8


@pytest.fixture(autouse=True)
def _highest():
    prev = mt.get_matmul_precision()
    mt.set_matmul_precision("highest")
    yield
    mt.set_matmul_precision(prev)


def _sentences(n=60, seed=0, max_len=11):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, VOCAB, rng.randint(1, max_len + 1)))
            for _ in range(n)]


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.numpy()


@pytest.mark.parametrize("kw", [
    dict(buckets=[4, 8], shuffle=False),
    dict(buckets=[3, 6, 9], shuffle=True, seed=4, invalid_label=-1),
    dict(buckets=None, pad_policy="pow2", shuffle=True, seed=2),
    dict(buckets=[5, 16], pad_policy="pow2", shuffle=True,
         init_states=[("l0_init_c", (BATCH, HIDDEN))])])
def test_bucket_sentence_iter_matches_jax(kw):
    """Buckets, padding, labels (the data shifted by one), the tail batch's
    pad rows, init states and the shuffle, over two epochs."""
    sents = _sentences()
    jit = mx.bucketing.BucketSentenceIter(sents, batch_size=BATCH, **kw)
    tit = mt.bucketing.BucketSentenceIter(sents, batch_size=BATCH, **kw)
    assert (jit.buckets, jit.discarded, jit.default_bucket_key) == \
        (tit.buckets, tit.discarded, tit.default_bucket_key)
    assert jit.provide_data == tit.provide_data
    assert jit.provide_label == tit.provide_label
    for _ in range(2):
        jb, tb = list(jit), list(tit)
        assert len(jb) == len(tb) > 2
        for a, b in zip(jb, tb):
            assert (a.bucket_key, a.pad, a.data_names, a.label_names) == \
                (b.bucket_key, b.pad, b.data_names, b.label_names)
            for x, y in zip(a.data + a.label, b.data + b.label):
                x, y = _np(x), _np(y)
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


def test_too_long_sentences_are_discarded_and_policy_checked():
    it = mt.bucketing.BucketSentenceIter([[1, 2], [1] * 50], buckets=[4],
                                         batch_size=1)
    assert it.discarded == 1
    with pytest.raises(ValueError, match="buckets"):
        mt.bucketing.BucketSentenceIter([[1, 2]], batch_size=1)
    with pytest.raises(mt.MXNetError, match="mode"):
        mt.bucketing.PadPolicy("bogus")
    assert mt.bucketing.PadPolicy("pow2").round_length(5) == 8
    assert mt.bucketing.PadPolicy("pow2").round_length(9, [4, 8]) is None


def test_bucketing_feedforward_matches_jax():
    """fit over 3 batches from buckets 4 and 8 (SGD with momentum) from the
    same parameters: the port tracks the JAX package."""
    states = [("l0_init_c", (BATCH, HIDDEN)), ("l0_init_h", (BATCH, HIDDEN))]
    sents = _sentences(n=20, max_len=8)
    shapes = {f"t{t}_data": (BATCH,) for t in range(8)}
    shapes.update(dict(states))
    args = random_params(tmodels.lstm_unroll(1, 8, VOCAB, HIDDEN, EMBED,
                                             VOCAB), 0, **shapes)[0]
    out, scores = [], []
    for pkg, unroll in ((mx, jlstm_unroll), (mt, tmodels.lstm_unroll)):
        it = pkg.bucketing.BucketSentenceIter(sents, buckets=[4, 8],
                                              batch_size=BATCH,
                                              init_states=states, seed=1)
        assert len(list(it)) == 3 and {b.bucket_key for b in it} == {4, 8}

        def gen(seq_len, unroll=unroll):
            return unroll(num_layers=1, seq_len=seq_len, input_size=VOCAB,
                          num_hidden=HIDDEN, num_embed=EMBED, num_label=VOCAB)

        conv = mx.nd.array if pkg is mx else torch.from_numpy
        kw = {} if pkg is mx else {"ctx": mt.cpu()}
        model = pkg.bucketing.BucketingFeedForward(
            gen, default_bucket_key=8, num_epoch=1, optimizer="sgd",
            learning_rate=0.3, momentum=0.9,
            arg_params={k: conv(v) for k, v in args.items()}, aux_params={},
            **kw)
        model.fit(it, batch_size=BATCH, eval_metric="accuracy")
        out.append({k: _np(v) for k, v in model.arg_params.items()})
        scores.append(model.score(it, eval_metric="accuracy"))
    jparams, tparams = out
    assert scores[0] == scores[1]  # each bucket's eval graph
    assert set(jparams) == set(tparams) == set(args)
    moved = 0.0
    for k in args:
        scale = float(np.abs(jparams[k]).max())
        assert np.abs(tparams[k] - jparams[k]).max() <= 1e-5 * scale, k
        moved = max(moved, float(np.abs(tparams[k] - args[k]).max()))
    assert moved > 1e-3
