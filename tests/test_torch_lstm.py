"""The port's LSTM LMs against the JAX package's.

``lstm_unroll``: the outputs of the bound graph within 1e-6 and its
gradients within 1e-5 of each gradient's largest magnitude of the JAX
package's. ``LSTMLM``: logits within 1e-5, the loss within 1e-6 relative,
and the parameters after 3 SGD-momentum steps within 1e-5 of each leaf's
largest magnitude, from parameters the JAX package drew
(``convert.lstm_params_from_numpy``). f32 throughout.
"""

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models import LSTMLM as JLSTMLM
from mxnet_tpu.models import lstm_unroll as jlstm_unroll
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import lstm_params_from_numpy, random_params

SEQ, LAYERS, BATCH, VOCAB, EMBED, HIDDEN = 5, 2, 4, 20, 12, 16


@pytest.fixture(autouse=True)
def _highest():
    prev = mt.get_matmul_precision()
    mt.set_matmul_precision("highest")
    yield
    mt.set_matmul_precision(prev)


def _shapes():
    shapes = {f"t{t}_data": (BATCH,) for t in range(SEQ)}
    shapes.update({f"t{t}_label": (BATCH,) for t in range(SEQ)})
    for i in range(LAYERS):
        shapes[f"l{i}_init_c"] = (BATCH, HIDDEN)
        shapes[f"l{i}_init_h"] = (BATCH, HIDDEN)
    return shapes


def test_lstm_unroll_names_and_outputs_match_jax():
    t = tmodels.lstm_unroll(LAYERS, SEQ, VOCAB, HIDDEN, EMBED, VOCAB)
    j = jlstm_unroll(LAYERS, SEQ, VOCAB, HIDDEN, EMBED, VOCAB)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_arguments().count("l0_i2h_weight") == 1
    assert t.infer_shape(**_shapes()) == j.infer_shape(**_shapes())


def test_lstm_unroll_forward_and_gradients_match_jax():
    shapes = _shapes()
    tsym = tmodels.lstm_unroll(LAYERS, SEQ, VOCAB, HIDDEN, EMBED, VOCAB)
    jsym = jlstm_unroll(LAYERS, SEQ, VOCAB, HIDDEN, EMBED, VOCAB)
    args = random_params(tsym, 0, **shapes)[0]
    rng = np.random.RandomState(1)
    feed = {f"t{t}_data": rng.randint(0, VOCAB, BATCH).astype(np.float32)
            for t in range(SEQ)}
    feed.update({f"t{t}_label": rng.randint(0, VOCAB, BATCH).astype(
        np.float32) for t in range(SEQ)})
    feed.update({n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
                 for n, s in shapes.items() if "init" in n})
    je = jsym.simple_bind(mx.cpu(), **shapes)
    te = tsym.simple_bind(mt.cpu(), **shapes)
    for name, arr in je.arg_dict.items():
        if name in args:
            arr[:] = args[name]
    te.copy_params_from({k: torch.from_numpy(v) for k, v in args.items()})
    jouts = je.forward(is_train=True, **{k: mx.nd.array(v)
                                          for k, v in feed.items()})
    touts = te.forward(is_train=True, **{k: torch.from_numpy(v)
                                          for k, v in feed.items()})
    assert len(jouts) == len(touts) == SEQ + 2 * LAYERS
    for a, b in zip(jouts, touts):
        np.testing.assert_allclose(b.numpy(), a.asnumpy(), rtol=0, atol=1e-6)
    je.backward()
    te.backward()
    for name in args:
        want = je.grad_dict[name].asnumpy()
        got = te.grad_dict[name].numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert np.abs(got - want).max() <= 1e-5 * scale, name


def _lstmlm_pair():
    jm = JLSTMLM(VOCAB, num_embed=EMBED, num_hidden=HIDDEN,
                 num_layers=LAYERS)
    tm = tmodels.LSTMLM(VOCAB, num_embed=EMBED, num_hidden=HIDDEN,
                        num_layers=LAYERS)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    return jm, tm, jparams, lstm_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")


def test_lstmlm_forward_and_loss_match_jax():
    jm, tm, jparams, tparams = _lstmlm_pair()
    rng = np.random.RandomState(2)
    tokens = rng.randint(0, VOCAB, (BATCH, 9)).astype(np.int32)
    targets = rng.randint(0, VOCAB, (BATCH, 9)).astype(np.int32)
    jlogits, jfinal = jm.forward(jparams, tokens)
    tlogits, tfinal = tm.forward(tparams, torch.from_numpy(tokens))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5)
    for (jc, jh), (tc, th) in zip(jfinal, tfinal):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6)
    jl = float(jm.loss(jparams, tokens, targets))
    tl = float(tm.loss(tparams, torch.from_numpy(tokens),
                       torch.from_numpy(targets)))
    assert abs(tl - jl) <= 1e-6 * abs(jl)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_lstmlm_train_steps_track_jax(clip):
    jm, tm, jparams, tparams = _lstmlm_pair()
    jmoms, tmoms = jm.init_optimizer(jparams), tm.init_optimizer(tparams)
    jstep = jm.make_train_step(lr=0.5, momentum=0.9, clip=clip)
    tstep = tm.make_train_step(lr=0.5, momentum=0.9, clip=clip)
    rng = np.random.RandomState(3)
    start = {k: v.clone() for k, v in tparams.items()}
    for _ in range(3):
        tokens = rng.randint(0, VOCAB, (BATCH, 7)).astype(np.int32)
        targets = np.roll(tokens, -1, axis=1)
        jparams, jmoms, jl = jstep(jparams, jmoms, tokens, targets)
        tparams, tmoms, tl = tstep(tparams, tmoms, torch.from_numpy(tokens),
                                   torch.from_numpy(targets))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k, v in jparams.items():
        want = np.asarray(v)
        scale = float(np.abs(want).max())
        assert np.abs(tparams[k].numpy() - want).max() <= 1e-5 * scale, k
        assert not torch.equal(tparams[k], start[k]) or k.endswith("bias")


def test_lstmlm_init_params_shapes_and_scales():
    tm = tmodels.LSTMLM(VOCAB, num_embed=EMBED, num_hidden=HIDDEN,
                        num_layers=LAYERS)
    p = tm.init_params(0, ctx=mt.cpu())
    jm = JLSTMLM(VOCAB, num_embed=EMBED, num_hidden=HIDDEN, num_layers=LAYERS)
    jp = jm.init_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k, v in p.items():
        bound = 0.0 if k.endswith("bias") else 1 / np.sqrt(v.shape[-1])
        assert float(v.abs().max()) <= bound + 1e-7
    assert torch.equal(p["embed_weight"], tm.init_params(0, ctx=mt.cpu())[
        "embed_weight"])
