"""The port's Module and BucketingModule against the JAX package's.

The same numpy-seeded parameters and batches go through both packages.
Tolerances: parameters after 3 SGD-momentum steps within 1e-5 of each
leaf's largest magnitude (f32 GEMMs in another summation order); scores
and predictions within 1e-5; checkpoints cross both ways bitwise.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models import lstm_unroll as jlstm_unroll
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import random_params

OPT = {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 32.0}


@pytest.fixture(autouse=True)
def _highest():
    prev = mt.get_matmul_precision()
    mt.set_matmul_precision("highest")
    yield
    mt.set_matmul_precision(prev)


def _dataset(n=96, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1.0,
                        rng.randn(n // 2, dim) - 1.0]).astype(np.float32)
    y = np.concatenate([np.ones(n // 2), np.zeros(n // 2)]).astype(np.float32)
    perm = rng.permutation(n)
    return X[perm], y[perm]


def _mlp(sym):
    net = sym.Variable("data")
    net = sym.FullyConnected(data=net, num_hidden=16, name="fc1")
    net = sym.Activation(data=net, act_type="relu", name="relu1")
    net = sym.FullyConnected(data=net, num_hidden=2, name="fc2")
    return sym.SoftmaxOutput(data=net, name="softmax")


def _close(got, want, tol=1e-5):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        scale = max(float(np.abs(w).max()), 1e-6)
        assert np.abs(g - w).max() <= tol * scale, (k, np.abs(g - w).max())


def _np(d):
    return {k: (v.asnumpy() if hasattr(v, "asnumpy") else v.numpy())
            for k, v in d.items()}


def _jax_module(args, X, y, steps_fit=True):
    jit = mx.io.NDArrayIter(X, y, batch_size=32)
    jmod = mx.mod.Module(_mlp(mx.symbol))
    jmod.bind(jit.provide_data, jit.provide_label)
    jmod.init_params(arg_params={k: mx.nd.array(v) for k, v in args.items()},
                     aux_params={})
    if steps_fit:
        jmod.fit(jit, num_epoch=1, optimizer_params=OPT)
    return jmod, jit


def test_module_fit_score_predict_match_jax():
    X, y = _dataset()
    args, _ = random_params(_mlp(mt.sym), 0, data=(32, 8))
    jmod, jit = _jax_module(args, X, y)
    tit = mt.io.NDArrayIter(X, y, batch_size=32)
    tmod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    tmod.bind(tit.provide_data, tit.provide_label)
    tmod.init_params(arg_params={k: torch.from_numpy(v)
                                 for k, v in args.items()}, aux_params={})
    tmod.fit(tit, num_epoch=1, optimizer_params=OPT)  # 3 steps
    _close(_np(tmod.get_params()[0]), _np(jmod.get_params()[0]))
    jname, jacc = jmod.score(mx.io.NDArrayIter(X, y, batch_size=32))
    tname, tacc = tmod.score(mt.io.NDArrayIter(X, y, batch_size=32))
    assert (tname, tacc) == (jname, jacc)
    np.testing.assert_allclose(
        tmod.predict(mt.io.NDArrayIter(X, y, batch_size=32)),
        jmod.predict(mx.io.NDArrayIter(X, y, batch_size=32)), atol=1e-5)


def test_explicit_lifecycle_equals_fit_bitwise():
    """bind -> init_params -> init_optimizer -> forward / backward /
    update is the path fit takes: the same parameters bit for bit."""
    X, y = _dataset(seed=3)
    args, _ = random_params(_mlp(mt.sym), 1, data=(32, 8))
    init = {k: torch.from_numpy(v) for k, v in args.items()}
    fitted = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    fitted.bind(*_shapes(X, y))
    fitted.init_params(arg_params=init, aux_params={})
    fitted.fit(mt.io.NDArrayIter(X, y, batch_size=32), num_epoch=2,
               optimizer_params=OPT)
    mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    it = mt.io.NDArrayIter(X, y, batch_size=32)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=init, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=OPT)
    metric = mt.metric.create("accuracy")
    for _ in range(2):
        it.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            mod.update_metric(metric, batch.label)
    for k, v in fitted.get_params()[0].items():
        assert torch.equal(v, mod.get_params()[0][k]), k
    assert 0.0 <= metric.get()[1] <= 1.0


def _shapes(X, y):
    it = mt.io.NDArrayIter(X, y, batch_size=32)
    return it.provide_data, it.provide_label


def test_bind_without_label_shapes_keeps_labels_as_inputs():
    X, y = _dataset(seed=7)
    mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    mod.bind(data_shapes=_shapes(X, y)[0])
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer_params=OPT)
    assert "softmax_label" not in mod._param_names


def test_set_params_writes_every_parameter():
    X, y = _dataset(seed=9)
    args, _ = random_params(_mlp(mt.sym), 5, data=(32, 8))
    mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    mod.bind(*_shapes(X, y))
    mod.init_params(mt.init.Xavier())
    mod.set_params({k: torch.from_numpy(v) for k, v in args.items()}, {})
    got = mod.get_params()[0]
    assert set(got) == set(args)
    for k, v in args.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(mt.MXNetError, match="missing from arg_params"):
        mod.init_params(arg_params={}, aux_params={}, force_init=True)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_both_ways(tmp_path, writer):
    """A Module checkpoint of either package loads in the other (and in
    FeedForward.load) with the same parameters and scores."""
    X, y = _dataset(seed=5)
    args, _ = random_params(_mlp(mt.sym), 2, data=(32, 8))
    prefix = str(tmp_path / "mod")
    if writer == "jax":
        jmod, _ = _jax_module(args, X, y)
        jmod.save_checkpoint(prefix, 3)
        want = _np(jmod.get_params()[0])
        loaded = mt.mod.Module.load(prefix, 3, context=mt.cpu())
        loaded.bind(*_shapes(X, y))
        loaded.init_params()
        got = _np(loaded.get_params()[0])
        acc = loaded.score(mt.io.NDArrayIter(X, y, batch_size=32))[1]
        ff = mt.FeedForward.load(prefix, 3, ctx=mt.cpu())
        assert (ff.predict(X).argmax(1) == loaded.predict(
            mt.io.NDArrayIter(X, y, batch_size=32)).argmax(1)).all()
        want_acc = jmod.score(mx.io.NDArrayIter(X, y, batch_size=32))[1]
    else:
        tmod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
        tmod.fit(mt.io.NDArrayIter(X, y, batch_size=32), num_epoch=1,
                 initializer=mt.init.Xavier(), optimizer_params=OPT)
        tmod.save_checkpoint(prefix, 3)
        want = _np(tmod.get_params()[0])
        jmod = mx.mod.Module.load(prefix, 3)
        jmod.bind(*_shapes(X, y))
        jmod.init_params()
        got = _np(jmod.get_params()[0])
        acc = jmod.score(mx.io.NDArrayIter(X, y, batch_size=32))[1]
        want_acc = tmod.score(mt.io.NDArrayIter(X, y, batch_size=32))[1]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert acc == want_acc


def test_update_through_a_kvstore_matches_without():
    """push / pull through a local store leaves one worker's gradients as
    they are: the same parameters as without; a store with its own updater
    is refused."""
    X, y = _dataset(seed=11)
    args, _ = random_params(_mlp(mt.sym), 3, data=(32, 8))
    out = []
    for kv in (None, mt.kv.create("local")):
        mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
        mod.bind(*_shapes(X, y))
        mod.init_params(arg_params={k: torch.from_numpy(v)
                                    for k, v in args.items()}, aux_params={})
        mod.fit(mt.io.NDArrayIter(X, y, batch_size=32), num_epoch=1,
                kvstore=kv, optimizer_params=OPT)
        out.append(mod.get_params()[0])
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k
    kv = mt.kv.create("local")
    kv.set_optimizer(mt.optimizer.create("sgd"))
    with pytest.raises(mt.MXNetError, match="update-on-kvstore"):
        mod.update(kvstore=kv)


def test_install_monitor_reads_the_bound_executor():
    X, y = _dataset(seed=13)
    mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    mod.bind(*_shapes(X, y))
    mod.init_params(mt.init.Xavier())
    mon = mt.Monitor(1)
    mod.install_monitor(mon)
    mon.tic()
    mod.forward(next(iter(mt.io.NDArrayIter(X, y, batch_size=32))),
                is_train=False)
    names = [row[1] for row in mon.toc()]
    assert "fc1_output" in names


VOCAB, HIDDEN, EMBED, BATCH = 8, 16, 8, 8


def _sentences(n=40, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        length = int(rng.choice([3, 4, 6, 7]))
        start = int(rng.randint(1, VOCAB))
        s = [start]
        for _ in range(length - 1):
            s.append(s[-1] % 7 + 1)
        out.append(s)
    return out


def _sym_gen(lstm_unroll):
    def gen(seq_len):
        return lstm_unroll(num_layers=1, seq_len=seq_len, input_size=VOCAB,
                           num_hidden=HIDDEN, num_embed=EMBED,
                           num_label=VOCAB)
    return gen


_STATES = [("l0_init_c", (BATCH, HIDDEN)), ("l0_init_h", (BATCH, HIDDEN))]


def _lstm_args():
    sym = tmodels.lstm_unroll(1, 8, VOCAB, HIDDEN, EMBED, VOCAB)
    shapes = {f"t{t}_data": (BATCH,) for t in range(8)}
    shapes.update(dict(_STATES))
    return random_params(sym, 4, **shapes)[0]


def test_bucketing_module_matches_jax_and_shares_weights():
    """Three steps over buckets 4 and 8 through the explicit lifecycle:
    the parameters track the JAX package's (1e-5 of each leaf's largest),
    and every bucket's executor holds the default bucket's tensors."""
    args = _lstm_args()
    mods = []
    for pkg, gen in ((mx, _sym_gen(jlstm_unroll)),
                     (mt, _sym_gen(tmodels.lstm_unroll))):
        it = pkg.bucketing.BucketSentenceIter(
            _sentences(), buckets=[4, 8], batch_size=BATCH,
            init_states=_STATES)
        kw = {} if pkg is mx else {"context": mt.cpu()}
        mod = pkg.mod.BucketingModule(gen, default_bucket_key=8, **kw)
        mod.bind(it.provide_data, it.provide_label)
        conv = mx.nd.array if pkg is mx else torch.from_numpy
        mod.init_params(arg_params={k: conv(v) for k, v in args.items()},
                        aux_params={})
        mod.init_optimizer(optimizer_params={
            "learning_rate": 0.3, "momentum": 0.9, "rescale_grad": 1 / 8})
        keys = []
        for _, batch in zip(range(3), it):
            keys.append(batch.bucket_key)
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        mods.append((mod, keys))
    (jmod, jkeys), (tmod, tkeys) = mods
    assert jkeys == tkeys and set(tkeys) == {4, 8}
    _close(_np(tmod.get_params()[0]), _np(jmod.get_params()[0]))
    e4, e8 = tmod._bucket_execs[4], tmod._bucket_execs[8]
    shared = [n for n in e8.arg_dict if n in args]
    assert shared and all(e4.arg_dict[n] is e8.arg_dict[n] for n in shared)
    assert all(e4.grad_dict[n] is e8.grad_dict[n] for n in shared)


def test_bucket_reads_the_weights_another_bucket_updated():
    """After a step on bucket 4, bucket 8's forward reads the updated
    weights bit for bit: the same outputs as a fresh module given them."""
    args = _lstm_args()
    gen = _sym_gen(tmodels.lstm_unroll)
    it = mt.bucketing.BucketSentenceIter(_sentences(), buckets=[4, 8],
                                         batch_size=BATCH, init_states=_STATES,
                                         shuffle=False)
    batches = {}
    for b in it:
        batches.setdefault(b.bucket_key, b)
    mod = mt.mod.BucketingModule(gen, default_bucket_key=8, context=mt.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: torch.from_numpy(v)
                                for k, v in args.items()}, aux_params={})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.3})
    mod.forward(batches[8], is_train=False)  # bind bucket 8's executor first
    mod.forward(batches[4], is_train=True)
    mod.backward()
    mod.update()
    mod.forward(batches[8], is_train=False)
    got = [o.clone() for o in mod.get_outputs()]
    fresh = mt.mod.BucketingModule(gen, default_bucket_key=8,
                                   context=mt.cpu())
    fresh.bind(it.provide_data, it.provide_label)
    fresh.init_params(arg_params=mod.get_params()[0], aux_params={})
    fresh.forward(batches[8], is_train=False)
    moved = False
    for a, b in zip(got, fresh.get_outputs()):
        assert torch.equal(a, b)
    for k, v in mod.get_params()[0].items():
        moved |= not torch.equal(v, torch.from_numpy(args[k]))
    assert moved
