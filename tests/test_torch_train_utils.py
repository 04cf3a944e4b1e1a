"""The port's training utilities against the JAX package's: initializers
(by their moments: torch and JAX draw different numbers from one seed),
metrics, NDArrayIter's pad and wrap-around, learning-rate schedules, the
per-leaf optimizers and the imperative updater.

Tolerances: metrics and schedules are host arithmetic on the same numbers,
within 1e-6. The optimizers round every operation in f32 as the JAX
package's expressions do, but XLA on the CPU contracts multiply-adds into
fused multiply-adds, so weights and states are held within 4 ulp of the
leaf's largest value after 3 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)


@pytest.mark.parametrize("init,check", [
    (lambda pkg: pkg.init.Uniform(0.2), ("uniform", 0.2)),
    (lambda pkg: pkg.init.Normal(0.3), ("normal", 0.3)),
    (lambda pkg: pkg.init.Xavier(), ("uniform", np.sqrt(3.0 / ((64 * 9 + 128) / 2)))),
    (lambda pkg: pkg.init.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2), ("normal", np.sqrt(2.0 / (64 * 9)))),
])
def test_initializers_by_moments(init, check):
    kind, scale = check
    mt.random.seed(0)
    w = torch.zeros(128, 64, 3, 3)
    init(mt)("conv_weight", w)
    jw = mx.nd.zeros((128, 64, 3, 3))
    init(mx)("conv_weight", jw)
    for a in (w.numpy(), jw.asnumpy()):
        assert abs(a.mean()) < 0.02 * scale
        want_std = scale / np.sqrt(3.0) if kind == "uniform" else scale
        assert abs(a.std() / want_std - 1) < 0.02
        if kind == "uniform":
            assert a.min() >= -scale and a.max() <= scale
    mt.random.seed(0)
    w2 = torch.zeros(128, 64, 3, 3)
    init(mt)("conv_weight", w2)
    assert torch.equal(w, w2)  # the seed makes it reproducible


@pytest.mark.parametrize("name,value", [
    ("fc_bias", 0.0), ("bn_gamma", 1.0), ("bn_beta", 0.0),
    ("bn_moving_mean", 0.0), ("bn_moving_var", 1.0)])
def test_initializer_dispatch_by_suffix(name, value):
    for init in (mt.init.Uniform(), mt.init.Xavier(), mt.init.Normal()):
        t = torch.full((5,), 7.0)
        init(name, t)
        assert torch.all(t == value)
    t = torch.zeros(3)
    mt.init.Constant(0.5)("anything", t)
    assert torch.all(t == 0.5)
    with pytest.raises(mt.MXNetError, match="Unknown parameter kind"):
        mt.init.Uniform()("strange", torch.zeros(2))


def _metric_inputs(seed=0):
    rng = np.random.default_rng(seed)
    preds = rng.random((12, 5)).astype(np.float32)
    preds /= preds.sum(1, keepdims=True)
    labels = rng.integers(0, 5, 12).astype(np.float32)
    return labels, preds


METRICS = [("accuracy", {}), ("top_k_accuracy", {"top_k": 2}), ("ce", {}),
           ("mae", {}), ("mse", {}), ("rmse", {})]


@pytest.mark.parametrize("name,kw", METRICS)
def test_metrics_host_and_device_match_jax(name, kw):
    labels, preds = _metric_inputs()
    if name in ("mae", "mse", "rmse"):
        labels = np.random.default_rng(1).random((12, 5)).astype(np.float32)
    jm, tm = mx.metric.create(name, **kw), mt.metric.create(name, **kw)
    for lo, hi in ((0, 6), (6, 12)):
        jm.update([mx.nd.array(labels[lo:hi])], [mx.nd.array(preds[lo:hi])])
        tm.update([labels[lo:hi]], [torch.from_numpy(preds[lo:hi])])
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)
    if tm.device_supported:
        dm = mt.metric.create(name, **kw)
        state = dm.device_init("cpu")
        for lo, hi in ((0, 6), (6, 12)):
            state = dm.device_update(state, [torch.from_numpy(labels[lo:hi])],
                                     [torch.from_numpy(preds[lo:hi])])
        dm.absorb_device_state(state)
        np.testing.assert_allclose(dm.get()[1], jm.get()[1], rtol=1e-6)


def test_custom_and_composite_metrics():
    labels, preds = _metric_inputs()

    def feval(label, pred):
        return float((pred.argmax(1) == label).mean())

    comp = mt.metric.CompositeEvalMetric([mt.metric.create(feval),
                                          mt.metric.create("accuracy")])
    comp.update([labels], [preds])
    names, values = comp.get()
    assert names == ["feval", "accuracy"]
    assert values[0] == pytest.approx(values[1])
    assert np.isnan(mt.metric.create("accuracy").get()[1])


@pytest.mark.parametrize("n,batch,handle", [(10, 4, "pad"), (12, 4, "pad"),
                                            (10, 4, "roll_over")])
def test_ndarray_iter_pad_and_wrap_match_jax(n, batch, handle):
    X = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    Y = np.arange(n, dtype=np.float32)
    ji = mx.io.NDArrayIter(X, Y, batch_size=batch, last_batch_handle=handle)
    ti = mt.io.NDArrayIter(X, Y, batch_size=batch, last_batch_handle=handle)
    assert ti.provide_data == ji.provide_data
    assert ti.provide_label == ji.provide_label
    for _ in range(2):  # and again after the reset
        jb, tb = list(ji), list(ti)
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.data[0].numpy(), b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].numpy(), b.label[0].asnumpy())
            assert a.data[0].dtype == torch.float32


def test_ndarray_iter_seeded_shuffle_and_errors():
    X = np.arange(20, dtype=np.float32).reshape(10, 2)
    a = [b.data[0] for b in mt.io.NDArrayIter(X, batch_size=5, shuffle=True, seed=3)]
    b = [b.data[0] for b in mt.io.NDArrayIter(X, batch_size=5, shuffle=True, seed=3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert sorted(torch.cat(a)[:, 0].tolist()) == X[:, 0].tolist()
    with pytest.raises(mt.MXNetError):
        mt.io.NDArrayIter(X, np.zeros(3), batch_size=2)
    with pytest.raises(mt.MXNetError):
        mt.io.NDArrayIter(X, batch_size=11)


@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(3, 0.5, 0.1),
    lambda m: m.MultiFactorScheduler([2, 5, 9], 0.3, 0.2),
    lambda m: m.CosineScheduler(20, final_lr=0.001, warmup=4, base_lr=0.05),
    lambda m: m.FixedScheduler(0.7),
])
def test_lr_schedulers_match_jax(make):
    js, ts = make(mx.lr_scheduler), make(mt.lr_scheduler)
    for k in range(25):
        assert ts(k) == js(k)


def _assert_leaf_close(got, want, maxulp=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=maxulp * np.finfo(np.float32).eps * scale)


OPTIMIZERS = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=0.01, clip_gradient=1.0,
                 rescale_grad=0.5)),
    ("sgd", dict(learning_rate=0.1)),
    ("test", dict(rescale_grad=0.25)),
    ("rmsprop", dict(learning_rate=0.01, gamma=0.8, wd=0.001)),
    ("adagrad", dict(learning_rate=0.05, clip_gradient=0.5)),
    ("adam", dict(learning_rate=0.01, wd=0.01, fused=False)),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{o[0]}-{i}" for i, o in enumerate(OPTIMIZERS)])
def test_per_leaf_optimizers_match_jax(name, kw):
    rng = np.random.RandomState(0)
    shapes = {"a": (6, 5), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in sorted(shapes.items())}
    jo, to = mx.optimizer.create(name, **kw), mt.optimizer.create(name, **kw)
    step = jax.jit(lambda p, g, s: jo.apply(p, g, s, jnp.float32(jo.lr)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init_state_tree(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = to.init_state_tree(tp)
    for i in range(3):
        g = {k: np.random.RandomState(10 + i).randn(*shapes[k]).astype(np.float32)
             for k in sorted(shapes)}
        jp, js = step(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        with torch.no_grad():
            tp, ts = to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                              ts, to.lr)
    for k in shapes:
        _assert_leaf_close(tp[k].numpy(), jp[k])
        j_state = jax.tree_util.tree_leaves(js[k])
        t_state = [] if ts[k] is None else (
            list(ts[k]) if isinstance(ts[k], tuple) else [ts[k]])
        assert len(t_state) == len(j_state)
        for a, b in zip(t_state, j_state):
            _assert_leaf_close(a.numpy(), b)


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01)),
    ("adamw", dict(learning_rate=0.01, weight_decay=0.1,
                   decay_filter=lambda n: n == "w0")),
])
def test_imperative_updater_matches_jax(name, kw):
    """``get_updater``: per-index state and in-place writes, as the JAX
    package's KVStore updater contract."""
    rng = np.random.RandomState(1)
    ws = [rng.randn(4, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    names = ["w0", "w1"]
    jo = mx.optimizer.create(name, arg_names=names, **kw)
    to = mt.optimizer.create(name, arg_names=names, **kw)
    jup, tup = mx.optimizer.get_updater(jo), mt.optimizer.get_updater(to)
    jw = [mx.nd.array(w) for w in ws]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    for step in range(3):
        for i in range(2):
            g = np.random.RandomState(20 + step * 2 + i).randn(*ws[i].shape)
            g = g.astype(np.float32)
            jup(i, mx.nd.array(g), jw[i])
            tup(i, torch.from_numpy(g), tw[i])
    for a, b in zip(tw, jw):
        _assert_leaf_close(a.numpy(), b.asnumpy())
    assert to.num_update == jo.num_update == 3


def test_adamw_rejects_wd_and_filter_needs_names():
    with pytest.raises(mt.MXNetError, match="weight_decay"):
        mt.optimizer.AdamW(wd=0.1)
    opt = mt.optimizer.AdamW(decay_filter=lambda n: True)
    up = mt.optimizer.get_updater(opt)
    with pytest.raises(mt.MXNetError, match="NAMES"):
        up(0, torch.zeros(2), torch.zeros(2))
