"""Training health through the port against the JAX package's: the
per-layer statistics of one step (``device_stats``) on the same
parameters, gradients and updated parameters within 1e-5 relative and
``nonfinite`` exact; ``HealthMonitor`` fed the same events raising the
same anomalies exactly; and three SGD steps of ``fit(health=True)`` on an
MLP from the same weights and batches giving health events within 1e-5
relative per layer (the two packages' f32 sums run in different orders).
The captured health step is held to the eager one on the card in
tests/test_torch_observability_card.py."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jt
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import random_params

mt.set_matmul_precision("highest")
RTOL = 1e-5


def _tree(rng, shapes, scale=1.0):
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in sorted(shapes.items())}


SHAPES = {"fc1_weight": (16, 8), "fc1_bias": (16,), "bn1_gamma": (16,),
          "bn1_beta": (16,), "fc2_weight": (4, 16), "fc2_bias": (4,),
          "embed": (10, 3)}


def _jax_stats(groups, params, grads, new, loss):
    import jax.numpy as jnp

    out = jt.health.device_stats(
        groups, {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in new.items()}, jnp.float32(loss))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_stats(groups, params, grads, new, loss):
    out = tt.health.device_stats(
        groups, {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in new.items()},
        torch.tensor(loss))
    return {k: v.numpy() for k, v in out.items()}


def _assert_stats(ps, js):
    for k in ("grad_norm", "weight_norm", "update_ratio", "loss"):
        np.testing.assert_allclose(ps[k], js[k], rtol=RTOL, atol=0, err_msg=k)
    np.testing.assert_array_equal(ps["nonfinite"], js["nonfinite"])
    assert ps["nonfinite"].dtype == np.int32


@pytest.mark.parametrize("seed", range(4))
def test_device_stats_match_jax(seed):
    rng = np.random.RandomState(seed)
    params = _tree(rng, SHAPES)
    grads = _tree(rng, SHAPES, scale=10.0 ** rng.randint(-3, 3))
    new = {k: v - 0.01 * grads[k] for k, v in params.items()}
    groups = tt.health.layer_groups(SHAPES)
    assert groups == jt.health.layer_groups(SHAPES)
    loss = float(rng.rand() * 5)
    _assert_stats(_port_stats(groups, params, grads, new, loss),
                  _jax_stats(groups, params, grads, new, loss))


@pytest.mark.parametrize("plant", ["nan", "inf", "both_layers"])
def test_device_stats_nonfinite_exact(plant):
    rng = np.random.RandomState(7)
    params = _tree(rng, SHAPES)
    grads = _tree(rng, SHAPES)
    grads["fc2_weight"][1, 3] = np.nan if plant != "inf" else np.inf
    if plant == "both_layers":
        grads["fc1_bias"][2] = -np.inf
        grads["fc1_weight"][0, :3] = np.nan
    new = {k: v - 0.1 * np.nan_to_num(grads[k]) for k, v in params.items()}
    groups = tt.health.layer_groups(SHAPES)
    ps = _port_stats(groups, params, grads, new, 1.0)
    js = _jax_stats(groups, params, grads, new, 1.0)
    np.testing.assert_array_equal(ps["nonfinite"], js["nonfinite"])
    layers = list(groups)
    assert ps["nonfinite"][layers.index("fc2")] == 1
    np.testing.assert_allclose(ps["weight_norm"], js["weight_norm"],
                               rtol=RTOL)


def test_device_stats_buffers_flat_gradients_and_monitor_blame():
    """The in-step form (static buffers, gradients as views of one flat
    buffer, pre-update weights kept) reads as the pure form, and a planted
    NaN is blamed on its layer."""
    rng = np.random.RandomState(3)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng, SHAPES).items()}
    names = list(params)
    sizes = [params[k].numel() for k in names]
    flat = torch.from_numpy(rng.randn(sum(sizes)).astype(np.float32))
    offs = np.cumsum([0] + sizes[:-1])
    views = {k: flat[o:o + n].view(params[k].shape)
             for k, o, n in zip(names, offs, sizes)}
    flat[int(offs[names.index("fc1_weight")]) + 5] = float("nan")
    groups = tt.health.layer_groups(names)
    ds = tt.health.DeviceStats(groups, params, "cpu", flat_grad=flat,
                               grad_views=views)
    old = {k: v.clone() for k, v in params.items()}
    ds.before_update(params)
    for k in names:
        params[k].sub_(0.01 * torch.nan_to_num(views[k]))
    ds.after_update(params, views, torch.tensor(2.0))
    pure = tt.health.device_stats(groups, old, views, params, 2.0)
    for k, v in pure.items():
        torch.testing.assert_close(ds.buffers[k], v, rtol=0, atol=0,
                                   equal_nan=True, msg=k)
    tt.reset()
    mon = tt.HealthMonitor().attach()
    try:
        _, finite = tt.health.observe_device_stats(groups, ds.buffers, 0, 0)
        assert not finite
        assert mon.blamed_layer() == ("fc1", "nonfinite")
    finally:
        mon.detach()


def _row(grad=1.0, weight=10.0, ratio=1e-3, nonfinite=0):
    return {"grad_norm": grad, "weight_norm": weight, "update_ratio": ratio,
            "nonfinite": nonfinite}


def _events(kind, rng):
    """A seeded health stream that trips the detector ``kind``."""
    out = []
    loss = 1.0
    for i in range(60):
        stats = {"fc1": _row(grad=1.0 + 0.05 * rng.randn()),
                 "fc2": _row(grad=2.0 + 0.1 * rng.randn())}
        finite = True
        step_loss = 1.0 + 0.02 * rng.randn()
        if kind == "grad_explosion" and i == 30:
            stats["fc2"] = _row(grad=80.0)
        if kind == "nonfinite" and i == 12:
            stats["fc1"] = _row(grad=float("nan"), nonfinite=3)
            finite = False
        if kind == "loss_spike" and i == 40:
            step_loss = 40.0
        if kind == "dead_layer":
            stats["fc1"] = _row(ratio=1e-14)
        if kind == "divergence_drift":
            loss *= 1.05
            step_loss = loss
        out.append({"kind": "health", "epoch": 0, "step": i,
                    "loss": step_loss, "finite": finite, "stats": stats})
    return out


@pytest.fixture
def one_rank_world():
    """Both packages' process world pinned to (0, 1) around a comparison
    of stamped records, and what it was put back after: each hub's
    ``emit`` stamps ``rank`` and ``world_size``, which the comparison
    keeps, and a test that ran before in this process may have left
    either package's world elsewhere."""
    prev = (tt.current_rank(), tt.world_size(), jt.current_rank(),
            jt.world_size())
    tt.set_world(0, 1)
    jt.set_world(0, 1)
    yield
    tt.set_world(*prev[:2])
    jt.set_world(*prev[2:])


@pytest.mark.parametrize("kind", list(jt.health.ANOMALY_REASONS))
def test_monitor_same_events_same_anomalies(kind, one_rank_world):
    assert tt.health.ANOMALY_REASONS == jt.health.ANOMALY_REASONS
    events = _events(kind, np.random.RandomState(11))
    cfg = dict(min_steps=4, dead_steps=10, drift_tol=0.1, drift_steps=10)
    jt.reset()
    tt.reset()
    jm = jt.HealthMonitor(jt.HealthConfig(**cfg))
    tm = tt.HealthMonitor(tt.HealthConfig(**cfg))
    for e in events:
        jf = jm.observe(dict(e))
        tf = tm.observe(dict(e))
        assert [f[:2] for f in tf] == [f[:2] for f in jf]
    strip = ("ts", "wall_ts", "run_id", "trace_id")
    assert [{k: v for k, v in a.items() if k not in strip}
            for a in tm.anomalies] == [
        {k: v for k, v in a.items() if k not in strip} for a in jm.anomalies]
    assert tm.blamed_layer() == jm.blamed_layer()
    assert any(a["reason"] == kind for a in tm.anomalies)
    assert dict(tm._anomaly_counts) == dict(jm._anomaly_counts)


@pytest.mark.parametrize("value,env", [(None, ""), (True, ""), (None, "1"),
                                       (False, "1")])
def test_health_config_resolves_as_jax(monkeypatch, value, env):
    monkeypatch.setenv("MXNET_TPU_HEALTH", env)
    j = jt.HealthConfig.resolve(value)
    t = tt.HealthConfig.resolve(value)
    assert (j is None) == (t is None)
    if t is not None:
        assert repr(t) == repr(j) and t.key() == j.key()


def _mlp(pkg):
    s = pkg.symbol
    h = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
    h = s.Activation(h, act_type="relu", name="relu1")
    h = s.FullyConnected(h, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def test_fit_health_events_match_jax():
    """Three SGD steps of ``fit(health=True)`` from the same weights and
    batches: each step's event within 1e-5 relative per layer."""
    rng = np.random.RandomState(0)
    X = rng.randn(24, 10).astype(np.float32)
    y = rng.randint(0, 4, 24).astype(np.float32)
    args, _ = random_params(_mlp(mt), 0, data=(8, 10))
    events = []
    for pkg, tel in ((mx, jt), (mt, tt)):
        tel.reset()
        kw = dict(ctx=pkg.cpu())
        model = pkg.FeedForward(
            _mlp(pkg), num_epoch=1, optimizer="sgd", learning_rate=0.5,
            arg_params={k: (pkg.nd.array(v) if pkg is mx else v)
                        for k, v in args.items()}, **kw)
        model.fit(pkg.io.NDArrayIter(X, y, batch_size=8, shuffle=False),
                  health=True)
        events.append(tel.hub().events("health"))
    jev, tev = events
    assert len(jev) == len(tev) == 3
    for je, te in zip(jev, tev):
        assert te["step"] == je["step"] and te["finite"] == je["finite"]
        np.testing.assert_allclose(te["loss"], je["loss"], rtol=RTOL)
        assert set(te["stats"]) == set(je["stats"]) == {"fc1", "fc2"}
        for layer, row in je["stats"].items():
            for key in ("grad_norm", "weight_norm", "update_ratio"):
                np.testing.assert_allclose(te["stats"][layer][key], row[key],
                                           rtol=RTOL, err_msg=(layer, key))
            assert te["stats"][layer]["nonfinite"] == row["nonfinite"] == 0


def test_fit_health_every_and_precompile_key():
    rng = np.random.RandomState(1)
    X = rng.randn(32, 64).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    tt.reset()
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1)
    model.fit(X, y, batch_size=8, health=tt.HealthConfig(every=2))
    assert [e["step"] for e in tt.hub().events("health")] == [0, 2]
    state = model._train_state
    key_on = model._program_key({"data": torch.zeros(8, 64)}, None, None)
    state.enable_health(None, (), on=False)
    key_off = model._program_key({"data": torch.zeros(8, 64)}, None, None)
    assert key_on != key_off and key_on[:len(key_off)] == key_off
