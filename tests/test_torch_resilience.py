"""Resilience through the port (``mxnet_tpu_torch/resilience/``: chaos,
retry, guards, preempt; ``fit(guards=)``) against the JAX package's, case
for case with ``tests/test_resilience.py``.

Where both packages compute, the port is held to the reference: the same
seed and rules fire at the same occurrences, the retry delays and breaker
transitions are the same, and a guarded fit with one injected NaN step ends
within 1e-5 of the JAX package's guarded fit from the same weights and
batches (f32, the MLP, SGD and Adam), with the same ``guard_stats`` and the
same loss-scale sequence. A skipped step leaves the parameters, moments and
running statistics bitwise as they were before it. The card's cases (the
captured guarded step against the eager one, the guard's cost, the
kernel path's quantize passes) are in tests/test_torch_resilience_card.py.
"""

import contextlib
import os
import signal
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import resilience as jres
from mxnet_tpu.models import mlp as jmlp
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.resilience import (ChaosConfig, CircuitBreaker,
                                        GuardConfig, RetryingKVStore,
                                        RetryPolicy, StepTimeoutError,
                                        TrainingPreempted, chaos_scope,
                                        retry_call)
from mxnet_tpu_torch.resilience import guards as tguards
from mxnet_tpu_torch.resilience.chaos import TransientError
from mxnet_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

SHAPE = (4, 4)


def _blobs(n=128):
    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(n, 8) + 1.0,
                        rng.randn(n, 8) - 1.0]).astype(np.float32)
    y = np.concatenate([np.ones(n), np.zeros(n)]).astype(np.float32)
    return X, y


def _model(num_epoch=4, hidden=(16,), **kw):
    mt.random.seed(0)
    kw = {"optimizer": "sgd", "learning_rate": 0.1, **kw}
    return mt.FeedForward(tmodels.mlp(num_classes=2, hidden=hidden),
                          ctx=mt.cpu(), num_epoch=num_epoch,
                          initializer=mt.init.Xavier(), **kw)


@contextlib.contextmanager
def _both_chaos(seed, rules):
    """The same schedule armed in both packages."""
    with jres.chaos_scope(seed=seed, rules=rules) as jz, \
            chaos_scope(seed=seed, rules=rules) as tz:
        yield jz, tz


def _both_fits(X, y, num_epoch, rules=None, seed=0, guards=True,
               batch_size=32, epoch_end=None, **kw):
    """The JAX package's and the port's guarded fits from the same weights,
    batches and chaos schedule; returns (jax model, port model)."""
    args, aux = random_params(tmodels.mlp(num_classes=2, hidden=(16,)), 5,
                              data=(batch_size, 8))
    out = []
    for pkg, net in ((mx, jmlp(num_classes=2, hidden=(16,))),
                     (mt, tmodels.mlp(num_classes=2, hidden=(16,)))):
        conv = (lambda v: mx.nd.array(v)) if pkg is mx else torch.from_numpy
        ctx = {"ctx": mx.cpu()} if pkg is mx else {"ctx": mt.cpu()}
        m = pkg.FeedForward(net, num_epoch=num_epoch,
                            arg_params={k: conv(v) for k, v in args.items()},
                            aux_params={k: conv(v) for k, v in aux.items()},
                            **ctx, **kw)
        scope = (jres.chaos_scope if pkg is mx else chaos_scope)(
            seed=seed, rules=rules or {})
        cfg = guards
        if isinstance(guards, GuardConfig):
            cfg = jres.GuardConfig(**vars(guards)) if pkg is mx else guards
        with scope:
            m.fit(pkg.io.NDArrayIter(X, y, batch_size=batch_size,
                                     shuffle=False),
                  guards=cfg, epoch_end_callback=(
                      (lambda *a, m=m: epoch_end(m)) if epoch_end else None))
        out.append(m)
    return out


def _host(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else v.numpy()


def _assert_params_close(jm, tm, atol=1e-5):
    for k, v in jm.arg_params.items():
        np.testing.assert_allclose(tm.arg_params[k].numpy(), _host(v),
                                   rtol=0, atol=atol, err_msg=k)


# -- chaos registry -------------------------------------------------------------

@pytest.mark.parametrize("seed", [7, 8, 13])
def test_chaos_schedule_matches_jax(seed):
    """Same seed and rule -> the same fire pattern as the JAX package's;
    the probability is honoured."""
    rules = {"s": 0.3, "t": 0.5}
    with _both_chaos(seed, rules) as (jz, tz):
        ja = [(jz.fires("s"), jz.fires("t")) for _ in range(50)]
        ta = [(tz.fires("s"), tz.fires("t")) for _ in range(50)]
    assert ta == ja
    assert tz.fired == jz.fired
    assert 5 < sum(a for a, _ in ta) < 25
    with chaos_scope(seed=seed + 100, rules=rules) as other:
        assert [(other.fires("s"), other.fires("t"))
                for _ in range(50)] != ta


def test_chaos_occurrence_index_and_env_format():
    with chaos_scope(seed=0, rules={"s": {2, 4}}) as cz:
        fired = [cz.fires("s") for _ in range(6)]
    assert fired == [False, False, True, False, True, False]
    text = "seed=9;kvstore.push=0.25;step.nan=#3;step.nan=#5; ;x={1}"[:-6]
    cfg = ChaosConfig.from_env(text)
    ref = jres.ChaosConfig.from_env(text)
    assert (cfg.seed, cfg.rules) == (ref.seed, ref.rules)
    assert cfg.seed == 9 and cfg.rules["step.nan"] == {3, 5}


def test_chaos_disarmed_is_free(monkeypatch):
    from mxnet_tpu_torch.resilience import chaos as chaos_mod

    monkeypatch.setattr(chaos_mod, "_CURRENT", None)
    monkeypatch.setattr(chaos_mod, "_ENV_CHECKED", True)
    assert chaos_mod.active() is None
    assert chaos_mod.fires("never.configured") is False
    chaos_mod.maybe_raise("never.configured")
    # the env arms it once, as the JAX package's does
    monkeypatch.setattr(chaos_mod, "_ENV_CHECKED", False)
    monkeypatch.setenv("MXNET_TPU_CHAOS", "seed=1;s=#0")
    assert chaos_mod.fires("s") is True and chaos_mod.fires("s") is False


# -- retry policy / breaker -------------------------------------------------------

def test_retry_policy_matches_jax():
    p = RetryPolicy(max_retries=4, base_delay=0.1, max_delay=0.5,
                    jitter=0.0, seed=0)
    assert list(p.delays()) == [0.1, 0.2, 0.4, 0.5]
    jittered = [list(RetryPolicy(max_retries=6, base_delay=0.05, seed=s)
                     .delays()) for s in (0, 1, 2)]
    ref = [list(jres.RetryPolicy(max_retries=6, base_delay=0.05, seed=s)
                .delays()) for s in (0, 1, 2)]
    assert jittered == ref

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientError("drop")
        return "ok"

    slept = []
    assert retry_call(flaky, RetryPolicy(max_retries=4, base_delay=0.01,
                                         jitter=0.5, seed=1),
                      sleep=slept.append) == "ok"
    assert len(calls) == 3 and len(slept) == 2

    def always_down():
        raise ConnectionError("dead")

    with pytest.raises(ConnectionError):
        retry_call(always_down, RetryPolicy(max_retries=2, base_delay=0.001),
                   sleep=lambda _d: None)


def test_circuit_breaker_transitions_match_jax():
    def run(cls):
        now = [0.0]
        b = cls(failure_threshold=2, reset_after=10.0, clock=lambda: now[0])
        seen = [(b.allow(), b.state)]
        for t, op in ((0, "f"), (0, "f"), (0, "allow"), (11, "allow"),
                      (11, "f"), (22, "allow"), (22, "s"), (22, "allow")):
            now[0] = float(t)
            if op == "f":
                b.record_failure()
            elif op == "s":
                b.record_success()
            seen.append((b.allow() if op == "allow" else None, b.state,
                         b.failures))
        return seen, b.trip_count

    seen, trips = run(CircuitBreaker)
    assert (seen, trips) == run(jres.CircuitBreaker)
    assert trips == 2 and seen[-1][1] == "closed"


# -- retrying kvstore -------------------------------------------------------------

class _FlakyStore(mt.kvstore.KVStore):
    """Local store whose transport can be killed (dead=True)."""

    def __init__(self):
        super().__init__("local")
        self.dead = False

    def push(self, key, value, priority=0):
        if self.dead:
            raise ConnectionError("server group down")
        super().push(key, value, priority)

    def pull(self, key, out, priority=0):
        if self.dead:
            raise ConnectionError("server group down")
        super().pull(key, out, priority)


def _fast_rkv(inner, threshold=2, reset_after=0.15):
    return RetryingKVStore(
        inner, policy=RetryPolicy(max_retries=3, base_delay=0.001, seed=0),
        breaker=CircuitBreaker(failure_threshold=threshold,
                               reset_after=reset_after))


def test_retrying_kvstore_retries_chaos_drops():
    rkv = _fast_rkv(_FlakyStore())
    rkv.init(3, torch.ones(SHAPE))
    with chaos_scope(seed=1, rules={"kvstore.push": 0.4}) as cz:
        for _ in range(10):
            rkv.push(3, [torch.ones(SHAPE) * 2])
    out = torch.empty(SHAPE)
    rkv.pull(3, out=out)
    np.testing.assert_allclose(out.numpy(), 2.0)
    # the same drops as the JAX package's under the same seed
    with jres.chaos_scope(seed=1, rules={"kvstore.push": 0.4}) as jz:
        jz.fires("kvstore.push")  # init's attempt, as the port's
        drops = sum(jz.fires("kvstore.push") for _ in range(40))
    assert rkv.stats["retries"] == cz.fired["kvstore.push"] > 0
    assert drops >= cz.fired["kvstore.push"] - 1
    assert rkv.breaker.state == "closed"


def test_retrying_kvstore_degrades_to_local_and_recovers():
    inner = _FlakyStore()
    rkv = _fast_rkv(inner)
    rkv.set_updater(lambda k, recv, stored: stored.__iadd__(recv))
    rkv.init("w", torch.ones(4))

    inner.dead = True
    for _ in range(4):
        rkv.push("w", [torch.ones(4)])
    assert rkv.breaker.state == "open"
    assert rkv.stats["degraded_ops"] >= 2
    out = torch.empty(4)
    rkv.pull("w", out=out)  # from the local mirror
    np.testing.assert_allclose(out.numpy(), 5.0)  # 1 + 4 degraded pushes

    inner.dead = False
    time.sleep(0.2)  # the breaker's reset window
    rkv.push("w", [torch.ones(4)])  # the half-open probe succeeds
    assert rkv.breaker.state == "closed"
    out2 = torch.empty(4)
    rkv.pull("w", out=out2)  # the server's state wins on recovery
    np.testing.assert_allclose(out2.numpy(), 2.0)  # init + 1 push
    assert rkv.stats["resyncs"] >= 1


def test_async_kvstore_reconnects_through_dead_sockets():
    from mxnet_tpu_torch.kvstore_async import AsyncKVStore

    with chaos_scope(seed=5, rules={"async.call": 0.3}) as cz:
        kv = AsyncKVStore()
        try:
            kv.init("w", torch.ones(8))
            out = None
            for i in range(6):
                out = kv.push_pull({"w": np.full((8,), float(i), np.float32)})
            np.testing.assert_allclose(out["w"], 5.0)
            assert cz.fired.get("async.call", 0) > 0  # sockets died
        finally:
            kv.close()


def test_group_push_resends_lost_requests_and_acks():
    """``group.push.send`` and ``group.push.ack``: a lost request is resent,
    a lost ack resends a push the server already applied, which it counts
    once."""
    kvs = mt.kvstore.create_group(1)
    kv = kvs[0]
    kv.init("w", torch.zeros(4))
    kv.set_updater(lambda k, g, w: w.__iadd__(g))
    with chaos_scope(seed=0, rules={"group.push.send": {0},
                                    "group.push.ack": {1}}) as cz:
        kv._retry_policy = RetryPolicy(max_retries=3, base_delay=0.001,
                                       seed=0)
        for _ in range(3):
            kv.push("w", [torch.ones(4)])
    out = torch.empty(4)
    kv.pull("w", out=out)
    np.testing.assert_allclose(out.numpy(), 3.0)
    assert cz.fired == {"group.push.send": 1, "group.push.ack": 1}
    assert kv._server.duplicate_count == 1


# -- step guards ----------------------------------------------------------------

def test_finite_flag_matches_jax_on_overflow():
    """Per-tensor sums, then their sum: a finite gradient whose sum
    overflows flags the step in both packages."""
    import jax.numpy as jnp

    cases = [
        {"a": [3e38, 3e38], "b": [1.0]},          # a tensor's sum overflows
        {"a": [3e38], "b": [3e38]},               # the sum of sums does
        {"a": [3e38, -3e38], "b": [1.0, 2.0]},    # cancels: finite
        {"a": [1.0, float("nan")], "b": [1.0]},
        {"a": [1.0, 2.0], "b": [float("-inf")]},
        {"a": [1.0, 2.0], "b": [3.0]},
    ]
    got, want = [], []
    for grads in cases:
        got.append(bool(tguards.finite_flag(
            torch.tensor(0.5), {k: torch.tensor(v, dtype=torch.float32)
                                for k, v in grads.items()})))
        want.append(bool(jres.guards.finite_flag(
            jnp.float32(0.5), {k: jnp.asarray(v, jnp.float32)
                               for k, v in grads.items()})))
    assert got == want == [False, False, True, False, False, True]
    assert not bool(tguards.finite_flag(torch.tensor(float("nan")), {}))


@pytest.mark.parametrize("optimizer,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("adam", dict(learning_rate=0.01, epsilon=1e-3)),
])
def test_guard_skips_nan_step_matches_jax(optimizer, kw):
    X, y = _blobs()
    jm, tm = _both_fits(X, y, 2, rules={"step.nan": {5}}, optimizer=optimizer,
                        **kw)
    assert tm.guard_stats == jm.guard_stats
    assert tm.guard_stats["skipped_steps"] == 1
    _assert_params_close(jm, tm)
    # and the skip is not a no-op fit: against the unguarded trajectory
    ref = _both_fits(X, y, 2, guards=None, optimizer=optimizer, **kw)[1]
    assert any(not torch.equal(ref.arg_params[k], v)
               for k, v in tm.arg_params.items())


def test_guard_on_real_bad_data():
    """No injection: one NaN sample poisons every parameter without
    guards, and its step is skipped (one an epoch) with them."""
    X, y = _blobs()
    X_nan = X.copy()
    X_nan[7, 3] = np.nan
    m2 = _model(num_epoch=1)
    m2.fit(X_nan, y, batch_size=32)
    assert not torch.isfinite(next(iter(m2.arg_params.values()))).all()
    m3 = _model(num_epoch=1)
    m3.fit(X_nan, y, batch_size=32, guards=True)
    assert m3.guard_stats["skipped_steps"] == 1
    for v in m3.arg_params.values():
        assert torch.isfinite(v).all()


def test_skipped_step_leaves_state_bitwise():
    """The select puts back the parameters, Adam's moments and step counts
    and the running statistics of a non-finite step exactly."""
    net = tmodels.resnet(units=(1, 1, 1, 1), filter_list=(8, 8, 16, 16),
                         num_classes=4)
    args, aux = random_params(net, 0, data=(4, 3, 32, 32))
    rng = np.random.RandomState(0)
    X = rng.randn(12, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 4, 12).astype(np.float32)
    seen = {}

    def before_third(param):
        if param.nbatch == 2:
            st = m._train_state
            seen["params"] = {k: v.detach().clone()
                              for k, v in st.params.items()}
            seen["aux"] = {k: v.clone() for k, v in st.aux.items()}
            seen["opt"] = [t.clone() for t in mt.model.opt_leaves(
                st.opt_state)]

    m = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=1, optimizer="adam",
                       fused=True, learning_rate=0.01, arg_params=args,
                       aux_params=aux)
    with chaos_scope(seed=0, rules={"step.nan": {2}}):
        m.fit(mt.io.NDArrayIter(X, y, batch_size=4, shuffle=False),
              guards=True, batch_end_callback=before_third)
    st = m._train_state
    assert m.guard_stats["skipped_steps"] == 1
    for k, v in seen["params"].items():
        assert torch.equal(st.params[k].detach(), v), k
    for k, v in seen["aux"].items():
        assert torch.equal(st.aux[k], v), k
    st.guard.read()  # the host's step counts from the device's
    for a, b in zip(mt.model.opt_leaves(st.opt_state), seen["opt"]):
        assert torch.equal(a, b)
    assert float(st.opt_state[sorted(st.opt_state)[0]][2]) == 2.0


def test_guard_step_retry_on_transient_raise():
    X, y = _blobs(64)
    jm, tm = _both_fits(X, y, 2, rules={"step.raise": {3}},
                        optimizer="sgd", learning_rate=0.1)
    assert tm.guard_stats == jm.guard_stats
    assert tm.guard_stats["step_retries"] == 1
    _assert_params_close(jm, tm)
    # past max_step_retries the fault surfaces
    m = _model(num_epoch=1)
    with chaos_scope(seed=0, rules={"step.raise": {0, 1, 2}}):
        with pytest.raises(tres.TransientStepError):
            m.fit(X, y, batch_size=32,
                  guards=GuardConfig(max_step_retries=2))


def test_dynamic_loss_scale_sequence_matches_jax():
    """Backoff on each skipped step, growth after ``growth_interval``
    finite steps in a row: the epoch-end scales equal the JAX package's."""
    X, y = _blobs(64)
    cfg = GuardConfig(dynamic_loss_scale=True, init_scale=8.0,
                      scale_backoff=0.5, growth_interval=3)
    scales = {"jax": [], "torch": []}

    def record(m):
        key = "jax" if isinstance(m, mx.FeedForward) else "torch"
        scales[key].append((m.guard_stats["loss_scale"],
                            m.guard_stats["skipped_steps"]))

    jm, tm = _both_fits(X, y, 4, rules={"step.nan": {2, 9}}, guards=cfg,
                        batch_size=16, epoch_end=record, optimizer="adam",
                        learning_rate=0.01, epsilon=1e-3)
    assert scales["torch"] == scales["jax"]
    assert scales["torch"][0] == (8.0, 1)  # 8 x 0.5 x 2 (growth at 4 finite)
    assert tm.guard_stats == jm.guard_stats
    _assert_params_close(jm, tm)


def test_watchdog_aborts_hung_step():
    X, y = _blobs(64)
    m = _model()
    with chaos_scope(seed=0, rules={"step.hang": {1}}):
        with pytest.raises(StepTimeoutError):
            m.fit(X, y, batch_size=32,
                  guards=GuardConfig(watchdog_deadline=0.4))
    # a beat clears a late step; a stopped watchdog stays quiet
    wd = tres.StepWatchdog(0.05, abort=False)
    wd.beat()
    time.sleep(0.15)
    with pytest.raises(StepTimeoutError):
        wd.check()
    wd.beat()
    wd.check()
    wd.stop()


def test_guard_config_resolve_and_env(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_GUARDS", raising=False)
    assert GuardConfig.resolve(None) is None
    assert GuardConfig.resolve(False) is None
    assert isinstance(GuardConfig.resolve(True), GuardConfig)
    cfg = GuardConfig(init_scale=4.0)
    assert GuardConfig.resolve(cfg) is cfg
    monkeypatch.setenv("MXNET_TPU_GUARDS", "1")
    assert isinstance(GuardConfig.resolve(None), GuardConfig)
    with pytest.raises(MXNetError):
        GuardConfig.resolve("yes")
    assert vars(GuardConfig()) == vars(jres.GuardConfig())
    assert GuardConfig().pinned_unit_scale()
    assert not GuardConfig(dynamic_loss_scale=True).pinned_unit_scale()


# -- preemption and checkpoint validity -------------------------------------------

def test_sigterm_mid_epoch_flushes_and_resumes(tmp_path):
    X, y = _blobs()
    d = str(tmp_path / "ckpt")

    def sigterm_at(param):
        if param.epoch == 2 and param.nbatch == 3:
            signal.raise_signal(signal.SIGTERM)

    m = _model(num_epoch=4)
    with pytest.raises(TrainingPreempted) as ei:
        m.fit(X, y, batch_size=32, sharded_checkpoint_dir=d,
              batch_end_callback=sigterm_at, guards=True)
    assert ei.value.epoch == 2
    # the flush overwrote epoch 1's step 2 with mid-epoch-2 state
    assert tck.latest_step(d) == 2
    _, _, _, meta, _ = tck.load_sharded(d, 2)
    assert meta["preempted"] and meta["epoch"] == 2
    assert meta["loss_scale"] == 1.0
    assert torch.isfinite(next(iter(m.arg_params.values()))).all()

    m2 = _model(num_epoch=4)
    m2.fit(X, y, batch_size=32, sharded_checkpoint_dir=d, guards=True)
    assert m2.begin_epoch == 2  # resumed from the flushed step
    assert tck.latest_step(d) == 4
    assert m2.score(X, y=y) > 0.95
    # the handler is gone after the fit: SIGTERM is the default again
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None) or \
        signal.getsignal(signal.SIGTERM) is not \
        tres.PreemptionHandler._on_term


def test_sigterm_step_granular_resume_is_bitwise(tmp_path, monkeypatch):
    """With a step cadence the flush saves the step and the batches done:
    the resumed fit ends bitwise where the uninterrupted one ends (Adam,
    guards on, a NaN step before the signal)."""
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "100")
    X, y = _blobs()
    kw = dict(optimizer="adam", learning_rate=0.01)
    rules = {"step.nan": {3}}

    def fit(d, cb=None):
        m = _model(num_epoch=2, **kw)
        with chaos_scope(seed=0, rules=rules):
            m.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
                  sharded_checkpoint_dir=d, checkpoint_every_n_steps=100,
                  guards=True, batch_end_callback=cb)
        return m

    ref = fit(str(tmp_path / "ref"))

    def sigterm_at(param):
        if param.epoch == 1 and param.nbatch == 3:
            signal.raise_signal(signal.SIGTERM)

    d = str(tmp_path / "kill")
    with pytest.raises(TrainingPreempted):
        fit(d, sigterm_at)
    step = tck.latest_step(d)
    _, _, _, meta, _ = tck.load_sharded(d, step)
    assert meta["preempted"] and meta["batches_done"] == 3 and step == 11
    rules = {}  # the relaunch injects nothing more
    resumed = fit(d)
    for k, v in ref.arg_params.items():
        assert torch.equal(resumed.arg_params[k], v), k


def test_corrupt_shard_resume_falls_back(tmp_path):
    """``ckpt.corrupt`` flips bytes in a written shard: its manifest CRC
    fails, and resume takes the last valid step."""
    X, y = _blobs(64)
    d = str(tmp_path / "ckpt")
    with chaos_scope(seed=0, rules={"ckpt.corrupt": {1}}) as cz:
        _model(num_epoch=2).fit(X, y, batch_size=32,
                                sharded_checkpoint_dir=d)
    assert cz.fired == {"ckpt.corrupt": 1}
    assert not tck.validate_step(d, 2) and tck.validate_step(d, 1)
    assert tck.latest_step(d) == 1
    m = _model(num_epoch=3)
    m.fit(X, y, batch_size=32, sharded_checkpoint_dir=d)
    assert m.begin_epoch == 1  # from the last valid step
    assert tck.latest_step(d) == 3


def test_async_write_and_replica_sites(tmp_path, monkeypatch):
    """``ckpt.async_write`` fails a background write (counted, never
    raised); ``ckpt.replica`` loses a snapshot on its way to the peer
    tier."""
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "100")
    X, y = _blobs(64)
    d = str(tmp_path / "ckpt")
    m = _model(num_epoch=1)
    with chaos_scope(seed=0, rules={"ckpt.async_write": {0},
                                    "ckpt.replica": {1}}) as cz:
        m.fit(X, y, batch_size=32, sharded_checkpoint_dir=d,
              checkpoint_every_n_steps=1)
    assert cz.fired == {"ckpt.async_write": 1, "ckpt.replica": 1}
    steps = sorted(int(s) for s in os.listdir(d) if s.isdigit())
    assert 1 not in steps and 4 in steps  # the lost write, the epoch's end
    assert m.ckpt_replicas.restore().step == 4


def test_engine_wait_deadline():
    from mxnet_tpu_torch.engine import Engine

    eng = Engine(num_workers=1)
    eng.push(lambda: time.sleep(0.8))
    with pytest.raises(MXNetError, match="deadline"):
        eng.wait_for_all(timeout=0.05)
    eng.wait_for_all()


def test_monitor_surfaces_nonfinite_counts():
    from mxnet_tpu_torch.monitor import Monitor, nonfinite_count

    assert nonfinite_count(np.array([1.0, np.nan, np.inf, 2.0])) == 2
    assert nonfinite_count(np.array([1, 2, 3])) == 0
    net = mt.sym.FullyConnected(data=mt.sym.Variable("data"), num_hidden=4,
                                name="fc")
    exe = net.simple_bind(mt.cpu(), data=(2, 3))
    exe.arg_dict["data"][:] = torch.tensor(
        [[1.0, np.nan, 2.0], [3.0, 4.0, 5.0]])
    exe.arg_dict["fc_weight"][:] = torch.ones((4, 3))
    exe.arg_dict["fc_bias"][:] = torch.zeros(4)
    mon = Monitor(interval=1, track_nonfinite=True)
    mon.install(exe)
    mon.tic()
    stats = dict((name, val) for _s, name, val in mon.toc())
    assert stats["data_nonfinite"] == 1
    assert stats["fc_output_nonfinite"] == 4


def test_skipped_step_keeps_the_residual_as_jax():
    """The reference selects no error-feedback residual on a skipped step
    (mxnet_tpu/model.py:700-715): the NaN step's residual stays NaN, so
    every later step is skipped too. The port does the same, on two
    replicas with int8 compression."""
    X, y = _blobs(64)
    args, aux = random_params(tmodels.mlp(num_classes=2, hidden=(16,)), 5,
                              data=(32, 8))
    stats = []
    for pkg, net, ctx in (
            (mx, jmlp(num_classes=2, hidden=(16,)), [mx.cpu(0), mx.cpu(1)]),
            (mt, tmodels.mlp(num_classes=2, hidden=(16,)),
             [mt.cpu(0), mt.cpu(1)])):
        conv = (lambda v: mx.nd.array(v)) if pkg is mx else torch.from_numpy
        m = pkg.FeedForward(net, ctx=ctx, num_epoch=2, learning_rate=0.1,
                            arg_params={k: conv(v) for k, v in args.items()})
        scope = (jres.chaos_scope if pkg is mx else chaos_scope)(
            seed=0, rules={"step.nan": {1}})
        with scope:
            m.fit(pkg.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
                  guards=True, compression="int8")
        stats.append(dict(m.guard_stats))
        if pkg is mt:
            rows = m._train_state.grad_sync.comm_state()[0]["__fused__"]
            assert torch.isnan(rows).any()
            for v in m.arg_params.values():
                assert torch.isfinite(v).all()
    assert stats[1] == stats[0]
    assert stats[1]["skipped_steps"] == 7  # steps 1-7 of 8


def test_scaled_guard_refuses_the_overlapped_exchange():
    """The overlapped exchange starts a bucket before backward ends, before
    its gradients could be unscaled: a loss scale other than a pinned 1.0
    is refused there, and a pinned one trains."""
    X, y = _blobs(64)
    m = mt.FeedForward(tmodels.mlp(num_classes=2, hidden=(16,)),
                       ctx=[mt.cpu(0), mt.cpu(1)], num_epoch=1,
                       learning_rate=0.1)
    with pytest.raises(MXNetError, match="overlap"):
        m.fit(X, y, batch_size=32, compression="int8", overlap=True,
              guards=GuardConfig(dynamic_loss_scale=True))
    m.fit(X, y, batch_size=32, compression="int8", overlap=True, guards=True)
    assert m.guard_stats["skipped_steps"] == 0


@pytest.mark.parametrize("compression", [None, "bf16"])
def test_guarded_ranks_skip_together(tmp_path, compression):
    """Two gloo ranks, one batch poisoned on rank 0 only: the ranks' summed
    loss flags the step on both (the reference's psum), both skip it and
    end with equal, finite parameters."""
    from torch_ranks import fit_guarded, run_ranks, small_net

    args, aux = random_params(small_net(mt), 0, data=(8, 16))
    rng = np.random.RandomState(0)
    X = rng.randn(96, 16).astype(np.float32)  # 3 steps of 32 rows
    Y = rng.randint(0, 10, 96).astype(np.float32)
    fit_kw = {} if compression is None else {"compression": compression}
    out = run_ranks(fit_guarded, 2, tmp_path, args, aux, X, Y, 32, 0, fit_kw)
    assert [r["fired"] for r in out] == [{"step.nan": 1}, {}]
    for r in out:
        assert r["guard_stats"] == {"skipped_steps": 1, "step_retries": 0,
                                    "loss_scale": 1.0}
        for v in r["params"].values():
            assert np.isfinite(v).all()
    for k, v in out[0]["params"].items():
        np.testing.assert_array_equal(out[1]["params"][k], v, err_msg=k)


def test_precompile_guards_then_fit():
    """``precompile(guards=)`` warms the guarded programs (on the CPU it
    records them) and a guarded fit after it trains."""
    X, y = _blobs(64)
    m = _model(num_epoch=1)
    out = m.precompile({"data": (32, 8)}, {"softmax_label": (32,)},
                       guards=True)
    assert out["programs"] == 1
    m.fit(X, y, batch_size=32, guards=True)
    assert m.guard_stats["skipped_steps"] == 0


# -- the acceptance scenario --------------------------------------------------------

def test_chaos_scenario_end_to_end(tmp_path):
    """Under seeded chaos (pushes dropped through the retrying dist_async
    transport, one corrupted checkpoint shard, an injected NaN step,
    SIGTERM mid-epoch) a fit completes, resumes from the last valid
    checkpoint and lands where the no-fault run lands."""
    from mxnet_tpu_torch.kvstore_async import AsyncKVStore

    X, y = _blobs()
    d = str(tmp_path / "ckpt")
    base = _model().fit(X, y, batch_size=32)
    acc_base = base.score(X, y=y)

    def sigterm_at(param):
        if param.epoch == 2 and param.nbatch == 4:
            signal.raise_signal(signal.SIGTERM)

    m = _model()
    with chaos_scope(seed=13, rules={"kvstore.push": 0.15,
                                     "step.nan": {9},
                                     "ckpt.corrupt": {2}}) as cz:
        kv = RetryingKVStore(AsyncKVStore(),
                             policy=RetryPolicy(base_delay=0.001, seed=0))
        try:
            with pytest.raises(TrainingPreempted):
                m.fit(X, y, batch_size=32, kvstore=kv,
                      sharded_checkpoint_dir=d, guards=True,
                      batch_end_callback=sigterm_at)
        finally:
            kv.close()
        assert cz.fired.get("kvstore.push", 0) > 0
        assert kv.stats["retries"] > 0
        assert m.guard_stats["skipped_steps"] == 1
    # the corrupted flush is skipped: the resume target is epoch 1's step
    assert tck.latest_step(d) == 1

    m2 = _model()
    with chaos_scope(seed=14, rules={"kvstore.push": 0.15}):
        kv2 = RetryingKVStore(AsyncKVStore(),
                              policy=RetryPolicy(base_delay=0.001, seed=0))
        try:
            m2.fit(X, y, batch_size=32, kvstore=kv2,
                   sharded_checkpoint_dir=d, guards=True)
        finally:
            kv2.close()
    assert m2.begin_epoch == 1
    assert tck.latest_step(d) == 4
    acc = m2.score(X, y=y)
    assert abs(acc - acc_base) <= 0.05, (acc, acc_base)
