"""The fleet controller through the port (``resilience/controller.py``,
``fit(controller=)``) against the JAX package's, case for case with
``tests/test_controller.py``.

The pure policy functions are compared on a grid. Each safety rail's
scenario (hysteresis, dry run, cooldown and rate limit, quarantine,
backfill, the breaker's freeze, a regression after an actuation) feeds
both packages' controllers the same scripted span stream and coordinator
calls under a fake clock (``tick(now=...)``), and the two decision lists
must be equal: the same ``lever``, ``action``, ``outcome`` and ``rank``
in the same order, with the same coordinator state after. The fits run
through the port only (their timing is the host's): an armed controller
over ``[cpu(i) for i in range(8)]`` evicts a straggler stalled by a real
sleep, backfills a rank whose heartbeats stopped and resumed, and
re-tiers the exchange; a tier it cannot apply freezes it, not the fit;
and no ``mx-fleet-ctl`` or ``mx-heartbeat`` thread outlives ``fit``. The
chaos soak stays ``slow``.
"""

import os
import threading
import time
import types

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import resilience as jres
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.resilience import controller as jctl
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import (CircuitBreaker, ElasticCoordinator,
                                        FleetController)
from mxnet_tpu_torch.resilience import controller as tctl

torch.set_num_threads(1)

PORT = types.SimpleNamespace(tel=ttel, R=tres, ctl=tctl)
JAX = types.SimpleNamespace(tel=jtel, R=jres, ctl=jctl)


@pytest.fixture(autouse=True)
def _fresh_hub():
    """Decisions count events and gauges: isolate both packages' hubs and
    keep ``commit``'s world relabeling out of later tests."""
    prev = (ttel.current_rank(), ttel.world_size(), jtel.current_rank(),
            jtel.world_size())
    ttel.reset()
    jtel.reset()
    yield
    ttel.set_world(*prev[:2])
    jtel.set_world(*prev[2:])
    ttel.reset()
    jtel.reset()


def _ctx(n):
    return [mt.cpu(i) for i in range(n)]


def _mlp(hidden=16, classes=2):
    s = mt.sym
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=hidden)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=classes)
    return s.SoftmaxOutput(data=net, name="softmax")


def _blobs(n=840, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1,
                        rng.randn(n - n // 2, dim) - 1]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(
        np.float32)
    order = rng.permutation(n)
    return X[order], y[order]


def _emit_fleet_step(P, step, world=8, slow_rank=None, slow_ms=30.0,
                     base_ms=2.0, alive=None):
    for r in (alive if alive is not None else range(world)):
        d = slow_ms if r == slow_rank else base_ms
        P.tel.emit("span", rank=r, name="step", epoch=0, step=step,
                   dur_ms=d, phases=[{"name": "device", "dur_ms": d}])


def _controller(P, co=None, **kw):
    defaults = dict(interval=0.0, window=8, min_report_steps=8,
                    evict_k=2, evict_n=3, rejoin_after=1000.0,
                    evaluate_after=1000.0,
                    cooldowns={"evict": 0.0, "backfill": 0.0,
                               "retier": 0.0, "world": 0.0})
    defaults.update(kw)
    ctl = P.R.FleetController(**defaults)
    if co is not None:
        ctl.bind(coordinator=co, model_key="m", world_size=co.world_size,
                 can_retier=True, fp32_wire_bytes=1e6)
    return ctl


def _decisions(ctl):
    return [(d["lever"], d["action"], d["outcome"], d.get("rank"))
            for d in ctl.decisions]


def _ev(co):
    ev = co.poll()
    return None if ev is None else (ev.kind, ev.ranks, ev.reason)


# -- pure policy: the same answers on a grid -----------------------------------

RATIOS = [None, 0.0, 0.01, 0.05, 0.050001, 0.1, 0.2, 0.25, 0.3, 0.5, 0.8,
          1.0, 1.5, 3.0, 100.0]


def test_select_tier_grid():
    got = [tctl.select_tier(r) for r in RATIOS]
    assert got == [jctl.select_tier(r) for r in RATIOS]
    assert got[:3] == [None, "none", "none"] and got[-1] == "twobit"


@pytest.mark.parametrize("base", [None, 1 << 20, 8 << 20, 64 << 20])
def test_select_overlap_bytes_grid(base):
    got = [tctl.select_overlap_bytes(r, base=base) for r in RATIOS]
    assert got == [jctl.select_overlap_bytes(r, base=base) for r in RATIOS]
    caps = [c for c in got if c is not None]
    assert all(c >= (1 << 20) for c in caps)
    assert all(a >= b for a, b in zip(caps, caps[1:]))


def test_choose_world_grid():
    perfs = [{6: 2.0}, {8: 1.0, 6: 1.5}, {8: 1.0, 6: 1.05}, {8: 1.0, 2: 9.0},
             {8: 0.0, 4: 1.0}, {8: 1.0, 7: None, 5: 1.3}, {4: 2.0, 6: 3.0,
                                                            8: 1.0}]
    cases = [(p, cur, lo, hi, m) for p in perfs for cur in (4, 6, 8)
             for lo, hi in ((2, 8), (4, 8), (2, 6)) for m in (0.0, 0.1, 0.5)]
    got = [tctl.choose_world(*c[:4], margin=c[4]) for c in cases]
    assert got == [jctl.choose_world(*c[:4], margin=c[4]) for c in cases]
    assert tctl.choose_world({8: 1.0, 6: 1.5}, 8, 2, 8) == 6


def test_select_ckpt_cadence_grid():
    cases = [(s, st, cur, tgt) for s in (None, 0.0, 0.01, 0.5, 3.0, 100.0)
             for st in (None, 0.0, 0.01, 0.2, 1.0) for cur in (1, 7, 50, 2000)
             for tgt in (0.01, 0.05, 0.5)]
    got = [tctl.select_ckpt_cadence(s, st, c, target_overhead=t)
           for s, st, c, t in cases]
    assert got == [jctl.select_ckpt_cadence(s, st, c, target_overhead=t)
                   for s, st, c, t in cases]
    assert 1024 in got and 1 in got


def test_config_defaults_match_jax(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_WIRE_GBPS", raising=False)
    assert vars(tctl.FleetControllerConfig()) == \
        vars(jctl.FleetControllerConfig())
    monkeypatch.setenv("MXNET_TPU_WIRE_GBPS", "2.5")
    cfg = tctl.FleetControllerConfig(cooldowns={"evict": 1.0})
    assert vars(cfg) == vars(jctl.FleetControllerConfig(
        cooldowns={"evict": 1.0}))
    assert cfg.wire_gbps == 2.5 and repr(cfg) == repr(
        jctl.FleetControllerConfig(cooldowns={"evict": 1.0}))
    with pytest.raises(MXNetError):
        tctl.FleetControllerConfig(evict_k=4, evict_n=3)
    assert tctl.__all__ == jctl.__all__


# -- the sensors the controller reads ------------------------------------------

def _span(rank, step, device_ms):
    return {"kind": "span", "name": "step", "epoch": 0, "step": step,
            "rank": rank, "dur_ms": device_ms,
            "phases": [{"name": "device", "dur_ms": device_ms}]}


def test_streaming_detector_matches_jax():
    def run(P):
        det = P.tel.StreamingStragglerDetector(window=8)
        for step in range(30):
            for r in range(3):
                det.write_event(_span(r, step, 25.0 if r == 0 else 5.0))
        first = det.report(publish=False)
        for step in range(30, 38):
            for r in range(3):
                det.write_event(_span(r, step, 5.0))
        return first, det.report(publish=False), det.steps_seen

    got = run(PORT)
    assert got == run(JAX)
    assert [s["rank"] for s in got[0]["stragglers"]] == [0]
    assert got[1]["stragglers"] == []


def test_breaker_transitions_match_jax():
    def run(P):
        clock = [0.0]
        br = P.R.CircuitBreaker(failure_threshold=2, reset_after=5.0,
                                clock=lambda: clock[0], name="testbrk")
        br.record_failure()
        out = [br.state, br.failures]
        br.record_failure()
        out.append(br.state)
        clock[0] = 6.0
        out += [br.allow(), br.state]
        br.record_success()
        out += [br.state, br.failures]
        out.append([(e["from_state"], e["state"])
                    for e in P.tel.hub().events(kind="breaker")])
        g = P.tel.hub().snapshot()["gauges"]
        return out + [g["circuit_breaker_state{breaker=testbrk}"]]

    got = run(PORT)
    assert got == run(JAX)
    assert got[-2] == [("closed", "open"), ("open", "half_open"),
                       ("half_open", "closed")]


# -- safety rails: the same decisions on both packages -------------------------

def _hysteresis(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, evict_k=3, evict_n=5)
    for s in range(8):
        _emit_fleet_step(P, s, slow_rank=7)
    ctl.tick(now=1.0)
    for s in range(8, 24):
        _emit_fleet_step(P, s)
    for i in range(4):
        ctl.tick(now=2.0 + i)
    mid = _ev(co)
    for s in range(24, 48):
        _emit_fleet_step(P, s, slow_rank=7)
        ctl.tick(now=10.0 + s)
    return _decisions(ctl), mid, _ev(co), ctl.decisions[-1].get("blame")


def _dry_run(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, dry_run=True, wire_gbps=1e-6)
    state = ctl.state
    for s in range(32):
        _emit_fleet_step(P, s, slow_rank=5)
        ctl.tick(now=float(s))
    return _decisions(ctl), state, _ev(co), ctl.take_retier()


def _cooldown_rate_limit(P):
    co = P.R.ElasticCoordinator(8, min_world=2)
    ctl = _controller(P, co, cooldowns={"evict": 1000.0}, evict_k=1,
                      evict_n=1)
    for s in range(8):
        _emit_fleet_step(P, s, slow_rank=7)
    ctl.tick(now=100.0)
    co.commit(co.poll())
    for s in range(8, 24):
        _emit_fleet_step(P, s, slow_rank=6, alive=range(7))
        ctl.tick(now=101.0 + s)
    first = (_decisions(ctl), _ev(co))
    P.tel.reset()
    ctl2 = _controller(P, P.R.ElasticCoordinator(8), evict_k=1, evict_n=1,
                       max_actions_per_hour=0)
    for s in range(8):
        _emit_fleet_step(P, s, slow_rank=7)
    ctl2.tick(now=1.0)
    return first, _decisions(ctl2), _ev(ctl2._co)


def _quarantine(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, evict_k=1, evict_n=1, max_evictions=1,
                      rejoin_after=0.0)
    for s in range(8):
        _emit_fleet_step(P, s, slow_rank=7)
    ctl.tick(now=1.0)
    co.commit(co.poll())
    for s in range(8, 16):
        _emit_fleet_step(P, s, alive=range(7))
        ctl.tick(now=10.0 + s)
    return _decisions(ctl), _ev(co), co.alive


def _backfill(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, max_evictions=5, rejoin_after=0.0, evict_k=1,
                      evict_n=1)
    co.kill(4, reason="failure")
    co.commit(co.poll())
    for s in range(8):
        _emit_fleet_step(P, s, alive=[r for r in range(8) if r != 4])
    ctl.tick(now=50.0)
    return _decisions(ctl), _ev(co)


def _backfill_gate(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, auto_backfill=False, rejoin_after=0.0)
    co.leave(4, reason="maintenance")
    co.commit(co.poll())
    for s in range(8):
        _emit_fleet_step(P, s, alive=[r for r in range(8) if r != 4])
    ctl.tick(now=50.0)
    return _decisions(ctl), _ev(co)


def _backfill_heartbeat(P):
    co = P.R.ElasticCoordinator(8, heartbeat_timeout=5.0)
    ctl = _controller(P, co, rejoin_after=0.0)
    for r in range(8):
        co.heartbeat(r)
    co.kill(4, reason="failure")
    co.commit(co.poll())
    for s in range(8):
        _emit_fleet_step(P, s, alive=[r for r in range(8) if r != 4])
    ctl.tick(now=50.0)
    silent = _ev(co)
    co.heartbeat(4)
    ctl.tick(now=51.0)
    return _decisions(ctl), silent, _ev(co)


def _breaker_freeze(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, evict_k=1, evict_n=1)
    fails = {"n": 0}

    def broken_kill(rank=None, reason="failure"):
        fails["n"] += 1
        raise RuntimeError("kvstore wedged")

    co.kill = broken_kill
    for s in range(40):
        _emit_fleet_step(P, s, slow_rank=7)
        ctl.tick(now=float(s))
    g = P.tel.hub().snapshot()["gauges"]
    return (_decisions(ctl), fails["n"], ctl.breaker.state, ctl.state,
            _ev(co), g["controller_state"],
            g["circuit_breaker_state{breaker=controller}"])


def _regression(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, evict_k=1, evict_n=1, evaluate_after=5.0,
                      regress_tolerance=0.1)
    for s in range(8):
        _emit_fleet_step(P, s, slow_rank=7)
    ctl.tick(now=1.0)
    co.commit(co.poll())
    for s in range(8, 24):
        _emit_fleet_step(P, s, base_ms=50.0, alive=range(7))
    ctl.tick(now=10.0)
    return _decisions(ctl), ctl.breaker.failures


def _retier_staged(P):
    """The tier lever stages a tier from the closed-form wire estimate,
    the fit applies it, and the next tick holds (same world, same tier)."""
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, auto_evict=False, wire_gbps=0.02)
    for s in range(8):
        _emit_fleet_step(P, s)
    ctl.tick(now=1.0)
    act = ctl.take_retier()
    ctl.retier_applied(act, 0.5)
    for s in range(8, 16):
        _emit_fleet_step(P, s)
    ctl.tick(now=2.0)
    g = P.tel.hub().snapshot()["gauges"]
    return _decisions(ctl), act, ctl._comm_mode, g["controller_comm_tier"]


def _world_lever(P):
    co = P.R.ElasticCoordinator(8)
    ctl = _controller(P, co, auto_world=True, auto_tier=False,
                      auto_evict=False)
    ctl._world_perf = {8: 1.0, 6: 2.0}
    for s in range(8):
        _emit_fleet_step(P, s, base_ms=1000.0)
    ctl.tick(now=1.0)
    return _decisions(ctl), _ev(co)


SCENARIOS = {"hysteresis": _hysteresis, "dry_run": _dry_run,
             "cooldown_rate_limit": _cooldown_rate_limit,
             "quarantine": _quarantine, "backfill": _backfill,
             "backfill_gate": _backfill_gate,
             "backfill_heartbeat": _backfill_heartbeat,
             "breaker_freeze": _breaker_freeze, "regression": _regression,
             "retier_staged": _retier_staged, "world_lever": _world_lever}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decisions_match_jax(name):
    got = SCENARIOS[name](PORT)
    assert got == SCENARIOS[name](JAX)
    decisions = got[0] if name != "cooldown_rate_limit" else got[0][0]
    assert decisions or name == "backfill_gate"
    if name == "hysteresis":
        assert got[1] is None and 7 not in got[2][1]
        assert [d[0] for d in decisions if d[2] == "actuated"] == ["evict"]
        assert got[3] == "device"
    if name == "dry_run":
        assert {d[2] for d in decisions} == {"recommended"}
        assert {"evict", "retier"} <= {d[0] for d in decisions}
    if name == "breaker_freeze":
        assert got[1] == 2 and got[3] == "frozen" and got[-2:] == (2.0, 2.0)
    if name == "backfill_heartbeat":
        assert got[1] is None and 4 in got[2][1]
    if name == "retier_staged":
        assert got[1]["mode"] == got[2] == "twobit"


def test_decision_events_reach_flight_recorder():
    ttel.flight.reset()
    co = ElasticCoordinator(8)
    ctl = _controller(PORT, co, evict_k=1, evict_n=1)
    for s in range(8):
        _emit_fleet_step(PORT, s, slow_rank=7)
    ctl.tick(now=1.0)
    _, _, incidents = ttel.flight.recorder().snapshot()
    assert "controller" in {e["kind"] for e in incidents}
    counters = ttel.hub().snapshot()["counters"]
    assert counters[
        "controller_decisions_total{lever=evict,outcome=actuated}"] == 1.0


def test_tick_thread_mode_runs_and_stops():
    co = ElasticCoordinator(8)
    ctl = _controller(PORT, co, interval=0.01)
    t = ctl.start()
    assert t.name == "mx-fleet-ctl" and t.daemon and ctl.threaded
    assert ctl.start() is t
    for s in range(8):
        _emit_fleet_step(PORT, s)
    time.sleep(0.1)
    ctl.stop()
    assert not ctl.threaded and not t.is_alive()
    assert ttel.hub().snapshot()["gauges"]["controller_state"] == 0.0


def test_controller_resolve(monkeypatch):
    for P in (PORT, JAX):
        ctl = P.R.FleetController()
        assert P.R.FleetController.resolve(ctl) is ctl
        monkeypatch.delenv("MXNET_TPU_CONTROLLER", raising=False)
        assert P.R.FleetController.resolve(None) is None
        assert P.R.FleetController.resolve(False) is None
        assert P.R.FleetController.resolve(True).cfg.dry_run is False
        cfg = P.ctl.FleetControllerConfig(dry_run=True)
        assert P.R.FleetController.resolve(cfg).cfg is cfg
        monkeypatch.setenv("MXNET_TPU_CONTROLLER", "dry")
        assert P.R.FleetController.resolve(None).cfg.dry_run is True
        monkeypatch.setenv("MXNET_TPU_CONTROLLER", "armed")
        assert P.R.FleetController.resolve(None).state == "armed"
        with pytest.raises(Exception, match="controller="):
            P.R.FleetController.resolve("bogus")
        with pytest.raises(Exception, match="OR kwargs"):
            P.R.FleetController(P.ctl.FleetControllerConfig(), window=4)


# -- fits through the port -----------------------------------------------------

class _FleetFaults:
    """Faults for an 8-replica fit: the straggler rank drags every step (a
    real sleep) and emits per-rank spans that blame it; the flaky rank's
    heartbeats stop from ``outage_step`` until the coordinator buries it,
    then resume. A beater thread heartbeats every other rank. Every step
    also lasts ``step_s`` at least, the time a fleet's step takes, so the
    outage and the recovery fall inside the run on a fast host."""

    def __init__(self, co, stall_s=0.015, straggler=7, flaky=6,
                 outage_step=2, step_s=0.02):
        self.co = co
        self.stall_s = stall_s
        self.step_s = step_s
        self.straggler = straggler
        self.flaky = flaky
        self.outage_step = outage_step
        self.step = 0
        self._outage = False
        self._recovered = False
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._beat, daemon=True)
        self.thread.start()

    def _beat(self):
        while not self._stop.wait(0.02):
            if self._outage and not self._recovered and \
                    self.co.last_heartbeat(self.flaky) is None:
                self._recovered = True
            silent = self._outage and not self._recovered
            for r in range(self.co.full_world_size):
                if r == self.flaky and silent:
                    continue
                self.co.heartbeat(r)

    def close(self):
        self._stop.set()
        self.thread.join(timeout=2.0)

    def __call__(self, param):
        del param
        s = self.step
        self.step += 1
        if s >= self.outage_step:
            self._outage = True
        alive = self.co.alive
        time.sleep(self.step_s)
        if self.straggler in alive:
            time.sleep(self.stall_s)
        for r in alive:
            d = (self.stall_s * 1e3 + 2.0) if r == self.straggler else 2.0
            ttel.emit("span", rank=r, name="step", epoch=0, step=s,
                      dur_ms=d, phases=[{"name": "device", "dur_ms": d}])


def _fleet_threads():
    return [t.name for t in threading.enumerate()
            if t.name in ("mx-fleet-ctl", "mx-heartbeat")]


def test_e2e_controller_evicts_backfills_and_retiers(tmp_path):
    """A straggler and a flaky rank in an 8-replica fit: the armed
    controller evicts the blamed rank, backfills the recovered flaky one,
    re-tiers the exchange from the (bandwidth-scaled) comm:compute ratio,
    and the whole story lands in a CRC-valid flight dump."""
    X, y = _blobs(n=840)
    co = ElasticCoordinator(8, heartbeat_timeout=0.3)
    ctl = FleetController(
        interval=0.0, window=16, min_report_steps=16, evict_k=2,
        evict_n=4, max_evictions=1, rejoin_after=0.05,
        evaluate_after=0.5,
        cooldowns={"evict": 0.0, "backfill": 0.0, "retier": 0.0},
        wire_gbps=1e-5)
    faults = _FleetFaults(co, outage_step=2)
    m = mt.FeedForward(_mlp(), ctx=_ctx(8), num_epoch=6, optimizer="sgd",
                       learning_rate=0.1)
    try:
        m.fit(X, y, batch_size=168, elastic=co, controller=ctl,
              sharded_checkpoint_dir=str(tmp_path / "ckpt"),
              batch_end_callback=faults,
              telemetry=ttel.TelemetryConfig(timeline=False, memory=False))
    finally:
        faults.close()
    evicts = [d for d in ctl.decisions
              if d["lever"] == "evict" and d["outcome"] == "actuated"]
    assert [d["rank"] for d in evicts] == [7]
    assert 7 not in co.alive
    assert any("evicted" in e.get("reason_kinds", "")
               for e in ttel.hub().events(kind="resize"))
    backfills = [d["rank"] for d in ctl.decisions
                 if d["lever"] == "backfill" and d["outcome"] == "actuated"]
    assert 6 in backfills and 6 in co.alive
    assert ctl._comm_mode in ("bf16", "int8", "twobit")
    assert m._train_state.grad_sync.spec.mode == ctl._comm_mode
    assert any(d["lever"] == "retier" and d["outcome"] == "actuated"
               for d in ctl.decisions)
    assert ctl.breaker.state == CircuitBreaker.CLOSED
    assert m.score(X, y=y) > 0.9
    assert _fleet_threads() == []
    dump = str(tmp_path / "flight.json")
    ttel.flight.dump(dump, reason="test")
    ok, payload = ttel.validate_flight(dump)
    assert ok, payload
    assert "controller" in {e["kind"] for e in payload["incidents"]}


def test_e2e_controller_failure_freezes_not_kills(tmp_path):
    """A tier the fit cannot apply trips the controller's breaker and
    freezes it; the fit finishes on its old exchange."""
    X, y = _blobs(n=480)
    co = ElasticCoordinator(8)
    ctl = FleetController(interval=0.0, window=8, min_report_steps=8,
                          auto_tier=False, auto_evict=False)
    staged = {"n": 0, "s": 0}

    def drive(param):
        ttel.emit("span", rank=0, name="step", epoch=0, step=staged["s"],
                  dur_ms=2.0, phases=[{"name": "device", "dur_ms": 2.0}])
        staged["s"] += 1
        if staged["n"] < 2:
            staged["n"] += 1
            ctl._pending_retier = {"mode": "bogus-tier"}

    m = mt.FeedForward(_mlp(), ctx=_ctx(8), num_epoch=2, optimizer="sgd",
                       learning_rate=0.1)
    m.fit(X, y, batch_size=48, elastic=co, controller=ctl,
          sharded_checkpoint_dir=str(tmp_path / "ckpt"),
          batch_end_callback=drive)
    assert staged["n"] == 2
    assert ctl.breaker.state == CircuitBreaker.OPEN
    assert ctl.state == "frozen"
    fails = [d for d in ctl.decisions if d["outcome"] == "failed"]
    assert len(fails) == 2 and all(d["lever"] == "retier" for d in fails)
    assert m._train_state.grad_sync.spec is None  # the old exchange
    assert m.score(X, y=y) > 0.9


def test_retier_rebuilds_the_exchange(tmp_path):
    """A staged tier is applied between two steps: the exchange is
    rebuilt on the new compression (and bucket plan) with zero residuals,
    BatchNorm's joined statistics go with the uncompressed exchange, and
    the fit goes on (no elastic coordinator needed)."""
    X, y = _blobs(n=480)
    ctl = FleetController(interval=0.0, window=8, min_report_steps=8,
                          auto_tier=False, auto_evict=False)
    seen = []

    def drive(param):
        state = m._train_state
        seen.append((state.grad_sync.spec and state.grad_sync.spec.mode,
                     state.grad_sync.plan is not None, state.global_stats))
        if param.nbatch == 2 and param.epoch == 0:
            ctl._pending_retier = {"mode": "int8", "bucket_bytes": 1 << 20,
                                   "ratio": 2.0}

    m = mt.FeedForward(_mlp(), ctx=_ctx(4), num_epoch=3, optimizer="sgd",
                       learning_rate=0.1, initializer=mt.init.Xavier())
    m.fit(X, y, batch_size=48, controller=ctl, batch_end_callback=drive)
    assert seen[0] == (None, False, True)
    assert seen[-1] == ("int8", True, False)
    applied = [e for e in ttel.hub().events(kind="controller")
               if e.get("outcome") == "applied"]
    assert [e["action"] for e in applied] == ["applied int8"]
    assert ctl._comm_mode == "int8"
    assert m.score(X, y=y) > 0.9


def test_no_fleet_thread_outlives_fit(tmp_path):
    """The controller's thread and the coordinator's heartbeat monitor
    stop when fit returns and when it raises."""
    X, y = _blobs(n=192)
    for fail in (False, True):
        co = ElasticCoordinator(8, heartbeat_timeout=30.0)
        co.start_heartbeat_monitor(interval=0.01)
        ctl = FleetController(interval=0.01, window=8, min_report_steps=8)
        ctl.start()
        assert sorted(_fleet_threads()) == ["mx-fleet-ctl", "mx-heartbeat"]

        def cb(param, fail=fail):
            if fail and param.nbatch == 2:
                raise RuntimeError("boom")

        m = mt.FeedForward(_mlp(), ctx=_ctx(8), num_epoch=1,
                           optimizer="sgd", learning_rate=0.1)
        kw = dict(batch_size=48, elastic=co, controller=ctl,
                  batch_end_callback=cb,
                  sharded_checkpoint_dir=str(tmp_path / f"c{fail}"))
        if fail:
            with pytest.raises(RuntimeError, match="boom"):
                m.fit(X, y, **kw)
        else:
            m.fit(X, y, **kw)
        assert _fleet_threads() == []
        assert not m._rank_per_ctx
        assert ctl._co is None  # unbound


@pytest.mark.slow
def test_chaos_soak_controller_keeps_fleet_healthy(tmp_path, monkeypatch):
    """A random rank killed or slowed every few steps through the port
    under the armed controller: the run never hangs, converges, and every
    flight dump validates."""
    flight_dir = str(tmp_path / "flight")
    os.makedirs(flight_dir)
    monkeypatch.setenv("MXNET_TPU_FLIGHT_DIR", flight_dir)
    X, y = _blobs(n=1680)
    co = ElasticCoordinator(8, min_world=6)
    ctl = FleetController(
        interval=0.0, window=16, min_report_steps=16, evict_k=2,
        evict_n=4, max_evictions=3, rejoin_after=0.1, evaluate_after=0.5,
        cooldowns={"evict": 0.2, "backfill": 0.1, "retier": 1.0})
    rng = np.random.RandomState(7)
    state = {"s": 0, "slow": None}

    def drive(param):
        s = state["s"]
        state["s"] += 1
        if s % 5 == 0:
            state["slow"] = int(rng.choice(co.alive)) \
                if rng.rand() < 0.7 else None
        if s and s % 9 == 0:
            ev = co.poll()
            if (ev.world_size if ev is not None
                    else co.world_size) > co.min_world:
                co.kill(reason="failure")
        if s and s % 23 == 0:
            co.join_all(reason="recovered")
        slow = state["slow"]
        alive = co.alive
        if slow in alive:
            time.sleep(0.005)
        for r in alive:
            d = 7.0 if r == slow else 2.0
            ttel.emit("span", rank=r, name="step", epoch=0, step=s,
                      dur_ms=d, phases=[{"name": "device", "dur_ms": d}])

    m = mt.FeedForward(_mlp(), ctx=_ctx(8), num_epoch=8, optimizer="sgd",
                       learning_rate=0.1)
    m.fit(mt.io.NDArrayIter(X, y, batch_size=168, shuffle=False),
          batch_size=168, elastic=co, controller=ctl,
          sharded_checkpoint_dir=str(tmp_path / "ckpt"),
          batch_end_callback=drive)
    assert co.resizes >= 3 and co.world_size >= co.min_world
    assert m.score(X, y=y) > 0.9
    assert ctl.decisions
    final = os.path.join(flight_dir, "final.json")
    ttel.flight.dump(final, reason="soak_end")
    for name in os.listdir(flight_dir):
        ok, payload = ttel.validate_flight(os.path.join(flight_dir, name))
        assert ok, (name, payload)
