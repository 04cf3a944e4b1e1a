"""The port's runtime lock-order watchdog against the JAX package's: the
same acquisition scripts give the same acquisition-order graph, cycles and
report; incidents land in the hub and in a flight dump the JAX package
validates; the port's locks carry the JAX package's names; and the port's
shared structures (hub reset racing emit, the live-array ledger's GC
callbacks, a kvstore group round) run under the watchdog with zero
cycles. Hold times are wall-clock readings and are left out of the
comparisons."""

import gc
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.analysis import lockwatch as jlw
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.analysis import lockwatch as tlw


@pytest.fixture
def watchdogs():
    """Both packages' watchers, fresh and enabled; disabled after."""
    was = (jlw.enabled(), tlw.enabled())
    for lw in (jlw, tlw):
        lw.enable()
        lw.reset(stall_ms=1e9)
    yield
    for lw, on in zip((jlw, tlw), was):
        if not on:
            lw.disable()


def _run_script(lw, script):
    """Run ``script``: a list of ``(thread name, [lock names])`` holds,
    each nesting its locks in order, one thread after the other (so the
    graph, not the interleaving, is what differs)."""
    locks = {}

    def lock(name):
        if name not in locks:
            locks[name] = lw.named_rlock(name) if name.startswith("r.") \
                else lw.named_lock(name)
        return locks[name]

    for thread_name, names in script:
        def body(names=names):
            held = []
            for n in names:
                lk = lock(n)
                lk.acquire()
                held.append(lk)
            for lk in reversed(held):
                lk.release()

        t = threading.Thread(target=body, name=thread_name)
        t.start()
        t.join()


def _comparable(report):
    return {k: v for k, v in report.items()
            if k not in ("max_hold_ms", "holds", "stalls")}


SCRIPTS = {
    "inversion": [("w0", ["t.A", "t.B"]), ("w1", ["t.B", "t.A"])],
    "three_cycle": [("w0", ["t.A", "t.B"]), ("w1", ["t.B", "t.C"]),
                    ("w2", ["t.C", "t.A"])],
    "tree_no_cycle": [("w0", ["t.A", "t.B"]), ("w1", ["t.A", "t.C"]),
                      ("w2", ["t.B", "t.C"])],
    "reentrant": [("w0", ["r.R", "r.R", "t.A"]), ("w1", ["t.A"])],
    "two_cycles": [("w0", ["t.A", "t.B"]), ("w1", ["t.B", "t.A"]),
                   ("w2", ["t.C", "t.D"]), ("w3", ["t.D", "t.C"])],
    "repeat_edges": [("w0", ["t.A", "t.B"])] * 3 + [("w1", ["t.B"])],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_scripts_same_graph_and_cycles(watchdogs, name):
    for lw in (jlw, tlw):
        _run_script(lw, SCRIPTS[name])
    jr, tr = jlw.report(), tlw.report()
    assert _comparable(tr) == _comparable(jr)
    assert [c["cycle"] for c in tlw.watcher().cycles()] == \
        [c["cycle"] for c in jlw.watcher().cycles()]
    if name == "reentrant":
        assert all(e["from"] != e["to"] for e in tr["edges"])


def test_disabled_watchdog_is_passthrough():
    was = tlw.enabled()
    tlw.disable()
    try:
        lk = tlw.named_lock("t.passthrough")
        with lk:
            pass
        assert lk.acquire(blocking=False)
        lk.release()
        assert tlw.report() == {"enabled": False}
    finally:
        if was:
            tlw.enable()


def test_named_condition_rejects_reentrant_lock():
    with pytest.raises(TypeError):
        tlw.named_condition("t.cv", tlw.named_rlock("t.r"))


def test_condition_over_watched_lock(watchdogs):
    lock = tlw.named_lock("t.cvlock")
    cv = tlw.named_condition("t.cv", lock)
    box = []

    def waiter():
        with cv:
            cv.wait_for(lambda: box, timeout=10)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        box.append(1)
        cv.notify_all()
    t.join(timeout=10)
    assert not t.is_alive()
    assert tlw.report()["cycles"] == []


def test_stall_is_an_incident(watchdogs):
    tlw.reset(stall_ms=5.0)
    jlw.reset(stall_ms=5.0)
    for lw in (jlw, tlw):
        lk = lw.named_lock("t.slow")
        with lk:
            time.sleep(0.02)
    assert [s["lock"] for s in tlw.report()["stalls"]] == \
        [s["lock"] for s in jlw.report()["stalls"]] == ["t.slow"]


def test_inversion_incident_lands_in_a_flight_dump_jax_validates(
        watchdogs, tmp_path):
    from mxnet_tpu import telemetry as jt

    tt.reset()
    tt.flight.reset()
    _run_script(tlw, SCRIPTS["inversion"])
    incidents = tt.hub().events("lockwatch")
    assert incidents and incidents[-1]["what"] == "cycle"
    tlw.publish()
    assert "mxtpu_lockwatch_cycles_total" in tt.prom_dump()
    path = str(tmp_path / "flight.json")
    tt.flight.dump(path, reason="lockwatch")
    ok, payload = jt.validate_flight(path)
    assert ok, payload
    kinds = [e["kind"] for e in payload["incidents"]]
    assert "lockwatch" in kinds


@pytest.mark.parametrize("pair", [
    ("engine", "_engine_lock"), ("native", "_lock"),
    ("ops.pallas.registry", "_LOCK")])
def test_module_locks_carry_the_jax_names(pair):
    import importlib

    module, attr = pair
    jmod = importlib.import_module(f"mxnet_tpu.{module}")
    tmod = importlib.import_module(
        "mxnet_tpu_torch.kernels.registry" if module.startswith("ops.pallas")
        else f"mxnet_tpu_torch.{module}")
    assert getattr(tmod, attr).name == getattr(jmod, attr).name


def test_object_locks_carry_the_jax_names(tmp_path):
    from mxnet_tpu.resilience import ckpt_async as jca
    from mxnet_tpu_torch.resilience import ckpt_async as tca
    from mxnet_tpu_torch.comm import stats as tstats
    from mxnet_tpu.comm import stats as jstats
    from mxnet_tpu_torch.utils import compile as tcompile
    from mxnet_tpu.utils import compile as jcompile

    jw = jca.AsyncCheckpointWriter(str(tmp_path / "j"))
    tw = tca.AsyncCheckpointWriter(str(tmp_path / "t"))
    try:
        assert tw.lock.name == jw.lock.name
        assert tw.cv._lock.name == jw.cv._lock.name
    finally:
        jw.close()
        tw.close()
    assert tca.ReplicaStore(2).lock.name == jca.ReplicaStore(2).lock.name
    assert tstats.registry()._lock.name == jstats.registry()._lock.name
    assert tcompile.registry()._lock.name == jcompile.registry()._lock.name
    js = mx.kvstore.create_group(2)
    ts = mt.kvstore.create_group(2)
    assert ts[0]._server.lock.name == js[0]._server.lock.name


def test_hub_reset_racing_emit_zero_cycles(watchdogs):
    tt.reset()
    stop = threading.Event()
    errors = []

    def writer(tid):
        try:
            i = 0
            while not stop.is_set():
                tt.emit("hammer", tid=tid, i=i)
                tt.counter("hammer_total")
                tt.observe("hammer_ms", 0.1, tid=tid)
                i += 1
        except Exception as e:  # noqa: BLE001 - the assertion surface
            errors.append(e)

    writers = [threading.Thread(target=writer, args=(t,), daemon=True)
               for t in range(4)]
    for t in writers:
        t.start()
    try:
        for _ in range(30):
            tt.reset()
            tt.hub().snapshot()
            time.sleep(0.002)
    finally:
        stop.set()
        for t in writers:
            t.join(timeout=30)
    assert not errors
    assert tlw.report()["cycles"] == []


def test_ledger_gc_callbacks_racing_adds_zero_cycles(watchdogs):
    from mxnet_tpu_torch.telemetry import memory as memory_mod

    prev = memory_mod.track_arrays(True)
    memory_mod.ledger().clear()
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            arrs = [mt.nd.array(np.zeros(64, np.float32), ctx=mt.cpu())
                    for _ in range(8)]
            del arrs
            gc.collect(0)

    threads = [threading.Thread(target=churn, daemon=True) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        memory_mod.track_arrays(prev)
    gc.collect()
    assert tlw.report()["cycles"] == []
    assert memory_mod.ledger().stats()["live_count"] == 0


def test_group_round_under_the_watchdog_zero_cycles(watchdogs):
    import torch

    stores = mt.kvstore.create_group(3, op_timeout=30)

    def worker(s, r):
        s.init(0, torch.zeros(4))
        s.push(0, [torch.full((4,), r + 1.0)])
        out = torch.empty(4)
        s.pull(0, out=out)

    threads = [threading.Thread(target=worker, args=(s, r))
               for r, s in enumerate(stores)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    rep = tlw.report()
    assert rep["cycles"] == []
    assert "kvstore.GroupServer" in rep["locks"]
