"""Elastic training through the port (``resilience/elastic.py``,
``fit(elastic=)``) against the JAX package's, case for case with
``tests/test_elastic.py``.

Where both packages compute, the port is held to the reference: the same
calls on both coordinators give the same resize events, history and
membership epochs; both packages' kvstores raise ``MembershipTimeout``
(carrying the membership epoch) where a round stalls; a checkpoint saved
by the port reshards 8 -> 6 -> 8 as the JAX package's does (optimizer
leaves bitwise, residual ledgers kept only when their layout key
matches); and the elastic fit over ``[cpu(i) for i in range(8)]`` (kill 2
mid-epoch, continue on 6, rejoin to 8, int8 with overlap) ends within
1e-6 absolute of the JAX fit over 8 host devices from the same weights
and rows (6e-8 measured: the two packages' f32 sums round apart in the
last bit). Within the port the
redone epoch is bitwise a fresh fit resumed from the same checkpoint on
the smaller world, from the disk tier and from the peer tier.

A world of replicas runs eager, so a new world has no program to warm:
``test_elastic_regrow_captures_nothing`` is the counterpart of the JAX
package's ``test_elastic_regrow_reuses_warm_programs``. The card's case
(an aliased ``[cuda:0] * 3`` world shrunk to 2 and grown back) is in
tests/test_torch_elastic_card.py.
"""

import os
import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import comm as jcomm
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import kvstore_async as jkva
from mxnet_tpu import resilience as jres
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.utils import checkpoint as jck
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import kvstore_async as tkva
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.resilience import ElasticCoordinator, chaos_scope
from mxnet_tpu_torch.utils import checkpoint as tck
from mxnet_tpu_torch.utils import compile as tcm

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

BATCH = 48  # divisible by 8 and by 6: the global batch survives resizes
# the elastic fit against the JAX package's, 40 steps over three worlds
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _restore_world_identity():
    """``commit`` relabels the process's world in both packages."""
    prev = (ttel.current_rank(), ttel.world_size(), jtel.current_rank(),
            jtel.world_size())
    yield
    ttel.set_world(*prev[:2])
    jtel.set_world(*prev[2:])


def _ctx(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _mlp(pkg, hidden=16, classes=2):
    s = pkg.sym
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=hidden)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=classes)
    return s.SoftmaxOutput(data=net, name="softmax")


def _blobs(n=480, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1,
                        rng.randn(n - n // 2, dim) - 1]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(
        np.float32)
    order = rng.permutation(n)
    return X[order], y[order]


ARGS, AUX = random_params(_mlp(mt), 3, data=(BATCH, 10))


def _model(pkg, n, num_epoch, **kw):
    wrap = mx.nd.array if pkg is mx else torch.from_numpy
    return pkg.FeedForward(
        _mlp(pkg), ctx=_ctx(pkg, n), num_epoch=num_epoch, optimizer="sgd",
        learning_rate=0.1,
        arg_params={k: wrap(v.copy()) for k, v in ARGS.items()}, **kw)


def _numpy(d):
    return {k: (v.asnumpy() if hasattr(v, "asnumpy") else
                v.detach().cpu().numpy()).copy() for k, v in d.items()}


def _history(co):
    return [{k: v for k, v in h.items() if k != "downtime_s"}
            for h in co.history]


def _event(ev):
    return None if ev is None else (ev.kind, ev.ranks, ev.reason,
                                    ev.membership_epoch, ev.world_size)


# -- coordinator control plane: the same calls on both packages ----------------

def _lifecycle(R):
    co = R.ElasticCoordinator(8)
    out = [co.world_size, _event(co.poll()), co.kill(), co.kill(5)]
    ev = co.poll()
    out += [_event(ev), co.world_size, co.commit(ev), co.world_size,
            co.membership_epoch, _event(co.poll()), co.kill(7), co.join(),
            co.join_all()]
    ev = co.poll()
    out += [_event(ev), co.commit(ev), co.world_size, co.resizes,
            co.alive, _history(co)]
    return out


def _min_world(R):
    co = R.ElasticCoordinator(4, min_world=2)
    out = [co.request_world(2), _event(co.poll())]
    for fn in (lambda: co.request_world(1), lambda: co.commit(co.poll()),
               lambda: co.kill(1), lambda: co.request_world(4),
               lambda: R.ElasticCoordinator(0),
               lambda: R.ElasticCoordinator(4, min_world=5)):
        try:
            out.append(("ok", fn()))
        except MXNetError as e:
            out.append(("raised", str(e)))
        except Exception as e:  # the JAX package's own MXNetError
            out.append(("raised", str(e)))
    return out + [_event(co.poll()), _history(co)]


def _chaos_sites(R):
    co = R.ElasticCoordinator(4)
    with R.chaos_scope(seed=0, rules={"elastic.kill": {1, 2},
                                      "elastic.rejoin": {4}}):
        for _ in range(4):
            co.chaos_poll()
        out = [_event(co.poll())]
        co.commit(co.poll())
        co.chaos_poll()
        out.append(_event(co.poll()))
    return out + [_history(co)]


def _blame(R):
    co = R.ElasticCoordinator(8)
    co.record_blame(3)
    co.request_world(7, reason="goodput")
    out = [_event(co.poll())]
    co.commit(co.poll())
    co.record_blame(None)
    co.request_world(6)
    out.append(_event(co.poll()))
    co.commit(co.poll())
    co.kill(5, reason="evicted")
    co.leave(4, reason="maintenance")
    ev = co.poll()
    out += [_event(ev), R.ElasticCoordinator._reason_kinds(ev.reason)]
    co.commit(ev)
    return out + [_history(co), co.membership_epoch]


SCRIPTS = {"lifecycle": _lifecycle, "min_world": _min_world,
           "chaos_sites": _chaos_sites, "blame": _blame}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_coordinator_matches_jax(name):
    got = SCRIPTS[name](tres)
    assert got == SCRIPTS[name](jres)
    if name == "lifecycle":
        assert got[2] == 7 and got[4][1] == (0, 1, 2, 3, 4, 6)
        assert [h["to"] for h in got[-1]] == [6, 8]


def test_coordinator_heartbeat_expiry():
    """Death by silence on both packages: the same ranks killed and held
    (a mass lapse holds the min_world floor)."""
    def run(R):
        co = R.ElasticCoordinator(4, heartbeat_timeout=0.2)
        co.heartbeat(0)
        co.heartbeat(3)
        out = [co.check_heartbeats()]
        time.sleep(0.35)
        co.heartbeat(0)
        out += [co.check_heartbeats(), _event(co.poll()),
                co.last_heartbeat(3), co.last_heartbeat(0) is not None]
        co2 = R.ElasticCoordinator(2, heartbeat_timeout=0.05)
        co2.heartbeat(0)
        co2.heartbeat(1)
        time.sleep(0.15)
        return out + [co2.check_heartbeats(), _event(co2.poll())]

    got = run(tres)
    assert got == run(jres)
    assert got[1] == [3] and got[2][1] == (0, 1, 2)


def test_heartbeat_monitor_thread_stops():
    co = ElasticCoordinator(4, heartbeat_timeout=0.1)
    t = co.start_heartbeat_monitor(interval=0.02)
    assert t.name == "mx-heartbeat" and t.daemon
    assert co.start_heartbeat_monitor() is t  # idempotent
    co.heartbeat(2)
    deadline = time.monotonic() + 5.0
    while co.poll() is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert co.poll().ranks == (0, 1, 3)
    co.stop_heartbeat_monitor()
    assert not t.is_alive()
    co.stop_heartbeat_monitor()
    assert ElasticCoordinator(4).start_heartbeat_monitor() is None


def test_coordinator_resolve(monkeypatch):
    for R in (tres, jres):
        co = R.ElasticCoordinator(4)
        assert R.ElasticCoordinator.resolve(co, 8) is co
        monkeypatch.delenv("MXNET_TPU_ELASTIC", raising=False)
        assert R.ElasticCoordinator.resolve(None, 8) is None
        assert R.ElasticCoordinator.resolve(False, 8) is None
        assert R.ElasticCoordinator.resolve(True, 8).full_world_size == 8
        monkeypatch.setenv("MXNET_TPU_ELASTIC", "on")
        assert R.ElasticCoordinator.resolve(None, 6).full_world_size == 6
        with pytest.raises(Exception, match="elastic="):
            R.ElasticCoordinator.resolve("nope", 8)
    assert issubclass(tres.MembershipTimeout, tres.MembershipChanged)
    assert issubclass(tres.MembershipChanged, MXNetError)
    assert tres.elastic.__all__ == jres.elastic.__all__


def test_resize_events_and_counters_match_jax():
    """``commit`` emits the same ``resize`` events and counters, and
    relabels the world, on both packages."""
    def run(R, tel):
        tel.reset()
        co = R.ElasticCoordinator(4)
        co.kill(3, reason="evicted")
        co.commit(co.poll())
        co.kill(2, reason="failure")
        co.commit(co.poll())
        co.record_downtime(0.25)
        ev = [{k: e[k] for k in ("from_world", "to_world", "reason",
                                 "reason_kinds", "membership_epoch",
                                 "resize_kind", "world_size")}
              for e in tel.hub().events(kind="resize")]
        snap = tel.hub().snapshot()
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith("elastic_")}
        return ev, counters, snap["gauges"]["elastic_world_size"], \
            co.history[-1]["downtime_s"], tel.world_size()

    got = run(tres, ttel)
    assert got == run(jres, jtel)
    assert got[0][0]["reason_kinds"] == "evicted" and got[-1] == 2
    ttel.reset()
    jtel.reset()


# -- kvstore membership: the same stalls on both packages ----------------------

def _outcome(fn):
    try:
        fn()
        return ("ok",)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return (type(e).__name__, "membership epoch 0" in str(e),
                getattr(e, "membership_epoch", None))


def _barrier_release(K):
    workers = K.create_group(2, op_timeout=10.0)
    server = workers[0]._server
    done = []
    t = threading.Thread(target=lambda: (workers[0].barrier(),
                                         done.append(True)))
    t.start()
    time.sleep(0.05)
    before = list(done)
    epoch = server.deregister_worker(1)
    t.join(timeout=5.0)
    return before, done, epoch, server.num_workers


def _barrier_timeout(K):
    workers = K.create_group(2, op_timeout=0.15)
    out = [_outcome(workers[0].barrier)]
    workers[0]._server.deregister_worker(1)
    return out + [_outcome(workers[0].barrier)]


def _push_release(K, nd):
    workers = K.create_group(3, op_timeout=10.0)
    server = workers[0]._server
    server.init("w", np.zeros((4,), np.float32))
    results = []

    def pusher(rank):
        workers[rank].push("w", nd(np.full((4,), rank + 1.0, np.float32)))
        results.append(rank)

    threads = [threading.Thread(target=pusher, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    before = list(results)
    server.deregister_worker(2)
    for t in threads:
        t.join(timeout=5.0)
    return before, sorted(results), np.asarray(server.store["w"]).tolist()


def _push_timeout(K, nd):
    workers = K.create_group(2, op_timeout=0.15)
    workers[0]._server.init("w", np.zeros((2,), np.float32))
    return [_outcome(lambda: workers[0].push(
        "w", nd(np.ones((2,), np.float32))))]


def _rejoin(K, nd):
    workers = K.create_group(2, op_timeout=10.0)
    server = workers[0]._server
    server.init("w", np.zeros((2,), np.float32))
    server.deregister_worker(1)
    workers[0].push("w", nd(np.ones((2,), np.float32)))
    out = [np.asarray(server.store["w"]).tolist(), server.register_worker(1),
           server.num_workers]
    threads = [threading.Thread(target=lambda r=r: workers[r].push(
        "w", nd(np.ones((2,), np.float32)))) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5.0)
    return out + [np.asarray(server.store["w"]).tolist()]


def _tnd(a):
    return torch.from_numpy(a)


GROUP_CASES = {
    "barrier_release": lambda K, nd: _barrier_release(K),
    "barrier_timeout": lambda K, nd: _barrier_timeout(K),
    "push_release": _push_release,
    "push_timeout": _push_timeout,
    "rejoin": _rejoin,
}


@pytest.mark.parametrize("name", list(GROUP_CASES))
def test_group_membership_matches_jax(name):
    got = GROUP_CASES[name](tkv, _tnd)
    assert got == GROUP_CASES[name](jkv, mx.nd.array)
    if name in ("barrier_timeout", "push_timeout"):
        # the stall is a detected membership change, an MXNetError
        assert got[0] == ("MembershipTimeout", True, 0)
    if name == "barrier_timeout":
        assert got[1] == ("ok",)


def test_group_timeout_is_membership_timeout():
    workers = tkv.create_group(2, op_timeout=0.1)
    with pytest.raises(tres.MembershipTimeout) as ei:
        workers[0].barrier()
    assert isinstance(ei.value, MXNetError)
    assert ei.value.membership_epoch == 0


def _async_server_ops(A, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_KV_OP_TIMEOUT", "0.3")
    srv = A._AsyncServer("127.0.0.1", 0, 2)
    port = srv._srv.getsockname()[1]
    s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    s.sendall(A._MAGIC)
    assert A._recv_exact(s, 4) == A._MAGIC

    def call(*msg):
        A._send_msg(s, msg)
        return A._recv_msg(s)

    def members(reply):
        return {k: reply[1][k] for k in ("num_workers",
                                         "membership_epoch", "keys")
                if k in reply[1]}

    try:
        reply = call("barrier")
        out = [reply[0], "membership:" in reply[1]]
        out += [members(call("leave", 1)), members(call("leave", 1)),
                call("barrier")[0]]
        call("init", "w", np.zeros((2,), np.float32))
        out.append(members(call("join", 1)))
        stats = call("stats")[1]
        out += [stats["membership_epoch"], stats["num_workers"]]
    finally:
        s.close()
        srv._srv.close()
    return out


def test_async_server_membership_matches_jax(monkeypatch):
    got = _async_server_ops(tkva, monkeypatch)
    assert got == _async_server_ops(jkva, monkeypatch)
    assert got[:2] == ["err", True]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_async_barrier_raises_membership_timeout(monkeypatch):
    """A worker's barrier in a world of two whose peer never arrives: the
    host bounds the round and the client raises MembershipTimeout, in both
    packages."""
    monkeypatch.setenv("MXNET_TPU_KV_OP_TIMEOUT", "0.3")
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_WORKER_RANK", "0")
    outcomes = []
    for A in (tkva, jkva):
        port = _free_port()
        if A is tkva:
            monkeypatch.setenv("MXTPU_COORDINATOR", "tcp://127.0.0.1:1")
            monkeypatch.setenv("MXTPU_ASYNC_PORT", str(port))
        else:
            monkeypatch.delenv("MXTPU_ASYNC_PORT", raising=False)
            monkeypatch.setenv("MXTPU_COORDINATOR", f"127.0.0.1:{port - 1}")
        kv = A.AsyncKVStore()
        try:
            with pytest.raises(MXNetError if A is tkva else Exception) as ei:
                kv.barrier()
            outcomes.append((type(ei.value).__name__,
                             "membership" in str(ei.value)))
        finally:
            kv._sock.close()
            kv._server._srv.close()
    assert outcomes == [("MembershipTimeout", True)] * 2
    assert isinstance(ei.value, jres.MembershipTimeout)


# -- checkpoint reshard round trip: 8 -> 6 -> 8 --------------------------------

def test_checkpoint_reshard_roundtrip_8_6_8(tmp_path):
    """Optimizer leaves and per-bucket residual ledgers round-trip a world
    change through each package's checkpoint alike: the leaves bitwise on
    every world, the ledgers kept only when the layout key still matches
    (8 -> 6 and 6 -> 8 drop them, 8 -> 8 keeps them)."""
    from mxnet_tpu import parallel as par
    import jax

    shapes = {"fc1_weight": (16, 10), "fc1_bias": (16,),
              "fc2_weight": (2, 16), "fc2_bias": (2,)}
    rng = np.random.RandomState(3)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    leaves = [rng.randn(*s).astype(np.float32) for s in shapes.values()]
    plans = {}
    for C in (tcomm, jcomm):
        p8 = C.plan_overlap(shapes, C.CompressionSpec.resolve("int8"), 8,
                            max_bytes=256)
        plans[C] = {8: p8, 6: p8.replan(6)}
    assert plans[tcomm][8].num_buckets > 1
    for n in (8, 6):
        assert plans[tcomm][n].layout_key() == plans[jcomm][n].layout_key()
    assert plans[tcomm][6].layout_key() != plans[tcomm][8].layout_key()

    def roundtrip(C, ck, save_params, load):
        out = []
        for n, fill in ((8, 0.25), (6, 0.5)):
            plan = plans[C][n]
            ck.save_sharded(
                str(tmp_path / f"{C.__name__}{n}"), 0, save_params,
                opt_state=list(leaves),
                comm_state={b["name"]: np.full((n, b["padded"]), fill,
                                               np.float32)
                            for b in plan.buckets},
                extra_meta={"comm_layout": plan.layout_key()})
        for saved, new in ((8, 6), (6, 8), (8, 8)):
            p, _, _, meta, got, comm_saved = load(
                str(tmp_path / f"{C.__name__}{saved}"), new)
            plan = plans[C][new]
            if C is tcomm:
                # the port's check reads one rank's row, as its exchange
                # keeps them (model._GradSync.load_comm_state)
                keep = C.residuals_match_plan(
                    {k: v[:1] for k, v in comm_saved.items()}, plan) and \
                    all(v.shape[0] == new for v in comm_saved.values())
            else:
                keep = C.residuals_match_plan(comm_saved, plan)
            keep = keep and meta["comm_layout"] == plan.layout_key()
            out.append((meta["comm_layout"], keep,
                        {k: np.asarray(v).tolist() for k, v in p.items()},
                        [np.asarray(v).tolist() for v in got],
                        {k: np.asarray(v).tolist()
                         for k, v in comm_saved.items()} if keep else None))
        return out

    def jload(directory, n):
        mesh = par.make_mesh(dp=n, devices=jax.devices()[:n])
        return jck.load_resharded(directory, mesh)

    got = roundtrip(tcomm, tck,
                    {k: torch.from_numpy(v) for k, v in params.items()},
                    lambda d, n: tck.load_resharded(d, None))
    assert got == roundtrip(jcomm, jck,
                            {k: jax.numpy.asarray(v)
                             for k, v in params.items()}, jload)
    assert [keep for _, keep, *_ in got] == [False, False, True]
    for _, _, p, got_leaves, _ in got:
        assert p == {k: v.tolist() for k, v in params.items()}
        assert got_leaves == [v.tolist() for v in leaves]


# -- telemetry: resize-aware accounting ----------------------------------------

def test_mfu_accountant_resize_matches_jax():
    def run(tel):
        acct = tel.MFUAccountant(num_devices=8, peak_flops=8e9)
        before = acct.peak_flops
        acct.set_num_devices(6)
        report = acct.epoch_report(0, steps=10, wall_seconds=10.0,
                                   resize_seconds=2.5)
        return before, acct.num_devices, report["badput"]["resize"], \
            report["goodput_pct"]

    got = run(ttel)
    assert got == run(jtel)
    assert got[2] == 2.5 and got[3] == pytest.approx(75.0)


def test_detect_stragglers_membership_change_matches_jax():
    def span(step, device_s):
        return {"kind": "span", "name": "step", "epoch": 0, "step": step,
                "dur_ms": device_s * 1e3,
                "phases": [{"name": "device", "dur_ms": device_s * 1e3}]}

    events = {r: [] for r in range(4)}
    for step in range(8):
        for r in range(4):
            events[r].append(span(step, 0.3 if r == 3 else 0.1))
    for step in range(8, 20):
        for r in range(3):
            events[r].append(span(step, 0.2))
    got = ttel.detect_stragglers(events, publish=False)
    assert got == jtel.detect_stragglers(events, publish=False)
    assert got["membership"]["departed"] == [3]
    assert got["stragglers"] == []


# -- fit integration -----------------------------------------------------------

def test_elastic_fit_validations(tmp_path):
    X, y = _blobs(n=96)
    m = _model(mt, 8, 1)
    with pytest.raises(MXNetError, match="sharded_checkpoint_dir"):
        m.fit(X, y, batch_size=48, elastic=True)
    m1 = mt.FeedForward(_mlp(mt), ctx=[mt.cpu(0)], num_epoch=1)
    with pytest.raises(MXNetError, match="multi-device"):
        m1.fit(X, y, batch_size=48, elastic=True,
               sharded_checkpoint_dir=str(tmp_path / "c"))
    with pytest.raises(MXNetError, match="does not match"):
        m.fit(X, y, batch_size=48, elastic=ElasticCoordinator(4),
              sharded_checkpoint_dir=str(tmp_path / "c2"))
    with pytest.raises(MXNetError, match="min_world >= 2"):
        m.fit(X, y, batch_size=48,
              elastic=ElasticCoordinator(8, min_world=1),
              sharded_checkpoint_dir=str(tmp_path / "c3"))
    assert not m._rank_per_ctx
    assert not os.path.exists(str(tmp_path / "c"))  # raised before work


def test_elastic_fit_chaos_kill_site(tmp_path):
    """The ``elastic.kill`` chaos site fires once mid-run, the coordinator
    buries the victim, and training finishes on 7 (batch 56 divides both
    worlds)."""
    X, y = _blobs(n=448)
    co = ElasticCoordinator(8)
    m = _model(mt, 8, 2)
    it = mt.io.NDArrayIter(X, y, batch_size=56, shuffle=False)
    with chaos_scope(seed=0, rules={"elastic.kill": {11}}):
        m.fit(it, batch_size=56, elastic=co,
              sharded_checkpoint_dir=str(tmp_path / "ckpt"))
    assert co.resizes == 1 and co.world_size == 7
    assert co.history[0]["reason"].startswith("kill:7:chaos")
    assert co.history[0]["downtime_s"] > 0
    assert len(m._train_state.members) == 7
    assert m.ctx == _ctx(mt, 7)
    assert m.score(X, y=y) > 0.9


def test_elastic_resize_indivisible_batch_raises(tmp_path):
    X, y = _blobs(n=96)
    co = ElasticCoordinator(8)

    def cb(param):
        if param.nbatch == 1 and co.world_size == 8:
            co.kill()  # 8 -> 7, but 48 % 7 != 0
    m = _model(mt, 8, 2)
    with pytest.raises(MXNetError, match="not divisible"):
        m.fit(X, y, batch_size=48, elastic=co, batch_end_callback=cb,
              sharded_checkpoint_dir=str(tmp_path / "ckpt"))
    assert not m._rank_per_ctx


# -- the acceptance scenario ---------------------------------------------------

def _copy_steps(src, dst, steps):
    os.makedirs(dst, exist_ok=True)
    for step in steps:
        shutil.copytree(os.path.join(src, str(step)),
                        os.path.join(dst, str(step)))


def _drive(co):
    def drive(param):
        if param.epoch == 1 and param.nbatch == 3 and co.world_size == 8:
            assert co.kill() == 7
            assert co.kill() == 6
        if param.epoch == 2 and param.nbatch == 2 and co.world_size == 6:
            assert co.join_all() == [6, 7]
    return drive


def _elastic_fit(pkg, R, directory, X, y, **kw):
    co = R.ElasticCoordinator(8)
    m = _model(pkg, 8, 4)
    m.fit(pkg.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False),
          batch_size=BATCH, elastic=co, sharded_checkpoint_dir=directory,
          batch_end_callback=_drive(co), compression="int8", overlap=True,
          **kw)
    return m, co


@pytest.fixture(scope="module")
def acceptance(tmp_path_factory):
    """The elastic fit through both packages, once: kill 2 of 8 mid-epoch
    1, continue on 6, rejoin to 8 in epoch 2."""
    tmp = tmp_path_factory.mktemp("elastic")
    X, y = _blobs(n=480)
    jsonl = str(tmp / "events.jsonl")
    port = _elastic_fit(mt, tres, str(tmp / "port"), X, y,
                        telemetry=ttel.TelemetryConfig(jsonl=jsonl))
    ref = _elastic_fit(mx, jres, str(tmp / "jax"), X, y)
    return tmp, X, y, jsonl, port, ref


def test_elastic_fit_tracks_jax(acceptance):
    _, X, y, _, (m, co), (jm, jco) = acceptance
    assert _history(co) == _history(jco)
    assert co.resizes == 2 and [h["to"] for h in co.history] == [6, 8]
    assert co.world_size == 8 and len(m._train_state.members) == 8
    got, want = _numpy(m.arg_params), _numpy(jm.arg_params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
    assert m.score(X, y=y) > 0.95


def test_elastic_acceptance_bitwise_replay(acceptance):
    """The killed epoch redone on 6 is bitwise a fresh 6-replica fit
    resumed from the same pre-kill checkpoint, and the post-rejoin epoch on
    8 is bitwise a fresh 8-replica fit resumed from the 6-world checkpoint
    (params, optimizer leaves, residual ledgers)."""
    tmp, X, y, _, _, _ = acceptance
    d_el = str(tmp / "port")
    assert tck.latest_step(d_el) == 4  # 0 is the elastic floor checkpoint
    for n, steps, epochs, step in ((6, (0, 1), 2, 2), (8, (0, 1, 2), 3, 3)):
        d_ref = str(tmp / f"ref{n}")
        _copy_steps(d_el, d_ref, steps)
        ref = _model(mt, n, epochs)
        ref.fit(mt.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False),
                batch_size=BATCH, sharded_checkpoint_dir=d_ref,
                compression="int8", overlap=True)
        assert ref.begin_epoch == epochs - 1  # it resumed
        el = tck.load_sharded(d_el, step, with_comm=True)
        rf = tck.load_sharded(d_ref, step, with_comm=True)
        for k in el[0]:
            np.testing.assert_array_equal(el[0][k], rf[0][k],
                                          err_msg=f"params[{k}]@{step}")
        for i, (a, b) in enumerate(zip(el[4], rf[4])):
            np.testing.assert_array_equal(a, b, err_msg=f"opt[{i}]@{step}")
        assert el[3]["num_update"] == rf[3]["num_update"]
        assert el[3]["comm_layout"] == rf[3]["comm_layout"]
        assert set(el[5]) == set(rf[5])
        for name in el[5]:
            np.testing.assert_array_equal(el[5][name], rf[5][name],
                                          err_msg=f"residual[{name}]")


def test_elastic_acceptance_downtime_priced_and_traced(acceptance):
    _, _, _, jsonl, (m, _), _ = acceptance
    events = ttel.read_events(jsonl)
    resizes = [e for e in events if e.get("kind") == "resize"]
    assert [(e["from_world"], e["to_world"]) for e in resizes] == \
        [(8, 6), (6, 8)]
    assert [e["membership_epoch"] for e in resizes] == [1, 2]
    assert {e.get("world_size") for e in resizes} == {6, 8}
    badput = [e for e in events if e.get("kind") == "badput"
              and e.get("reason") == "resize"]
    assert badput and all(e["seconds"] > 0 for e in badput)
    assert len(m.telemetry.steps(kind="resize")) == 2
    trace, _ = ttel.merge_traces([jsonl])
    assert any(e.get("name", "").startswith("resize[")
               for e in trace["traceEvents"])


def test_elastic_regrow_captures_nothing(tmp_path):
    """A world of replicas runs eager: shrinking and growing back builds
    no program (no capture, no new program key), where the JAX package
    finds its old world's executable warm."""
    X, y = _blobs(n=192)
    co = ElasticCoordinator(8)
    seen = {"shrunk": False, "grown": False}

    def drive(param):
        if param.epoch == 1 and param.nbatch == 1 and not seen["shrunk"]:
            seen["shrunk"] = True
            co.kill(), co.kill()
        if param.epoch == 2 and param.nbatch == 1 and not seen["grown"]:
            seen["grown"] = True
            co.join_all()

    m = _model(mt, 8, 4)
    before = tcm.compile_stats()
    m.fit(mt.io.NDArrayIter(X, y, batch_size=48, shuffle=False),
          batch_size=48, elastic=co, sharded_checkpoint_dir=str(tmp_path),
          batch_end_callback=drive)
    after = tcm.compile_stats()
    assert co.resizes == 2
    assert after["captures"] == before["captures"]
    assert after["compiles"] - before["compiles"] == 1  # one program key
    assert m._train_state.programs == {}


def test_elastic_peer_tier_restore_is_bitwise(tmp_path):
    """With a step cadence the peer tier holds one rank a replica, each
    snapshot replicated to every alive rank (the ``ckpt.replica`` site
    fires once a rank), and a resize restores from it without a disk
    read; the redone steps are bitwise a fresh 6-replica fit resumed from
    the same step on disk."""
    X, y = _blobs(n=480)
    co = ElasticCoordinator(8)
    d_el = str(tmp_path / "el")
    d_copy = str(tmp_path / "copy")

    def drive(param):
        if param.epoch == 1 and param.nbatch == 4 and co.world_size == 8:
            co.kill(), co.kill()

    ttel.reset()
    m = _model(mt, 8, 2)
    with chaos_scope(seed=0, rules={"ckpt.replica": {1}}) as ch:
        m.fit(mt.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False),
              batch_size=BATCH, elastic=co, sharded_checkpoint_dir=d_el,
              batch_end_callback=drive, compression="int8",
              checkpoint_every_n_steps=4)
    store = m.ckpt_replicas
    assert store.world_size == 8 and co.resizes == 1
    counters = ttel.hub().snapshot()["counters"]
    assert counters["ckpt_peer_restores_total"] == 1.0
    # steps 4, 8 and 12 on 8 ranks, then 16 and 20 on 6
    assert ch._counts["ckpt.replica"] == 3 * 8 + 2 * 6
    assert ch.fired["ckpt.replica"] == 1
    # the resize restored step 12 (epoch 1, 2 batches done); the replay
    # resumes from its copy on disk
    _copy_steps(d_el, d_copy, (12,))
    ref = _model(mt, 6, 2)
    ref.fit(mt.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False),
            batch_size=BATCH, sharded_checkpoint_dir=d_copy,
            compression="int8", checkpoint_every_n_steps=4)
    el = tck.load_sharded(d_el, 20, with_comm=True)
    rf = tck.load_sharded(d_copy, 20, with_comm=True)
    for k in el[0]:
        np.testing.assert_array_equal(el[0][k], rf[0][k], err_msg=k)
    for a, b in zip(el[4], rf[4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(el[5]["__fused__"], rf[5]["__fused__"])
    ttel.reset()
