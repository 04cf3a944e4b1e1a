"""The port's kvstore transports (``kvstore.py``'s group server and
``push_bucketed``, ``kvstore_async.py``, ``kvstore_server.py``) against
the JAX package's (tests/test_kvstore.py, tests/test_comm_overlap.py:
444-535, tests/test_multiprocess_dist.py:142-177).

- The in-process group (``create_group``): BSP semantics with and without
  an updater, duplicate-push idempotency, and int8 pushes through each
  worker's ``HostCodec``, which equal the JAX package's group bit for bit
  (two workers: the f32 sum of two decoded pushes does not depend on
  their order).
- ``HostCodec`` and ``GradBucketer``: payloads and residuals bitwise the
  JAX package's numpy codec's, symmetric sent/received accounting, and
  ``from_layout``'s exact rebuild; ``push_bucketed`` on two gloo ranks
  sums each bucket over the wire (bf16 rounded, summed in f32).
- The dist_async host: the replay of a ``push_pull`` answered from the
  ``(rank, seq)`` cache, a replay racing the original's apply, and
  ``push_pull_stale``'s one-round staleness with ``flush_stale``; the
  reference's dist_async semantics and staleness scripts' checks
  (examples/distributed/dist_async_{kvstore,staleness}.py, their numbers
  kept here) on two and four CPU ranks; a launcher ``-s`` server process
  that retires at import.
- ``fit(kvstore="dist_async")``: with SGD the final weights equal, bitwise,
  a replay of the host's updates over the gradients the worker pushed;
  with ``overlap=True`` stale sync is armed, logged, and the fit converges
  on the reference's blobs above its accuracy bound (0.85).
"""

import logging
import os
import socket
import subprocess
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import comm as jcomm
from mxnet_tpu import kvstore as jkv
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import kvstore_async as ka
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore_server import KVStoreServer
from torch_ranks import (dist_async_semantics, dist_async_staleness,
                         kvstore_bucketed, run_ranks)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 4)


def _threads(fn, n, timeout=60):
    errors = []

    def run(rank):
        try:
            fn(rank)
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not errors, errors


# -- the in-process group ----------------------------------------------------------

def test_group_bsp_semantics():
    """tests/python/multi-node/dist_sync_kvstore.py on 4 in-process
    workers: every worker pulls 1 + 2 + 3 + 4."""
    stores = tkv.create_group(4)
    results = {}

    def worker(rank):
        kv = stores[rank]
        kv.init(3, torch.ones(SHAPE))
        kv.push(3, [torch.ones(SHAPE) * (rank + 1)])
        out = torch.empty(SHAPE)
        kv.pull(3, out=out)
        results[rank] = out.numpy()
        kv.barrier()

    _threads(worker, 4)
    for rank in range(4):
        np.testing.assert_array_equal(results[rank], np.full(SHAPE, 10.0))


def test_group_with_updater_runs_once_a_round():
    stores = tkv.create_group(3)

    def updater(key, recv, stored):
        stored += recv

    stores[0].set_updater(updater)
    results = {}

    def worker(rank):
        kv = stores[rank]
        kv.init(9, torch.zeros(SHAPE))
        for _ in range(2):
            kv.push(9, [torch.ones(SHAPE)])
        out = torch.empty(SHAPE)
        kv.pull(9, out=out)
        results[rank] = out.numpy()

    _threads(worker, 3)
    for rank in range(3):
        np.testing.assert_array_equal(results[rank], np.full(SHAPE, 6.0))


def test_group_server_duplicate_push_idempotent():
    """A resend of an applied push (a lost ack) is absorbed: one round,
    each worker counted once."""
    stores = tkv.create_group(2)
    server = stores[0]._server
    server.init(1, np.zeros(SHAPE, np.float32))
    server.updater = tkv.wrap_np_updater(
        lambda key, recv, stored: stored.add_(recv))
    results = {}

    def worker(rank):
        value = np.ones(SHAPE, np.float32) * (rank + 1)
        assert server.push(1, value, worker=rank, seq=0) is False
        if rank == 0:
            assert server.push(1, value, worker=rank, seq=0) is True
        results[rank] = server.pull(1)

    _threads(worker, 2)
    assert server.duplicate_count == 1
    assert server._round[1] == 1
    for r in range(2):
        np.testing.assert_array_equal(results[r], np.full(SHAPE, 3.0))


def test_group_op_timeout_and_membership():
    """A round stalled past the deadline raises; deregistering the dead
    worker releases the survivors' open round."""
    stores = tkv.create_group(2, op_timeout=0.2)
    with pytest.raises(MXNetError, match="stalled"):
        stores[0].barrier()
    server = stores[0]._server
    server.init(5, np.zeros(3, np.float32))
    server.op_timeout = None
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "dup", server.push(5, np.ones(3, np.float32), worker=0, seq=0)))
    t.start()
    time.sleep(0.1)
    assert server.deregister_worker(1) == 1
    t.join(timeout=10)
    assert out["dup"] is False and server.num_workers == 1
    np.testing.assert_array_equal(server.pull(5), np.ones(3))
    assert server.register_worker(1) == 2 and server.num_workers == 2


@pytest.mark.parametrize("mode", ["int8", "twobit", "bf16"])
def test_group_compressed_pushes_match_reference(mode):
    """Two workers push the same gradients over two rounds through their
    codecs (each with its own residuals); the server decodes and sums. The
    pulled values and the wire accounting equal the JAX package's group."""
    rng = np.random.RandomState(3)
    grads = rng.randn(2, 2, 700).astype(np.float32)

    def run(pkg, new, wrap):
        stores = pkg.create_group(2, compression=mode)

        def updater(key, recv, stored):
            stored += recv

        stores[0].set_updater(updater)
        results = {}

        def worker(rank):
            kv = stores[rank]
            kv.init(0, wrap(np.zeros(700, np.float32)))
            for r in range(2):
                kv.push(0, [wrap(grads[r, rank])])
            out = new()
            kv.pull(0, out=out)
            results[rank] = np.asarray(
                out.asnumpy() if hasattr(out, "asnumpy") else out.numpy())

        _threads(worker, 2)
        server = stores[0]._server
        return results, (server.wire_bytes_received,
                         server.raw_bytes_received), stores[0]

    want, jbytes, _ = run(jkv, lambda: mx.nd.empty((700,)), mx.nd.array)
    got, tbytes, w0 = run(tkv, lambda: torch.empty(700), torch.from_numpy)
    for r in range(2):
        np.testing.assert_array_equal(got[r], want[r])
    assert tbytes == jbytes
    stats = w0.compression_stats()
    assert stats["bytes_raw"] == 2 * 700 * 4 and stats["bytes_encoded"] > 0


# -- HostCodec, GradBucketer, push_bucketed ------------------------------------

def _codec_data(seed=0, n=4100):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.exp(rng.uniform(-4, 4, n))).astype(np.float32)
    x[7], x[300] = 0.5, -0.5  # twobit's inclusive boundary
    x[1000:1256] = 0.0
    return x


@pytest.mark.parametrize("mode", ["bf16", "int8", "twobit"])
def test_host_codec_bitwise_the_reference(mode):
    """Three encodes of the same slab name (the residual fed back each
    time): the payloads, their decodes and the byte counts equal the JAX
    package's numpy codec's; bf16 payloads are the same 16 bits."""
    jc, tc = jcomm.HostCodec(mode), tcomm.HostCodec(mode)
    for i in range(3):
        x = _codec_data(i)
        jp, tp = jc.encode("s", x), tc.encode("s", x)
        assert set(jp) == set(tp)
        for k in jp:
            a, b = np.asarray(jp[k]), np.asarray(tp[k])
            if a.dtype == ml_dtypes.bfloat16:
                a = a.view(np.uint16)
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), k
        np.testing.assert_array_equal(tc.decode(tp), jc.decode(jp))
    assert (tc.bytes_encoded, tc.bytes_raw, tc.bytes_decoded) == \
        (jc.bytes_encoded, jc.bytes_raw, jc.bytes_decoded)
    assert tc.ratio == jc.ratio


def test_host_codec_symmetric_wire_accounting():
    tcomm.reset_comm_stats()
    codec = tcomm.HostCodec("int8")
    flat = np.random.RandomState(0).randn(4096).astype(np.float32)
    payload = codec.encode("slab0", flat)
    assert codec.bytes_encoded > 0 and codec.bytes_decoded == 0
    assert codec.decode(payload).shape == flat.shape
    assert codec.bytes_decoded == codec.bytes_encoded
    host = tcomm.comm_stats()["host_bytes"]
    assert host["sent"] == host["received"] > 0
    assert tcomm.comm_stats()["wire_bytes"] == host["sent"] + host["received"]
    tcomm.reset_comm_stats()
    tcomm.decode_payload("int8", payload)
    host = tcomm.comm_stats()["host_bytes"]
    assert host["received"] > 0 and host["sent"] == 0
    with pytest.raises(MXNetError):
        tcomm.HostCodec(None)


def test_grad_bucketer_layout_and_from_layout_match_reference():
    shapes = [("a", (100, 10)), ("b", (5000,)), ("c", (300, 300)),
              ("d", ()), ("e", (7,))]
    for cap in (40_000, 4 << 20, 4):
        jb = jcomm.GradBucketer(shapes, max_bytes=cap)
        tb = tcomm.GradBucketer(shapes, max_bytes=cap)
        assert tb.layout() == jb.layout()
        assert tb.num_buckets == jb.num_buckets and tb.num_keys == 5
    b1 = tcomm.GradBucketer(shapes, max_bytes=40_000)
    b2 = tcomm.GradBucketer.from_layout(b1.layout())
    for x, y in zip(b1.buckets, b2.buckets):
        assert (x["name"], x["keys"], x["shapes"], x["offsets"],
                x["size"]) == (y["name"], y["keys"], y["shapes"],
                               y["offsets"], y["size"])
    assert b2.max_bytes == max(4 * b["size"] for b in b2.buckets)
    rng = np.random.RandomState(1)
    kvs = {k: rng.randn(*s).astype(np.float32) if s
           else np.float32(rng.randn()) for k, s in shapes}
    back = b2.unpack(b2.pack(kvs))
    for k, s in shapes:
        np.testing.assert_array_equal(back[k], np.asarray(kvs[k]).reshape(s))
    with pytest.raises(MXNetError, match="missing key"):
        b2.pack({"a": kvs["a"]})
    with pytest.raises(MXNetError):
        tcomm.GradBucketer.from_layout([])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_push_bucketed_two_ranks(tmp_path, bf16):
    """Two ranks push 1.3 M elements (two 4 MB buckets) with
    ``push_bucketed``: each pulls the sum, of the bf16-rounded pushes
    summed in f32 with a bf16 wire."""
    rng = np.random.RandomState(2)
    shapes = {"a": (600_000,), "b": (700_000,), "c": (5, 3)}
    values = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
              for _ in range(2)]
    assert tcomm.GradBucketer(shapes).num_buckets == 2
    got = run_ranks(kvstore_bucketed, 2, tmp_path, values, bf16, join=False)
    for k in shapes:
        a, b = values[0][k], values[1][k]
        if bf16:
            a, b = (v.astype(ml_dtypes.bfloat16).astype(np.float32)
                    for v in (a, b))
        for res in got:
            np.testing.assert_array_equal(res[k], a + b)


# -- the dist_async host ------------------------------------------------------------

@pytest.fixture
def async_kv():
    kv = ka.AsyncKVStore()
    yield kv
    kv.close()


def test_async_server_dedups_replayed_push_pull(async_kv):
    kv = async_kv
    kv.init("w", torch.zeros(4))
    kv.set_optimizer(mt.optimizer.create("test", rescale_grad=1.0))
    r1 = kv.push_pull({"w": np.ones(4, np.float32)})
    np.testing.assert_array_equal(r1["w"], np.ones(4))
    # the exact wire message again (rank 0, seq 0): the cached reply
    with kv._lock:
        ka._send_msg(kv._sock, ("push_pull", {"w": np.ones(4, np.float32)},
                                0, 0))
        replay = ka._recv_msg(kv._sock)
    assert replay[0] == "ok"
    np.testing.assert_array_equal(replay[1]["w"], np.ones(4))
    assert kv._server.duplicate_count == 1
    np.testing.assert_array_equal(kv.pull_many(["w"])["w"], np.ones(4))
    assert kv.stats()["update_count"] == 1


def test_async_server_replay_racing_inflight_apply(async_kv):
    kv = async_kv
    kv.init("w", torch.zeros(4))
    applies = []

    def slow_updater(key, recv, stored):
        applies.append(1)
        time.sleep(0.4)  # the replay arrives while this applies
        stored += recv

    kv._server.updater = slow_updater

    def raw_conn():
        s = socket.create_connection((kv._host, kv._port))
        s.sendall(ka._MAGIC)
        assert ka._recv_exact(s, 4) == ka._MAGIC
        return s

    msg = ("push_pull", {"w": np.ones(4, np.float32)}, 0, 0)
    replies = {}

    def send(tag, delay):
        time.sleep(delay)
        c = raw_conn()
        ka._send_msg(c, msg)
        replies[tag] = ka._recv_msg(c)
        c.close()

    threads = [threading.Thread(target=send, args=("orig", 0)),
               threading.Thread(target=send, args=("replay", 0.1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(applies) == 1, "the racing resend applied twice"
    assert kv._server.duplicate_count == 1
    np.testing.assert_array_equal(replies["orig"][1]["w"], np.ones(4))
    np.testing.assert_array_equal(replies["replay"][1]["w"], np.ones(4))


def test_push_pull_stale_one_round_staleness_and_flush(async_kv):
    kv = async_kv
    kv.init("w", torch.zeros(4))
    kv.set_optimizer(mt.optimizer.create("test", rescale_grad=1.0))
    g = {"w": np.ones(4, np.float32)}
    for want in (0.0, 1.0, 2.0):  # call k returns push k-1's result
        np.testing.assert_array_equal(kv.push_pull_stale(g)["w"],
                                      np.full(4, want))
    np.testing.assert_array_equal(kv.flush_stale(["w"])["w"], np.full(4, 3.0))
    assert kv._stale_round is None
    np.testing.assert_array_equal(kv.flush_stale(["w"])["w"], np.full(4, 3.0))


def test_async_compressed_pushes_and_api(async_kv):
    """Compressed batch pushes: the host decodes what the worker's codec
    encoded (sent bytes = received bytes), the layout ships once; the
    single-key API, replicas and membership."""
    kv = async_kv
    kv.init(["a", "b"], [torch.zeros(300), torch.zeros(5, 4)])
    kv.set_optimizer(mt.optimizer.create("test", rescale_grad=1.0))
    assert kv.set_gradient_compression("int8").mode == "int8"
    rng = np.random.RandomState(0)
    g = {"a": rng.randn(300).astype(np.float32),
         "b": rng.randn(5, 4).astype(np.float32)}
    codec = jcomm.HostCodec("int8")
    want = {k: np.zeros_like(v) for k, v in g.items()}
    for _ in range(2):
        got = kv.push_pull(g)
        flats = jcomm.GradBucketer([(k, g[k].shape) for k in ("a", "b")]) \
            .pack(g)
        dec = jcomm.GradBucketer([(k, g[k].shape) for k in ("a", "b")]) \
            .unpack({n: codec.decode(codec.encode(n, f))
                     for n, f in flats.items()})
        want = {k: want[k] + dec[k] for k in g}
        for k in g:
            np.testing.assert_array_equal(got[k], want[k])
    stats, cs = kv.stats(), kv.compression_stats()
    assert stats["wire_bytes_received"] == cs["bytes_encoded"] > 0
    assert stats["raw_bytes_received"] == cs["bytes_raw"] == 2 * 320 * 4
    assert len(kv._layouts_sent) == 1
    out = torch.empty(300)
    kv.push("a", torch.ones(300))
    kv.pull("a", out=out)
    np.testing.assert_array_equal(out.numpy(), want["a"] + 1)
    assert kv.push_replica(0, 3, {"x": 1}) is True
    assert kv.push_replica(0, 2, {"x": 0}) is False
    assert kv.pull_replica(0) == (3, {"x": 1}) and kv.pull_replica(5) is None
    assert kv.leave_group()["num_workers"] == 0
    assert kv.rejoin_group()["num_workers"] == 1
    kv.push_many({"a": np.ones(300, np.float32), "b": g["b"]})
    assert kv.stats()["update_count"] == 4  # 2 push_pull, 1 push, 1 here
    with pytest.raises(MXNetError, match="parameter host"):
        kv.set_updater(lambda *a: None)
    with pytest.raises(MXNetError, match="not initialized"):
        kv.pull_many(["zz"])


def test_kvstore_server_commands():
    server = tkv._GroupServer(1)
    ctl = KVStoreServer(server)
    import pickle

    ctl.handle_command(0, pickle.dumps(mt.optimizer.create(
        "sgd", learning_rate=0.5)))
    server.init("w", np.ones(3, np.float32))
    server.push("w", np.ones(3, np.float32), worker=0, seq=0)
    np.testing.assert_array_equal(server.pull("w"), np.full(3, 0.5))
    stats = ctl.handle_command(-4, None)
    assert stats["rounds"] == {"w": 1} and stats["duplicates"] == 0
    assert stats["num_workers"] == 1 and stats["keys"] == 1
    assert ctl.handle_command(-3, None) is None and ctl.sync_mode
    ctl.handle_command(-2, None)
    assert ctl.run() is None
    assert tkv.create("local").send_command_to_servers(0, b"") is None


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_dist_async_semantics_across_ranks(tmp_path, world):
    """examples/distributed/dist_async_kvstore.py: rank 0's three pushes
    land while the others wait (3.0), then one push each (3 + world)."""
    res = run_ranks(dist_async_semantics, world, tmp_path, _free_port(),
                    join=False)
    for rank, r in enumerate(res):
        assert r["rank"] == rank and r["num_workers"] == world
        want = [3.0, 3.0 + world] if rank else [3.0, 3.0, 3.0 + world]
        for got, w in zip(r["seen"], want):
            np.testing.assert_array_equal(got, np.full(4, w))
        assert r["stats"]["update_count"] == 3 + world


def test_dist_async_staleness_four_ranks(tmp_path):
    """examples/distributed/dist_async_staleness.py: four workers at
    skewed speeds each finish their 12 batches, the host applied all 48
    pushes, and the stale-gradient fit reaches 0.9."""
    res = run_ranks(dist_async_staleness, 4, tmp_path, _free_port(), 12,
                    0.05, join=False)
    assert [r["done"] for r in res] == [12] * 4
    assert res[0]["stats"]["update_count"] == 48
    assert res[0]["acc"] > 0.9, res[0]["acc"]


def test_launcher_server_process_retires(tmp_path):
    """``tools/launch.py -n 2 -s 1`` of a dist_async script through the
    port: the server-role process exits at ``import mxnet_tpu_torch``,
    the two workers train against rank 0's host."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import sys, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import mxnet_tpu_torch as mt\n"
        "kv = mt.kv.create('dist_async')\n"
        "kv.init(1, torch.zeros(2))\n"
        "kv.set_optimizer(mt.optimizer.create('test'))\n"
        "kv.push(1, torch.ones(2))\n"
        "kv.barrier()\n"
        "out = torch.empty(2)\n"
        "kv.pull(1, out=out)\n"
        "print('worker', kv.rank, 'value', float(out[0]))\n"
        "kv.barrier()\n"
        "kv.close()\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MXTPU")}
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n", "2",
         "-s", "1", sys.executable, str(script)],
        capture_output=True, text=True, timeout=240, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    # the two workers print into one pipe: their lines may interleave
    assert res.stdout.count("value 2.0") == 2, res.stdout
    assert "DMLC_ROLE=server" in res.stderr


# -- fit(kvstore="dist_async") ---------------------------------------------------

def _blobs(n=120, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1,
                        rng.randn(n - n // 2, dim) - 1]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(
        np.float32)
    order = rng.permutation(n)
    return X[order], y[order]


def _mlp(pkg, hidden=32):
    s = pkg.symbol
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=hidden)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=2)
    return s.SoftmaxOutput(data=net, name="softmax")


def test_fit_dist_async_overlap_stale_sync_converges(caplog):
    """tests/test_comm_overlap.py:517-529 through the port: stale sync is
    armed and logged, and the fit converges (accuracy above 0.85)."""
    X, y = _blobs(120)
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=4,
                           learning_rate=0.5)
    with caplog.at_level(logging.INFO):
        model.fit(X, y, batch_size=40, kvstore="dist_async", overlap=True)
    assert "stale-sync armed" in caplog.text
    acc = (model.predict(X, batch_size=40).argmax(axis=1) == y).mean()
    assert acc > 0.85, acc
    assert len(model.async_rounds) == 4 * 3
    assert model._train_state.opt_state == {}


def test_fit_dist_async_weights_are_the_hosts_replay(monkeypatch):
    """One worker with SGD and momentum: the fit's final weights equal,
    bitwise, a replay of the host's updater over the gradients the worker
    pushed, from the initial weights; the loss falls. With int8
    compression the codec's sent bytes equal the host's received bytes."""
    pushed, stats = [], {}
    real = ka.AsyncKVStore.push_pull

    def recording(self, kvs, priority=0):
        pushed.append({k: np.array(v, copy=True) for k, v in kvs.items()})
        out = real(self, kvs, priority)
        stats.update(self.stats(), **self.compression_stats())
        return out

    monkeypatch.setattr(ka.AsyncKVStore, "push_pull", recording)
    X, y = _blobs(120)
    for compression in (None, "int8"):
        pushed.clear()
        model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=3,
                               learning_rate=0.1, momentum=0.9,
                               initializer=mt.init.Xavier())
        model._init_params({"data": (40, 10), "softmax_label": (40,)})
        init = {k: v.clone() for k, v in model.arg_params.items()}
        losses = []
        model.fit(X, y, batch_size=40, kvstore="dist_async",
                  compression=compression, eval_metric="ce",
                  batch_end_callback=lambda p: losses.append(
                      p.eval_metric.get()[1]))
        assert len(pushed) == 9
        if compression is None:
            opt = mt.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                      rescale_grad=1 / 40,
                                      arg_names=list(init))
            update = tkv.wrap_np_updater(mt.optimizer.get_updater(opt))
            store = {k: v.numpy().copy() for k, v in init.items()}
            for grads in pushed:
                for k, g in grads.items():
                    update(k, g, store[k])
            for k, v in model.arg_params.items():
                assert np.array_equal(v.numpy().view(np.uint32),
                                      store[k].view(np.uint32)), k
        else:
            assert stats["wire_bytes_received"] == stats["bytes_encoded"] > 0
        assert losses[-1] < losses[0]


def test_fit_raising_before_its_first_step_restores_the_world(monkeypatch,
                                                             tmp_path):
    """The store a fit makes sets the process's telemetry world (rank 0
    of 2 here); a fit that raises before its first step puts back the
    world it found, so no later record of the process carries a world of
    a store that is gone."""
    from mxnet_tpu_torch import telemetry as tt

    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_WORKER_RANK", "0")
    monkeypatch.setenv("MXTPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("MXTPU_ASYNC_PORT", str(_free_port()))
    prev = (tt.current_rank(), tt.world_size())
    tt.set_world(0, 1)
    seen = []
    real_set_world = tt.set_world
    monkeypatch.setattr(tt, "set_world", lambda r, w: (
        seen.append((r, w)), real_set_world(r, w))[1])
    try:
        model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=1)
        X, y = _blobs(40)
        with pytest.raises(MXNetError, match="multi-worker"):
            model.fit(X, y, batch_size=40, kvstore="dist_async",
                      sharded_checkpoint_dir=str(tmp_path / "ck"))
        assert (0, 2) in seen  # the store set it
        assert (tt.current_rank(), tt.world_size()) == (0, 1)
    finally:
        real_set_world(*prev)


def test_fit_dist_async_multi_worker_checkpoint_raises(monkeypatch, tmp_path):
    """Rank 0 of two (it hosts the parameter host, so the store is made
    for real): a shared sharded checkpoint directory raises with the
    reference's message before any step."""
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_WORKER_RANK", "0")
    monkeypatch.setenv("MXTPU_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("MXTPU_ASYNC_PORT", str(_free_port()))
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=1)
    X, y = _blobs(40)
    with pytest.raises(MXNetError, match="multi-worker kvstore='dist_async'"):
        model.fit(X, y, batch_size=40, kvstore="dist_async",
                  sharded_checkpoint_dir=str(tmp_path / "ck"))
    assert model.arg_params is None
