"""The asynchronous checkpoint plane of the port
(``mxnet_tpu_torch/resilience/ckpt_async.py``) and ``fit``'s step-granular
resume, against the JAX package's.

A fit killed mid-epoch (an exception from a batch callback) and resumed from
its newest snapshot ends bitwise where the uninterrupted fit ends, on the
CPU: an MLP with Adam, and a small AlexNet-like net whose Dropout draws from
the random state the snapshot saved. The port's resumed MLP fit ends within
the fit tolerance of tests/test_torch_model.py (3e-4 absolute) of the JAX
package's resumed fit from the same weights and batches.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.utils import checkpoint as jck
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import ckpt_async
from mxnet_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

BATCH = 32


def _host_params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(16, 8).astype(np.float32),
            "fc1_bias": rng.randn(16).astype(np.float32)}


def _snap(step):
    return ckpt_async.capture_snapshot(
        step, {k: torch.from_numpy(v) for k, v in _host_params(step).items()},
        meta={"epoch": 0, "num_update": step})


def test_resolvers(monkeypatch):
    for name in ("MXNET_TPU_CKPT_STEPS", "MXNET_TPU_CKPT_KEEP",
                 "MXNET_TPU_CKPT_QUEUE"):
        monkeypatch.delenv(name, raising=False)
    assert ckpt_async.resolve_every() is None
    assert ckpt_async.resolve_keep() == 3
    assert ckpt_async.resolve_queue_depth() == 2
    monkeypatch.setenv("MXNET_TPU_CKPT_STEPS", "5")
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "7")
    monkeypatch.setenv("MXNET_TPU_CKPT_QUEUE", "4")
    assert ckpt_async.resolve_every() == 5 and ckpt_async.resolve_every(2) == 2
    assert ckpt_async.resolve_every(0) == 1
    assert ckpt_async.resolve_keep() == 7 and ckpt_async.resolve_keep(0) == 0
    assert ckpt_async.resolve_queue_depth() == 4


def test_capture_snapshot_is_a_host_copy():
    params = {k: torch.from_numpy(v.copy())
              for k, v in _host_params(1).items()}
    snap = ckpt_async.capture_snapshot(
        4, params, aux={"m": torch.ones(3)},
        opt_state=[torch.zeros(2), torch.tensor(3.0)], meta={"epoch": 1})
    params["fc1_bias"].add_(1.0)  # the snapshot does not alias the tensors
    np.testing.assert_array_equal(snap.state["params"]["fc1_bias"],
                                  _host_params(1)["fc1_bias"])
    assert isinstance(snap.state["opt"], list) and len(snap.state["opt"]) == 2
    assert snap.state["opt"][1].shape == () and snap.meta == {"epoch": 1}
    assert snap.step == 4 and set(snap.state) == {"params", "aux", "opt"}


def test_writer_drains_prunes_and_reports(tmp_path):
    w = ckpt_async.AsyncCheckpointWriter(tmp_path, keep_last_k=2)
    for step in (1, 2, 3):
        w.submit(_snap(step))
        assert w.flush(timeout=30)
    assert w.last_durable_step == 3 and w.written == 3
    assert sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit()) == [2, 3]
    w.close()
    assert not w.submit(_snap(4))  # closed
    p, _, _, meta, _ = tck.load_sharded(tmp_path)
    assert meta["num_update"] == 3
    np.testing.assert_array_equal(p["fc1_weight"],
                                  _host_params(3)["fc1_weight"])
    assert jck.latest_step(tmp_path) == 3  # the JAX package agrees


def test_writer_drops_oldest_and_never_blocks(tmp_path, monkeypatch):
    gate = threading.Event()
    real = tck.save_sharded

    def slow(*a, **k):
        gate.wait(timeout=30)
        return real(*a, **k)

    monkeypatch.setattr(tck, "save_sharded", slow)
    w = ckpt_async.AsyncCheckpointWriter(tmp_path, queue_depth=2,
                                         keep_last_k=0)
    w.submit(_snap(1))
    deadline = time.monotonic() + 10
    while w._inflight is None and time.monotonic() < deadline:
        time.sleep(0.01)  # step 1 is in the writer's hands
    t0 = time.perf_counter()
    for step in (2, 3, 4, 5):
        assert w.submit(_snap(step))
    assert time.perf_counter() - t0 < 1.0
    assert w.dropped == 2  # 2 and 3 gave way to 4 and 5
    gate.set()
    assert w.flush(timeout=30)
    w.close()
    assert sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit()) \
        == [1, 4, 5]
    assert w.last_durable_step == 5 and w.failures == 0


def test_writer_failure_is_counted_not_raised(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(tck, "save_sharded", boom)
    w = ckpt_async.AsyncCheckpointWriter(tmp_path)
    w.submit(_snap(1))
    assert w.flush(timeout=30)
    w.close()
    assert w.failures == 1 and w.last_durable_step is None


def test_replica_store_dedup_restore_drop():
    store = ckpt_async.ReplicaStore(3)
    assert store.holder_of(2) == 0 and ckpt_async.ReplicaStore(1).holder_of(0) == 0
    assert store.replicate(0, _snap(4))
    assert not store.replicate(0, _snap(4))  # repeated
    assert not store.replicate(0, _snap(3))  # stale
    assert store.duplicate_count == 2
    assert store.replicate(1, _snap(6))
    assert store.restore().step == 6
    assert store.restore(alive=[1]).step == 4  # rank 1 holds rank 0's
    store.drop_rank(2)  # the holder of rank 1's replica
    assert store.restore().step == 4
    store.drop_rank(1)
    assert store.restore() is None


def test_save_now_prunes(tmp_path):
    for step in (1, 2, 3, 4):
        ckpt_async.save_now(tmp_path, step, _host_params(step),
                            extra_meta={"epoch": 0}, keep=2)
    assert sorted(int(d) for d in os.listdir(tmp_path) if d.isdigit()) == [3, 4]


# -- fit: cadence, kill and resume ---------------------------------------------

def _blobs(n=256, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1,
                        rng.randn(n - n // 2, dim) - 1]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(
        np.float32)
    order = rng.permutation(n)
    return X[order], y[order]


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, name="fc1", num_hidden=16)
    net = pkg.sym.Activation(data=net, name="relu1", act_type="relu")
    net = pkg.sym.FullyConnected(data=net, name="fc2", num_hidden=2)
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _alexnet_like(pkg):
    """A small AlexNet: convolution, LRN, pooling, then two FC layers with
    Dropout between them."""
    s = pkg.sym
    net = s.Convolution(data=s.Variable("data"), name="conv1", kernel=(3, 3),
                        num_filter=4)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.LRN(data=net, name="norm1", nsize=3)
    net = s.Pooling(data=net, name="pool1", kernel=(2, 2), stride=(2, 2),
                    pool_type="max")
    net = s.Flatten(data=net, name="flat")
    net = s.FullyConnected(data=net, name="fc1", num_hidden=16)
    net = s.Activation(data=net, name="relu2", act_type="relu")
    net = s.Dropout(data=net, name="drop1", p=0.5)
    net = s.FullyConnected(data=net, name="fc2", num_hidden=2)
    return s.SoftmaxOutput(data=net, name="softmax")


class _Killed(Exception):
    pass


def _fit(pkg, net, X, y, directory, init, kill_after=None, **kw):
    """Two epochs of 8 steps, Adam, a snapshot every 3 steps; killed by a
    batch callback after ``kill_after`` steps of this call."""
    np.random.seed(0)
    pkg.random.seed(0)
    seen = [0]

    def kill(_p):
        seen[0] += 1
        if kill_after is not None and seen[0] == kill_after:
            raise _Killed()

    ctx = pkg.cpu()
    arg = {k: (mx.nd.array(v) if pkg is mx else v) for k, v in init.items()}
    model = pkg.FeedForward(net, ctx=ctx, num_epoch=2, optimizer="adam",
                            learning_rate=0.01, epsilon=1e-3,
                            arg_params=arg, **kw)
    try:
        model.fit(pkg.io.NDArrayIter(X, y, batch_size=BATCH, shuffle=False),
                  batch_size=BATCH, sharded_checkpoint_dir=directory,
                  checkpoint_every_n_steps=3, batch_end_callback=kill)
    except _Killed:
        return None
    return model


def _init(net, shape):
    from mxnet_tpu_torch.convert import random_params

    return random_params(net, 3, data=shape)[0]


def test_fit_cadence_and_meta(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "100")
    X, y = _blobs()
    d = str(tmp_path / "ck")
    net = _mlp(mt)
    _fit(mt, net, X, y, d, _init(net, (BATCH, 10)))
    steps = sorted(int(s) for s in os.listdir(d) if s.isdigit())
    assert steps == [3, 6, 8, 9, 12, 15, 16]  # the JAX package's ids
    _, _, _, meta, leaves = tck.load_sharded(d, 12)
    assert meta["num_update"] == 12 and meta["epoch"] == 1
    assert meta["batches_done"] == 4 and "generators" in meta["rng_state"]
    # Adam: (m, v, t) per parameter, names sorted
    assert len(leaves) == 3 * 4 and float(leaves[2]) == 12.0
    _, _, _, meta16, _ = tck.load_sharded(d, 16)
    assert meta16["batches_done"] == 0 and meta16["epoch"] == 2


@pytest.mark.parametrize("which", ["mlp", "alexnet_like"])
def test_killed_fit_resumes_bitwise(tmp_path, monkeypatch, which):
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "100")
    if which == "mlp":
        X, y = _blobs()
        net = _mlp(mt)
    else:
        rng = np.random.RandomState(1)
        X = rng.randn(256, 1, 12, 12).astype(np.float32)
        y = (X.mean(axis=(1, 2, 3)) > 0).astype(np.float32)
        net = _alexnet_like(mt)
    init = _init(net, (BATCH,) + X.shape[1:])
    ref = _fit(mt, net, X, y, str(tmp_path / "ref"), init)
    d = str(tmp_path / "kill")
    assert _fit(mt, net, X, y, d, init, kill_after=11) is None
    assert tck.latest_step(d) == 9  # a snapshot, mid-epoch 1
    resumed = _fit(mt, net, X, y, d, init)
    assert resumed.begin_epoch == 1
    for k, v in ref.arg_params.items():
        assert torch.equal(resumed.arg_params[k], v), k
    for step in (12, 15, 16):
        a = tck.load_sharded(str(tmp_path / "ref"), step)
        b = tck.load_sharded(d, step)
        for k in a[0]:
            np.testing.assert_array_equal(a[0][k], b[0][k])
        for x, z in zip(a[4], b[4]):
            np.testing.assert_array_equal(x, z)
        assert a[3]["rng_state"] == b[3]["rng_state"]


def test_resumed_fit_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "100")
    X, y = _blobs()
    init = _init(_mlp(mt), (BATCH, 10))
    out = {}
    for pkg, name in ((mx, "jax"), (mt, "torch")):
        d = str(tmp_path / name)
        assert _fit(pkg, _mlp(pkg), X, y, d, init, kill_after=11) is None
        out[name] = _fit(pkg, _mlp(pkg), X, y, d, init)
        assert out[name].begin_epoch == 1
    for k, v in out["torch"].arg_params.items():
        np.testing.assert_allclose(v.numpy(),
                                   out["jax"].arg_params[k].asnumpy(),
                                   rtol=0, atol=3e-4, err_msg=k)


def test_resume_copies_into_the_trainers_buffers(tmp_path, monkeypatch):
    """A resume on the same object loads into the tensors its earlier fit
    trained (a captured step reads those), not new ones."""
    monkeypatch.setenv("MXNET_TPU_CKPT_KEEP", "100")
    X, y = _blobs()
    net = _mlp(mt)
    init = _init(net, (BATCH, 10))
    np.random.seed(0)
    model = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=2, optimizer="adam",
                           learning_rate=0.01, epsilon=1e-3, arg_params=init)
    d = str(tmp_path / "ck")
    calls = [0]

    def kill(_p):
        calls[0] += 1
        if calls[0] == 11:
            raise _Killed()

    with pytest.raises(_Killed):
        model.fit(mt.io.NDArrayIter(X, y, batch_size=BATCH), batch_size=BATCH,
                  sharded_checkpoint_dir=d, checkpoint_every_n_steps=3,
                  batch_end_callback=kill)
    state = model._train_state
    held = {k: v for k, v in state.params.items()}
    model.fit(mt.io.NDArrayIter(X, y, batch_size=BATCH), batch_size=BATCH,
              sharded_checkpoint_dir=d, checkpoint_every_n_steps=3)
    assert model._train_state is state
    assert all(state.params[k] is held[k] for k in held)
    ref = _fit(mt, net, X, y, str(tmp_path / "ref"), init)
    for k, v in ref.arg_params.items():
        assert torch.equal(model.arg_params[k], v), k


def test_fit_without_cadence_saves_epochs(tmp_path):
    X, y = _blobs()
    net = _mlp(mt)
    model = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=2,
                           learning_rate=0.1, arg_params=_init(net, (32, 10)))
    d = str(tmp_path)
    model.fit(X, y, batch_size=BATCH, sharded_checkpoint_dir=d)
    assert sorted(int(s) for s in os.listdir(d) if s.isdigit()) == [1, 2]
    _, _, _, meta, _ = tck.load_sharded(d, 2)
    assert meta == {"step": 2, "epoch": 2, "num_update": 16}
    # a finished run resumes past its last epoch and trains nothing more
    again = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=2, learning_rate=0.1)
    again.fit(X, y, batch_size=BATCH, sharded_checkpoint_dir=d)
    for k, v in model.arg_params.items():
        assert torch.equal(again.arg_params[k], v)
