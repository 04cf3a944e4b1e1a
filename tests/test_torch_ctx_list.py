"""A list of devices as ``ctx`` in one process: ``FeedForward(ctx=[cpu(i)
for i in range(4)])`` through the port against the JAX package's fit over
its single-process ``dp`` mesh of the same four devices.

Conftest declares 8 host devices (``XLA_FLAGS``), which the port reads as
the JAX package does, so ``cpu(0..3)`` are four replicas in both packages.
Both fits take the same parameters and rows without shuffling, and
``rescale_grad = 1/global batch``. Bounds, as for the gloo ranks
(tests/test_torch_data_parallel.py): per-step cross-entropy within 1e-5
relative, parameters within 2e-4 absolute and auxiliary states within
1e-5 relative after each of 3 steps.

Without compression the JAX step is the partitioned single-device step on
the global batch, so BatchNorm's statistics are the global batch's; with
compression each device normalises its own rows and the moving statistics
are averaged (``pmean``). The BatchNorm net holds the port to both.
"""

import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import model as jmodel
from mxnet_tpu_torch import comm
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.comm.allreduce import all_reduce_sum, broadcast_
from mxnet_tpu_torch.convert import (random_params, residual_rows_from_numpy,
                                     residual_rows_to_numpy)
from mxnet_tpu_torch.utils import checkpoint as tckpt
from mxnet_tpu_torch.utils import compile as tcm
from torch_ranks import exchange, run_ranks, small_net

torch.set_num_threads(1)

WORLD = 4
BATCH = 16          # 4 rows a replica
EPOCHS = 3          # one batch an epoch: one step each
FIT_KW = dict(optimizer="adam", fused=True, learning_rate=0.01, epsilon=1e-3)


def _ctx(pkg, n=WORLD):
    return [pkg.cpu(i) for i in range(n)]


def _mlp(pkg, hidden=32, classes=10):
    s = pkg.symbol
    h = s.FullyConnected(s.Variable("data"), num_hidden=hidden, name="fc1")
    h = s.Activation(h, act_type="relu", name="relu1")
    h = s.FullyConnected(h, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


NETS = {"mlp": _mlp, "bn": small_net}


def _data(net, seed=4):
    args, aux = random_params(net(mt), seed, data=(BATCH, 16))
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((BATCH, 16)).astype(np.float32)
    Y = rng.integers(0, 10, BATCH).astype(np.float32)
    return args, aux, X, Y


def _numpy(d):
    return {k: (v.asnumpy() if hasattr(v, "asnumpy") else
                v.detach().cpu().numpy()).copy() for k, v in d.items()}


def _fit(pkg, net, args, aux, X, Y, fit_kw, ctx=None):
    epochs, sums = [], []
    wrap = mx.nd.array if pkg is mx else torch.from_numpy
    model = pkg.FeedForward(
        net(pkg), ctx=_ctx(pkg) if ctx is None else ctx, num_epoch=EPOCHS,
        arg_params={k: wrap(v.copy()) for k, v in args.items()},
        aux_params={k: wrap(v.copy()) for k, v in aux.items()}, **FIT_KW)
    model.fit(pkg.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False),
              eval_metric="ce",
              epoch_end_callback=lambda e, s, a, x: epochs.append(
                  (_numpy(a), _numpy(x))),
              batch_end_callback=lambda p: sums.append(
                  p.eval_metric.sum_metric), **fit_kw)
    return model, epochs, np.asarray(sums)


# (mode, net, overlap cap in bytes)
CASES = {"none-mlp": ("none", "mlp", None), "none-bn": ("none", "bn", None),
         "int8": ("int8", "bn", None), "twobit": ("twobit", "bn", None),
         "int8-overlap": ("int8", "bn", 2048),
         "twobit-overlap": ("twobit", "bn", 2048)}
_FITS = {}


@pytest.fixture(scope="module", params=list(CASES))
def fits(request):
    """Both packages' 3 steps over the 4 devices, once per case."""
    name = request.param
    if name not in _FITS:
        mode, net, cap = CASES[name]
        args, aux, X, Y = _data(NETS[net])
        fit_kw = dict(compression=None if mode == "none" else mode,
                      comm_kernels=True, overlap=cap)
        port = _fit(mt, NETS[net], args, aux, X, Y, fit_kw)
        ref = _fit(mx, NETS[net], args, aux, X, Y, fit_kw)
        _FITS[name] = (args, aux, port, ref)
    return (name,) + _FITS[name]


def test_fit_loss_tracks_jax(fits):
    name, _, _, (_, _, sums), (_, _, jsums) = fits
    np.testing.assert_allclose(sums / BATCH, jsums / BATCH, rtol=1e-5,
                               err_msg=name)
    assert sums[-1] < sums[0], name


def test_fit_params_and_aux_track_jax_each_step(fits):
    name, args, aux, (_, epochs, _), (_, jepochs, _) = fits
    assert len(epochs) == len(jepochs) == EPOCHS
    for step, ((targs, taux), (jargs, jaux)) in enumerate(zip(epochs,
                                                             jepochs)):
        for k in args:
            np.testing.assert_allclose(targs[k], jargs[k], rtol=0, atol=2e-4,
                                       err_msg=f"{name} step {step} {k}")
        for k in aux:
            np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")
    moved = [k for k in args if k != "fc1_bias"]
    assert all(not np.array_equal(epochs[-1][0][k], args[k]) for k in moved)


def test_replicas_hold_bitwise_equal_state(fits):
    name, _, _, (model, _, _), _ = fits
    state = model._train_state
    assert len(state.members) == WORLD, name
    first = state.members[0]
    for m in state.members[1:]:
        for k in first.params:
            assert torch.equal(m.params[k], first.params[k]), (name, k)
        for k in first.aux:
            assert torch.equal(m.aux[k], first.aux[k]), (name, k)


def test_replica_residuals_and_wire_plan(fits):
    name, args, _, (model, _, _), _ = fits
    mode, _, cap = CASES[name]
    sync = model._train_state.grad_sync
    state, layout = sync.comm_state()
    if mode == "none":
        assert state is None and layout is None
        return
    rows = next(iter(state.values()))
    assert rows.shape[0] == WORLD
    # each replica's residual is its own
    assert not torch.equal(rows[0], rows[1])
    if cap is None:
        n = sum(v.size for v in args.values())
        spec = comm.CompressionSpec(mode)
        assert rows.shape == (WORLD, comm.padded_flat_size(n, spec, WORLD))
        assert layout == comm.fused_layout_key(n, spec, WORLD)
    else:
        assert len(state) >= 2 and layout.startswith("overlap:")


def test_batchnorm_statistics_follow_the_mode(fits):
    """Without compression the running statistics are the global batch's
    (every replica's rows), with it the mean of each replica's own: the
    two differ, and each package agrees with the other."""
    name, _, aux, (_, epochs, _), (_, jepochs, _) = fits
    if name not in ("none-bn", "int8"):
        return
    X = _data(small_net)[2]
    fc1 = _data(small_net)[0]
    h = X @ fc1["fc1_weight"].T + fc1["fc1_bias"]
    blocks = h.reshape(WORLD, BATCH // WORLD, -1)
    global_mean = 0.9 * aux["bn1_moving_mean"] + 0.1 * h.mean(0)
    got = jepochs[0][1]["bn1_moving_mean"]
    np.testing.assert_allclose(epochs[0][1]["bn1_moving_mean"], got,
                               rtol=1e-5, atol=1e-6)
    # the first step's statistics are of the initial weights' activations
    np.testing.assert_allclose(got, global_mean, rtol=1e-4, atol=1e-5)
    var_global = 0.9 * aux["bn1_moving_var"] + 0.1 * h.var(0)
    var_local = 0.9 * aux["bn1_moving_var"] + 0.1 * blocks.var(1).mean(0)
    want = var_global if name == "none-bn" else var_local
    np.testing.assert_allclose(jepochs[0][1]["bn1_moving_var"], want,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(epochs[0][1]["bn1_moving_var"], want,
                               rtol=1e-4, atol=1e-5)
    assert not np.allclose(var_global, var_local, rtol=1e-3)


# --------------------------------------------------------------------------
# the in-process exchange against the gloo ranks, bitwise
# --------------------------------------------------------------------------

SHAPES = {"w": (37, 29), "b": (29,), "a": (3,)}


def _exchange_cases():
    rng = np.random.RandomState(3)
    grads = {k: (rng.randn(WORLD, *s) * 0.6).astype(np.float32)
             for k, s in SHAPES.items()}
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    cases = []
    for mode in ("none", "bf16", "int8", "twobit"):
        spec = comm.CompressionSpec(mode, threshold=0.5, chunk=64)
        for kernels in (False, True):
            for ef in (True, False) if spec.error_feedback else (False,):
                resid = None
                if ef:
                    lp = comm.padded_flat_size(n, spec, WORLD)
                    resid = (rng.randn(WORLD, lp) * 0.05).astype(np.float32)
                cases.append({"mode": mode, "threshold": 0.5, "chunk": 64,
                              "kernels": kernels, "average": False,
                              "grads": grads, "resid": resid})
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = _exchange_cases()
    return cases, run_ranks(exchange, WORLD, tmp_path_factory.mktemp("ex"),
                            cases)


def _bits(a, b, what):
    assert a.shape == b.shape, what
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), what


def _replica_run(case):
    group = comm.ReplicaGroup([torch.device("cpu")] * WORLD)
    spec = comm.CompressionSpec(case["mode"], threshold=0.5, chunk=64)
    trees = [{k: torch.from_numpy(v[r].copy())
              for k, v in case["grads"].items()} for r in range(WORLD)]
    if case["resid"] is not None:
        resid = [residual_rows_from_numpy(case["resid"], r)
                 for r in range(WORLD)]
        return comm.error_feedback_allreduce(
            trees, resid, spec, group=group, kernels=case["kernels"])
    return comm.compressed_allreduce(
        trees, spec if spec.mode != "none" else None, group=group,
        average=False, kernels=case["kernels"]), None


@pytest.mark.parametrize("index", range(9))
def test_replica_exchange_bitwise_the_gloo_ranks(ranks, index):
    cases, port = ranks
    case = cases[index]
    outs, resid = _replica_run(case)
    what = (case["mode"], case["kernels"], case["resid"] is not None)
    for r in range(WORLD):
        for k in SHAPES:
            got, want = outs[r][k].numpy(), port[r][index]["out"][k]
            if case["mode"] == "none":
                # gloo's 4-rank all_reduce adds in an order of its own; the
                # replicas add in replica order
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                _bits(got, want, what + (r, k))
        if resid is not None:
            _bits(resid[r].numpy(), port[r][index]["resid"],
                  what + (r, "resid"))
    if resid is not None:
        rows = residual_rows_to_numpy(resid)
        assert rows.shape == case["resid"].shape
        # (R, Lp) rows go back as they came: all of them, in replica order
        back = residual_rows_from_numpy(rows, None)
        _bits(back.numpy(), rows, what + ("rows",))


def test_replica_wire_ops_over_one_device():
    group = comm.ReplicaGroup(["cpu", "cpu", "cpu"])
    ts = [torch.full((2,), float(i + 1)) for i in range(3)]
    summed = all_reduce_sum(ts, group)
    assert all(torch.equal(s, torch.full((2,), 6.0)) for s in summed)
    broadcast_(ts, group)
    assert all(torch.equal(t, torch.ones(2)) for t in ts)
    with pytest.raises(mt.base.MXNetError, match="one a replica"):
        all_reduce_sum(ts[:2], group)


# --------------------------------------------------------------------------
# overlap: per-bucket residuals through the sharded checkpoint
# --------------------------------------------------------------------------

def _blobs(n=96, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1,
                        rng.randn(n - n // 2, dim) - 1]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(
        np.float32)
    order = rng.permutation(n)
    return X[order], y[order]


def _logger(name):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    records = []

    class _H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger.addHandler(_H())
    return logger, records


def test_overlap_residual_checkpoint_resume_and_invalidation(tmp_path):
    """tests/test_comm_overlap.py:381-420 through the port: per-bucket
    residuals round-trip through the sharded checkpoint (layout-keyed, the
    JAX package's names, layout key and shapes), and a bucket-plan change
    on resume drops them."""
    X, y = _blobs()
    d, jd = str(tmp_path / "ckpt"), str(tmp_path / "jckpt")
    kw = dict(batch_size=32, compression="int8", overlap=2048)
    m1 = mt.FeedForward(_mlp(mt, 64, 2), ctx=_ctx(mt), num_epoch=2,
                        learning_rate=0.5)
    m1.fit(X, y, sharded_checkpoint_dir=d, **kw)
    assert tckpt.latest_step(d) == 2
    *_, meta, _, comm_state = tckpt.load_sharded(d, 2, with_comm=True)
    assert comm_state is not None and len(comm_state) >= 2
    assert meta["comm_layout"].startswith("overlap:")
    assert all(n.startswith("bucket") for n in comm_state)
    assert all(v.shape[0] == WORLD for v in comm_state.values())
    j1 = mx.FeedForward(_mlp(mx, 64, 2), ctx=_ctx(mx), num_epoch=2,
                        learning_rate=0.5)
    j1.fit(X, y, sharded_checkpoint_dir=jd, **kw)
    from mxnet_tpu.utils import checkpoint as jckpt
    *_, jmeta, _, jcomm = jckpt.load_sharded(jd, 2, with_comm=True)
    assert jmeta["comm_layout"] == meta["comm_layout"]
    assert {k: v.shape for k, v in jcomm.items()} == \
        {k: v.shape for k, v in comm_state.items()}

    log1, rec1 = _logger("ctx_list_resume1")
    m2 = mt.FeedForward(_mlp(mt, 64, 2), ctx=_ctx(mt), num_epoch=3,
                        learning_rate=0.5)
    m2.fit(X, y, sharded_checkpoint_dir=d, logger=log1, **kw)
    assert any("resumed" in m and "ledger" in m for m in rec1), rec1
    # the adopted ledgers are the saved ones, before the third epoch ran
    log2, rec2 = _logger("ctx_list_resume2")
    m3 = mt.FeedForward(_mlp(mt, 64, 2), ctx=_ctx(mt), num_epoch=4,
                        learning_rate=0.5)
    m3.fit(X, y, sharded_checkpoint_dir=d, logger=log2,
           **{**kw, "overlap": 32768})
    assert any("dropped on resume" in m for m in rec2), rec2
    acc = (m3.predict(X, batch_size=32).argmax(axis=1) == y).mean()
    assert acc > 0.9


def test_fused_residual_checkpoint_resume(tmp_path):
    X, y = _blobs()
    d = str(tmp_path / "ckpt")
    m1 = mt.FeedForward(_mlp(mt, 64, 2), ctx=_ctx(mt), num_epoch=2,
                        learning_rate=0.5)
    m1.fit(X, y, batch_size=32, compression="int8",
           sharded_checkpoint_dir=d)
    *_, meta, _, comm_state = tckpt.load_sharded(d, 2, with_comm=True)
    assert set(comm_state) == {"__fused__"}
    assert comm_state["__fused__"].shape[0] == WORLD
    assert meta["comm_layout"].startswith("fused:")
    saved = comm_state["__fused__"]
    log1, rec1 = _logger("ctx_list_fused_resume")
    m2 = mt.FeedForward(_mlp(mt, 64, 2), ctx=_ctx(mt), num_epoch=2,
                        learning_rate=0.5)
    m2.fit(X, y, batch_size=32, compression="int8",
           sharded_checkpoint_dir=d, logger=log1)
    assert any("resumed fused EF residual" in m for m in rec1), rec1
    # nothing left to train: the adopted rows are the saved ones
    rows = m2._train_state.grad_sync.comm_state()[0]["__fused__"]
    assert np.array_equal(rows.numpy(), saved)


# --------------------------------------------------------------------------
# predict, score, aliases, kvstore, the user flow
# --------------------------------------------------------------------------

def test_predict_and_score_over_the_list():
    args, aux, X, Y = _data(small_net)
    outs = []
    for pkg in (mt, mx):
        wrap = mx.nd.array if pkg is mx else torch.from_numpy
        model = pkg.FeedForward(small_net(pkg), ctx=_ctx(pkg),
                                arg_params={k: wrap(v) for k, v in args.items()},
                                aux_params={k: wrap(v) for k, v in aux.items()})
        outs.append((model.predict(X, batch_size=8),
                     model.score(X, y=Y, eval_metric="ce", batch_size=8)))
    (p, s), (jp, js) = outs
    np.testing.assert_allclose(p, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s, js, rtol=1e-5)


def _one_batch_fit(ctx, args, aux, X, Y, **kw):
    model = mt.FeedForward(small_net(mt), ctx=ctx, num_epoch=EPOCHS,
                           arg_params={k: torch.from_numpy(v.copy())
                                       for k, v in args.items()},
                           aux_params={k: torch.from_numpy(v.copy())
                                       for k, v in aux.items()}, **FIT_KW)
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False), **kw)
    return model


@pytest.mark.parametrize("ctx", [[0, 0], [0, 8], [8]])
def test_aliases_of_one_device_train_as_one(ctx):
    """``[cpu(0), cpu(0)]`` and ``cpu(8)`` (8 % 8 host devices) are one
    device, as in the JAX package: the fit is bitwise ``ctx=cpu(0)``'s."""
    args, aux, X, Y = _data(small_net)
    one = _one_batch_fit(mt.cpu(0), args, aux, X, Y)
    got = _one_batch_fit([mt.cpu(i) for i in ctx], args, aux, X, Y)
    assert isinstance(got._train_state, tmodel._TrainState)
    for k in one.arg_params:
        assert torch.equal(got.arg_params[k], one.arg_params[k]), k
    for k in one.aux_params:
        assert torch.equal(got.aux_params[k], one.aux_params[k]), k
    assert len(got._replicas) == 1
    assert jmodel.FeedForward(small_net(mx), ctx=[mx.cpu(i) for i in ctx]
                              )._make_mesh(False) is None


def test_replica_keys_follow_the_host_device_count(monkeypatch):
    assert mt.cpu(9).replica_key == mt.cpu(1).replica_key == ("cpu", 1)
    assert mt.context.host_device_count() == 8
    monkeypatch.setenv("XLA_FLAGS", "")
    assert mt.context.host_device_count() == 1
    assert mt.cpu(3).replica_key == ("cpu", 0)
    assert len(mt.context.distinct_contexts(_ctx(mt))) == 1


def test_compression_ignored_on_one_device_after_aliases(caplog):
    args, aux, X, Y = _data(small_net)
    with caplog.at_level("INFO"):
        model = _one_batch_fit([mt.cpu(0), mt.cpu(8)], args, aux, X, Y,
                               compression="int8", comm_kernels=True)
    assert "compression=int8 ignored" in caplog.text
    assert model._train_state.grad_sync is None


def test_indivisible_batch_raises_as_jax_does():
    X = np.zeros((10, 16), np.float32)
    Y = np.zeros(10, np.float32)
    for pkg in (mt, mx):
        model = pkg.FeedForward(_mlp(pkg), ctx=_ctx(pkg), num_epoch=1)
        with pytest.raises(ValueError, match="should be divisible by 4, "
                                             "but it is equal to 10"):
            model.fit(X, Y, batch_size=10)


@pytest.mark.parametrize("kind,devices", [("local", 1), ("device", 1),
                                          ("local", 4), ("device", 4),
                                          (None, 4)])
def test_create_kvstore_rules_match_jax(kind, devices):
    got = tmodel._create_kvstore(kind, devices, mt.cpu())
    want = jmodel._create_kvstore(kind, devices, {})
    assert (got is None) == (want is None)
    if got is not None:
        assert got.type == want.type and got.num_workers == want.num_workers
        # pushes from several contexts aggregate (tests/test_kvstore.py)
        got.init(3, torch.ones(2, 3))
        got.push(3, [torch.ones(2, 3) for _ in range(devices)])
        out = torch.empty(2, 3)
        got.pull(3, out=out)
        assert torch.equal(out, torch.full((2, 3), float(devices)))


def test_multi_device_fit_converges():
    """tests/test_model.py:71-79 through the port."""
    rng = np.random.RandomState(0)
    centers = rng.uniform(-2, 2, (2, 10))
    X = np.concatenate([centers[c] + 0.3 * rng.randn(200, 10)
                        for c in range(2)]).astype(np.float32)
    y = np.repeat([0.0, 1.0], 200).astype(np.float32)
    order = rng.permutation(400)
    X, y = X[order], y[order]
    model = mt.FeedForward(_mlp(mt, 16, 2), ctx=_ctx(mt), num_epoch=6,
                           learning_rate=0.5)
    model.fit(X, y, batch_size=40, kvstore="device")
    acc = (model.predict(X, batch_size=40).argmax(axis=1) == y).mean()
    assert acc > 0.95, acc


def test_precompile_over_the_list_then_fit_compiles_nothing():
    """tests/test_comm_overlap.py:347-355 through the port: the replicas'
    program counted ahead, none at fit."""
    X, y = _blobs(120)
    model = mt.FeedForward(_mlp(mt, 64, 2), ctx=_ctx(mt), num_epoch=2,
                           learning_rate=0.5)
    out = model.precompile(data_shapes={"data": (40, 10)},
                           label_shapes={"softmax_label": (40,)},
                           compression="int8", overlap=8192)
    assert out["programs"] == 1
    with tcm.RecompileTracker(raise_on_recompile=True):
        model.fit(X, y, batch_size=40, compression="int8", overlap=8192)


def test_dist_kvstore_across_workers_with_a_list_raises():
    model = mt.FeedForward(_mlp(mt), ctx=_ctx(mt), num_epoch=1)

    class _World(mt.kv.KVStore):
        num_workers = 2

    with pytest.raises(mt.base.MXNetError, match="one process a device"):
        model.fit(np.zeros((8, 16), np.float32), np.zeros(8, np.float32),
                  batch_size=8, kvstore=_World("dist_sync"))
