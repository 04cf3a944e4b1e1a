"""Data-parallel training through the port across gloo CPU ranks: the
reference's dist_sync closed form through the kvstore, the
``make_data_parallel_step`` helper, and ``FeedForward.fit(kvstore=
"dist_sync", compression=..., comm_kernels=True)`` on two ranks against the
JAX package's ``FeedForward(ctx=[cpu(0), cpu(1)])`` over a dp=2 mesh.

The fit comparison feeds both the same parameters and the same rows without
shuffling: rank r of the port trains on the rows the mesh gives device r,
and both take ``rescale_grad = 1/global batch``. Each step runs the int8
kernel path, which the exchange tests hold bitwise to the JAX kernel path
(tests/test_torch_comm.py); the forward and backward sum in other orders
(ATen's against XLA's), so a gradient element on a quantization boundary
can move by one step. Tolerances: per-step cross-entropy within 1e-5
relative; parameters within 2e-4 absolute after each step (a fiftieth of
one Adam step of lr 0.01; readings: 4.0e-5 after the third int8 step, 6e-8
before it); running stats within 1e-5 relative (readings 2.4e-7). The
ranks' parameters are bitwise equal to each other after every step.

Every multi-rank run is one spawn under a time limit
(``torch_ranks.run_ranks``).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.parallel import grad_accum
from torch_ranks import (data_parallel_steps, fit_dist_sync,
                         kvstore_closed_form, run_ranks, small_net)

torch.set_num_threads(1)

WORLD = 2
BATCH = 16          # global: 8 rows a rank
EPOCHS = 3          # one batch an epoch: one step each
FIT_KW = dict(optimizer="adam", fused=True, learning_rate=0.01, epsilon=1e-3)


def test_dist_sync_kvstore_closed_form(tmp_path):
    """examples/distributed/dist_sync_kvstore.py: every rank pushes
    rank + 1 and pulls 1 + 2 = 3; the store joins the world from the
    MXTPU_* variables."""
    results = run_ranks(kvstore_closed_form, WORLD, tmp_path, join=False)
    for rank, res in enumerate(results):
        assert res["rank"] == rank and res["num_workers"] == WORLD
        for out in res["keys"]:
            np.testing.assert_array_equal(out, np.full((4, 4), 3.0))
        np.testing.assert_array_equal(res["big"], np.full((1200,), 3.0))


def test_kvstore_local_and_later_types():
    kv = mt.kv.create("local")
    kv.init(3, torch.ones(2, 2))
    kv.push(3, [torch.ones(2, 2), torch.ones(2, 2) * 2])
    out = torch.empty(2, 2)
    kv.pull(3, out=out)
    assert torch.equal(out, torch.full((2, 2), 3.0))
    assert kv.rank == 0 and kv.num_workers == 1
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init(3, torch.ones(2, 2))
    # an optimizer as the updater: push applies an SGD step to the store
    kv.set_optimizer(mt.optimizer.create("sgd", learning_rate=0.5))
    kv.push(3, torch.ones(2, 2))
    kv.pull(3, out=out)
    assert torch.equal(out, torch.full((2, 2), 2.5))
    # no process group and no MXTPU_* variables: one rank
    one = mt.kv.create("dist_sync", ctx=mt.cpu())
    assert one.num_workers == 1 and one.rank == 0
    with pytest.raises(MXNetError, match="bf16"):
        one.set_gradient_compression("int8")
    assert one.set_gradient_compression({"type": "bf16"}).mode == "bf16"
    # the three calls A4 brought: each works now
    one.init(4, torch.zeros(3))
    one.push_bucketed({4: torch.tensor([1.0, 2.0, 1.0 + 2 ** -10])})
    got = torch.empty(3)
    one.pull(4, out=got)  # bf16 on the wire: 1 + 2^-10 rounds to 1
    assert torch.equal(got, torch.tensor([1.0, 2.0, 1.0]))
    group = mt.kv.create_group(2)
    assert [w.rank for w in group] == [0, 1] and \
        group[0].num_workers == 2
    async_kv = mt.kv.create("dist_async")
    try:
        assert async_kv.type == "dist_async" and async_kv.num_workers == 1
    finally:
        async_kv.close()


def test_kvstore_join_failure_raises(monkeypatch, tmp_path):
    """A world the variables describe but that cannot be joined raises; it
    does not go on as one process (unlike kvstore.py:202-204)."""
    monkeypatch.setenv("MXTPU_COORDINATOR", "bogus://nowhere")
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_WORKER_RANK", "0")
    with pytest.raises(MXNetError, match="failed"):
        mt.kv.create("dist_sync", ctx=mt.cpu())


# --------------------------------------------------------------------------
# make_data_parallel_step
# --------------------------------------------------------------------------

def _lsq(seed=0, rows=16, dim=6):
    rng = np.random.RandomState(seed)
    w0 = {"w": rng.randn(dim, 1).astype(np.float32),
          "b": np.zeros(1, np.float32)}
    X = rng.randn(rows, dim).astype(np.float32)
    Y = (X @ rng.randn(dim, 1) + 0.1).astype(np.float32)
    return w0, X, Y


def _full_batch_sgd(w0, X, Y, steps):
    """The same SGD on the whole batch in one process, in float64."""
    w, b = w0["w"].astype(np.float64), w0["b"].astype(np.float64)
    out = []
    for _ in range(steps):
        r = X @ w + b - Y
        gw, gb = 2 * X.T @ r / len(X), 2 * r.sum(0) / len(X)
        out.append(float((r ** 2).mean()))
        w, b = w - 0.1 * gw, b - 0.1 * gb
    return out, {"w": w, "b": b}


@pytest.mark.parametrize("compression,n_micro,overlap", [
    (None, 1, None), (None, 2, None), ("bf16", 1, None), ("int8", 1, None),
    ({"type": "2bit", "threshold": 0.05}, 1, None), ("int8", 1, 8),
    ("bf16", 2, 8)], ids=[
    "none", "none-micro2", "bf16", "int8", "twobit", "int8-overlap",
    "bf16-micro2-overlap"])
def test_make_data_parallel_step(tmp_path, compression, n_micro, overlap):
    """Two ranks with half the rows each train like one process with all of
    them: up to f32 rounding without compression, within the codec's error
    with bf16 and int8 (error feedback carries what it drops), bucket by
    bucket with ``overlap`` (a cap of 8 bytes: w and b apart, each with its
    own residual). twobit moves each weight by ±0.05 steps, which is no
    SGD: its ranks agree and its loss falls."""
    w0, X, Y = _lsq()
    results = run_ranks(data_parallel_steps, WORLD, tmp_path, w0, X, Y,
                        compression, 4, n_micro, overlap)
    losses, final = _full_batch_sgd(w0, X, Y, 4)
    for res in results[1:]:
        for a, b in zip(res["params"], results[0]["params"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert res["losses"] == results[0]["losses"]
    np.testing.assert_allclose(results[0]["losses"][0], losses[0], rtol=1e-5)
    assert results[0]["losses"][-1] < results[0]["losses"][0]
    if isinstance(compression, dict):
        return
    tol = {None: 1e-5, "bf16": 1e-2, "int8": 2e-2}[compression]
    for k in final:
        np.testing.assert_allclose(results[0]["params"][-1][k], final[k],
                                   rtol=tol, atol=tol)


def test_grad_accum_is_the_mean_over_microbatches():
    rng = np.random.RandomState(1)
    params = {"w": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}
    batch = {"x": torch.from_numpy(rng.randn(8, 4).astype(np.float32))}

    def loss_fn(p, b):
        return (b["x"] @ p["w"]).pow(2).mean()

    loss, grads = grad_accum(loss_fn, params, batch, 4)
    leaf = params["w"].clone().requires_grad_(True)
    full = loss_fn({"w": leaf}, batch)
    (g,) = torch.autograd.grad(full, [leaf])
    torch.testing.assert_close(loss, full.detach(), rtol=1e-6, atol=0)
    torch.testing.assert_close(grads["w"], g, rtol=1e-5, atol=1e-7)


def test_make_data_parallel_step_needs_a_group_and_no_overlap():
    """A process group is needed, with or without ``overlap`` (which is
    now ported: it no longer raises NotImplementedError)."""
    for overlap in (None, True):
        with pytest.raises(MXNetError, match="process group"):
            mt.parallel.make_data_parallel_step(None, None,
                                                compression="int8",
                                                overlap=overlap)
    with pytest.raises(MXNetError, match="process group"):
        mt.parallel.make_data_parallel_step(None, None)


# --------------------------------------------------------------------------
# FeedForward.fit(kvstore="dist_sync") against the JAX package on a mesh
# --------------------------------------------------------------------------

def _data(seed=4):
    net = small_net(mt)
    args, aux = random_params(net, seed, data=(BATCH, 16))
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((BATCH, 16)).astype(np.float32)
    Y = rng.integers(0, 10, BATCH).astype(np.float32)
    return args, aux, X, Y


def _jax_fit(args, aux, X, Y, fit_kw):
    epochs, sums = [], []
    jm = mx.FeedForward(
        small_net(mx), ctx=[mx.cpu(0), mx.cpu(1)], num_epoch=EPOCHS,
        arg_params={k: mx.nd.array(v) for k, v in args.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()}, **FIT_KW)
    jm.fit(mx.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False),
           eval_metric="ce",
           epoch_end_callback=lambda e, s, a, x: epochs.append(
               ({k: v.asnumpy() for k, v in a.items()},
                {k: v.asnumpy() for k, v in x.items()})),
           batch_end_callback=lambda p: sums.append(p.eval_metric.sum_metric),
           **fit_kw)
    return epochs, sums


_FITS = {}


@pytest.fixture(scope="module", params=["int8", "twobit", "none"])
def fits(request, tmp_path_factory):
    """Both packages' 3 steps with the comm kernels, once per mode. Without
    compression the JAX step is the partitioned one, BatchNorm over both
    devices' rows, which the ranks hold to through
    ``ops.nn.batch_statistics_over``."""
    mode = request.param
    if mode not in _FITS:
        args, aux, X, Y = _data()
        fit_kw = dict(compression=mode, comm_kernels=True)
        port = run_ranks(fit_dist_sync, WORLD,
                         tmp_path_factory.mktemp(f"fit_{mode}"), args, aux,
                         X, Y, EPOCHS, fit_kw, FIT_KW)
        _FITS[mode] = (args, aux, port, _jax_fit(args, aux, X, Y, fit_kw))
    return (mode,) + _FITS[mode]


def test_fit_loss_tracks_jax(fits):
    mode, args, aux, port, (_, jsums) = fits
    # each epoch is one step: the metric's sum after it is that step's
    ce_port = np.sum([r["ce_sums"] for r in port], axis=0) / BATCH
    ce_jax = np.asarray(jsums) / BATCH
    np.testing.assert_allclose(ce_port, ce_jax, rtol=1e-5)
    assert ce_port[-1] < ce_port[0]


def test_fit_params_track_jax_each_step(fits):
    mode, args, aux, port, (jepochs, _) = fits
    for step, (jargs, jaux) in enumerate(jepochs):
        targs, taux = port[0]["epochs"][step]
        for k in args:
            np.testing.assert_allclose(targs[k], jargs[k], rtol=0, atol=2e-4,
                                       err_msg=f"{mode} step {step} {k}")
        for k in aux:
            np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"{mode} step {step} {k}")
    # fc1's bias feeds a BatchNorm, which removes it: its gradient is
    # rounding noise that quantizes to zero, so only the rest must move
    for k in args:
        if k != "fc1_bias":
            assert not np.array_equal(port[0]["epochs"][-1][0][k], args[k]), k


def test_fit_ranks_hold_bitwise_equal_params(fits):
    _, args, aux, port, _ = fits
    for step in range(EPOCHS):
        for part in (0, 1):
            a, b = port[0]["epochs"][step][part], port[1]["epochs"][step][part]
            for k in a:
                assert np.array_equal(a[k].view(np.uint32),
                                      b[k].view(np.uint32)), (step, k)


def test_fit_rescale_residual_and_wire_plan(fits):
    mode, args, aux, port, _ = fits
    n = sum(v.size for v in args.values())
    spec = mt.comm.CompressionSpec.resolve(mode)
    plan = mt.comm.allreduce_plan(n, WORLD, spec)
    for res in port:
        assert res["rescale_grad"] == 1.0 / BATCH
        stats = res["stats"]
        assert stats["steps"] == EPOCHS
        assert stats["wire_bytes"] == EPOCHS * plan["wire_bytes"]
        if spec is None:
            assert res["residual"] is None
            continue
        assert res["residual"].shape == (
            1, mt.comm.padded_flat_size(n, spec, WORLD))
        assert np.isfinite(res["residual"]).all() and res["residual"].any()
    # each rank's residual is its own
    if spec is not None:
        assert not np.array_equal(port[0]["residual"], port[1]["residual"])


def test_fit_compression_ignored_on_one_rank(caplog):
    args, aux, X, Y = _data()
    model = mt.FeedForward(small_net(mt), ctx=mt.cpu(), num_epoch=1,
                           arg_params=args, aux_params=aux, **FIT_KW)
    with caplog.at_level("INFO"):
        model.fit(X, Y, batch_size=8, kvstore="dist_sync",
                  compression="int8", comm_kernels=True)
    assert "compression=int8 ignored" in caplog.text
    assert model._train_state.grad_sync is None
