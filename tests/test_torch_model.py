"""FeedForward through the port against the JAX package's: training from the
same weights and batches, checkpoints and ``.params`` files across the two
packages, and the digits MLP to accuracy.

Tolerances for the fit comparison (small ResNet, batch 4, Adam with the
fused step, 3 steps, lr 0.01): per-step cross-entropy within 1e-4 relative;
parameters within 3e-4 absolute (3% of one step's size); running stats within
1e-4. Adam runs with ``epsilon=1e-3`` here. With the default 1e-8 a
direction the network cannot see (the beta of a BatchNorm whose every
consumer is a 1x1 convolution into another BatchNorm) has a gradient that is
zero up to rounding, |g| ~ 1e-8, and Adam scales that noise to a step of
±lr whose sign differs between any two summation orders: XLA's and ATen's
disagree on it in a quarter of such channels. A larger epsilon keeps the
noise from being scaled up and leaves the real gradients' steps at lr.
"""

import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

NARROW = dict(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
              num_classes=10)


def _per_step_ce(pkg, model, X, Y, batch_size, **fit_kw):
    """Fit one epoch without shuffling; return each step's mean
    cross-entropy of its training-mode outputs."""
    sums = []
    model.fit(pkg.io.NDArrayIter(X, Y, batch_size=batch_size, shuffle=False),
              eval_metric="ce", batch_end_callback=lambda p: sums.append(
                  p.eval_metric.sum_metric), **fit_kw)
    return np.diff([0.0] + sums) / batch_size


def _both_models(js, ts, args, aux, **kw):
    jm = mx.FeedForward(js, ctx=mx.cpu(), num_epoch=1,
                        arg_params={k: mx.nd.array(v) for k, v in args.items()},
                        aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                        **kw)
    tm = mt.FeedForward(ts, ctx=mt.cpu(), num_epoch=1, arg_params=args,
                        aux_params=aux, **kw)
    return jm, tm


def test_fit_fused_adam_resnet_matches_jax():
    js, ts = jmodels.resnet(**NARROW), tmodels.resnet(**NARROW)
    args, aux = random_params(ts, 0, data=(4, 3, 32, 32))
    rng = np.random.default_rng(1)
    X = rng.standard_normal((12, 3, 32, 32)).astype(np.float32)
    Y = rng.integers(0, 10, 12).astype(np.float32)
    jm, tm = _both_models(js, ts, args, aux, optimizer="adam", fused=True,
                          learning_rate=0.01, epsilon=1e-3)
    launches = mt.optimizer.fused_adam.launches
    ce_j = _per_step_ce(mx, jm, X, Y, 4)
    ce_t = _per_step_ce(mt, tm, X, Y, 4)
    assert mt.optimizer.fused_adam.launches == launches  # CPU: plain version
    assert tm._optimizer_obj._fused_active()
    np.testing.assert_allclose(ce_t, ce_j, rtol=1e-4)
    for k in args:
        np.testing.assert_allclose(tm.arg_params[k].numpy(),
                                   jm.arg_params[k].asnumpy(), rtol=0,
                                   atol=3e-4, err_msg=k)
        assert not np.array_equal(tm.arg_params[k].numpy(), args[k]), k
    for k in aux:
        np.testing.assert_allclose(tm.aux_params[k].numpy(),
                                   jm.aux_params[k].asnumpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    # the caller's arrays are not written by the in-place update
    fresh, _ = random_params(ts, 0, data=(4, 3, 32, 32))
    for k in args:
        np.testing.assert_array_equal(args[k], fresh[k])


@pytest.mark.parametrize("optimizer,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4)),
    ("adamw", dict(learning_rate=0.01, weight_decay=0.1, epsilon=1e-3,
                   decay_filter=lambda n: n.endswith("weight"))),
])
def test_fit_mlp_per_leaf_optimizers_match_jax(optimizer, kw):
    """The per-leaf paths, with a learning-rate schedule taken in the JAX
    package's order (lr before num_update)."""
    js, ts = jmodels.mlp(), tmodels.mlp()
    args, aux = random_params(ts, 2, data=(8, 64))
    rng = np.random.default_rng(3)
    X = rng.standard_normal((40, 64)).astype(np.float32)
    Y = rng.integers(0, 10, 40).astype(np.float32)
    jm, tm = _both_models(
        js, ts, args, aux, optimizer=optimizer,
        lr_scheduler=mx.lr_scheduler.FactorScheduler(2, 0.5, kw["learning_rate"]),
        **kw)
    tm.kwargs["lr_scheduler"] = mt.lr_scheduler.FactorScheduler(
        2, 0.5, kw["learning_rate"])
    np.testing.assert_allclose(_per_step_ce(mt, tm, X, Y, 8),
                               _per_step_ce(mx, jm, X, Y, 8), rtol=1e-5)
    for k in args:
        np.testing.assert_allclose(tm.arg_params[k].numpy(),
                                   jm.arg_params[k].asnumpy(), rtol=1e-5,
                                   atol=2e-6, err_msg=k)


def _digits():
    from sklearn.datasets import load_digits

    d = load_digits()
    X = (d.data / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    order = np.random.RandomState(0).permutation(len(y))
    X, y = X[order], y[order]
    return X[:1500], y[:1500], X[1500:], y[1500:]


def test_digits_mlp_reaches_097_through_the_port():
    """The JAX package's digits bar (tests/test_train_digits.py) through
    the port: 40 epochs of SGD with momentum from a Xavier start."""
    X, y, Xv, yv = _digits()
    mt.random.seed(0)
    np.random.seed(0)  # fit shuffles array input with numpy's global RNG
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=40,
                           learning_rate=0.1, momentum=0.9,
                           initializer=mt.init.Xavier())
    model.fit(X, y, batch_size=50)
    acc = model.score(mt.io.NDArrayIter(Xv, yv, batch_size=50))
    assert acc >= 0.97, f"MLP val accuracy {acc:.4f} < 0.97"


def _lenet():
    """tests/test_train_digits.py's LeNet, built with the port's symbols."""
    net = tsym.Variable("data")
    for i, nf in enumerate((16, 32), start=1):
        net = tsym.Convolution(data=net, name=f"c{i}", kernel=(3, 3),
                               pad=(1, 1), num_filter=nf)
        net = tsym.Activation(data=net, name=f"a{i}", act_type="relu")
        net = tsym.Pooling(data=net, name=f"p{i}", kernel=(2, 2),
                           stride=(2, 2), pool_type="max")
    net = tsym.Flatten(data=net, name="flat")
    net = tsym.FullyConnected(data=net, name="fc1", num_hidden=64)
    net = tsym.Activation(data=net, name="a3", act_type="relu")
    net = tsym.FullyConnected(data=net, name="fc2", num_hidden=10)
    return tsym.SoftmaxOutput(data=net, name="softmax")


def test_digits_lenet_reaches_095_through_the_port():
    """The JAX package's LeNet bar (tests/test_train_digits.py): 40 epochs
    of SGD with momentum on the 8x8 scans."""
    X, y, Xv, yv = _digits()
    mt.random.seed(0)
    np.random.seed(0)
    model = mt.FeedForward(_lenet(), ctx=mt.cpu(), num_epoch=40,
                           learning_rate=0.1, momentum=0.9,
                           initializer=mt.init.Xavier())
    model.fit(X.reshape(-1, 1, 8, 8), y, batch_size=50)
    acc = model.score(mt.io.NDArrayIter(Xv.reshape(-1, 1, 8, 8), yv,
                                        batch_size=50))
    assert acc >= 0.95, f"LeNet val accuracy {acc:.4f} < 0.95"


DTYPES = [np.float32, np.float64, np.float16, np.uint8, np.int32, np.int8,
          np.int64, np.bool_]


def test_params_files_cross_both_ways(tmp_path):
    """The container, dtype codes and names cross both ways. Values are
    small integers so every dtype holds them exactly; JAX keeps 64-bit
    arrays as 32-bit (x64 off), so its reading of a file is the reference
    for what the file holds."""
    rng = np.random.default_rng(0)
    arrays = {f"a{i}": rng.integers(-50, 50, (3, 2)).astype(dt)
              for i, dt in enumerate(DTYPES)}
    arrays["a7"] = arrays["a7"] > 0
    arrays["a3"] = np.abs(arrays["a3"].astype(np.int64)).astype(np.uint8)
    arrays["scalar"] = np.array(2.5, np.float32)
    arrays["empty"] = np.zeros((0, 4), np.float32)
    # JAX writes, the port reads what JAX reads
    path = str(tmp_path / "j.params")
    mx.nd.save(path, {k: mx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()})
    want, got = mx.nd.load(path), mt.nd.load(path)
    assert list(got) == list(arrays)
    for k in arrays:
        np.testing.assert_array_equal(got[k].numpy(), want[k].asnumpy(), err_msg=k)
        assert got[k].numpy().dtype == want[k].asnumpy().dtype, k
        np.testing.assert_array_equal(got[k].numpy(), arrays[k], err_msg=k)
    # the port writes its own dtypes (a bfloat16 among them), JAX reads
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["bf16"] = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    mt.nd.save(str(tmp_path / "t.params"), tensors)
    back = mx.nd.load(str(tmp_path / "t.params"))
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v, err_msg=k)
    np.testing.assert_array_equal(back["bf16"].asnumpy().astype(np.float32),
                                  [1.5, -2.25, 3.0])
    mine = mt.nd.load(str(tmp_path / "t.params"))
    for k, v in tensors.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
    # lists, both ways
    mt.nd.save(str(tmp_path / "l.params"), [tensors["a0"], tensors["a4"]])
    lst = mx.nd.load(str(tmp_path / "l.params"))
    np.testing.assert_array_equal(lst[1].asnumpy(), arrays["a4"])
    assert len(mt.nd.load(str(tmp_path / "l.params"))) == 2


def _trained_mlp(tmp_path):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((37, 64)).astype(np.float32)
    Y = rng.integers(0, 10, 37).astype(np.float32)
    mt.random.seed(1)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=2,
                           optimizer="adam", fused=True, learning_rate=0.01,
                           initializer=mt.init.Xavier())
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=8))
    return model, X, Y


def test_checkpoints_serve_across_packages(tmp_path):
    """A checkpoint of the port's fit serves through the JAX package's
    ``Predictor.create``, and one of JAX's fit through the port's."""
    model, X, _ = _trained_mlp(tmp_path)
    prefix = str(tmp_path / "port")
    model.save(prefix)
    assert os.path.exists(f"{prefix}-0002.params.crc32")
    want = model.predict(X[:8])
    j_pred = mx.Predictor.create(prefix, 2, ctx=mx.cpu())
    np.testing.assert_allclose(j_pred.forward(data=X[:8]).get_output(0), want,
                               rtol=1e-5, atol=1e-6)
    t_pred = mt.Predictor.create(prefix, 2, ctx=mt.cpu())
    np.testing.assert_allclose(t_pred.forward(data=X[:8]).get_output(0), want,
                               rtol=1e-6, atol=1e-7)
    # the reverse: the JAX package trains and saves, the port serves
    jm = mx.FeedForward(jmodels.mlp(), ctx=mx.cpu(), num_epoch=1,
                        learning_rate=0.1, initializer=mx.init.Xavier())
    jm.fit(mx.io.NDArrayIter(X, np.zeros(37, np.float32), batch_size=8))
    jprefix = str(tmp_path / "jax")
    jm.save(jprefix)
    t_pred = mt.Predictor.create(jprefix, 1, ctx=mt.cpu())
    np.testing.assert_allclose(t_pred.forward(data=X[:8]).get_output(0),
                               jm.predict(X[:8]), rtol=1e-5, atol=1e-6)


def test_save_load_predict_score(tmp_path):
    model, X, Y = _trained_mlp(tmp_path)
    prefix = str(tmp_path / "m")
    model.save(prefix, epoch=3)
    loaded = mt.FeedForward.load(prefix, 3, ctx=mt.cpu())
    assert loaded.begin_epoch == 3
    for k, v in model.arg_params.items():
        torch.testing.assert_close(loaded.arg_params[k], v, rtol=0, atol=0)
    out = loaded.predict(X, batch_size=16)  # 37 rows: a padded tail batch
    assert out.shape == (37, 10)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(out, model.predict(X, batch_size=16))
    acc = float((out.argmax(1) == Y).mean())
    assert loaded.score(X, y=Y, batch_size=16) == pytest.approx(acc)
    assert loaded.score(mt.io.NDArrayIter(X, Y, batch_size=37)) == \
        pytest.approx(acc)
    with pytest.raises(MXNetError, match="labels"):
        loaded.score(X)
    # a torn params file fails its sidecar
    path = f"{prefix}-0003.params"
    with open(path, "r+b") as f:
        f.seek(20)
        f.write(b"\xff\xff")
    with pytest.raises(MXNetError, match="CRC"):
        mt.load_checkpoint(prefix, 3)


LATER = ["shard_audit"]


@pytest.mark.parametrize("arg", LATER)
def test_later_slice_fit_arguments_raise(arg):
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1)
    X = np.zeros((8, 64), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP A[0-9]"):
        model.fit(X, np.zeros(8, np.float32), batch_size=8, **{arg: True})
    assert model.arg_params is None  # raised before any work


def test_guarded_fit_runs():
    """``fit(guards=True)`` trains and leaves its counters; a NaN batch is
    skipped and the parameters stay finite."""
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.1)
    rng = np.random.RandomState(0)
    X = rng.randn(32, 64).astype(np.float32)
    X[9, 3] = np.nan  # the second of four batches
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=8,
              guards=True)
    assert model.guard_stats == {"skipped_steps": 1, "step_retries": 0,
                                 "loss_scale": 1.0}
    for v in model.arg_params.values():
        assert torch.isfinite(v).all()


@pytest.mark.parametrize("arg", ["telemetry", "health", "profile"])
def test_observability_fit_arguments_run(arg):
    """The observability arguments train and leave their handles."""
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.1)
    rng = np.random.RandomState(0)
    X = rng.randn(32, 64).astype(np.float32)
    kwargs = {arg: mt.telemetry.ProfileConfig(steps=1, warmup=1)
              if arg == "profile" else True}
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=8, **kwargs)
    handle = {"telemetry": model.telemetry,
              "health": model.health_monitor,
              "profile": model.profile_report}[arg]
    assert handle is not None
    if arg == "telemetry":
        assert len(handle.steps()) == 4
    elif arg == "health":
        assert set(handle.report()["layers"]) == {"fc1", "fc2", "fc3"}
    else:
        assert handle.steps == 1 and handle.coverage_pct > 50.0


def test_more_than_one_device_raises():
    """Two devices train as two replicas of one process; a batch they
    cannot split evenly raises as the JAX package's placement does."""
    model = mt.FeedForward(tmodels.mlp(), ctx=[mt.cpu(0), mt.cpu(1)],
                           num_epoch=1)
    with pytest.raises(ValueError, match="should be divisible by 2"):
        model.fit(np.zeros((9, 64), np.float32), np.zeros(9, np.float32),
                  batch_size=9)
    model.fit(np.zeros((8, 64), np.float32), np.zeros(8, np.float32),
              batch_size=8)
    assert len(model._train_state.members) == 2


def test_default_context_is_current_context():
    net = tmodels.mlp()
    with mt.cpu():
        assert mt.FeedForward(net).ctx == [mt.cpu()]
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA"):
            mt.FeedForward(net)


def test_epoch_callbacks_and_eval_data(tmp_path, caplog):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((32, 64)).astype(np.float32)
    Y = rng.integers(0, 10, 32).astype(np.float32)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=2,
                           learning_rate=0.05, initializer=mt.init.Xavier())
    prefix = str(tmp_path / "cb")
    seen = []
    with caplog.at_level(logging.INFO):
        model.fit(X, Y, batch_size=8, eval_data=(X, Y),
                  epoch_end_callback=[mt.callback.do_checkpoint(prefix),
                                      lambda e, *a: seen.append(e)],
                  batch_end_callback=mt.callback.Speedometer(8, 2))
    assert seen == [0, 1]
    assert os.path.exists(f"{prefix}-0002.params")
    assert "Validation-accuracy" in caplog.text and "Speed" in caplog.text


def test_fix_gamma_trains_with_zero_gamma_gradient():
    data = tsym.Variable("data")
    net = tsym.FullyConnected(data=data, name="fc", num_hidden=6)
    net = tsym.BatchNorm(data=net, name="bn", fix_gamma=True)
    net = tsym.SoftmaxOutput(data=net, name="softmax")
    rng = np.random.default_rng(2)
    X = rng.standard_normal((16, 5)).astype(np.float32)
    Y = rng.integers(0, 6, 16).astype(np.float32)
    model = mt.FeedForward(net, ctx=mt.cpu(), num_epoch=1, optimizer="adam",
                           fused=True, initializer=mt.init.Xavier())
    model.fit(mt.io.NDArrayIter(X, Y, batch_size=8))
    np.testing.assert_array_equal(model.arg_params["bn_gamma"].numpy(), 1.0)
    assert not np.array_equal(model.arg_params["bn_beta"].numpy(), 0.0)
