"""bf16 ``compute_dtype`` through ``FeedForward`` in the port against the
JAX package's ``FeedForward(compute_dtype=jnp.bfloat16)``, and the f32
contractions' precision setting.

Both packages cast the f32 master parameters and the data (never labels or
auxiliary states) to bf16, take BatchNorm statistics and the softmax in f32,
and sum the loss in f32. XLA on the CPU rounds elementwise chains at other
points than ATen (as for the LM's bf16, ``ROADMAP.md`` C.2), so bf16 results
differ by about a bf16 rounding of the activations, while f32 agrees to
1e-6. Bounds, small ResNet at batch 4, from the same seeded weights:

- ``predict``: the centred log-probabilities within 5e-3 relative Frobenius
  of the JAX package's bf16 ones (reading 2.2e-3; either package's bf16
  against its own f32 reads 1.0e-2), ``score`` equal.
- ``fit``, 3 SGD steps (lr 0.05, momentum 0.9): the first step's
  cross-entropy within 2e-3 relative of the JAX package's (reading 8.6e-4:
  one bf16 forward), the next two within 2e-2 (readings 5.0e-3, 6.8e-3:
  the updates carry each package's bf16 gradients). A leaf's bf16
  gradients at batch 4 are as noisy as its update is large, so each leaf is
  held by its distance from the f32 run: the port's bf16 leaf no farther
  from it than 2.5 times the JAX package's bf16 leaf (readings up to 1.84).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

NARROW = dict(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
              num_classes=10)
SGD = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9)


@pytest.fixture(scope="module")
def case():
    js, ts = jmodels.resnet(**NARROW), tmodels.resnet(**NARROW)
    args, aux = random_params(ts, 0, data=(4, 3, 32, 32))
    rng = np.random.default_rng(1)
    X = rng.standard_normal((12, 3, 32, 32)).astype(np.float32)
    Y = rng.integers(0, 10, 12).astype(np.float32)
    return js, ts, args, aux, X, Y


def _models(case, bf16, **kw):
    js, ts, args, aux, _, _ = case
    jm = mx.FeedForward(
        js, ctx=mx.cpu(), num_epoch=1, compute_dtype=jnp.bfloat16 if bf16
        else None, arg_params={k: mx.nd.array(v) for k, v in args.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()}, **kw)
    tm = mt.FeedForward(ts, ctx=mt.cpu(), num_epoch=1, arg_params=args,
                        aux_params=aux,
                        compute_dtype=torch.bfloat16 if bf16 else None, **kw)
    return jm, tm


def _per_step_ce(pkg, model, X, Y):
    sums = []
    model.fit(pkg.io.NDArrayIter(X, Y, batch_size=4, shuffle=False),
              eval_metric="ce", batch_end_callback=lambda p: sums.append(
                  p.eval_metric.sum_metric))
    return np.diff([0.0] + sums) / 4


def _centred_log(p):
    lp = np.log(p.astype(np.float64))
    return lp - lp.mean(axis=1, keepdims=True)


def _rel_fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_predict_and_score_in_bf16_match_jax(case):
    X, Y = case[4], case[5]
    jm, tm = _models(case, bf16=True)
    got, want = tm.predict(X, batch_size=4), jm.predict(X, batch_size=4)
    assert got.dtype == np.float32 and got.shape == (12, 10)
    assert _rel_fro(_centred_log(got), _centred_log(want)) < 5e-3
    f32 = _models(case, bf16=False)[1].predict(X, batch_size=4)
    # bf16 really ran: its distance from f32 is a bf16 rounding's
    assert _rel_fro(_centred_log(got), _centred_log(f32)) > 1e-3
    assert tm.score(X, y=Y, batch_size=4) == jm.score(X, y=Y, batch_size=4)


def test_fit_in_bf16_tracks_jax(case):
    js, ts, args, aux, X, Y = case
    jm, tm = _models(case, bf16=True, **SGD)
    ce_j, ce_t = _per_step_ce(mx, jm, X, Y), _per_step_ce(mt, tm, X, Y)
    rel = np.abs(ce_t - ce_j) / ce_j
    assert rel[0] < 2e-3 and (rel[1:] < 2e-2).all(), rel
    jm32, tm32 = _models(case, bf16=False, **SGD)
    ce_j32 = _per_step_ce(mx, jm32, X, Y)
    # f32 masters: the trained parameters stay f32, auxiliary states too
    for k, v in {**tm.arg_params, **tm.aux_params}.items():
        assert v.dtype == torch.float32, k
    for k in args:
        ref = jm32.arg_params[k].asnumpy()
        port = np.abs(tm.arg_params[k].numpy() - ref).max()
        jax_ = np.abs(jm.arg_params[k].asnumpy() - ref).max()
        assert port <= 2.5 * jax_, (k, port, jax_)
        assert not np.array_equal(tm.arg_params[k].numpy(), args[k]), k
    for k in aux:
        assert np.isfinite(tm.aux_params[k].numpy()).all()
    assert not np.allclose(ce_j, ce_j32, rtol=1e-4)  # bf16 really ran


def test_compute_dtype_must_be_floating(case):
    ts = case[1]
    with pytest.raises(MXNetError, match="floating"):
        mt.FeedForward(ts, ctx=mt.cpu(), compute_dtype=torch.int32)


def test_only_data_is_cast():
    """Labels go in as given, and auxiliary states in f32: the training
    forward of a bf16 FeedForward sees bf16 data and parameters only."""
    from mxnet_tpu_torch.model import _TrainState

    net = tmodels.mlp()
    args, aux = random_params(net, 0, data=(4, 64))
    seen = {}
    state = _TrainState(net, mt.optimizer.create("sgd"),
                        {k: torch.from_numpy(v) for k, v in args.items()},
                        {}, torch.device("cpu"),
                        compute_dtype=torch.bfloat16, data_names=["data"])
    fn = state.graph_fn

    def spy(values, aux_values, rng=None, mask=None):
        seen.update({k: v.dtype for k, v in values.items()})
        return fn(values, aux_values, rng, mask)

    state.graph_fn = spy
    outs = state.forward({"data": torch.ones(4, 64),
                          "softmax_label": torch.arange(4.0)})
    assert seen.pop("softmax_label") == torch.float32
    assert set(seen.values()) == {torch.bfloat16}
    assert outs[0].dtype == torch.bfloat16
    state.backward()
    assert all(g.dtype == torch.float32 for g in state.grads.values())


@pytest.mark.parametrize("value,tf32", [
    ("highest", False), ("float32", False), ("default", True),
    ("high", True), ("tensorfloat32", True), ("HIGHEST", False)])
def test_matmul_precision_moves_both_flags(value, tf32):
    try:
        mt.set_matmul_precision(value)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert mt.get_matmul_precision() == value.lower()
    finally:
        mt.set_matmul_precision("highest")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert mt.get_matmul_precision() == "highest"


def test_matmul_precision_rejects_unknown_values():
    with pytest.raises(ValueError, match="unknown matmul precision"):
        mt.set_matmul_precision("bfloat16")
    assert mt.get_matmul_precision() == "highest"


def test_matmul_precision_default_at_import():
    """A fresh process that imports the package has TF32 on for both, as
    the JAX package leaves its backend's default."""
    import os
    import subprocess
    import sys

    code = ("import torch, mxnet_tpu_torch as mt; "
            "print(mt.get_matmul_precision(), "
            "torch.backends.cuda.matmul.allow_tf32, "
            "torch.backends.cudnn.allow_tf32)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=root)
    assert out.stdout.split() == ["default", "True", "True"]
