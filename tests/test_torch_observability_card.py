"""The observability layer on the card (``-m cuda``; skipped without one):
the health statistics computed inside a captured training step are the
eager step's, bit for bit, and every captured program records a memory
plan whose temporaries are its graph pool. ``chip_smoke.py``'s
``telemetry`` phase holds the rest at ResNet-50's full width."""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.utils import compile as tcompile
from mxnet_tpu_torch.utils import memory as tutil

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    mt.set_matmul_precision("highest")
    return torch.device("cuda", 0)


def _mlp():
    s = mt.symbol
    h = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
    h = s.Activation(h, act_type="relu", name="relu1")
    h = s.FullyConnected(h, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(h, name="softmax")


def _card_fit(monkeypatch, graphs, opt):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1" if graphs else "0")
    rng = np.random.RandomState(0)
    X = rng.randn(128, 20).astype(np.float32)
    y = rng.randint(0, 4, 128).astype(np.float32)
    args, _ = random_params(_mlp(), 0, data=(32, 20))
    mt.random.seed(0)
    tt.reset()
    tcompile.reset_compile_stats()
    model = mt.FeedForward(_mlp(), ctx=mt.gpu(0), num_epoch=1,
                           arg_params=args, learning_rate=0.05, **opt)
    model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
              health=True)
    return tt.hub().events("health"), tcompile.compile_stats()


@pytest.mark.parametrize("opt", [dict(optimizer="adam", fused=True),
                                 dict(optimizer="sgd", momentum=0.9)])
def test_captured_health_step_bitwise_eager(cuda_device, monkeypatch, opt):
    eager, _ = _card_fit(monkeypatch, False, opt)
    captured, stats = _card_fit(monkeypatch, True, opt)
    assert stats["captures"] >= 1 and stats["replays"] >= 2
    assert len(eager) == len(captured) == 4
    for e, c in zip(eager, captured):
        assert c["loss"] == e["loss"]
        assert c["stats"] == e["stats"]  # floats compared exactly


def test_captured_programs_record_plans(cuda_device):
    tcompile.reset_compile_stats()
    rng = np.random.RandomState(0)
    X = rng.randn(64, 64).astype(np.float32)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.gpu(0), num_epoch=1)
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=16)
    model.predict(X, batch_size=16)
    plans = tcompile.memory_plans()
    train = [p for k, p in plans.items() if k.startswith("train_step")]
    evals = [p for k, p in plans.items() if k.startswith("eval_step")]
    assert train and evals
    for plan in train + evals:
        assert plan["temp_bytes"] > 0 and plan["argument_bytes"] > 0
        assert plan["total_bytes"] == plan["temp_bytes"] + \
            plan["output_bytes"]
    stats = tutil.memory_stats(cuda_device)["cuda:0"]
    assert stats["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated(0)
