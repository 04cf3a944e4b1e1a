"""The card's cases of slice 19 (``-m cuda``; skipped without a card):
a captured guarded ResNet fit with a poisoned step bitwise the eager one,
and the kernel path's profiled exchange running no slab-sized quantize
pass as a torch operation. The guard's cost a step is measured at full
width by ``chip_smoke.py``'s phase ``guards``, against the JAX package's
5% (tests/test_resilience.py:269). Run on the card with
``python3 -m pytest tests/test_torch_resilience_card.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.resilience import chaos_scope

pytestmark = pytest.mark.cuda


def _by_op(rows):
    return {r["op"]: (r["payload_bytes"], r["wire_bytes"]) for r in rows}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _resnet_on_card():
    net = tmodels.resnet(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
                         num_classes=10)
    args, aux = random_params(net, 0, data=(8, 3, 32, 32))
    return mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1, optimizer="adam",
                          fused=True, learning_rate=0.01, arg_params=args,
                          aux_params=aux)


def test_captured_guarded_step_is_the_eager_one(cuda_device, monkeypatch):
    """A captured guarded ResNet fit, a NaN step among its steps, ends
    bitwise where the same fit run eager ends."""
    rng = np.random.RandomState(0)
    X = rng.randn(48, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 48).astype(np.float32)
    # cuDNN's deterministic algorithms in both runs: its default backward
    # convolutions may differ from run to run
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    out = {}
    for mode in ("captured", "eager"):
        if mode == "eager":
            monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "0")
        m = _resnet_on_card()
        with chaos_scope(seed=0, rules={"step.nan": {3}}):
            m.fit(mt.io.NDArrayIter(X, y, batch_size=8, shuffle=False),
                  guards=True)
        out[mode] = m
        assert m.guard_stats["skipped_steps"] == 1
    for k, v in out["eager"].arg_params.items():
        assert torch.equal(out["captured"].arg_params[k], v), k
    for k, v in out["eager"].aux_params.items():
        assert torch.equal(out["captured"].aux_params[k], v), k


def test_kernel_path_runs_no_slab_pass_on_the_card(cuda_device):
    """With the fused kernels the exchange's quantize stages are kernels:
    no slab-sized quantize pass runs as a torch operation; the codec path
    runs them."""
    from torch.profiler import ProfilerActivity, profile

    group = tcomm.ReplicaGroup(["cuda:0", "cuda:0"])
    spec = tcomm.CompressionSpec.resolve("int8")
    L = 1 << 20
    Lp = tcomm.padded_flat_size(L, spec, 2)
    passes = {}
    for kernels in (None, tcomm.CommKernelConfig()):
        flats = [torch.randn(Lp, device="cuda") for _ in range(2)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            tcomm.error_feedback_exchange(flats, spec, group=group,
                                          kernels=kernels)
            torch.cuda.synchronize()
        passes[kernels is not None] = tcomm.quantize_pass_count(prof, Lp)
        assert _by_op(tcomm.collective_table(prof)) == _by_op(
            tcomm.allreduce_plan(Lp, 2, spec)["collectives"])
    assert passes[True] == 0 and passes[False] > 0, passes
