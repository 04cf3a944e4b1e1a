"""The card's case of the elastic fit (``-m cuda``; skipped without a
card): a world of three aliased replicas on one card (``[gpu(0)] * 3``,
one rank an entry) shrunk to two and grown back, with fused Adam and the
int8 exchange's kernels. Each world launches ``fused_adam`` and the int8
comm kernels, a regrow captures nothing (replica steps run eager), and
the card's memory after the regrow is within 5% of what it was before the
kill: the departed replica's tensors were freed. ``chip_smoke.py``'s
phase ``elastic`` runs the same at the full width of ResNet-50. Run on
the card with
``python3 -m pytest tests/test_torch_elastic_card.py -m cuda -q``.
"""

import gc

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.kernels import comm_kernels as ck
from mxnet_tpu_torch.kernels import fused_adam as kfa
from mxnet_tpu_torch.resilience import ElasticCoordinator
from mxnet_tpu_torch.utils import compile as tcm

pytestmark = pytest.mark.cuda

KERNELS = {"fused_adam": kfa.fused_adam,
           **{k.__name__: k for k in ck.KERNELS}}
INT8_PATH = ("fused_adam", "quant_int8", "dequant_sum_int8", "dequant_int8")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _mlp():
    s = mt.sym
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=512)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=10)
    return s.SoftmaxOutput(data=net, name="softmax")


def test_aliased_world_shrinks_and_regrows(cuda_device, tmp_path):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((8 * 48, 256)).astype(np.float32)
    y = rng.integers(0, 10, 8 * 48).astype(np.float32)
    args, _ = random_params(_mlp(), 0, data=(48, 256))
    co = ElasticCoordinator(3)
    by_world, memory = {}, []
    last = {n: 0 for n in KERNELS}

    def watch(param):
        gc.collect()  # reachable bytes only
        torch.cuda.synchronize()
        now = {n: k.launches for n, k in KERNELS.items()}
        got = by_world.setdefault(co.world_size, {n: 0 for n in KERNELS})
        for n in KERNELS:
            got[n] += now[n] - last[n]
        last.update(now)
        memory.append((co.resizes, co.world_size,
                       torch.cuda.memory_allocated(cuda_device)))
        if param.epoch == 1 and param.nbatch == 3 and co.resizes == 0:
            co.kill()
        if param.epoch == 2 and param.nbatch == 3 and co.resizes == 1:
            co.join_all()

    m = mt.FeedForward(_mlp(), ctx=[mt.gpu(0)] * 3, num_epoch=4,
                       optimizer="adam", fused=True, learning_rate=1e-3,
                       arg_params={k: torch.from_numpy(v)
                                   for k, v in args.items()})
    for k in KERNELS.values():
        k.launches = 0
    before = tcm.compile_stats()
    m.fit(mt.io.NDArrayIter(X, y, batch_size=48, shuffle=False),
          batch_size=48, elastic=co, compression="int8", comm_kernels=True,
          batch_end_callback=watch,
          sharded_checkpoint_dir=str(tmp_path / "ckpt"))
    assert co.resizes == 2 and [h["to"] for h in co.history] == [2, 3]
    assert all(h["downtime_s"] > 0 for h in co.history)
    assert len(m._train_state.members) == 3
    for world in (3, 2):
        for name in INT8_PATH:
            assert by_world[world][name] > 0, (world, name, by_world)
    assert tcm.compile_stats()["captures"] == before["captures"]
    assert m._train_state.programs == {}
    pre_kill = [b for r, w, b in memory if r == 0][-1]
    regrown = [b for r, w, b in memory if r == 2][-1]
    assert abs(regrown - pre_kill) <= 0.05 * pre_kill, memory
    assert all(np.isfinite(v.numpy()).all() for v in m.arg_params.values())
