"""The data-parallel step's gradients as views of one padded flat buffer
(``model._GradSync``): backward accumulates each gradient into its view of
the buffer, which is the error-feedback residual itself where the mode has
one, so the residual add happens in that accumulation and nothing is
flattened or unflattened by copy.

Held bitwise to what the tree form computes (``_flatten`` of the gradients,
padded, plus the residual: ``g + r`` and ``r + g`` are the same bits), on one
process: the buffer is filled by backward before any collective runs. The
exchange itself is held bitwise to the JAX package by
``tests/test_torch_comm.py::test_exchange_matches_jax`` and through ``fit``
by ``tests/test_torch_data_parallel.py``.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm
from mxnet_tpu_torch.comm.allreduce import _flatten, _pad_flat
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.model import _GradSync, _TrainState

torch.set_num_threads(1)


def _state(spec, net, args, workers=2):
    params = {k: torch.from_numpy(v.copy()) for k, v in args.items()}
    sync = _GradSync(comm.CompressionSpec.resolve(spec), None, params,
                     workers, torch.device("cpu"))
    opt = mt.optimizer.create("sgd", learning_rate=0.1)
    return _TrainState(net, opt, params, {}, torch.device("cpu"), sync=sync)


@pytest.mark.parametrize("spec", ["int8", "twobit", "bf16", None])
def test_backward_fills_the_flat_buffer_bitwise(spec):
    net = mt.models.mlp()
    args, _ = random_params(net, 0, data=(8, 64))
    rng = np.random.default_rng(1)
    batch = {"data": torch.from_numpy(rng.standard_normal((8, 64)).astype(
        np.float32)), "softmax_label": torch.arange(8.0) % 10}
    state = _state(spec, net, args)
    sync = state.grad_sync
    if sync.residual is not None:
        sync.residual.copy_(torch.from_numpy(rng.standard_normal(
            sync.residual.shape).astype(np.float32)) * 1e-3)
    residual = None if sync.residual is None else sync.residual.clone()
    # the plain step's gradients, by autograd of the same forward
    plain = _TrainState(net, mt.optimizer.create("sgd"), {
        k: torch.from_numpy(v.copy()) for k, v in args.items()}, {},
        torch.device("cpu"))
    plain.forward(batch)
    plain.backward()
    state.forward(batch)
    state.backward()
    flat, L = _flatten(plain.grads)[0], None
    if spec is not None:
        flat, L = _pad_flat(flat, sync.spec, 2)
    want = flat if residual is None else flat + residual[0]
    assert torch.equal(sync.flat, want)
    if residual is not None:
        assert sync.flat.data_ptr() == sync.residual.data_ptr()
    # every parameter's .grad is a view of the buffer, in _flatten's order
    base, off = sync.flat.data_ptr(), 0
    for k in sorted(args):
        p = state.params[k]
        assert p.grad.data_ptr() == base + 4 * off, k
        off += p.numel()


def test_flat_views_are_views_in_sorted_order():
    flat = torch.arange(20.0)
    views = comm.flat_views(flat, {"b": (2, 3), "a": (4,), "c": ()})
    assert list(views) == ["a", "b", "c"]
    assert torch.equal(views["a"], torch.arange(4.0))
    assert torch.equal(views["b"], torch.arange(4.0, 10.0).reshape(2, 3))
    assert views["c"].shape == () and float(views["c"]) == 10.0
    views["b"][1, 1] = -1.0
    assert float(flat[8]) == -1.0

