"""The analysis passes on the card (``-m cuda``; skipped without a card):
graph verification on a bind of CUDA tensors (bf16 reaching ``verify`` as
``torch.bfloat16``, a seeded conflict raising MX402), the program audit of
a bf16 training forward giving the CPU run's findings, with a copy from
the card to the host and a ``_Native`` node each one MX501, and the
sharding audit of the int8 and twobit exchanges between two replicas on
the card through the comm kernels: clean, int8's codes and scales a named
note, and each kernel launched. ``chip_smoke.py``'s phases ``verify``,
``program_audit`` and ``shard_audit`` run the same at ResNet-50's width.
Run on the card with
``python3 -m pytest tests/test_torch_analysis_card.py -m cuda -q``.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import comm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import comm_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _net():
    s = mt.sym
    x = s.Convolution(data=s.Variable("data"), num_filter=8, kernel=(3, 3),
                      pad=(1, 1), name="c1")
    x = s.BatchNorm(data=x, name="bn1")
    x = s.Activation(data=x, act_type="relu", name="r1")
    x = s.Pooling(data=x, kernel=(1, 1), global_pool=True, pool_type="avg",
                  name="gp")
    x = s.FullyConnected(data=s.Flatten(data=x), num_hidden=4, name="fc")
    return s.SoftmaxOutput(data=x, name="softmax")


def _bind(device, dtype):
    sym = _net()
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(4, 3, 16, 16))
    rng = np.random.default_rng(0)
    args = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device, dtype) for n, s in zip(sym.list_arguments(),
                                                arg_shapes)}
    aux = {n: torch.ones(s, device=device, dtype=dtype)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym.bind(mt.Context("gpu", 0) if device.type == "cuda"
                    else mt.cpu(), args, aux_states=aux)


def test_bind_on_the_card_verifies(cuda_device, monkeypatch):
    seen = []
    real = mt.symbol.Symbol.verify
    monkeypatch.setattr(mt.symbol.Symbol, "verify", lambda self, **k: (
        seen.append(k), real(self, **k))[1])
    monkeypatch.delenv("MXNET_TPU_VERIFY", raising=False)
    _bind(cuda_device, torch.bfloat16)
    (kw,) = seen
    assert set(kw["arg_dtypes"].values()) == {torch.bfloat16}
    net = mt.symbol.FullyConnected(data=mt.sym.Variable("data"),
                                   num_hidden=3, name="fc1")
    bad = {"data": torch.zeros(4, 5, device=cuda_device),
           "fc1_weight": torch.zeros(3, 9, device=cuda_device),
           "fc1_bias": torch.zeros(3, device=cuda_device)}
    with pytest.raises(MXNetError, match="MX402"):
        net.bind(mt.Context("gpu", 0), bad)


def test_program_audit_on_the_card_matches_the_cpu(cuda_device):
    card = tanalysis.audit_executor(_bind(cuda_device, torch.bfloat16),
                                    is_train=True,
                                    intended_dtype=torch.bfloat16)
    host = tanalysis.audit_executor(_bind(torch.device("cpu"),
                                          torch.bfloat16),
                                    is_train=True,
                                    intended_dtype=torch.bfloat16)
    assert [(f.rule.id, f.node) for f in card.findings] == \
        [(f.rule.id, f.node) for f in host.findings] == \
        [("MX502", "_to_copy")]
    assert card.totals["contraction_flops"] == \
        host.totals["contraction_flops"] > 0


def test_host_round_trips_on_the_card(cuda_device):
    x = torch.ones(64, device=cuda_device)
    rep = tanalysis.audit_program(lambda: (x * 2).cpu())
    assert [(f.rule.id, f.node) for f in rep.findings] == \
        [("MX501", "_to_copy")]

    class Twice(mt.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = 2 * in_data[0]

    net = Twice()(data=mt.sym.Variable("data"), name="twice")
    ex = net.bind(mt.Context("gpu", 0),
                  {"data": torch.ones(4, 3, device=cuda_device)})
    rep = tanalysis.audit_executor(ex)
    assert [(f.rule.id, f.node) for f in rep.findings] == [("MX501", "twice")]


@pytest.mark.parametrize("mode", ["int8", "twobit"])
def test_shard_audit_of_the_card_exchange(cuda_device, mode):
    members, size = 2, 1 << 20
    spec = comm.CompressionSpec.resolve(mode)
    group = comm.ReplicaGroup([cuda_device] * members)
    padded = comm.padded_flat_size(size, spec, members)
    flats = [torch.randn(padded, device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(m))
             for m in range(members)]
    kernels = comm.CommKernelConfig()
    for k in ck.KERNELS:
        k.launches = 0

    def step():
        comm.error_feedback_exchange([f.clone() for f in flats], spec,
                                     group=group, axis_size=members,
                                     kernels=kernels)
        torch.cuda.synchronize(cuda_device)

    rep = tanalysis.audit_step_program(
        step, plan=comm.allreduce_plan(size, members, mode),
        compression=mode)
    assert rep.findings == [], "\n".join(f.format() for f in rep.findings)
    assert rep.reconciliation["matched"]
    notes = {r["op"] for r in rep.reconciliation["notes"]}
    assert notes == ({"all-to-all", "all-gather"} if mode == "int8"
                     else set())
    launched = {k.__name__ for k in ck.KERNELS if k.launches}
    assert launched >= ({"quant_int8", "dequant_sum_int8", "dequant_int8"}
                        if mode == "int8"
                        else {"quant_twobit", "dequant_sum_twobit"})
