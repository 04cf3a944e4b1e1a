"""The port's measurement tools (``mxnet_tpu_torch/tools/bench_*.py``,
``scaling_projection.py``, ``_bench.py``) against the JAX package's under
``tools/`` and ``bench.py``, on the CPU, on the same seeded numpy inputs.

The JAX tools are imported as ``tests/test_roofline_tool.py`` imports
them, with ``tools/`` and the repository's root on ``sys.path``. What only
the card can give (a time, a rate) is not tested here: every timed entry
raises naming CUDA where there is none, and
``tests/test_torch_bench_tools_card.py`` runs each tool on the card.
"""

import ast
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import transformer_params_from_numpy
from mxnet_tpu_torch.tools import (_bench, bench_flash, bench_io_scaling,
                                   bench_longctx, bench_mnist, bench_roofline,
                                   scaling_projection)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402
import bench_flash as jflash  # noqa: E402
import bench_io_scaling as jio  # noqa: E402
import bench_longctx as jlongctx  # noqa: E402
import bench_mnist as jmnist  # noqa: E402
import bench_roofline as jroof  # noqa: E402
import scaling_projection as jscaling  # noqa: E402

torch.set_num_threads(1)
TOOLS = ("bench_flash", "bench_longctx", "bench_mnist", "bench_roofline",
         "bench_io_scaling", "scaling_projection")


# -- bench_flash ---------------------------------------------------------------

@pytest.mark.parametrize("combo", bench_flash.sweep() + bench_flash.sweep(
    quick=True), ids=lambda c: f"b{c[0]}h{c[1]}s{c[2]}d{c[3]}"
    f"{'c' if c[5] else 'n'}{str(c[4])[-4:]}")
def test_flash_flop_count_is_the_jax_tools(combo, monkeypatch):
    """Each sweep entry's forward and forward+backward FLOPs are the JAX
    tool's: its ``bench_config`` with its timer stubbed to 1e-12 s gives
    TF/s equal to the FLOPs, within the two divisions' rounding (relative
    1e-12)."""
    batch, heads, seq, d, dtype, causal = combo
    monkeypatch.setattr(jflash, "_timeit_chained",
                        lambda *a, **k: 1e-12)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rec = jflash.bench_config(batch * heads, seq, d, 512, 1024, jdtype,
                              causal)
    fwd, fwdbwd = bench_flash.flops(batch, heads, seq, d, causal)
    assert rec["fwd_tflops"] == pytest.approx(fwd, rel=1e-12)
    assert rec["fwdbwd_tflops"] == pytest.approx(fwdbwd, rel=1e-12)


def test_flash_sweep_covers_every_configuration():
    """head_dim 64 and 128, causal and not, bf16 and f32 at B*H 4 and
    16,384, then the LM's attention; each schedule derives its launches."""
    combos = bench_flash.sweep()
    assert {(c[3], c[4], c[5]) for c in combos[:-1]} == {
        (d, t, c) for d in (64, 128) for t in (torch.bfloat16, torch.float32)
        for c in (False, True)}
    assert all(c[0] * c[1] == 4 and c[2] == 16384 for c in combos[:-1])
    assert combos[-1] == (8, 8, 2048, 64, torch.bfloat16, True)
    assert bench_flash.derived_launches(10) == {
        n: 23 for n in bench_flash.FLASH_NAMES}


# -- bench_mnist ---------------------------------------------------------------

def _ce(probs, labels):
    p = np.asarray(probs, np.float64)
    return float(-np.log(p[np.arange(len(labels)), labels.astype(int)]).sum())


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_mnist_step_is_the_jax_tools(model):
    """One step of each net from the same parameters and batch (batch 8):
    the cross-entropy of its softmax output and the updated parameters and
    momenta within rtol 1e-5 of the JAX tool's step (f32; the sums run in
    other orders), elements near zero within 1e-6 of their leaf's largest
    magnitude (an element of 4e-3 read 1.1e-7 apart, 2.5e-3 relative)."""
    from mxnet_tpu.executor import _build_graph_fn as jgraph

    jstep, jparams, jmoms, shape = jmnist.build_step(model, 8)
    tstep, tparams, tmoms, tshape = bench_mnist.build_step(model, 8)
    assert tshape == shape and list(tparams) == list(jparams)
    for k in jparams:
        np.testing.assert_array_equal(tparams[k].numpy(),
                                      np.asarray(jparams[k]))
    rng = np.random.RandomState(5)
    data = rng.randn(*shape).astype(np.float32)
    label = rng.randint(0, 10, 8).astype(np.int32)
    net = mx.models.mlp() if model == "mlp" else mx.models.lenet()
    jouts, _ = jgraph(net, is_train=True)(
        {**jparams, "data": jnp.asarray(data),
         "softmax_label": jnp.asarray(label)}, {},
        jnp.zeros((2,), jnp.uint32))
    new_p, new_m = jax.jit(jstep)(jparams, jmoms, jnp.asarray(data),
                                  jnp.asarray(label))
    probs = tstep(tparams, tmoms, {}, torch.from_numpy(data),
                  torch.from_numpy(label.astype(np.float32)))
    assert _ce(probs.numpy(), label) == pytest.approx(
        _ce(np.asarray(jouts[0]), label), rel=1e-5)
    for k in jparams:
        for got, want in ((tparams[k], new_p[k]), (tmoms[k], new_m[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=k)


# -- bench_longctx -------------------------------------------------------------

LM_SMALL = dict(seq=64, d_model=64, n_layers=2, vocab=128)
# bf16 compute on both sides (the tool's configuration), rounded at other
# places. The loss read 6.3e-5 apart (relative); each leaf's update (the
# step's change of it, lr 1e-3) read within 2.8% of that leaf's largest
# update (layer0_ln2_scale; one bf16 step is 0.4%, and the gradients of
# two layers compound it), so: the loss within 1e-3, each update within
# 5% of the leaf's largest. A wrong gradient is off by all of it.
LM_LOSS_RTOL = 1e-3
LM_UPDATE_BOUND = 5e-2


def _lm_batch(vocab, seq):
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, vocab, (1, seq)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _port_lm_step(remat, params):
    _, step, tp, moms = bench_longctx.build_step(
        LM_SMALL["seq"], remat, LM_SMALL["d_model"], LM_SMALL["n_layers"],
        LM_SMALL["vocab"], ctx=mt.cpu())
    tp = transformer_params_from_numpy(params, "cpu")
    moms = {k: torch.zeros_like(v) for k, v in tp.items()}
    tokens, targets = _lm_batch(LM_SMALL["vocab"], LM_SMALL["seq"])
    return step(tp, moms, torch.from_numpy(tokens), torch.from_numpy(targets))


def test_longctx_step_is_the_jax_tools():
    """The tool's LM step at seq 64, d_model 64, 2 layers, vocab 128 (the
    JAX tool's model and update, lr 1e-3) from the JAX model's parameters:
    the loss and each parameter's update within the bounds above; and remat
    on and off give the same step in the port, bitwise."""
    from mxnet_tpu.models.transformer import (TransformerLM,
                                              transformer_lm_config)

    cfg = transformer_lm_config(
        vocab_size=LM_SMALL["vocab"], d_model=LM_SMALL["d_model"],
        n_heads=LM_SMALL["d_model"] // 64, n_layers=LM_SMALL["n_layers"],
        d_ff=4 * LM_SMALL["d_model"], max_len=LM_SMALL["seq"])
    jm = TransformerLM(cfg)
    jp, jmoms = jm.init_sharded(None)
    params = {k: np.asarray(v) for k, v in jp.items()}
    tokens, targets = _lm_batch(LM_SMALL["vocab"], LM_SMALL["seq"])
    new_p, _, jloss = jm.make_train_step(None, lr=1e-3)(
        jp, jmoms, jnp.asarray(tokens), jnp.asarray(targets))
    runs = [_port_lm_step(remat, params) for remat in (False, True)]
    tp, _, tloss = runs[0]
    assert float(tloss) == pytest.approx(float(jloss), rel=LM_LOSS_RTOL)
    for k, v in params.items():
        want = np.asarray(new_p[k]) - v
        np.testing.assert_allclose(tp[k].numpy() - v, want, rtol=0,
                                   atol=LM_UPDATE_BOUND * np.abs(want).max(),
                                   err_msg=k)
        assert torch.equal(runs[1][0][k], tp[k]), k
    assert torch.equal(runs[1][2], tloss)


def test_longctx_config_is_the_jax_tools():
    """The JAX tool's sweep and model: seqs, d_model 512, 8 heads, 4 layers,
    d_ff 2,048, vocab 8,192."""
    import inspect

    args = bench_longctx.parser().parse_args([])
    assert args.seqs == "2048,8192,16384,32768" and args.iters == 4
    want = inspect.signature(jlongctx.bench_config).parameters
    got = inspect.signature(bench_longctx.bench_config).parameters
    for name in ("d_model", "n_layers", "vocab", "iters"):
        assert got[name].default == want[name].default, name
    model = bench_longctx.build_step(64, False, ctx=mt.cpu())[0]
    assert (model.cfg["n_heads"], model.cfg["d_ff"]) == (8, 2048)


# -- bench_roofline ------------------------------------------------------------

@pytest.mark.parametrize("batch", [2, 256])
def test_analytic_min_traffic_is_the_jax_tools(batch):
    assert bench_roofline.analytic_min_traffic_gb(batch) == \
        jroof.analytic_min_traffic_gb(batch)


def test_op_table_charges_what_moves():
    """The charging rule on hand-made calls: a product and an in-place add
    their operands and results, a view, a transpose, a detach and an
    allocation nothing; ``charged`` is the cost counter's rule for all."""
    x = torch.randn(4, 3)
    w = torch.randn(3, 5)
    with bench_roofline.OpTable() as table:
        y = x @ w                          # mm: 12 + 15 in, 20 out
        yt = y.t()                         # view
        y.view(20)                         # view
        y.detach()                         # alias
        z = torch.empty(20)                # allocation
        y.add_(1.0)                        # 20 in, 20 out
        s = yt.relu()                      # 20 in, 20 out
    rows = {c["opcode"]: c for c in table.calls}
    assert rows["mm"]["bytes"] == rows["mm"]["charged"] == (12 + 15 + 20) * 4
    assert rows["add_"]["bytes"] == 40 * 4
    assert rows["relu"]["bytes"] == 40 * 4
    for name in ("t", "view", "detach", "empty"):
        assert rows[name]["bytes"] == 0, name
    assert rows["t"]["charged"] == 40 * 4
    assert rows["empty"]["charged"] == 20 * 4
    assert table.traffic_bytes == (47 + 40 + 40) * 4
    top, totals = bench_roofline.per_op_bytes_table(table, top_k=2)
    assert [r["opcode"] for r in top] == ["mm", "add_"]
    assert list(totals) == ["mm", "add_", "relu"]
    assert top[0]["shape"] == "f32[4,5]"
    del z, s


def test_op_table_names_each_operation_by_its_node():
    """A step of a tiny Symbol graph under ``step_traffic``: forward calls
    in their node's ``<node>/<op>`` range, backward calls by the node their
    autograd node was made in, the update by its own range; the table's
    charges add up to ``cost_rows``' bytes."""
    from mxnet_tpu_torch.executor import _build_graph_fn

    s = mt.sym
    net = s.FullyConnected(data=s.Variable("data"), num_hidden=8,
                           name="fc1")
    net = s.Activation(data=net, act_type="relu", name="relu1")
    net = s.FullyConnected(data=net, num_hidden=3, name="fc2")
    net = s.SoftmaxOutput(data=net, name="softmax")
    rng = np.random.RandomState(0)
    params = {"fc1_weight": rng.randn(8, 5), "fc1_bias": np.zeros(8),
              "fc2_weight": rng.randn(3, 8), "fc2_bias": np.zeros(3)}
    params = {k: torch.tensor(v, dtype=torch.float32)
              for k, v in params.items()}
    moms = {k: torch.zeros_like(v) for k, v in params.items()}
    step = _bench.sgd_momentum_step(_build_graph_fn(net, is_train=True),
                                    lr=0.1, momentum=0.9, rescale=0.25)
    data = torch.randn(4, 5)
    label = torch.tensor([0.0, 1.0, 2.0, 1.0])
    rows, totals, table = bench_roofline.step_traffic(
        lambda: step(params, moms, {}, data, label))
    sources = {c["source"] for c in table.calls if c["bytes"]}
    assert {"fc1/FullyConnected", "fc2/FullyConnected",
            "fc1/FullyConnected (backward)", "fc2/FullyConnected (backward)",
            "update/sgd_momentum"} <= sources
    assert table.charged_bytes == totals["bytes"]
    assert 0 < table.traffic_bytes < totals["bytes"]


def test_op_table_names_a_custom_functions_backward():
    """A custom ``autograd.Function``'s backward (the fused BatchNorm
    paths use them) is named by the range its node was made in, found by
    its sequence number; an operation outside every range by its node."""

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return g * 2

    x = torch.randn(3, requires_grad=True)
    with bench_roofline.OpTable() as table:
        with torch.autograd.profiler.record_function("n1/Op"):
            y = Twice.apply(x).sin()
        torch.autograd.grad(y.sum(), x)
    sources = [(c["opcode"], c["source"]) for c in table.calls]
    assert sources[:2] == [("mul", "n1/Op"), ("sin", "n1/Op")]
    assert ("expand", "SumBackward0 (backward)") in sources
    assert sources[-2:] == [("mul", "n1/Op (backward)"),
                            ("mul", "n1/Op (backward)")]


def test_roofline_analyze_only_on_the_cpu(tmp_path):
    """``--analyze-only --cpu`` at batch 2: no time, the JAX tool's analytic
    minimum, the port's traffic below its every-call count, the ranked
    table with the nodes as sources, and the JAX keys it stands for."""
    out = tmp_path / "roof.json"
    res = bench_roofline.main(["--analyze-only", "--cpu", "--batch-size",
                               "2", "--out", str(out)])
    got = json.loads(out.read_text())
    assert got["card"] == _bench.NO_CARD and "measured_step_ms" not in got
    assert got["analytic_min_traffic_gb"] == \
        jroof.analytic_min_traffic_gb(2)
    assert 0 < got["port_bytes_accessed_gb"] < got["port_op_bytes_gb"]
    top = got["per_op_top"]
    assert len(top) == 25 and all(a["gbytes"] >= b["gbytes"]
                                  for a, b in zip(top, top[1:]))
    assert any((r["source"] or "").endswith("/Convolution (backward)")
               for r in top)
    assert set(got["jax_keys"].values()) <= set(_jax_roofline_keys())
    assert res["batch_size"] == 2 and os.environ.get("MXNET_TPU_REMAT") \
        is None


def _jax_roofline_keys():
    """The keys the JAX tool's JSON has (its ``main``'s source)."""
    with open(os.path.join(REPO, "tools", "bench_roofline.py")) as f:
        tree = ast.parse(f.read())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_roofline_remat_is_set_for_the_run_only(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_REMAT", raising=False)
    res = bench_roofline.main(["--analyze-only", "--cpu", "--batch-size",
                               "1", "--remat", "--out",
                               str(tmp_path / "r.json")])
    assert res["remat"] == r"unit\d+_out$"
    assert "MXNET_TPU_REMAT" not in os.environ


# -- scaling_projection --------------------------------------------------------

def test_projection_rows_are_the_jax_tools(monkeypatch):
    """``project`` at the same payload and constants (both modules'
    patched) gives the JAX tool's rows under the port's key names."""
    for mod, names in ((jscaling, ("ICI_GBS", "DCN_GBS_PER_CHIP")),
                       (scaling_projection, ("NVLINK_GBS",
                                             "NIC_GBS_PER_CARD"))):
        monkeypatch.setattr(mod, names[0], 300.0)
        monkeypatch.setattr(mod, names[1], 12.5)
        monkeypatch.setattr(mod, "ACHIEVABLE", 0.6)
        monkeypatch.setattr(mod, "OVERLAP", 0.5)
    monkeypatch.setattr(jscaling, "STEP_MS", 87.5)
    payload = 102440612
    want = jscaling.project(payload)
    got = scaling_projection.project(payload, 87.5)
    assert [r["cards"] for r in got] == [r["chips"] for r in want]
    for g, w in zip(got, want):
        for ours, theirs in scaling_projection.JAX_KEYS.items():
            assert g[ours] == w[theirs], (ours, g, w)
        assert g["link"] == ("nvlink" if g["cards"] <= 8 else "nic")
        t = g["t_comm_nvlink_ms" if g["link"] == "nvlink" else
              "t_comm_nic_ms"]
        assert g["eff_no_overlap"] == pytest.approx(87.5 / (87.5 + t),
                                                    abs=1e-3)


def test_payload_is_resnet50s_gradient_bytes():
    """The payload (``overlap_plan``, checked against the profiled table
    inside) is the f32 bytes of ResNet-50's parameters by either package's
    ``infer_shape``, and the JAX tool's committed HLO payload
    (``SCALING_r05.json``) is that plus what it names: BatchNorm's batch
    statistics (the moving statistics' shapes, f32) and the loss."""
    got = scaling_projection.allreduce_payload(device="cpu")
    sym = mx.models.resnet50(num_classes=1000, layout="NHWC")
    shapes = {"data": (16, 224, 224, 3), "softmax_label": (16,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    jax_bytes = sum(int(np.prod(s)) * 4 for n, s in
                    zip(sym.list_arguments(), arg_shapes) if n not in shapes)
    assert got["payload_bytes"] == got["param_bytes_f32"] == jax_bytes
    assert got["profiled"]["payload_bytes"] == got["payload_bytes"]
    stats = sum(int(np.prod(s)) * 4 for s in aux_shapes)
    assert got["not_in_payload"]["batchnorm_statistics_bytes"] == stats
    with open(os.path.join(REPO, "SCALING_r05.json")) as f:
        recorded = json.load(f)
    assert recorded["param_bytes_f32"] == jax_bytes
    assert recorded["allreduce_payload_bytes_per_step"] == \
        jax_bytes + stats + got["not_in_payload"]["loss_bytes"]


def test_projection_from_a_roofline_file_on_the_cpu(tmp_path):
    roof = tmp_path / "roof.json"
    roof.write_text(json.dumps({"measured_step_ms": 250.0,
                                "card": "a card, 700.00 W",
                                "batch_size": 256}))
    out = scaling_projection.main(["--cpu", "--roofline", str(roof),
                                   "--out", str(tmp_path / "s.json")])
    assert out["card"] == "a card, 700.00 W"
    assert out["assumptions"]["step_ms_measured_1card"] == 250.0
    assert "PROJECTION from one card" in out["assumptions"]["note"]
    assert [r["link"] for r in out["projection"]] == \
        ["nvlink"] + ["nic"] * 5


# -- bench_io_scaling and ensure_recordio --------------------------------------

def test_ensure_recordio_is_the_jax_helpers(tmp_path):
    """The same 32 records as ``bench.ensure_recordio`` (the port's JPEG
    encoder writes the bytes PIL writes): the files byte for byte, and so
    the labels, ids and decoded images exactly."""
    from mxnet_tpu_torch import recordio as trio

    jpath = jbench.ensure_recordio(str(tmp_path / "j.rec"), n=32)
    tpath = _bench.ensure_recordio(str(tmp_path / "t.rec"), n=32)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    jr, tr = mx.recordio.MXRecordIO(jpath, "r"), trio.MXRecordIO(tpath, "r")
    n = 0
    while True:
        a, b = jr.read(), tr.read()
        if a is None:
            assert b is None
            break
        (jh, jimg), (th, timg) = mx.recordio.unpack_img(a), \
            trio.unpack_img(b)
        assert (th.label, th.id) == (jh.label, jh.id) == (float(n % 1000), n)
        np.testing.assert_array_equal(timg, jimg)
        n += 1
    assert n == 32


def test_io_projection_is_the_jax_tools(tmp_path, monkeypatch):
    """The JAX tool's ``main`` with its pipeline runs stubbed to fixed
    rates gives the summary that ``summarize`` gives from the same rates."""
    rates = {(1, False, False): 2400.0, (2, False, False): 4500.0,
             (4, False, False): 8000.0, (8, False, False): 12000.0,
             (1, True, False): 8400.0, (1, False, True): 27000.0}
    monkeypatch.setattr(jio, "ensure_recordio", lambda path, n: path)
    monkeypatch.setattr(jio.native, "scan_offsets", lambda path: [0])
    monkeypatch.setattr(
        jio, "run_epochs", lambda path, offsets, nt, skip_decode=False,
        skip_work=False: rates[(nt, skip_decode, skip_work)])
    monkeypatch.chdir(tmp_path)
    jio.main()
    want = json.loads((tmp_path / "IO_SCALING_r03.json").read_text())
    curve = [{"threads": t, "img_per_sec": rates[(t, False, False)]}
             for t in (1, 2, 4, 8)]
    got = bench_io_scaling.summarize(curve, rates[(1, False, True)],
                                     rates[(1, True, False)])
    for key in ("decode_share_of_worker_cost", "parallel_fraction",
                "amdahl_projected_speedup_8_cores",
                "amdahl_projected_img_per_sec_8_cores"):
        assert got[key] == pytest.approx(want[key], abs=10 ** -(
            1 if key.endswith("img_per_sec_8_cores") else
            2 if key.startswith("amdahl") else 4)), key
    assert got["single_thread_img_per_sec"] == \
        want["single_core_img_per_sec"]
    assert got["measured_speedup_by_threads"]["8"] == 5.0


def test_io_pipeline_runs_each_mode_and_restores_the_variables(
        tmp_path, monkeypatch):
    """The three modes over a small shard on the host: each a rate, the
    skip variables set only while its pipeline is made."""
    from mxnet_tpu_torch import native

    monkeypatch.setenv("MXTPU_NATIVE_SKIP_WORK", "0")
    monkeypatch.delenv("MXTPU_NATIVE_SKIP_DECODE", raising=False)
    path = _bench.ensure_recordio(str(tmp_path / "s.rec"), n=32)
    offsets = native.scan_offsets(path)
    assert len(offsets) == 32
    for kw in ({}, {"skip_decode": True}, {"skip_work": True}):
        assert bench_io_scaling.run_epochs(path, offsets, 2, batch=8,
                                           **kw) > 0
    assert os.environ["MXTPU_NATIVE_SKIP_WORK"] == "0"
    assert "MXTPU_NATIVE_SKIP_DECODE" not in os.environ
    assert bench_io_scaling.default_threads()[:4] == [1, 2, 4, 8]


# -- every tool ----------------------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    ("bench_flash", []), ("bench_flash", ["--quick"]),
    ("bench_longctx", []), ("bench_mnist", []), ("bench_roofline", []),
    ("bench_roofline", ["--analyze-only"]), ("bench_io_scaling", []),
    ("scaling_projection", []),
    ("scaling_projection", ["--roofline", "r.json"])])
def test_timed_entries_need_cuda(tool, argv, monkeypatch, tmp_path):
    """Without CUDA each timed entry raises naming it, before it writes or
    builds anything; nothing is timed on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module = globals()[tool]
    with pytest.raises(MXNetError, match="CUDA"):
        module.main(argv + ["--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


@pytest.mark.parametrize("tool,argv", [
    ("bench_roofline", ["--cpu"]), ("scaling_projection", ["--cpu"])])
def test_cpu_only_for_the_analyses(tool, argv, tmp_path):
    """``--cpu`` is for what the JAX tools also run on the CPU: a timed
    roofline or a projection without a step time refuses it."""
    with pytest.raises(MXNetError, match="card"):
        globals()[tool].main(argv + ["--out", str(tmp_path / "o.json")])


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_imports_no_jax_and_names_its_counterpart(tool):
    """No import of jax, jaxlib, the JAX package, ``bench`` or ``tools``,
    at any depth of the file; its default ``--out`` is the port's own,
    never one of the JAX tools' files at the root; and it names its JAX
    counterpart."""
    path = os.path.join(REPO, "mxnet_tpu_torch", "tools", f"{tool}.py")
    with open(path) as f:
        source = f.read()
    for node in ast.walk(ast.parse(source)):
        names = [a.name for a in node.names] \
            if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) and \
            not node.level else []
        for name in names:
            assert name.split(".")[0] not in (
                "jax", "jaxlib", "mxnet_tpu", "bench", "tools"), (tool, name)
    assert f"tools/{tool}.py" in source
    module = globals()[tool]
    out = module.parser().parse_args([]).out
    assert out.endswith("_torch.json") and not os.path.exists(
        os.path.join(REPO, out))


def test_common_helpers_import_no_jax():
    path = os.path.join(REPO, "mxnet_tpu_torch", "tools", "_bench.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and not node.level:
            assert node.module.split(".")[0] not in ("jax", "mxnet_tpu",
                                                     "bench")
        if isinstance(node, ast.Import):
            assert all(a.name.split(".")[0] not in ("jax", "mxnet_tpu",
                                                    "bench")
                       for a in node.names)


def test_data_shape_is_bench_pys():
    for layout in ("NHWC", "NCHW"):
        assert _bench._data_shape(8, layout) == jbench._data_shape(8, layout)


def test_resnet50_step_parameters_are_bench_pys():
    """The step's parameters and auxiliary states from ``build_resnet50_
    train_step`` are bench.py's, value for value (its scales, its seed),
    in the port's layout."""
    step, params, moms, aux = _bench.build_resnet50_train_step(
        2, layout="NHWC")
    _, jparams, jmoms, jaux = jbench.build_resnet50_train_step(
        2, layout="NHWC")
    assert sorted(params) == sorted(jparams) and sorted(aux) == sorted(jaux)
    for k in jparams:
        np.testing.assert_array_equal(params[k].numpy(),
                                      np.asarray(jparams[k]))
    for k in jaux:
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(jaux[k]))
