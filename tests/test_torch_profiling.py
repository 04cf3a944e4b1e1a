"""The port's device-time profiler, ``utils.profiler`` and MFU FLOP count
against the JAX package's.

``attribute_op_name`` and ``build_report`` give the same output on the
same rows; ``fit(profile=...)`` on the CPU produces a report whose rows
name the net's layers (a backward operation named by its forward's
ranges); ``compile_report``/``comm_report`` print the same text for the
same stats. The FLOP count of one step (``telemetry.mfu.FlopCounter``)
gives the JAX package's contraction FLOPs exactly on an MLP and a small
BatchNorm ResNet; the total, which adds each package's elementwise
decomposition of its ops (XLA's jaxpr against ATen's), agrees within 2%
(0.7% and 0.5% at these sizes)."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu import telemetry as jt
from mxnet_tpu.utils import profiler as jprofiler
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.convert import random_params
from mxnet_tpu_torch.telemetry import profiling as tp
from mxnet_tpu_torch.utils import profiler as tprofiler

mt.set_matmul_precision("highest")

OP_NAMES = [
    "jit(step)/jit(main)/jvp(fc1/FullyConnected)/dot_general",
    "jit(step)/jit(main)/transpose(jvp(fc1/FullyConnected))/dot_general",
    "jit(step)/jit(main)/shmap_body/a1/Activation/tanh",
    "jit(step)/jit(main)/optimizer/update/sub",
    "jit(step)/jit(main)/comm/allreduce/psum",
    "jit(step)/jit(main)/convert_element_type",
    "fc1/FullyConnected/matmul",
    "optimizer/update/fused_adam",
    "health/stats/_foreach_norm",
    "loss/sum/SumBackward0",
    "metric/update/argmax",
    "conv0/Convolution/convolution_backward",
    "mm",
]


@pytest.mark.parametrize("op_name", OP_NAMES)
def test_attribute_op_name_matches_jax(op_name):
    layers = {"fc1", "a1", "conv0"}
    assert tp.attribute_op_name(op_name, layers) == \
        jt.profiling.attribute_op_name(op_name, layers)


def _rows(rng):
    rows, maps = {}, {}
    for i, name in enumerate(OP_NAMES):
        instr = f"fusion.{i}"
        rows[("m", instr)] = {"us": float(rng.randint(1, 500)),
                              "count": int(rng.randint(1, 9))}
        if i % 4 != 3:  # some instructions have no metadata
            maps[instr] = name
    return rows, [maps]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_report_matches_jax(seed):
    rows, maps = _rows(np.random.RandomState(seed))
    layers = {"fc1", "a1", "conv0"}
    kw = dict(steps=3, window_seconds=0.25, flops_per_step=1e9,
              peak_flops=1e12, num_devices=1)
    jr = jt.profiling.build_report(
        {k: dict(v) for k, v in rows.items()}, maps, layers, **kw)
    tr = tp.build_report({k: dict(v) for k, v in rows.items()}, maps,
                         layers, **kw)
    assert tr.to_dict() == jr.to_dict()
    assert tr.table() == jr.table()
    assert tr.coverage_pct == jr.coverage_pct < 100.0


@pytest.mark.parametrize("value,env", [(None, ""), (None, "3"), (True, ""),
                                       (5, ""), (0, ""), (None, "on")])
def test_profile_config_resolves_as_jax(monkeypatch, value, env):
    monkeypatch.setenv("MXNET_TPU_PROFILE", env)
    j = jt.ProfileConfig.resolve(value)
    t = tt.ProfileConfig.resolve(value)
    assert (j is None) == (t is None)
    if t is not None:
        assert repr(t) == repr(j)


def test_capture_fails_soft_and_emits_events(tmp_path):
    tt.reset()
    d = tp.start_capture(str(tmp_path / "a"), owner="test")
    try:
        with pytest.raises(RuntimeError):
            tp.start_capture(str(tmp_path / "b"))
        assert tp.ranges_on() and tp.capture_active() == d
    finally:
        tp.stop_capture()
    assert tp.stop_capture() == (None, 0.0)
    phases = [e["phase"] for e in tt.hub().events("profile")]
    assert phases == ["start", "capture"]
    assert not tp.ranges_on()


def test_parse_trace_names_backward_by_its_forward(tmp_path):
    """A captured forward in ranges, its backward (autograd, no ranges
    open) and an optimizer range: the backward's operations are named by
    the forward operation's ranges."""
    x = torch.randn(8, 16)
    w = torch.randn(4, 16, requires_grad=True)
    with tp.capture(str(tmp_path), owner="test"):
        with tp.scope("fc1/FullyConnected"):
            y = x @ w.t()
        with tp.scope("act/Activation"):
            z = torch.relu(y).sum()
        z.backward()
        with tp.scope("optimizer/update"), torch.no_grad():
            w.sub_(0.1 * w.grad)
    rows = tp.parse_trace_dir(str(tmp_path))
    names = {r["op_name"] for r in rows.values()}
    assert "fc1/FullyConnected/MmBackward0" in names
    assert "act/Activation/ReluBackward0" in names
    assert any(n.startswith("optimizer/update/") for n in names)
    report = tp.build_report(rows, [], {"fc1", "act"})
    assert {"fc1", "act", "optimizer"} <= set(report.layers)
    assert report.total_us == pytest.approx(
        sum(r["us"] for r in rows.values()))


def test_fit_profile_report_names_the_layers(tmp_path):
    rng = np.random.RandomState(0)
    X = rng.randn(48, 64).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    tt.reset()
    mt.utils.compile.reset_compile_stats()
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1,
                           optimizer="adam", fused=True, learning_rate=0.01)
    model.fit(X, y, batch_size=8, telemetry=True, health=True,
              profile=tt.ProfileConfig(steps=3, warmup=2,
                                       log_dir=str(tmp_path)))
    report = model.profile_report
    assert report.steps == 3
    layers = {row["layer"] for row in report.ops} - {None}
    assert {"fc1", "fc2", "fc3", "optimizer", "health"} <= layers
    assert report.coverage_pct > 80.0
    assert sum(r["us"] for r in report.ops) == pytest.approx(report.total_us)
    summary = tt.hub().events("profile")[-1]
    assert summary["phase"] == "summary" and summary["steps"] == 3
    for key in jt.EVENT_GOLDEN_KEYS["profile"]:
        assert key in summary
    # the window's steps are not counted as another eager reason on the
    # CPU, where every step runs eager anyway
    assert set(mt.utils.compile.compile_stats()["eager"]) == {"cpu context"}


def test_predict_profile_and_spans():
    rng = np.random.RandomState(1)
    X = rng.randn(40, 64).astype(np.float32)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1)
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=8)
    out = model.predict(X, batch_size=8, telemetry=True,
                        profile=tt.ProfileConfig(steps=2, warmup=1))
    assert out.shape == (40, 10)
    assert len(model.telemetry.steps(kind="predict_step")) == 5
    assert model.profile_report.steps == 2
    assert {"fc1", "fc2", "fc3"} <= set(model.profile_report.layers)


# -- utils.profiler -------------------------------------------------------------

def test_profile_step_and_timer():
    a = torch.randn(64, 64)
    stats, log_dir = tprofiler.profile_step(lambda: torch.relu(a @ a),
                                            iters=2)
    assert {s.name for s in stats} >= {"matmul", "relu"}
    assert all(s.count == 2 for s in stats if s.name == "relu")
    with tprofiler.Timer() as t:
        t.block(a @ a)
    assert t.elapsed > 0


COMPILE_STATS = {"compiles": 3, "compile_seconds": 1.5, "hits": 10,
                 "misses": 3, "persistent_cache_hits": 0,
                 "persistent_cache_saved_seconds": 0.0,
                 "per_function": {
                     "train_step:abc": {"compile_seconds": 1.2,
                                        "compiles": 2, "hits": 8,
                                        "misses": 2, "programs": 2},
                     "eval_step:abc": {"compile_seconds": 0.3,
                                       "compiles": 1, "hits": 2,
                                       "misses": 1, "programs": 1}}}

COMM_STATS = {"steps": 4, "wire_bytes": 4e6, "fp32_wire_bytes": 16e6,
              "ratio": 4.0, "host_bytes": {"sent": 0, "received": 0},
              "per_program": {"sync": {
                  "mode": "int8", "steps": 4, "wire_bytes": 1e6,
                  "fp32_wire_bytes": 4e6, "ratio": 4.0,
                  "total_wire_bytes": 4e6, "collectives": [
                      {"op": "all_gather", "count": 1,
                       "payload_bytes": 5e5, "wire_bytes": 5e5}]}}}


def test_compile_and_comm_reports_print_as_jax():
    assert tprofiler.compile_report(COMPILE_STATS) == \
        jprofiler.compile_report(COMPILE_STATS)
    assert tprofiler.comm_report(COMM_STATS) == \
        jprofiler.comm_report(COMM_STATS)
    # the port's own counters fill the same table
    assert tprofiler.compile_report().startswith("compiles=")


# -- MFU: the FLOP count of one step -------------------------------------------

def _flops_both(js, ts, shape, X, y):
    args, aux = random_params(ts, 0, data=shape)
    accts = []
    orig = jt.MFUAccountant.maybe_trace

    def spy(self, *a, **k):
        accts.append(self)
        return orig(self, *a, **k)

    jt.MFUAccountant.maybe_trace = spy
    try:
        for pkg in (mx, mt):
            model = pkg.FeedForward(
                js if pkg is mx else ts, ctx=pkg.cpu(), num_epoch=1,
                optimizer="sgd", learning_rate=0.1,
                arg_params={k: pkg.nd.array(v) if pkg is mx else v
                            for k, v in args.items()},
                aux_params={k: pkg.nd.array(v) if pkg is mx else v
                            for k, v in aux.items()})
            model.fit(pkg.io.NDArrayIter(X, y, batch_size=shape[0],
                                         shuffle=False), telemetry=True)
    finally:
        jt.MFUAccountant.maybe_trace = orig
    ja = accts[0]
    jax_contraction = sum(r["flops"] for r in ja.audit_rows
                          if r["primitive"] in ("dot_general",
                                                "conv_general_dilated"))
    return ja.flops_per_step, jax_contraction, model.mfu


@pytest.mark.parametrize("net", ["mlp", "bn_resnet"])
def test_flop_count_matches_jax(net):
    rng = np.random.RandomState(0)
    if net == "mlp":
        js, ts, shape = jmodels.mlp(), tmodels.mlp(), (8, 64)
    else:
        kw = dict(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
                  num_classes=10)
        js, ts, shape = jmodels.resnet(**kw), tmodels.resnet(**kw), \
            (4, 3, 32, 32)
    X = rng.randn(2 * shape[0], *shape[1:]).astype(np.float32)
    y = rng.randint(0, 10, 2 * shape[0]).astype(np.float32)
    jax_total, jax_contraction, acct = _flops_both(js, ts, shape, X, y)
    assert acct.contraction_flops == jax_contraction > 0
    assert acct.flops_per_step == pytest.approx(jax_total, rel=0.02)


def test_kernels_priced_from_the_registry():
    """A fused Adam step is one ``kernel::fused_adam`` row priced by the
    kernel registry's model; its plain version's operations are not
    counted."""
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.kernels import registry as kreg

    ps = [torch.randn(100), torch.randn(7, 3)]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    counter = tt.mfu.FlopCounter()
    with counter:
        kfa.fused_adam(ps, gs, ms, vs, [0.1, 0.1], [0.01, 0.01], [0.0, 0.0],
                       lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8,
                       rescale_grad=1.0, clip_gradient=None, wd_l2=0.0,
                       decoupled=False)
    rows = {r["primitive"]: r for r in counter.rows}
    cost = kreg.get_kernel("fused_adam").cost((ps, gs, ms, vs),
                                              (ps, ms, vs))
    assert set(rows) == {"kernel::fused_adam"}
    assert rows["kernel::fused_adam"]["flops"] == int(cost.flops)


def test_measured_peak_and_env_override(monkeypatch):
    peak = tt.measured_peak_flops()
    assert peak > 0 and tt.measured_peak_flops() == peak  # cached
    monkeypatch.setenv("MXNET_TPU_PEAK_FLOPS", "2e12")
    assert tt.resolve_peak_flops(2) == 4e12
