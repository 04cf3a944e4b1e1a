"""The sharding audit of the port (``analysis/sharding.py``) against the
JAX package's (``mxnet_tpu/analysis/sharding.py``), following
``tests/test_shardcheck.py``.

- The golden exchange: the JAX package's compiled dp-8 exchange (HLO text)
  in every compression tier x overlap gives both packages the same MX802
  findings (none) and the same reconciliation rows; so do the seeded
  drifts (compression dropped, unplanned compressed collectives, an
  element-count drift, the small-all-reduce allowance).
- MX804 over the port's mesh specs, as the JAX package finds it.
- MX801/MX803 are JAX-only: the port has no jaxpr pass of their names, its
  reports say so, and a collective issued once a loop iteration is priced
  by MX802 instance by instance (three in a loop: three times the plan).
- The gate: ``shard_audit_enabled`` resolves as the JAX package's;
  ``precompile(shard_audit=)`` raises on a seeded error and reports on
  eight CPU replicas; ``fit(shard_audit=True)`` there audits each program
  once and trains bitwise as without it; a wrong plan raises MX802 with
  the parameters bitwise the initial ones.
- Two gloo ranks (``tests/torch_ranks.py``): int8 and twobit with overlap
  and the comm kernels audit clean, int8's doubled collectives a named
  note with payload and wire bytes equal to the plan's, BatchNorm's
  averaged statistics a planned row.
- ``selfcheck_report()``: the repo's full-stack step over eight replicas
  audits clean, with matched rows.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import comm as jcomm
from mxnet_tpu.analysis import sharding as jshard
from mxnet_tpu.compat import shard_map
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch.analysis import sharding as tshard
from mxnet_tpu_torch.analysis.rules import Finding, get_rule
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel.mesh import P as TP
from torch_ranks import run_ranks, shard_audit_fit, small_net

torch.set_num_threads(1)
L = 8192  # flat gradient elements of the golden exchange


def _mesh8():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    return Mesh(np.array(devs[:8]), ("dp",))


def _exchange_hlo(mode, overlap):
    """The JAX package's dp-8 gradient exchange compiled one way, as
    ``tests/test_shardcheck.py`` compiles it: (hlo, plan)."""
    mesh = _mesh8()
    g = np.random.RandomState(0).randn(8, L).astype(np.float32)
    if overlap and mode is not None:
        oplan = jcomm.plan_overlap({"w": (L,)}, mode, 8)
        plan = oplan.wire_plan()
        resid = jcomm.init_overlap_residuals(oplan)
        if resid is None:

            def body(gs):
                out, _ = jcomm.overlap_allreduce(
                    {"w": gs[0]}, None, oplan, "dp", average=True)
                return out["w"][None]

            f = jax.jit(shard_map(body, mesh=mesh, in_specs=JP("dp"),
                                  out_specs=JP("dp"), check_vma=False))
            return f.lower(g).compile().as_text(), plan

        def body(gs, res):
            out, res2 = jcomm.overlap_allreduce(
                {"w": gs[0]}, res, oplan, "dp", average=True)
            return out["w"][None], res2

        f = jax.jit(shard_map(body, mesh=mesh,
                              in_specs=(JP("dp"), JP("dp")),
                              out_specs=(JP("dp"), JP("dp")),
                              check_vma=False))
        return f.lower(g, resid).compile().as_text(), plan
    plan = jcomm.allreduce_plan(L, 8, mode)

    def body(gs):
        out = jcomm.compressed_allreduce({"w": gs[0]}, mode, "dp",
                                         axis_size=8, average=True)
        return out["w"][None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=JP("dp"),
                          out_specs=JP("dp"), check_vma=False))
    return f.lower(g).compile().as_text(), plan


def _port_plan(mode, overlap):
    if overlap and mode is not None:
        return tcomm.plan_overlap({"w": (L,)}, mode, 8).wire_plan()
    return tcomm.allreduce_plan(L, 8, mode)


def _same(port, jax_out):
    (tf, trep), (jf, jrep) = port, jax_out
    assert [(f.rule.id, f.node, f.message, f.extra) for f in tf] == \
        [(f.rule.id, f.node, f.message, f.extra) for f in jf]
    assert set(trep) == set(jrep)
    for key in trep:
        assert trep[key] == jrep[key], key


@pytest.mark.parametrize("overlap", [False, True], ids=["fused", "overlap"])
@pytest.mark.parametrize("mode", [None, "bf16", "int8", "twobit"])
def test_golden_exchange_reconciles_as_jax(mode, overlap):
    hlo, jplan = _exchange_hlo(mode, overlap)
    tplan = _port_plan(mode, overlap)
    assert tplan == jplan
    assert tshard.expected_collectives(tplan, mode) == \
        jshard.expected_collectives(jplan, mode)
    port = tshard.audit_collective_drift(hlo, tplan, compression=mode)
    _same(port, jshard.audit_collective_drift(hlo, jplan, compression=mode))
    findings, report = port
    assert findings == [] and report["unplanned"] == []
    assert len(report["matched"]) + len(report["widened"]) == \
        len(report["expected"])


def _seeded(case):
    """(hlo, plan kwargs, audit kwargs) of the JAX package's seeded MX802
    fixtures (tests/test_shardcheck.py:148-247)."""
    groups = "replica_groups={{0,1,2,3,4,5,6,7}}"
    grad = (f"  %ar.1 = f32[8192]{{0}} all-reduce(f32[8192]{{0}} %x), "
            f"{groups}\n")
    stat_f32 = f"  %ar.2 = f32[8]{{0}} all-reduce(f32[8]{{0}} %y), {groups}\n"
    stat_s32 = f"  %ar.3 = s32[4]{{0}} all-reduce(s32[4]{{0}} %z), {groups}\n"
    if case == "compression_dropped":
        return (_exchange_hlo(None, False)[0], (L, 8, "int8"),
                dict(compression="int8", small_allreduce_bytes=1024))
    if case == "unplanned_compressed":
        return _exchange_hlo("int8", False)[0], (L, 8, None), {}
    if case == "element_drift":
        return _exchange_hlo(None, False)[0], (2 * L, 8, None), {}
    if case == "allowance":
        return grad + stat_f32 + stat_s32, (8192, 8, None), {}
    if case == "allowance_31":
        return (grad + stat_f32 + stat_s32, (8192, 8, None),
                dict(small_allreduce_bytes=31))
    return grad + stat_s32, (8192, 8, None), dict(small_allreduce_bytes=15)


SEEDED = ["compression_dropped", "unplanned_compressed", "element_drift",
          "allowance", "allowance_31", "allowance_15"]


@pytest.mark.parametrize("case", SEEDED)
def test_seeded_mx802_as_jax(case):
    hlo, plan_args, kw = _seeded(case)
    port = tshard.audit_collective_drift(
        hlo, tcomm.allreduce_plan(*plan_args), **kw)
    _same(port, jshard.audit_collective_drift(
        hlo, jcomm.allreduce_plan(*plan_args), **kw))
    findings, report = port
    assert all(f.rule.id == "MX802" and f.is_error for f in findings)
    if case in ("allowance",):
        assert findings == [] and report["stat_rows"]
    else:
        assert findings


def test_expected_collectives_rejects_mode_mismatch():
    with pytest.raises(ValueError, match="does not match plan mode"):
        tshard.expected_collectives(tcomm.allreduce_plan(L, 8, "int8"),
                                    compression="bf16")


# -- MX804 --------------------------------------------------------------------

@pytest.mark.parametrize("specs,mesh,batch", [
    ({"w": ("tp",), "data": (None, None)}, {"dp": 8}, ("data",)),
    ({"w": (), "data": ("dp",)}, {"dp": 8, "tp": 1}, ("data",)),
    ({"data": (None,)}, {"dp": 1}, ("data",)),
    ({"w": (("dp", "sp"),), "data": ("sp",)}, {"dp": 2, "sp": 2},
     ("data",)),
], ids=["unknown_axis_and_unsharded", "clean", "dp1", "tuple_axes"])
def test_mx804_as_jax(specs, mesh, batch):
    tspecs = {k: TP(*v) for k, v in specs.items()}
    jspecs = {k: JP(*v) for k, v in specs.items()}
    got = tanalysis.check_partition_specs(tspecs, mesh, batch=batch)
    want = jshard.check_partition_specs(jspecs, mesh, batch=batch)
    assert [(f.rule.id, f.node, f.message, f.extra) for f in got] == \
        [(f.rule.id, f.node, f.message, f.extra) for f in want]
    assert all(f.is_error for f in got)


def test_mx804_over_a_port_mesh_object():
    class Mesh2:  # a mesh's ``shape`` mapping is what the check reads
        shape = {"dp": 2, "tp": 2}

    got = tanalysis.check_partition_specs(
        {"w": TP(None, "ep"), "data": TP(None)}, Mesh2(), batch=("data",))
    assert sorted(f.node for f in got) == ["data", "w"]


# -- MX801 / MX803: JAX-only --------------------------------------------------

def test_mx801_mx803_are_jax_only():
    assert not hasattr(tanalysis, "audit_jaxpr_sharding")
    assert not hasattr(tanalysis, "audit_jaxpr")
    assert not hasattr(tshard, "audit_jaxpr_sharding")
    rep = tanalysis.audit_step_program(
        hlo_text=_exchange_hlo("int8", False)[0],
        plan=tcomm.allreduce_plan(L, 8, "int8"), compression="int8")
    assert rep.findings == [] and tshard.JAX_ONLY_NOTE in rep.notes
    assert tshard.DEFAULT_MIN_REPLICATED_BYTES == \
        jshard.DEFAULT_MIN_REPLICATED_BYTES
    assert tshard.DEFAULT_SMALL_ALLREDUCE_BYTES == \
        jshard.DEFAULT_SMALL_ALLREDUCE_BYTES


def _replica_exchange(times, members=4, mode="int8"):
    group = tcomm.ReplicaGroup([torch.device("cpu")] * members)
    spec = tcomm.CompressionSpec.resolve(mode)
    size = tcomm.padded_flat_size(L, spec, members)
    flats = [torch.randn(size, generator=torch.Generator().manual_seed(m))
             for m in range(members)]

    def step():
        for _ in range(times):
            tcomm.compressed_exchange([f.clone() for f in flats], spec,
                                      group=group, axis_size=members)

    return step, tcomm.allreduce_plan(L, members, mode)


@pytest.mark.parametrize("times", [1, 3], ids=["once", "in_a_loop"])
def test_a_collective_in_a_loop_is_priced_by_mx802(times):
    step, plan = _replica_exchange(times)
    rep = tanalysis.audit_step_program(step, plan=plan, compression="int8")
    if times == 1:
        assert rep.findings == []
        assert {r["op"] for r in rep.reconciliation["notes"]} == \
            {"all-to-all", "all-gather"}
    else:
        msgs = [f.message for f in rep.findings]
        assert rep.findings and all(f.rule.id == "MX802"
                                    for f in rep.findings)
        assert any("moves" in m and "expects" in m for m in msgs)


# -- the runtime gate ---------------------------------------------------------

@pytest.mark.parametrize("env", [None, "", "0", "false", "off", "no", "1",
                                 "yes", "anything"])
@pytest.mark.parametrize("value", [None, True, False, "report"])
def test_shard_audit_enabled_resolves_as_jax(monkeypatch, env, value):
    if env is None:
        monkeypatch.delenv("MXNET_TPU_SHARD_AUDIT", raising=False)
    else:
        monkeypatch.setenv("MXNET_TPU_SHARD_AUDIT", env)
    assert tanalysis.shard_audit_enabled(value) == \
        jshard.shard_audit_enabled(value)


def _ctx8():
    ctx = [mt.cpu(i) for i in range(8)]
    if len(mt.context.distinct_contexts(ctx)) < 8:
        pytest.skip("needs 8 host devices")
    return ctx


def _small_model(ctx, **kw):
    s = mt.symbol
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=16)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=2)
    net = s.SoftmaxOutput(data=net, name="softmax")
    return mt.FeedForward(net, ctx=ctx, num_epoch=1, learning_rate=0.5,
                          **kw)


PRECOMPILE_KW = dict(data_shapes={"data": (16, 4)},
                     label_shapes={"softmax_label": (16,)},
                     compression="int8")


def test_precompile_shard_audit_raises_on_seeded_error(monkeypatch):
    seeded = tshard.ShardAuditReport(findings=[Finding(
        get_rule("MX802"), "seeded drift for the raise-path test",
        node="all-gather:s8")])
    monkeypatch.setattr(tshard, "audit_step_program", lambda *a, **k: seeded)
    with pytest.raises(MXNetError, match="MX802"):
        _small_model(_ctx8()).precompile(shard_audit=True, **PRECOMPILE_KW)
    out = _small_model(_ctx8()).precompile(shard_audit="report",
                                           **PRECOMPILE_KW)
    assert any(f.rule.id == "MX802"
               for rep in out["shard_audit"] for f in rep.findings)
    monkeypatch.setenv("MXNET_TPU_SHARD_AUDIT", "1")
    with pytest.raises(MXNetError, match="MX802"):
        _small_model(_ctx8()).precompile(**PRECOMPILE_KW)


@pytest.mark.parametrize("overlap", [None, True], ids=["fused", "overlap"])
@pytest.mark.parametrize("mode", [None, "bf16", "int8", "twobit"])
def test_precompile_shard_audit_report_clean(mode, overlap):
    model = _small_model(_ctx8())
    out = model.precompile(data_shapes={"data": (16, 4)},
                           label_shapes={"softmax_label": (16,)},
                           compression=mode, overlap=overlap,
                           shard_audit="report")
    (rep,) = out["shard_audit"]
    assert rep.findings == [], "\n".join(f.format() for f in rep.findings)
    assert rep.reconciliation["matched"]
    notes = {r["op"]: r for r in rep.reconciliation["notes"]}
    if mode == "int8":
        assert set(notes) == {"all-to-all", "all-gather"}
        for r in notes.values():
            assert r["profiled_count"] == 2 * r["plan_count"]
            assert r["payload_bytes"] == r["plan_payload_bytes"]
            assert r["wire_bytes"] == r["plan_wire_bytes"]
    else:
        assert notes == {}
    assert model.arg_params is not None and model._train_state is None


def _wide_bn_net(m):
    """A BatchNorm of 16,400 channels: 32,800 f32 running statistics,
    131,200 bytes, averaged over the replicas under compression."""
    s = m.symbol
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=16400)
    net = s.BatchNorm(data=net, name="bn1")
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=2)
    return s.SoftmaxOutput(data=net, name="softmax")


def test_averaged_statistics_planned_where_jax_allows_only_64_kib():
    _mesh8()
    kw = dict(data_shapes={"data": (16, 4)},
              label_shapes={"softmax_label": (16,)}, compression="int8",
              shard_audit="report")
    port = mt.FeedForward(_wide_bn_net(mt), ctx=_ctx8(), num_epoch=1)
    (rep,) = port.precompile(**kw)["shard_audit"]
    assert rep.findings == [] and rep.reconciliation["aux_elements"] == 32800
    assert {"op": "all-reduce", "dtype": "f32", "expected_elements": 32800,
            "hlo_elements": 32800, "hlo_dtype": "f32", "instances": 1} in \
        rep.reconciliation["matched"]
    ref = mx.FeedForward(_wide_bn_net(mx), ctx=[mx.cpu(i) for i in range(8)],
                         num_epoch=1)
    jfind = [f for r in ref.precompile(**kw)["shard_audit"]
             for f in r.findings]
    assert [(f.rule.id, f.node) for f in jfind] == \
        [("MX802", "all-reduce:f32")]
    assert "exceeds the small-all-reduce allowance" in jfind[0].message


def _blobs(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    return X, (X.sum(axis=1) > 0).astype(np.float32)


def _fit8(audit, guards=None, health=None):
    X, y = _blobs(64)
    mt.random.seed(0)
    model = _small_model(_ctx8(), initializer=mt.init.Xavier())
    model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
              compression="int8", overlap=True, guards=guards,
              health=health, shard_audit=audit)
    return model


def test_fit_shard_audit_trains_bitwise_as_without_it(monkeypatch):
    calls = []
    real = tshard.audit_step_program

    def spy(*a, **k):
        rep = real(*a, **k)
        calls.append(rep)
        return rep

    monkeypatch.setattr(tshard, "audit_step_program", spy)
    audited = _fit8(True, guards=True, health=True)
    plain = _fit8(None, guards=True, health=True)
    assert len(calls) == 1 and calls[0].errors == []
    assert audited.shard_audit_reports == calls
    assert audited.shard_audit_seconds > 0
    for k, v in plain.arg_params.items():
        assert torch.equal(audited.arg_params[k], v), k
    assert audited.guard_stats == plain.guard_stats


def test_fit_shard_audit_raises_before_any_step_moves_a_parameter(
        monkeypatch):
    def wrong(sync):
        return tcomm.allreduce_plan(sync.size, sync.num_workers,
                                    "int8"), tcomm.CompressionSpec("int8")

    monkeypatch.setattr(mt.model.FeedForward, "_shard_audit_plan",
                        staticmethod(wrong))
    X, y = _blobs(64)
    model = _small_model(_ctx8(), initializer=mt.init.Xavier())
    model._init_params({"data": (32, 4), "softmax_label": (32,)})
    before = {k: v.clone() for k, v in model.arg_params.items()}
    steps = []
    with pytest.raises(MXNetError, match="MX802"):
        model.fit(X, y, batch_size=32, compression="twobit", overlap=True,
                  shard_audit=True,
                  batch_end_callback=lambda p: steps.append(p.nbatch))
    assert steps == []
    for m in model._train_state.members:
        for k, v in m.params.items():
            assert torch.equal(v, before[k]), k
    assert model.shard_audit_reports == []


def test_env_turns_the_fit_gate_on(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SHARD_AUDIT", "1")
    model = _fit8(None)
    (rep,) = model.shard_audit_reports
    assert rep.errors == [] and rep.reconciliation["matched"]


# -- two gloo ranks -----------------------------------------------------------

WORLD, BATCH = 2, 16


@pytest.fixture(scope="module")
def gloo_fits(tmp_path_factory):
    rng = np.random.RandomState(3)
    X = rng.randn(2 * BATCH, 12).astype(np.float32)
    Y = rng.randint(0, 10, 2 * BATCH).astype(np.float32)
    args, aux = mt.convert.random_params(small_net(mt), 5, data=(BATCH, 12))
    cases = [{"mode": "int8", "overlap": True, "audit": True},
             {"mode": "twobit", "overlap": True, "audit": True},
             {"mode": "int8", "overlap": True, "audit": None},
             {"mode": "twobit", "overlap": True, "audit": True,
              "plan_mode": "int8"}]
    results = run_ranks(shard_audit_fit, WORLD,
                        tmp_path_factory.mktemp("shard_audit"), args, aux, X,
                        Y, BATCH, cases)
    return cases, results, args


def test_gloo_ranks_audit_clean_with_int8_note(gloo_fits):
    cases, results, _ = gloo_fits
    for rank_res in results:
        for case, res in list(zip(cases, rank_res))[:2]:
            assert res["error"] is None
            (rep,) = res["reports"]
            assert rep["findings"] == []
            assert rep["matched"]
            # BatchNorm's two running statistics of 32 channels, averaged
            assert rep["aux_elements"] == 64
            notes = {r["op"]: r for r in rep["notes"]}
            if case["mode"] == "int8":
                assert set(notes) == {"all-to-all", "all-gather"}
                for r in notes.values():
                    assert r["note"] == \
                        "int8 codes and scales as two collectives"
                    assert r["profiled_count"] == 2 * r["plan_count"]
                    assert r["payload_bytes"] == r["plan_payload_bytes"]
                    assert r["wire_bytes"] == r["plan_wire_bytes"]
            else:
                assert notes == {}


def test_gloo_ranks_audited_fit_is_bitwise_the_plain_one(gloo_fits):
    _, results, _ = gloo_fits
    for rank_res in results:
        audited, plain = rank_res[0]["params"], rank_res[2]["params"]
        for k in plain:
            np.testing.assert_array_equal(audited[k], plain[k])


def test_gloo_ranks_wrong_plan_raises_before_a_step(gloo_fits):
    _, results, args = gloo_fits
    for rank_res in results:
        res = rank_res[3]
        assert res["error"] is not None and "MX802" in res["error"]
        for k, v in args.items():
            np.testing.assert_array_equal(res["params"][k], v)


# -- the full-stack self-check ------------------------------------------------

def test_selfcheck_full_stack_dp8_zero_findings():
    _ctx8()
    rep = tanalysis.selfcheck_report()
    assert rep.findings == [], "\n".join(f.format() for f in rep.findings)
    rec = rep.reconciliation
    assert rec["matched"] and rec["unplanned"] == []
    for row in rec["matched"] + rec["widened"]:
        assert row["hlo_elements"] >= row["expected_elements"]
    assert {r["op"] for r in rec["notes"]} == {"all-to-all", "all-gather"}
    assert not rep.errors
