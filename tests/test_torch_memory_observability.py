"""The port's memory observability against the JAX package's:
``utils.memory.memory_stats`` (the base keys, 0 on the CPU), the
live-array ledger over the port's NDArray, the epoch leak detector, the
OOM preflight (names, ranking and message), the memory-plan table and its
hub gauges, all from the same inputs. The captured programs' plans on the
card are tested in tests/test_torch_observability_card.py."""

import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import telemetry as jt
from mxnet_tpu.telemetry import memory as jmem
from mxnet_tpu.utils import compile as jcompile
from mxnet_tpu.utils import memory as jutil
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import telemetry as tt
from mxnet_tpu_torch.telemetry import memory as tmem
from mxnet_tpu_torch.utils import compile as tcompile
from mxnet_tpu_torch.utils import memory as tutil


def test_memory_stats_base_keys_zero_on_the_cpu():
    assert tutil.BASE_KEYS == jutil.BASE_KEYS
    stats = tutil.memory_stats(torch.device("cpu"))
    assert stats == {"cpu": {k: 0 for k in tutil.BASE_KEYS}}
    jstats = jutil.memory_stats()
    for row in jstats.values():
        assert {k: row[k] for k in jutil.BASE_KEYS} == stats["cpu"]
    assert tmem.hbm_budget() is None or torch.cuda.is_available()


def _tracked(pkg, shapes):
    led = (jmem if pkg is mx else tmem).ledger()
    mod = jt if pkg is mx else tt
    prev = mod.track_arrays(True)
    led.clear()
    try:
        arrs = [pkg.nd.array(np.zeros(s, np.float32), ctx=pkg.cpu())
                for s in shapes]
        alias = pkg.nd.NDArray(arrs[0])  # a second wrapper of one buffer
        stats = led.stats()
        top = led.top_arrays(3)
        del arrs, alias
        gc.collect()
        after = led.stats()
    finally:
        mod.track_arrays(prev)
    return stats, top, after


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_counts_as_jax(seed):
    rng = np.random.RandomState(seed)
    shapes = [tuple(rng.randint(1, 40, size=rng.randint(1, 4)))
              for _ in range(6)]
    js, jtop, jafter = _tracked(mx, shapes)
    ts, ttop, tafter = _tracked(mt, shapes)
    assert {k: ts[k] for k in ("live_bytes", "live_count",
                               "watermark_bytes")} == \
        {k: js[k] for k in ("live_bytes", "live_count", "watermark_bytes")}
    assert ts["by_platform"] == js["by_platform"] == {
        "cpu": {"bytes": js["live_bytes"], "count": len(shapes)}}
    assert ttop == jtop
    assert tafter["live_bytes"] == jafter["live_bytes"] == 0


def _leak_run(pkg, mem, mod, growth):
    mod.reset()
    prev = mod.track_arrays(True)
    mem.reset_leak_tracker()
    hoard, leaks = [], []
    try:
        for epoch in range(4):
            if growth:
                hoard.append(pkg.nd.zeros((128, 128), ctx=pkg.cpu()))
            else:
                a = pkg.nd.zeros((64, 64), ctx=pkg.cpu())
                del a
                gc.collect()
            leaks.append(mem.epoch_mark(epoch, drift_bytes=1024,
                                        consecutive=2))
    finally:
        mod.track_arrays(prev)
    return leaks, [e["watermark_bytes"] for e in
                   mod.hub().events("memory_watermark")]


@pytest.mark.parametrize("growth", [True, False])
def test_leak_detector_as_jax(growth):
    jl, jw = _leak_run(mx, jmem, jt, growth)
    tl, tw = _leak_run(mt, tmem, tt, growth)
    assert tl == jl and tw == jw
    assert (tl[2] is not None) == growth
    if growth:
        _, _, incidents = tt.flight.recorder().snapshot()
        assert any(e["kind"] == "memory_leak" for e in incidents)


def _tree(rng):
    return {"fc1_weight": rng.randn(16, 8).astype(np.float32),
            "fc1_bias": rng.randn(16).astype(np.float32),
            "bn_gamma": rng.randn(16).astype(np.float32)}


def test_named_bytes_and_preflight_message_as_jax():
    rng = np.random.RandomState(3)
    params = _tree(rng)
    opt = [rng.randn(16, 8).astype(np.float32),
           rng.randn(16).astype(np.float32)]
    aux = {"bn_moving_mean": rng.randn(16).astype(np.float32)}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    topt = [torch.from_numpy(v) for v in opt]
    taux = {k: torch.from_numpy(v) for k, v in aux.items()}
    jentries = jmem.preflight_entries(params, opt, aux, plan_label="p",
                                      plan={"total_bytes": 4096,
                                            "alias_bytes": 0})
    tentries = tmem.preflight_entries(tparams, topt, taux, plan_label="p",
                                      plan={"total_bytes": 4096,
                                            "alias_bytes": 0})
    assert tentries == jentries
    with pytest.raises(jt.MemoryPreflightError) as je:
        jmem.preflight(jentries, budget=1024, what="fit")
    with pytest.raises(tt.MemoryPreflightError) as te:
        tmem.preflight(tentries, budget=1024, what="fit")
    assert str(te.value) == str(je.value)
    ok = tmem.preflight(tentries, budget=1 << 20, what="fit")
    assert ok["fits"] and ok["entries"] == jmem.preflight(
        jentries, budget=1 << 20, what="fit")["entries"]


PLANS = {"train_step:abc": {"argument_bytes": 1 << 20, "output_bytes": 4096,
                            "temp_bytes": 3 << 20, "generated_code_bytes": 0,
                            "alias_bytes": 0, "total_bytes": (3 << 20) + 4096},
         "eval_step:abc": {"argument_bytes": 1 << 19, "output_bytes": 1024,
                           "temp_bytes": 1 << 18, "generated_code_bytes": 0,
                           "alias_bytes": 0, "total_bytes": (1 << 18) + 1024}}


def test_plan_table_gauges_and_events_as_jax():
    assert tcompile.MEMORY_PLAN_FIELDS == jcompile.MEMORY_PLAN_FIELDS
    assert tmem.plan_table(PLANS) == jmem.plan_table(PLANS)
    assert tmem.plan_table({}) == jmem.plan_table({})
    for comp, mod in ((jcompile, jt), (tcompile, tt)):
        comp.reset_compile_stats()
        mod.reset()
        for label, plan in PLANS.items():
            comp.registry().record_memory_plan(label, plan)
    assert tcompile.memory_plans() == jcompile.registry().memory_plans()
    assert tcompile.memory_plan_for("train_step:abc") == \
        PLANS["train_step:abc"]
    plan_lines = [l for l in tt.prom_dump().splitlines() if "memory_plan" in l]
    assert plan_lines == [l for l in jt.prom_dump().splitlines()
                          if "memory_plan" in l]
    assert [e["program"] for e in tt.hub().events("memory_plan")] == \
        list(PLANS)
    assert tmem.largest_plan(prefixes=("train_step:",)) == \
        ("train_step:abc", PLANS["train_step:abc"])


def test_plan_from_tensors_rule():
    args = [torch.zeros(10), {"w": torch.zeros(3, 4)}]
    outs = [torch.zeros(5, dtype=torch.float64)]
    plan = tcompile.memory_plan_from_tensors(args, outs, 1000)
    assert plan == {"argument_bytes": 88, "output_bytes": 40,
                    "temp_bytes": 1000, "generated_code_bytes": 0,
                    "alias_bytes": 0, "total_bytes": 1040}
    assert set(plan) == set(tcompile.MEMORY_PLAN_FIELDS)


def test_preflight_refuses_an_over_budget_fit_before_any_step(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_HBM_BYTES", "64")
    rng = np.random.RandomState(0)
    X = rng.randn(16, 64).astype(np.float32)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=1)
    before = tcompile.registry().snapshot()
    with pytest.raises(tt.MemoryPreflightError) as ei:
        model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=8)
    msg = str(ei.value)
    assert "exceeds" in msg and "param:['fc1_weight']" in msg
    assert tcompile.registry().snapshot()["misses"] == before["misses"]
    monkeypatch.setenv("MXNET_TPU_HBM_BYTES", str(1 << 30))
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=8)
    ev = tt.hub().events("memory_preflight")[-1]
    assert ev["fits"] is True and ev["budget_bytes"] == 1 << 30


def test_fit_memory_tracking_samples_and_marks(tmp_path):
    tt.reset()
    rng = np.random.RandomState(0)
    X = rng.randn(16, 64).astype(np.float32)
    model = mt.FeedForward(tmodels.mlp(), ctx=mt.cpu(), num_epoch=2)
    model.fit(X, (X[:, 0] > 0).astype(np.float32), batch_size=8,
              telemetry=True)
    assert len(tt.hub().events("memory_watermark")) == 2
    gauges = tt.hub().snapshot()["gauges"]
    assert "live_array_bytes" in gauges
    assert not tt.memory.tracking_enabled()
    snap = tt.memory.forensics_snapshot()
    assert snap["allocator"] and "ledger" in snap
