"""The overhead benches of the port (``mxnet_tpu_torch/tools/bench_{telemetry,
trace,mem,health,profile}.py``) at ``--smoke --cpu``, each in a process of
its own, against what ``tests/test_bench_entry.py`` holds of the JAX
package's ``bench.py`` modes: the metric, the contract keys and the
structural assertions. The health detectors' latencies are held against the
JAX package's ``HealthMonitor`` on the same synthetic streams.

The JAX modes' wall-clock shares (under 2% of a step, a profile poll under
0.5%) are held on the card only (``tests/test_torch_bench_subsystems_card.py``
and ``chip_smoke.py`` phase ``bench_subsystems``): on a loaded build box
such a share measures the box's load. Each bench prints its share here
beside its JAX bound, and a share must be positive. Also here: every
bench's entry raises naming CUDA without ``--cpu`` where there is none.
"""

import ast
import importlib
import os

import pytest
import torch

import mxnet_tpu.telemetry as jtel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import (bench_health, bench_mem, bench_profile,
                                   bench_telemetry, bench_trace)
from torch_bench_util import REPO, contract, run_benches  # noqa: F401

NAMES = ("telemetry", "trace", "mem", "health", "profile")
ALL = ("telemetry", "trace", "mem", "health", "profile", "comm", "overlap",
       "kernels", "elastic", "ckpt", "lockwatch", "controller", "compile")


@pytest.fixture(scope="module")
def bench(run_benches):  # noqa: F811
    return run_benches(*NAMES)


def test_telemetry_smoke_contract(bench):
    """``tests/test_bench_entry.py:49-60``."""
    blob = bench("telemetry")
    contract(blob, "telemetry", "telemetry_hub_overhead_pct_of_step",
             ("value", "vs_baseline", "emit_ns", "observe_ns", "counter_ns",
              "step_ms_baseline", "step_ms_telemetry",
              "timeline_overhead_pct", "bounds"))
    assert blob["emit_ns"] > 0 and blob["step_ms_baseline"] > 0
    bench_telemetry.check(blob)
    assert blob["jax_hub_ops_per_step"] == 10
    assert blob["bounds"]["value"]["bound"] == 2.0
    assert blob["axis_size"] == 8


def test_trace_smoke_contract(bench):
    """``tests/test_bench_entry.py:74-87``."""
    blob = bench("trace")
    contract(blob, "trace", "trace_flight_overhead_pct_of_step",
             ("value", "vs_baseline", "note_ns", "sink_ns", "ctx_ns",
              "mint_ns", "step_ms_baseline", "step_ms_traced",
              "traced_overhead_pct", "flight_steps_recorded", "bounds"))
    assert blob["note_ns"] > 0 and blob["step_ms_baseline"] > 0
    bench_trace.check(blob)  # the black box was live, its ops counted


def test_mem_smoke_contract(bench):
    """``tests/test_bench_entry.py:103-119``. Two of its assertions differ
    here, as ROADMAP C.2 records: the port's fit makes no NDArray, so the
    live-array ledger reads a watermark of 0 over the fit, and on the CPU
    ``precompile`` captures nothing, so no memory plan is recorded (the
    card test holds at least one). The ops priced are those counted over a
    tracked fit: no ledger add, the timeline's phase samples."""
    blob = bench("mem")
    contract(blob, "mem", "memory_ledger_overhead_pct_of_step",
             ("value", "vs_baseline", "add_ns", "sample_ns",
              "step_ms_baseline", "step_ms_tracked", "tracked_overhead_pct",
              "watermark_mb", "memory_plans_registered", "bounds"))
    assert blob["add_ns"] > 0 and blob["step_ms_baseline"] > 0
    bench_mem.check(blob)
    assert blob["watermark_mb"] == 0.0
    assert blob["ledger_ops_per_step"] == 0.0
    assert blob["memory_plans_registered"] == 0


def test_health_smoke_contract(bench):
    """``tests/test_bench_entry.py:137-162``: the statistics' FLOP share
    (counted, not timed: held under the JAX bound here too), the per-layer
    table and the detection latencies."""
    blob = bench("health")
    contract(blob, "health", "health_stats_overhead_pct_of_step",
             ("value", "vs_baseline", "flops_per_step_baseline",
              "flops_per_step_health", "step_ms_baseline", "step_ms_health",
              "wall_overhead_pct", "health_events", "layers",
              "detect_latency_steps"))
    assert 0 < blob["value"] < 2.0, blob
    bench_health.check(blob)  # the FLOP delta and the latencies
    assert blob["health_events"] > 0
    assert {row["layer"] for row in blob["layers"]} == {"fc1", "fc2"}
    for row in blob["layers"]:
        assert row["max_grad_norm"] > 0, row


@pytest.mark.parametrize("kind", bench_health.KINDS)
def test_health_latency_is_the_jax_monitors(bench, kind):
    """The bench's latencies against the JAX package's ``HealthMonitor``
    fed the same synthetic stream (``bench.py:1343-1381``)."""
    want = bench_health.detect_latency(kind, tel=jtel)
    assert bench("health")["detect_latency_steps"][kind] == want
    assert bench_health.detect_latency(kind) == want


def test_profile_smoke_contract(bench):
    """``tests/test_bench_entry.py:375-404``: coverage of the window's
    device time (the CPU's op time here) by named layers and kernels,
    the hotspot table, measured roofline rows, the MFU reconciliation and
    the window priced as badput."""
    blob = bench("profile")
    contract(blob, "profile", "profile_attribution_coverage_pct",
             ("value", "vs_baseline", "window_steps", "device_ms",
              "unattributed_ms", "layers_ms", "top", "roofline",
              "measured_mfu_pct", "mfu_delta_pct", "profile_badput_s",
              "out_of_window_poll_ns", "out_of_window_overhead_pct",
              "step_ms", "bounds"))
    bench_profile.check(blob)  # coverage of at least 80%, fc1 and fc2
    assert blob["unattributed_ms"] >= 0.0
    assert blob["top"] and blob["top"][0]["ms"] > 0
    assert blob["roofline"], blob
    for row in blob["roofline"]:
        assert row["source"] == "measured", row
        assert row["model_flops"] > 0 and row["measured_ms_per_step"] > 0
        assert row.get("bound") in ("compute", "bandwidth"), row
    assert blob["measured_mfu_pct"] is not None
    assert blob["mfu_delta_pct"] is not None
    assert blob["out_of_window_overhead_pct"] >= 0
    assert blob["profile_badput_s"] > 0


# -- every bench -------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_entry_needs_cuda_without_cpu(name, monkeypatch, tmp_path):
    """Without ``--cpu`` each bench raises naming CUDA where there is none,
    before it writes anything; nothing is timed on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    module = importlib.import_module(f"mxnet_tpu_torch.tools.bench_{name}")
    with pytest.raises(MXNetError, match="CUDA"):
        module.main(["--out", str(tmp_path / "o.json")])
    assert not (tmp_path / "o.json").exists()


@pytest.mark.parametrize("name", ALL)
def test_bench_imports_no_jax_and_names_its_mode(name):
    """No import of jax, the JAX package or ``bench`` at any depth of the
    file; it names the ``bench.py`` function it ports; its default output
    is under the ignored ``build/``, never the JAX benches' files."""
    from mxnet_tpu_torch.tools import _subsystem

    path = os.path.join(REPO, "mxnet_tpu_torch", "tools", f"bench_{name}.py")
    with open(path) as f:
        source = f.read()
    for node in ast.walk(ast.parse(source)):
        names = [a.name for a in node.names] \
            if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) and \
            not node.level else []
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "mxnet_tpu",
                                           "bench"), (name, n)
    assert f"run_{'kernel' if name == 'kernels' else name}_bench" in source
    out = _subsystem.out_path(type("A", (), {"out": None})(), name)
    assert out.parent == _subsystem.WORK_DIR
    assert out.name == f"BENCH_{name.upper()}_torch.json"
    assert "build" in out.parts
