"""The training-health statistics' cost and their detectors: the port's
counterpart of ``bench.py --health-bench`` (``run_health_bench``).

Three measurements: (1) the statistics' cost, the headline: two dp-8 MLP
fits, health off and on, priced as the FLOP delta of their steps, counted
by ``telemetry.mfu.FlopCounter`` over each fit's first step (the
``model_flops_per_step`` gauge; the JAX bench counts the jaxpr), as a
share of the baseline step's FLOPs (the JAX bound: under 2%); the raw wall
delta beside it. (2) The per-layer table of the instrumented run's health
events. (3) Detection latency: synthetic streams through the
``HealthMonitor`` detectors (a layer's gradient norm exploding, a loss
spike, a nonfinite step), steps from injection to the ``health_anomaly``
event; acceptance: nonfinite in 0 steps, explosion and spike within 1.

    python -m mxnet_tpu_torch.tools.bench_health [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from .. import telemetry
from ..telemetry.health import aggregate_events
from . import _bench
from . import _subsystem as sub
from .bench_mem import shapes

METRIC = "health_stats_overhead_pct_of_step"
BOUND_PCT = 2.0
KINDS = ("nonfinite", "grad_explosion", "loss_spike")


def detect_latency(kind, tel=telemetry):
    """Steps from an injected anomaly of ``kind`` to its detection through
    ``tel.HealthMonitor`` (None: missed within 8 steps), after 40 healthy
    steps drawn from ``np.random.RandomState(7)`` (``bench.py:1343-1381``).
    ``tel`` is a telemetry package with ``reset``, ``HealthMonitor`` and
    ``HealthConfig``: this package's by default."""
    tel.reset()
    mon = tel.HealthMonitor(tel.HealthConfig())
    srng = np.random.RandomState(7)
    base = 40
    for i in range(base):
        stats = {"fc1": {"grad_norm": 1.0 + 0.05 * srng.randn(),
                         "weight_norm": 1.0, "update_ratio": 1e-3,
                         "nonfinite": 0},
                 "fc2": {"grad_norm": 2.0 + 0.1 * srng.randn(),
                         "weight_norm": 1.0, "update_ratio": 1e-3,
                         "nonfinite": 0}}
        mon.observe({"kind": "health", "epoch": 0, "step": i,
                     "loss": 1.0 + 0.01 * srng.randn(), "finite": True,
                     "stats": stats})
    for k in range(8):
        stats = {"fc1": {"grad_norm": 1.0, "weight_norm": 1.0,
                         "update_ratio": 1e-3, "nonfinite": 0},
                 "fc2": {"grad_norm": 2.0, "weight_norm": 1.0,
                         "update_ratio": 1e-3, "nonfinite": 0}}
        loss = 1.0
        if kind == "grad_explosion":
            stats["fc2"]["grad_norm"] = 20.0 * (k + 1)
        elif kind == "loss_spike":
            loss = 20.0
        elif kind == "nonfinite":
            stats["fc2"]["nonfinite"] = 17
        found = mon.observe({"kind": "health", "epoch": 0,
                             "step": base + k, "loss": loss,
                             "finite": kind != "nonfinite", "stats": stats})
        if any(r[0] == kind for r in found):
            return k
    return None


def run(args):
    dev = _bench.card(args.cpu, "bench_health")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs = shapes(smoke)
    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch
    telemetry.measured_peak_flops(device=dev)

    def timed_fit(health, jsonl=None):
        telemetry.reset()
        model = sub.build_mlp(hidden, classes, epochs, dev)
        # the warm-up fit without the sink: the counts and the table
        # describe the instrumented run only
        model.fit(X, y, batch_size=batch,
                  telemetry=telemetry.TelemetryConfig(memory=False),
                  health=health)
        sub.synchronize(dev)
        tel = telemetry.TelemetryConfig(jsonl=jsonl, memory=False)
        t0 = time.perf_counter()
        model.fit(X, y, batch_size=batch, telemetry=tel, health=health)
        sub.synchronize(dev)
        wall = time.perf_counter() - t0
        flops = telemetry.hub().snapshot()["gauges"].get(
            "model_flops_per_step", 0.0)
        return wall, flops

    jsonl = os.path.join(tempfile.mkdtemp(prefix="mxtorch_health_bench_"),
                         "run.jsonl")
    wall_off, flops_off = timed_fit(False)
    wall_on, flops_on = timed_fit(True, jsonl=jsonl)
    step_s_off = wall_off / (epochs * steps_per_epoch)
    step_s_on = wall_on / (epochs * steps_per_epoch)
    flop_overhead_pct = (flops_on - flops_off) / flops_off * 100.0 \
        if flops_off else 0.0
    wall_overhead_pct = (wall_on - wall_off) / wall_off * 100.0

    rows = telemetry.read_events(jsonl)
    health_events = [e for e in rows if e.get("kind") == "health"]
    run_anomalies = [e for e in rows if e.get("kind") == "health_anomaly"]
    layer_table = [{"layer": k, **v}
                   for k, v in sorted(aggregate_events(rows).items())]
    latency = {kind: detect_latency(kind) for kind in KINDS}

    result = {
        "metric": METRIC,
        "value": round(flop_overhead_pct, 4),
        "unit": "%",
        "vs_baseline": round(flop_overhead_pct, 4),
        "flops_per_step_baseline": flops_off,
        "flops_per_step_health": flops_on,
        "step_ms_baseline": round(step_s_off * 1e3, 3),
        "step_ms_health": round(step_s_on * 1e3, 3),
        "wall_overhead_pct": round(wall_overhead_pct, 2),
        "health_events": len(health_events),
        "anomalies_in_run": len(run_anomalies),
        "layers": layer_table,
        "detect_latency_steps": latency,
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "axis_size": sub.REPLICAS,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {"value": sub.bound_flag(flop_overhead_pct, BOUND_PCT)},
        "notes": (
            "headline = FlopCounter delta of the health-instrumented step "
            "against the bare one (each fit's first step, the "
            "model_flops_per_step gauge), as % of the baseline FLOPs; "
            "wall_overhead_pct is the raw dp-8 wall delta (the per-step "
            "pull of the statistics and the detectors included). "
            "detect_latency_steps: steps from a synthetic injection to the "
            "health_anomaly event through the HealthMonitor detectors. "
            + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "health", args)


def check(result):
    """The bench's gates: each detector within one step (nonfinite at
    once), the health step counting more FLOPs than the plain one."""
    lat = result["detect_latency_steps"]
    sub.require(lat["nonfinite"] == 0 and lat["grad_explosion"] is not None
                and lat["grad_explosion"] <= 1
                and lat["loss_spike"] is not None and lat["loss_spike"] <= 1,
                f"bench_health: the detection latencies {lat}")
    sub.require(result["flops_per_step_health"]
                > result["flops_per_step_baseline"],
                "bench_health: the health step counts more FLOPs")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
