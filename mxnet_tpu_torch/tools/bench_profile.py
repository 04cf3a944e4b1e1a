"""The device-time profiler's acceptance numbers: the port's counterpart of
``bench.py --profile-bench`` (``run_profile_bench``).

Three measurements: (1) attribution coverage, the headline: a dp-8 MLP fit
with a bounded capture window (guards and health on, the production
shape; the window's steps run eager under ``torch.profiler``, as
``telemetry/profiling.py`` does) must attribute at least 80% of the
window's device time to named layers and kernels (the JAX bound), the rest
an explicit ``unattributed`` row; the top-K table, the per-layer split and
the measured roofline rows beside it. (2) Measured against modelled MFU.
(3) The out-of-window overhead: once the window has closed, the loop's
only profiler cost is one state poll a step, timed on the host against the
measured step (the JAX bound: under 0.5%); the window itself is priced as
``profile`` badput.

    python -m mxnet_tpu_torch.tools.bench_profile [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import time

from .. import telemetry
from ..base import MXNetError
from ..telemetry import profiling
from . import _bench
from . import _subsystem as sub

METRIC = "profile_attribution_coverage_pct"
COVERAGE_BOUND_PCT = 80.0
POLL_BOUND_PCT = 0.5


def shapes(smoke):
    """``bench.py:1444-1448``: dims, rows, epochs and the window's steps."""
    dim, hidden, classes = (64, 128, 8) if smoke else (256, 1024, 32)
    batch, n_rows = (128, 1024) if smoke else (256, 4096)
    epochs = 2 if smoke else 4
    window = 4 if smoke else 8
    return dim, hidden, classes, batch, n_rows, epochs, window


def poll_ns(reps):
    """Nanoseconds of one out-of-window poll of a closed session."""
    ses = profiling.ProfileSession(telemetry.ProfileConfig(), layers=())
    ses._state = "done"

    def poll(_i):
        _ = ses.pending
        _ = ses.open

    return sub.per_op_ns(poll, reps)


def run(args):
    dev = _bench.card(args.cpu, "bench_profile")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs, window = shapes(smoke)
    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch
    telemetry.measured_peak_flops(device=dev)
    profiling.measured_peak_bandwidth(device=dev)

    telemetry.reset()
    model = sub.build_mlp(hidden, classes, epochs, dev)
    t0 = time.perf_counter()
    model.fit(X, y, batch_size=batch, guards=True, health=True,
              telemetry=telemetry.TelemetryConfig(memory=False),
              profile=telemetry.ProfileConfig(steps=window, warmup=2))
    sub.synchronize(dev)
    wall = time.perf_counter() - t0
    rep = model.profile_report
    if rep is None:
        raise MXNetError("bench_profile: the profiled fit made no report")
    summary = rep.to_dict(top_k=10)
    step_ms = wall / (epochs * steps_per_epoch) * 1e3

    p_ns = poll_ns(20000 if smoke else 200000)
    overhead_pct = p_ns / (step_ms * 1e6) * 100.0
    badput = sum(float(e.get("seconds", 0.0))
                 for e in telemetry.hub().events(kind="badput")
                 if e.get("reason") == "profile")
    mfu = summary.get("mfu", {})
    coverage = summary["coverage_pct"]
    result = {
        "metric": METRIC,
        "value": round(coverage, 2),
        "unit": "%",
        "vs_baseline": COVERAGE_BOUND_PCT,
        "window_steps": summary["steps"],
        "device_ms": round(summary["device_ms"], 3),
        "unattributed_ms": round(summary["unattributed_ms"], 3),
        "layers_ms": {k: round(v, 3) for k, v in summary["layers"].items()},
        "top": [{"layer": r.get("layer"), "op": r.get("op"),
                 "ms": round(r.get("us", 0.0) / 1e3, 4),
                 "pct": round(r.get("pct", 0.0), 2)}
                for r in summary["top"]],
        "roofline": summary["roofline"][:10],
        "measured_mfu_pct": mfu.get("measured_mfu_pct"),
        "modeled_mfu_pct": mfu.get("modeled_mfu_pct"),
        "mfu_delta_pct": mfu.get("delta_pct"),
        "profile_badput_s": round(badput, 4),
        "out_of_window_poll_ns": round(p_ns, 1),
        "out_of_window_overhead_pct": round(overhead_pct, 6),
        "step_ms": round(step_ms, 3),
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "axis_size": sub.REPLICAS,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {
            "value": sub.bound_flag(coverage, COVERAGE_BOUND_PCT,
                                    below=False),
            "out_of_window_overhead_pct": sub.bound_flag(overhead_pct,
                                                         POLL_BOUND_PCT)},
        "notes": (
            "headline = share of the window's device time attributed to "
            "named layers and kernels (>= 80% acceptance; the rest is the "
            "explicit unattributed row); the window's steps run eager under "
            "torch.profiler. roofline rows are source=measured: measured "
            "per-op seconds against the FlopCounter and kernel-registry "
            "models. out_of_window = the closed session's per-step state "
            "poll against the measured step (< 0.5% acceptance); the window "
            "itself is priced as `profile` badput. " + sub.TIME_SHARED
            + "."),
    }
    return sub.publish(result, "profile", args)


def check(result):
    """The bench's gates: the window's device time attributed to named
    layers and kernels, at least :data:`COVERAGE_BOUND_PCT`; the MLP's
    layers named."""
    sub.require(result["value"] >= COVERAGE_BOUND_PCT,
                f"bench_profile: the profiler attributed {result['value']}% "
                f"of the window's device time (at least "
                f"{COVERAGE_BOUND_PCT}%)")
    sub.require({"fc1", "fc2"} <= set(result["layers_ms"]),
                f"bench_profile: the MLP's layers named: "
                f"{sorted(result['layers_ms'])}")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
