"""Telemetry-hub overhead on the dp-8 MLP step: the port's counterpart of
``bench.py --telemetry-bench`` (``run_telemetry_bench``).

Three measurements: (1) the hub's per-operation cost (``emit``,
``observe``, ``counter``, ``gauge``), timed on the host; (2) the dp-8 MLP
``fit()`` without telemetry; (3) the same fit with ``telemetry=True``
(timeline, MFU, a sync each step). The hub writes a step are counted over
one more fit with ``telemetry=True``. The headline is the hub's share of
the baseline step: each write counted a step x its measured cost / step
time (the JAX bound: under 2%; the JAX bench assumes
:data:`JAX_HUB_OPS_PER_STEP` writes a step, printed beside the count).
``timeline_overhead_pct`` is the raw wall delta of (3) over (2).

    python -m mxnet_tpu_torch.tools.bench_telemetry [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

from .. import telemetry
from ..telemetry.hub import MetricsHub
from . import _bench
from . import _subsystem as sub

METRIC = "telemetry_hub_overhead_pct_of_step"
BOUND_PCT = 2.0
# what the JAX bench assumes a step: 1 span emit + ~6 observes + ~3 counters
JAX_HUB_OPS_PER_STEP = 10
HUB_OPS = ("emit", "observe", "counter", "gauge")
HUB_REPS = 20000


def shapes(smoke):
    """``bench.py:913-916``: dims, rows and epochs."""
    dim, hidden, classes = (128, 256, 8) if smoke else (256, 1024, 32)
    batch, n_rows = (128, 1024) if smoke else (256, 4096)
    epochs = 3 if smoke else 6
    return dim, hidden, classes, batch, n_rows, epochs


def hub_op_ns():
    """Nanoseconds of one of each of :data:`HUB_OPS` on a fresh hub."""
    hub = telemetry.reset()
    calls = {"emit": lambda i: hub.emit("bench", i=i),
             "observe": lambda i: hub.observe("bench_seconds", 0.001),
             "counter": lambda i: hub.counter("bench_total"),
             "gauge": lambda i: hub.gauge("bench_value", 1.0)}
    return {op: sub.per_op_ns(calls[op], HUB_REPS) for op in HUB_OPS}


def run(args):
    dev = _bench.card(args.cpu, "bench_telemetry")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs = shapes(smoke)
    op_ns = hub_op_ns()

    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch
    telemetry.measured_peak_flops(device=dev)  # the probe outside timing

    def build():
        return sub.build_mlp(hidden, classes, epochs, dev)

    wall_off = sub.timed_fit(build, X, y, batch, dev, telemetry=None)
    wall_on = sub.timed_fit(build, X, y, batch, dev, telemetry=True)
    step_s_off = wall_off / (epochs * steps_per_epoch)
    step_s_on = wall_on / (epochs * steps_per_epoch)
    per_step = sub.counted_fit(build, X, y, batch, epochs * steps_per_epoch,
                               [(MetricsHub, op) for op in HUB_OPS],
                               telemetry=True)
    hub_ns = sum(per_step[op] * op_ns[op] for op in HUB_OPS)
    hub_overhead_pct = hub_ns / (step_s_off * 1e9) * 100.0
    timeline_overhead_pct = (wall_on - wall_off) / wall_off * 100.0

    result = {
        "metric": METRIC,
        "value": round(hub_overhead_pct, 4),
        "unit": "%",
        "vs_baseline": round(hub_overhead_pct, 4),
        **{f"{op}_ns": round(op_ns[op], 1) for op in HUB_OPS},
        "hub_ops_per_step": round(sum(per_step.values()), 2),
        "hub_ops_by_kind_per_step": {op: round(per_step[op], 2)
                                     for op in HUB_OPS},
        "jax_hub_ops_per_step": JAX_HUB_OPS_PER_STEP,
        "step_ms_baseline": round(step_s_off * 1e3, 3),
        "step_ms_telemetry": round(step_s_on * 1e3, 3),
        "timeline_overhead_pct": round(timeline_overhead_pct, 2),
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "axis_size": sub.REPLICAS,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {"value": sub.bound_flag(hub_overhead_pct, BOUND_PCT)},
        "notes": (
            "hub overhead = each hub write counted a step of a "
            "telemetry=True fit x its measured cost, against the "
            "un-instrumented step (the always-on tax); "
            "timeline_overhead_pct also holds the opt-in per-step output "
            "sync and one FLOP count per fit. " + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "telemetry", args)


def check(result):
    """The bench's gates: hub writes counted and priced."""
    sub.require(result["hub_ops_per_step"] > 0 and result["value"] > 0,
                f"bench_telemetry: hub writes counted and priced: "
                f"{result['hub_ops_by_kind_per_step']}")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
