"""Flight-recorder and trace-propagation overhead on the dp-8 MLP step: the
port's counterpart of ``bench.py --trace-bench`` (``run_trace_bench``).

The always-on black box and the distributed-tracing identity work must
cost under 2% of a dp-8 step (the JAX bound). Three measurements: (1) the
per-op costs tracing adds a step, timed on the host: one flight
``note_step`` ring append, one rank-stamped event through the recorder's
sink, one ``trace_ctx()`` capture, one span-id mint; (2) the dp-8 MLP
``fit()`` without telemetry; (3) the same fit with the timeline and flight
recording on (the opt-in per-step sync included). The tracing ops a step
are counted over one more traced fit. The headline is each op counted a
step x its cost / the baseline step (the JAX bench assumes one of each a
step, :data:`JAX_OPS_PER_STEP`, printed beside the count).

    python -m mxnet_tpu_torch.tools.bench_trace [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

from .. import telemetry
from ..telemetry import distributed
from ..telemetry.flight import FlightRecorder
from . import _bench
from . import _subsystem as sub
from .bench_telemetry import shapes

METRIC = "trace_flight_overhead_pct_of_step"
BOUND_PCT = 2.0
OP_REPS = 20000
# a tracing op's calls in a fit: the ring append, the recorder's sink, the
# trace-context capture (through the package or its module), the span-id
# mint
COUNTED = {"note": [(FlightRecorder, "note_step")],
           "sink": [(FlightRecorder, "write_event")],
           "ctx": [(telemetry, "trace_ctx"), (distributed, "trace_ctx")],
           "mint": [(distributed, "mint_span_id")]}
JAX_OPS_PER_STEP = {"note": 1, "sink": 1, "ctx": 1, "mint": 1}


def tracing_op_ns():
    """``(note_ns, sink_ns, ctx_ns, mint_ns, recorder)`` on a fresh hub
    and recorder."""
    reps = OP_REPS
    telemetry.reset()
    telemetry.flight.reset()
    rec = telemetry.flight.recorder()
    note_ns = sub.per_op_ns(lambda i: rec.note_step(0, i), reps)
    span_event = {"kind": "span", "name": "step", "epoch": 0, "step": 0,
                  "dur_ms": 1.0, "phases": [], "rank": 0}
    sink_ns = sub.per_op_ns(lambda i: rec.write_event(span_event), reps)
    ctx_ns = sub.per_op_ns(lambda i: telemetry.trace_ctx(), reps)
    mint_ns = sub.per_op_ns(lambda i: telemetry.mint_span_id(0, 0, i), reps)
    return note_ns, sink_ns, ctx_ns, mint_ns, rec


def run(args):
    dev = _bench.card(args.cpu, "bench_trace")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs = shapes(smoke)
    note_ns, sink_ns, ctx_ns, mint_ns, rec = tracing_op_ns()

    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch
    telemetry.measured_peak_flops(device=dev)

    def build():
        return sub.build_mlp(hidden, classes, epochs, dev)

    wall_off = sub.timed_fit(build, X, y, batch, dev, telemetry=None)
    wall_on = sub.timed_fit(build, X, y, batch, dev, telemetry=True)
    step_s_off = wall_off / (epochs * steps_per_epoch)
    step_s_on = wall_on / (epochs * steps_per_epoch)
    by_name = sub.counted_fit(
        build, X, y, batch, epochs * steps_per_epoch,
        [t for targets in COUNTED.values() for t in targets],
        telemetry=True)
    per_step = {op: by_name[targets[0][1]]
                for op, targets in COUNTED.items()}
    op_ns = {"note": note_ns, "sink": sink_ns, "ctx": ctx_ns,
             "mint": mint_ns}
    overhead_pct = sum(per_step[op] * op_ns[op] for op in COUNTED) \
        / (step_s_off * 1e9) * 100.0
    traced_overhead_pct = (wall_on - wall_off) / wall_off * 100.0

    result = {
        "metric": METRIC,
        "value": round(overhead_pct, 4),
        "unit": "%",
        "vs_baseline": round(overhead_pct, 4),
        "note_ns": round(note_ns, 1),
        "sink_ns": round(sink_ns, 1),
        "ctx_ns": round(ctx_ns, 1),
        "mint_ns": round(mint_ns, 1),
        "step_ms_baseline": round(step_s_off * 1e3, 3),
        "step_ms_traced": round(step_s_on * 1e3, 3),
        "traced_overhead_pct": round(traced_overhead_pct, 2),
        "ops_per_step": {op: round(n, 2) for op, n in per_step.items()},
        "jax_ops_per_step": JAX_OPS_PER_STEP,
        "flight_steps_recorded": len(rec.snapshot()[0]),
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "axis_size": sub.REPLICAS,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {"value": sub.bound_flag(overhead_pct, BOUND_PCT)},
        "notes": (
            "headline = measured per-op cost of the tracing additions "
            "(flight ring append, rank-stamped emit through the recorder "
            "sink, trace-context capture, span-id mint) x each one's calls "
            "a step counted over a traced fit (ops_per_step), against the "
            "un-instrumented dp-8 step; step_ms_traced also holds the "
            "opt-in timeline's per-step sync. " + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "trace", args)


def check(result):
    """The bench's gates: the black box live, tracing ops counted."""
    sub.require(result["flight_steps_recorded"] > 0
                and result["value"] > 0,
                f"bench_trace: the flight recorder was live and its ops "
                f"counted: {result['ops_per_step']}")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
