"""Memory-observability overhead on the dp-8 MLP step: the port's
counterpart of ``bench.py --mem-bench`` (``run_mem_bench``).

The live-array ledger and the phase-boundary sampler must cost under 2% of
a dp-8 step (the JAX bound). Three measurements: (1) the per-op costs,
timed on the host: one ledger ``add`` (a weakref and a locked insert, the
NDArray-creation hook) and one ``sample`` (three gauge writes); (2) the
dp-8 MLP ``fit()`` with telemetry and memory tracking off; (3) the same
fit with tracking on. The ledger adds and samples a step are counted over
one more tracked fit. The headline is each op counted a step x its cost /
the baseline step (the JAX bench assumes :data:`JAX_LEDGER_OPS_PER_STEP`
adds and :data:`JAX_SAMPLES_PER_STEP` samples, printed beside the
counts). Also the run's watermark and the memory plans registered: in the
port, the plans recorded when ``precompile`` captures a step's program
(``utils/compile.py``), here one replica's step, since the eight
replicas' steps run eager; the count is of this bench's capture alone.

    python -m mxnet_tpu_torch.tools.bench_mem [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

from .. import ndarray as nd
from .. import telemetry
from ..telemetry import memory as mem_mod
from ..telemetry.memory import ArrayLedger
from . import _bench
from . import _subsystem as sub

METRIC = "memory_ledger_overhead_pct_of_step"
BOUND_PCT = 2.0
# what the JAX bench assumes a step: NDArray creations, phase samples
JAX_LEDGER_OPS_PER_STEP = 4
JAX_SAMPLES_PER_STEP = 6
COUNTED = [(ArrayLedger, "add"), (mem_mod, "sample")]


def shapes(smoke):
    """``bench.py:1144-1147``."""
    dim, hidden, classes = (128, 256, 8) if smoke else (256, 1024, 32)
    batch, n_rows = (128, 1024) if smoke else (256, 4096)
    epochs = 2 if smoke else 6
    return dim, hidden, classes, batch, n_rows, epochs


def ledger_op_ns(reps, ctx):
    """``(add_ns, sample_ns)``: one ledger insert of a distinct array (the
    ledger keeps one entry a buffer, so each probe is its own) and one
    sample."""
    telemetry.reset()
    led = mem_mod.ledger()
    led.clear()
    probes = [nd.zeros((8, 8), ctx=ctx) for _ in range(reps)]
    add_ns = sub.per_op_ns(lambda i: led.add(probes[i]), reps)
    del probes
    led.clear()
    sample_ns = sub.per_op_ns(lambda i: mem_mod.sample(), reps)
    return add_ns, sample_ns


def run(args):
    dev = _bench.card(args.cpu, "bench_mem")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs = shapes(smoke)
    ctx = sub.contexts(dev, 1)[0]
    add_ns, sample_ns = ledger_op_ns(5000 if smoke else 20000, ctx)

    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch
    telemetry.measured_peak_flops(device=dev)

    def build():
        return sub.build_mlp(hidden, classes, epochs, dev)

    wall_off = sub.timed_fit(build, X, y, batch, dev,
                             telemetry=telemetry.TelemetryConfig(memory=False))
    wall_on = sub.timed_fit(build, X, y, batch, dev,
                            telemetry=telemetry.TelemetryConfig(memory=True))
    step_s_off = wall_off / (epochs * steps_per_epoch)
    step_s_on = wall_on / (epochs * steps_per_epoch)
    watermark = mem_mod.ledger().watermark_bytes
    per_step = sub.counted_fit(build, X, y, batch, epochs * steps_per_epoch,
                               COUNTED, telemetry=telemetry.TelemetryConfig(
                                   memory=True))

    # the step's program captured ahead records its memory plan; the
    # replicas' steps run eager, so the plan is one replica's program
    one = sub.build_mlp(hidden, classes, epochs, dev, world=1)
    plans_before = len(mem_mod.plans())
    one.precompile(data_shapes={"data": (batch, dim)},
                   label_shapes={"softmax_label": (batch,)})
    plans = len(mem_mod.plans()) - plans_before

    overhead_pct = (per_step["add"] * add_ns
                    + per_step["sample"] * sample_ns) \
        / (step_s_off * 1e9) * 100.0
    tracked_overhead_pct = (wall_on - wall_off) / wall_off * 100.0

    result = {
        "metric": METRIC,
        "value": round(overhead_pct, 4),
        "unit": "%",
        "vs_baseline": round(overhead_pct, 4),
        "add_ns": round(add_ns, 1),
        "sample_ns": round(sample_ns, 1),
        "ledger_ops_per_step": round(per_step["add"], 2),
        "samples_per_step": round(per_step["sample"], 2),
        "jax_ledger_ops_per_step": JAX_LEDGER_OPS_PER_STEP,
        "jax_samples_per_step": JAX_SAMPLES_PER_STEP,
        "step_ms_baseline": round(step_s_off * 1e3, 3),
        "step_ms_tracked": round(step_s_on * 1e3, 3),
        "tracked_overhead_pct": round(tracked_overhead_pct, 2),
        "watermark_mb": round(watermark / (1 << 20), 3),
        "memory_plans_registered": plans,
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "axis_size": sub.REPLICAS,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {"value": sub.bound_flag(overhead_pct, BOUND_PCT)},
        "notes": (
            "headline = measured per-op ledger/sampler cost x the ops "
            "counted a step of a tracked fit (ledger_ops_per_step, "
            "samples_per_step) against the tracking-off step; the port's "
            "fit makes no NDArray, so the ledger's adds are 0 and its "
            "watermark 0. tracked_overhead_pct is the "
            "raw wall delta of the same fit with tracking on. "
            "memory_plans_registered counts the plans this bench's "
            "precompile recorded for one replica's step (the eight replicas' "
            "steps run eager; on the CPU nothing is captured). "
            + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "mem", args)


def check(result):
    """The bench's gates: phase samples counted and priced; on the card,
    this bench's capture recorded a memory plan (on the CPU nothing is
    captured)."""
    sub.require(result["samples_per_step"] > 0 and result["value"] > 0,
                f"bench_mem: the sampler's calls counted and priced: "
                f"{result['samples_per_step']} a step")
    if sub.on_card(result):
        sub.require(result["memory_plans_registered"] >= 1,
                    f"bench_mem: precompile recorded a memory plan "
                    f"({result['memory_plans_registered']})")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
