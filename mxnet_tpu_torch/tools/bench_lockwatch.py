"""The price of the runtime lock-order watchdog: the port's counterpart of
``bench.py --lockwatch-bench`` (``run_lockwatch_bench``).

Two soaks with the watchdog armed in this process (``MXNET_TPU_LOCKWATCH``
semantics): (a) a 4-rank ``kvstore.create_group`` push soak with a churn
in the middle (rank 3 stops inside an open round and is deregistered,
then registered again), and (b) an elastic fit of the MLP over four
replicas of one device that shrinks to three in epoch 1 and regrows in
epoch 2: the two paths of the port that hold the most locks together.
Acceptance: zero lock-order cycles in both. The overhead is priced as the
bench prices it: the acquire/release pair's extra cost with the watchdog
on (timed on the host) x the acquisitions a step / the median step (the
JAX bound: under 2%).

    python -m mxnet_tpu_torch.tools.bench_lockwatch [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

import torch

from .. import kvstore as kv_mod
from .. import telemetry
from ..analysis import lockwatch
from ..resilience import ElasticCoordinator
from . import _bench
from . import _subsystem as sub

METRIC = "lockwatch_overhead_pct_of_step"
BOUND_PCT = 2.0
WORLD = 4
KV_WORKERS = 4


def shapes(smoke):
    """``bench.py:2221-2224``: the full layer widths in both modes (the
    overhead's denominator must be a real step); smoke trims rows and
    epochs only."""
    dim, hidden, classes = 256, 1024, 16
    batch, n_rows = 96, 960 if smoke else 3840
    return dim, hidden, classes, batch, n_rows, 4 if smoke else 6


def pair_ns(reps):
    """``(ns off, ns on)``: one acquire/release pair of a watched lock,
    the best of three runs with the watchdog off, then on."""
    lk = lockwatch.named_lock("bench.probe")

    def pairs(_i):
        lk.acquire()
        lk.release()

    lockwatch.disable()
    sub.per_op_ns(pairs, reps // 10)  # warm
    off = min(sub.per_op_ns(pairs, reps) for _ in range(3))
    lockwatch.enable()
    lockwatch.reset()
    sub.per_op_ns(pairs, reps // 10)
    on = min(sub.per_op_ns(pairs, reps) for _ in range(3))
    return off, on


def kv_soak(rounds):
    """``(cycles, hung)`` of the group-kvstore churn soak
    (``bench.py:2182-2210``)."""
    lockwatch.reset()
    churn_at = rounds // 3
    workers = kv_mod.create_group(KV_WORKERS, op_timeout=120.0)
    server = workers[0]._server
    server.init("k", torch.zeros(256).numpy())
    soak_rounds = {0: rounds, 1: rounds, 2: rounds, 3: churn_at}

    def run_worker(rank):
        w = workers[rank]
        for _ in range(soak_rounds[rank]):
            w.push("k", torch.ones(256))

    ts = [threading.Thread(target=run_worker, args=(r,), daemon=True)
          for r in range(KV_WORKERS)]
    for t in ts:
        t.start()
    ts[3].join(timeout=300)      # rank 3 stops after churn_at rounds
    time.sleep(0.05)             # the others block in the open round
    server.deregister_worker(3)  # the churn, inside the open round
    for t in ts[:3]:
        t.join(timeout=300)
    server.register_worker(3)    # back between rounds
    hung = any(t.is_alive() for t in ts)
    return len(lockwatch.report()["cycles"]), hung


def resize_driver(co):
    """``bench.py:2243-2247``: one replica killed at step 2 of epoch 1,
    rejoined at step 2 of epoch 2."""

    def drive(param):
        if param.epoch == 1 and param.nbatch == 2 and co.world_size == 4:
            # the bench's planted failure, not a policy decision
            co.kill()  # mxlint: disable=MX311
        if param.epoch == 2 and param.nbatch == 2 and co.world_size == 3:
            co.join_all()

    return drive


def run(args):
    dev = _bench.card(args.cpu, "bench_lockwatch")
    smoke = bool(args.smoke)
    rounds = 30 if smoke else 200
    off_ns, on_ns = pair_ns(20000 if smoke else 200000)
    delta_ns = max(on_ns - off_ns, 0.0)
    kv_cycles, kv_hung = kv_soak(rounds)

    lockwatch.reset()
    dim, hidden, classes, batch, n_rows, epochs = shapes(smoke)
    model = sub.build_mlp(hidden, classes, epochs, dev, world=WORLD)
    X, y = sub.mlp_data(n_rows, dim, classes)
    telemetry.reset()
    telemetry.measured_peak_flops(device=dev)
    co = ElasticCoordinator(WORLD)
    tmp = tempfile.mkdtemp(prefix="mxtorch_lockwatch_bench_")
    acq0 = lockwatch.watcher().acquires
    model.fit(X, y, batch_size=batch, elastic=co,
              sharded_checkpoint_dir=os.path.join(tmp, "ckpt"),
              batch_end_callback=resize_driver(co), telemetry=True)
    acq1 = lockwatch.watcher().acquires
    rep = lockwatch.report()
    fit_cycles = len(rep["cycles"])
    lockwatch.publish()

    spans = model.telemetry.steps()
    durs = sorted(s.duration for s in spans)
    step_ms = durs[len(durs) // 2] * 1e3 if durs else 0.0
    total_steps = max(len(spans), 1)
    acquires_per_step = (acq1 - acq0) / total_steps
    overhead_pct = (acquires_per_step * delta_ns) / (step_ms * 1e6) * 100.0 \
        if step_ms else 0.0
    lockwatch.disable()

    result = {
        "metric": METRIC,
        "value": round(overhead_pct, 4),
        "unit": "%",
        "vs_baseline": round(overhead_pct, 4),
        "pair_ns_off": round(off_ns, 1),
        "pair_ns_on": round(on_ns, 1),
        "pair_delta_ns": round(delta_ns, 1),
        "acquires_per_step": round(acquires_per_step, 1),
        "step_ms": round(step_ms, 3),
        "steps": total_steps,
        "cycles": fit_cycles,
        "max_hold_ms": rep["max_hold_ms"],
        "stalls": len(rep["stalls"]),
        "kv_soak": {"workers": KV_WORKERS, "rounds": rounds,
                    "churn_resizes": 2, "cycles": kv_cycles,
                    "hung": bool(kv_hung)},
        "resizes": co.resizes,
        "worlds": [h["to"] for h in co.history],
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {"value": sub.bound_flag(overhead_pct, BOUND_PCT)},
        "notes": (
            "overhead = the pair's extra cost with the watchdog on x "
            "acquisitions a step / the median step (two timed whole runs "
            "would drown it in the host's noise). Acceptance: zero "
            "lock-order cycles in the group-kvstore churn soak and in the "
            "elastic resize fit, overhead < 2% of a dp-4 step. Four "
            "replicas time-share one device: a step's time is their work "
            "in turn."),
    }
    return sub.publish(result, "lockwatch", args)


def check(result):
    """The bench's gates: no lock-order cycle and no hung worker in either
    soak, both resizes (worlds 3 then 4) under the watchdog."""
    sub.require(result["cycles"] == 0 and result["kv_soak"]["cycles"] == 0
                and not result["kv_soak"]["hung"]
                and result["worlds"] == [3, 4],
                f"bench_lockwatch: no cycle and no hang over worlds [3, 4]: "
                f"{result['cycles']}, {result['kv_soak']}, "
                f"{result['worlds']}")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
