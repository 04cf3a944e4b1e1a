"""The price of a mid-run world resize: the port's counterpart of
``bench.py --elastic-bench`` (``run_elastic_bench``).

An elastic fit of the dp-8 MLP over eight replicas of one device loses two
of them in epoch 1, goes on with six, and regrows to eight in epoch 2
(worlds 8 -> 6 -> 8). The bench reads each resize's downtime (quiesce,
restore, re-plan, rebuild the replicas), the median step at each world
size, each epoch's goodput and the ``resize`` badput the epoch report
prices. The headline is the shrink's downtime.

    python -m mxnet_tpu_torch.tools.bench_elastic [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import os
import tempfile
import time

from .. import telemetry
from ..resilience import ElasticCoordinator
from . import _bench
from . import _subsystem as sub

METRIC = "elastic_resize_downtime_seconds"
WORLD = 8


def shapes(smoke):
    """``bench.py:1564-1566``: dims, rows (batch a multiple of 6) and
    epochs."""
    dim, hidden, classes = (32, 64, 4) if smoke else (256, 1024, 32)
    batch, n_rows = (48, 480) if smoke else (192, 3840)
    epochs = 4 if smoke else 6
    return dim, hidden, classes, batch, n_rows, epochs


def resize_driver(co):
    """``bench.py:1586-1593``: kill two of eight at step 2 of epoch 1,
    rejoin them at step 2 of epoch 2 (both resizes mid-epoch, so the redo
    and the downtime are priced in full)."""

    def drive(param):
        if param.epoch == 1 and param.nbatch == 2 and co.world_size == 8:
            # the bench's planted failure, not a policy decision
            co.kill()  # mxlint: disable=MX311
            co.kill()  # mxlint: disable=MX311
        if param.epoch == 2 and param.nbatch == 2 and co.world_size == 6:
            co.join_all()

    return drive


def step_ms_by_world(spans, steps_per_epoch):
    """Median step (ms) of epochs 0, 1 and 3 (worlds 8, 6, 8): an epoch cut
    by a resize keeps the aborted attempt's spans under its number, so only
    its last ``steps_per_epoch`` spans count."""
    out = {}
    for world, epoch in (("8_pre", 0), ("6", 1), ("8_post", 3)):
        tail = sorted([s.duration for s in spans
                       if s.epoch == epoch][-steps_per_epoch:])
        if tail:
            out[world] = tail[len(tail) // 2] * 1e3
    return out


def run(args):
    dev = _bench.card(args.cpu, "bench_elastic")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs = shapes(smoke)
    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch
    telemetry.reset()
    telemetry.measured_peak_flops(device=dev)

    co = ElasticCoordinator(WORLD)
    tmp = tempfile.mkdtemp(prefix="mxtorch_elastic_bench_")
    jsonl = os.path.join(tmp, "events.jsonl")
    model = sub.build_mlp(hidden, classes, epochs, dev, world=WORLD)
    t0 = time.perf_counter()
    model.fit(X, y, batch_size=batch, elastic=co,
              sharded_checkpoint_dir=os.path.join(tmp, "ckpt"),
              batch_end_callback=resize_driver(co),
              telemetry=telemetry.TelemetryConfig(jsonl=jsonl))
    sub.synchronize(dev)
    wall = time.perf_counter() - t0

    downs = [h["downtime_s"] for h in co.history]
    step_ms = step_ms_by_world(model.telemetry.steps(), steps_per_epoch)
    events = telemetry.read_events(jsonl)
    goodput = {int(e["epoch"]): e.get("goodput_pct")
               for e in events if e.get("kind") == "epoch_summary"}
    resize_badput = sum(float(e.get("seconds", 0.0)) for e in events
                        if e.get("kind") == "badput"
                        and e.get("reason") == "resize")
    resizes = [e for e in events if e.get("kind") == "resize"]
    shrink = round(downs[0], 4) if downs else None
    result = {
        "metric": METRIC,
        "value": shrink,
        "unit": "s",
        "vs_baseline": shrink,
        "shrink_downtime_s": shrink,
        "grow_downtime_s": round(downs[1], 4) if len(downs) > 1 else None,
        "resizes": co.resizes,
        "resize_events": len(resizes),
        "worlds": [h["to"] for h in co.history],
        "step_ms_by_world": {k: round(v, 3) for k, v in step_ms.items()},
        "goodput_pct_by_epoch": {k: round(v, 2)
                                 for k, v in sorted(goodput.items())
                                 if v is not None},
        "resize_badput_s": round(resize_badput, 4),
        "wall_s": round(wall, 3),
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "batch": batch, "full_world": WORLD,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "notes": (
            "headline = the shrink's (8->6) downtime: quiesce, restore from "
            "the peer tier or the checkpoint, re-plan the exchange and "
            "rebuild the replicas for the new world. resize badput also "
            "prices the redone part of the epoch. " + sub.TIME_SHARED
            + "."),
    }
    return sub.publish(result, "elastic", args)


def check(result):
    """The bench's gates: two resizes, worlds 6 then 8."""
    sub.require(result["worlds"] == [6, 8] and result["resizes"] == 2,
                f"bench_elastic: worlds {result['worlds']}, "
                f"{result['resizes']} resizes")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
