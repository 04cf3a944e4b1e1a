"""The price of the async multi-tier checkpoint plane: the port's
counterpart of ``bench.py --ckpt-bench`` (``run_ckpt_bench``).

Three measurements over eight replicas of one device:

1. the step loop's stall a checkpoint: the T0 capture and submit (one
   blocking device-to-host copy; the writer thread does the rest) against
   the synchronous durable save of the same state (the JAX bound: the
   stall under 10% of the save);
2. the recovery on an 8 -> 6 elastic resize: the peer tier (T1, host
   memory) against a disk restore (T2) forced by chaos (``ckpt.replica``)
   in the same run;
3. the checkpoint badput an epoch at cadences of 1, 4 and 16 steps, as the
   epoch report prices it.

    python -m mxnet_tpu_torch.tools.bench_ckpt [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import torch

from .. import io as mio
from .. import telemetry
from ..resilience import ElasticCoordinator, chaos_scope, ckpt_async
from ..utils import checkpoint as ckpt_mod
from . import _bench
from . import _subsystem as sub

METRIC = "ckpt_async_stall_pct_of_sync"
BOUND_PCT = 10.0
WORLD = 8
CADENCES = (1, 4, 16)


def shapes(smoke):
    """``bench.py:2322-2324``: dims, rows and the stall's repeats."""
    dim, hidden, classes = (32, 64, 4) if smoke else (256, 1024, 32)
    batch, n_rows = (48, 480) if smoke else (192, 3840)
    return dim, hidden, classes, batch, n_rows, 5 if smoke else 20


def stall_and_save_ms(state_dir, tmp, reps, dev):
    """``(async stall ms, sync save ms)``, medians over ``reps``: the state
    of a one-epoch fit's checkpoint, on ``dev``, captured and submitted to
    an ``AsyncCheckpointWriter`` (drained outside the timer), then saved
    with ``save_now``."""
    loaded, _, _, _, opt_leaves = ckpt_mod.load_sharded(state_dir)
    params = {k: torch.as_tensor(v).to(dev) for k, v in loaded.items()}
    opt = None if opt_leaves is None else \
        [torch.as_tensor(leaf).to(dev) for leaf in opt_leaves]
    writer = ckpt_async.AsyncCheckpointWriter(
        os.path.join(tmp, "async"), queue_depth=2, keep_last_k=0)
    async_ms, step_id = [], 0
    try:
        for _ in range(reps):
            step_id += 1
            sub.synchronize(dev)
            t0 = time.perf_counter()
            snap = ckpt_async.capture_snapshot(
                step_id, params, opt_state=opt, meta={"num_update": step_id})
            writer.submit(snap)
            # the capture's copy to the host has waited for the card
            async_ms.append((time.perf_counter() - t0) * 1e3)  # mxlint: disable=MX306
            writer.flush(timeout=120)  # the drain stays outside the timer
    finally:
        writer.close()
    sync_ms = []
    for _ in range(reps):
        step_id += 1
        sub.synchronize(dev)
        t0 = time.perf_counter()
        ckpt_async.save_now(os.path.join(tmp, "sync"), step_id, params,
                            opt_state=opt,
                            extra_meta={"num_update": step_id})
        # save_now writes host copies: the card has been waited for
        sync_ms.append((time.perf_counter() - t0) * 1e3)  # mxlint: disable=MX306
    return statistics.median(async_ms), statistics.median(sync_ms)


def resize_recovery(build, X, y, batch, chaos_rules=None):
    """``(downtime s, tier)`` of an 8 -> 6 resize at step 2 of epoch 1 of a
    3-epoch fit checkpointing every 2 steps; ``chaos_rules`` kill the peer
    tier so the restore reads the disk."""
    telemetry.reset()
    co = ElasticCoordinator(WORLD)

    def drive(param):
        if param.epoch == 1 and param.nbatch == 2 and co.world_size == WORLD:
            # the bench's planted failure, not a policy decision
            co.kill()  # mxlint: disable=MX311
            co.kill()  # mxlint: disable=MX311

    model = build(3)
    d = tempfile.mkdtemp(prefix="mxtorch_ckpt_bench_el_")
    kw = dict(batch_size=batch, elastic=co, sharded_checkpoint_dir=d,
              checkpoint_every_n_steps=2, batch_end_callback=drive)
    it = mio.NDArrayIter(X, y, batch_size=batch, shuffle=False)
    if chaos_rules:
        with chaos_scope(seed=0, rules=chaos_rules):
            model.fit(it, **kw)
    else:
        model.fit(it, **kw)
    if co.resizes != 1:
        raise RuntimeError(f"bench_ckpt: {co.resizes} resizes, not 1")
    events = telemetry.hub().events("checkpoint")
    tier = "t1" if any(e.get("tier") == "t1" for e in events) else "t2"
    return co.history[0]["downtime_s"], tier


def badput_by_cadence(build, X, y, batch, tmp):
    """The epoch report's ``checkpoint`` badput at each cadence of
    :data:`CADENCES`: seconds an epoch, and the share of the epochs'
    walls."""
    out = {}
    for every in CADENCES:
        telemetry.reset()
        jsonl = os.path.join(tmp, f"events_{every}.jsonl")
        build(2).fit(mio.NDArrayIter(X, y, batch_size=batch, shuffle=False),
                     batch_size=batch,
                     sharded_checkpoint_dir=os.path.join(tmp, f"cad{every}"),
                     checkpoint_every_n_steps=every,
                     telemetry=telemetry.TelemetryConfig(jsonl=jsonl))
        events = telemetry.read_events(jsonl)
        ckpt_s = [float(e.get("seconds", 0.0)) for e in events
                  if e.get("kind") == "badput"
                  and e.get("reason") == "checkpoint"]
        walls = [float(e.get("seconds", 0.0)) for e in events
                 if e.get("kind") == "epoch_summary"]
        out[str(every)] = {
            "badput_s_per_epoch": round(sum(ckpt_s) / max(1, len(walls)), 4),
            "badput_pct_of_wall": round(100.0 * sum(ckpt_s) / sum(walls), 2)
            if sum(walls) else None,
        }
    return out


def run(args):
    dev = _bench.card(args.cpu, "bench_ckpt")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, reps = shapes(smoke)
    X, y = sub.mlp_data(n_rows, dim, classes)
    steps_per_epoch = n_rows // batch

    def build(epochs):
        return sub.build_mlp(hidden, classes, epochs, dev, world=WORLD)

    # no pruning inside the timed saves, for this run only
    prior = os.environ.get("MXNET_TPU_CKPT_KEEP")
    os.environ.setdefault("MXNET_TPU_CKPT_KEEP", "0")
    try:
        tmp = tempfile.mkdtemp(prefix="mxtorch_ckpt_bench_")
        d_state = os.path.join(tmp, "state")
        build(1).fit(X, y, batch_size=batch, sharded_checkpoint_dir=d_state)
        async_stall, sync_wall = stall_and_save_ms(d_state, tmp, reps, dev)
        peer_s, peer_tier = resize_recovery(build, X, y, batch)
        disk_s, disk_tier = resize_recovery(build, X, y, batch,
                                            {"ckpt.replica": 1.0})
        cadences = badput_by_cadence(build, X, y, batch, tmp)
    finally:
        if prior is None:
            os.environ.pop("MXNET_TPU_CKPT_KEEP", None)
    stall_pct = 100.0 * async_stall / sync_wall if sync_wall else None

    result = {
        "metric": METRIC,
        "value": round(stall_pct, 2) if stall_pct is not None else None,
        "unit": "%",
        "vs_baseline": round(sync_wall, 3),
        "async_stall_ms": round(async_stall, 3),
        "sync_save_ms": round(sync_wall, 3),
        "peer_recovery_s": round(peer_s, 4),
        "disk_recovery_s": round(disk_s, 4),
        "peer_recovery_tier": peer_tier,
        "disk_recovery_tier": disk_tier,
        "badput_by_cadence": cadences,
        "reps": reps, "steps_per_epoch": steps_per_epoch,
        "batch": batch, "world": WORLD,
        "smoke": smoke,
        "device": _bench.card_identity(dev),
        "bounds": {"value": sub.bound_flag(stall_pct, BOUND_PCT)},
        "notes": (
            "headline = the step loop's stall a checkpoint (T0 capture and "
            "submit) as % of the synchronous durable save of the same "
            "state; acceptance < 10%. Peer against disk recovery is the "
            "8->6 resize's downtime with the T1 host-memory tier live, "
            "then killed by chaos (ckpt.replica) so the restore reads the "
            "T2 disk. The badput rows are the epoch report's `checkpoint` "
            "bucket. " + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "ckpt", args)


def check(result):
    """The bench's gates: the peer tier recovers while it lives (t1), the
    disk tier after chaos kills it (t2)."""
    tiers = (result["peer_recovery_tier"], result["disk_recovery_tier"])
    sub.require(tiers == ("t1", "t2"),
                f"bench_ckpt: the recovery tiers {tiers}")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
