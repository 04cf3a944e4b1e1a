"""The goodput the fleet controller wins back from a persistent straggler
and a flaky rank: the port's counterpart of ``bench.py
--controller-bench`` (``run_controller_bench``).

Three dp-8 fits of the MLP over eight replicas of one device, same model,
data and steps:

- clean: no fault, no controller (the ceiling);
- static: rank 7 drags every step by a fixed stall (a real sleep, with
  per-rank spans that blame it); no controller, so the fleet pays the
  stall to the end;
- armed: the same straggler under ``fit(controller=...)``, and rank 6
  falls silent for the second epoch (declared dead at its first step, as
  the heartbeat monitor declares a silent rank) and beats again from the
  third: the controller blames rank 7 over K-of-N windows and evicts it,
  backfills the flaky rank once it beats again, and picks a compression
  tier from the
  comm:compute ratio (the wire's rate scaled down, so the tier policy has
  a real choice).

The headline is ``(tpc_armed - tpc_static) / (tpc_clean - tpc_static)``:
the share of the per-replica throughput the straggler cost that the
controller won back, in each fit's last epoch.

    python -m mxnet_tpu_torch.tools.bench_controller [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import os
import tempfile
import threading
import time

from .. import telemetry
from ..resilience import ElasticCoordinator, FleetController
from . import _bench
from . import _subsystem as sub

METRIC = "controller_goodput_recovered_frac"
WORLD = 8
STRAGGLER, FLAKY = 7, 6


def shapes(smoke):
    """``bench.py:1697-1702``: dims, rows (the batch divides every world
    the fleet can pass through: 6, 7, 8), epochs and the stall."""
    dim, hidden, classes = (32, 64, 4) if smoke else (128, 512, 16)
    batch, n_rows = (168, 840) if smoke else (168, 3360)
    epochs = 3 if smoke else 5
    return dim, hidden, classes, batch, n_rows, epochs, \
        0.03 if smoke else 0.05


# the armed run's controller (``bench.py:1817-1823``): the wire's rate
# scaled down, so the MLP reads as comm-bound and the tier policy has a
# real choice
CONTROLLER = dict(
    interval=0.0, window=24, min_report_steps=24, evict_k=3, evict_n=5,
    max_evictions=1, rejoin_after=1.0, evaluate_after=1.0,
    cooldowns={"evict": 0.5, "backfill": 0.2, "retier": 0.5},
    wire_gbps=0.01)


def controller():
    """The armed run's controller."""
    return FleetController(**CONTROLLER)


class FaultHarness:
    """The injected pathology (``bench.py:1725-1793``): a persistent
    straggler (a real sleep a step while rank 7 is in the world) with
    per-rank spans that blame it, and, with a coordinator, a flaky rank
    whose heartbeats (from a thread of their own) stop for the second
    epoch, then resume. The JAX bench times that outage on the wall clock
    (``6 x heartbeat_timeout`` from the second epoch's first step); here
    it is counted in steps, so that the fit's steps outlast it however
    fast the device runs them. ``inject=False`` is the clean harness: the
    same step clock, no fault."""

    def __init__(self, steps_per_epoch, stall_s, co=None, inject=True):
        self.co = co
        self.inject = inject
        self.steps_per_epoch = steps_per_epoch
        self.stall_s = stall_s
        self.step = 0
        self.times = []  # the monotonic clock at every batch callback
        self._stop = threading.Event()
        self._silent = False  # the flaky rank's outage
        if co is not None and co.heartbeat_timeout:
            threading.Thread(target=self._beat, daemon=True,
                             name="mx-bench-beater").start()

    def alive(self):
        return self.co.alive if self.co is not None else tuple(range(WORLD))

    def _beat(self):
        # every rank beats (a departed one too: a recovered host beats
        # before it is readmitted) but the flaky one during its outage
        while not self._stop.wait(0.05):
            for r in range(WORLD):
                if not (r == FLAKY and self._silent):
                    self.co.heartbeat(r)

    def close(self):
        self._stop.set()

    def final_epoch_step_s(self):
        """The median step of the last epoch: the steady state each fleet
        settled into."""
        tail = self.times[-(self.steps_per_epoch + 1):]
        diffs = sorted(b - a for a, b in zip(tail, tail[1:]))
        return diffs[len(diffs) // 2] if diffs else None

    def __call__(self, param):
        del param
        self.times.append(time.monotonic())
        s = self.step
        self.step += 1
        if not self.inject:
            return
        if self.co is not None and s == self.steps_per_epoch:
            # the outage starts: silent, then declared dead as the
            # heartbeat monitor declares a rank silent past its timeout
            # (the planted fault, not a policy decision)
            self._silent = True
            self.co.kill(FLAKY, reason="heartbeat")  # mxlint: disable=MX311
        elif self.co is not None and s == 2 * self.steps_per_epoch:
            self._silent = False  # it beats again
        alive = self.alive()
        if STRAGGLER in alive:
            time.sleep(self.stall_s)  # every replica waits for it
        for r in alive:
            dur_ms = (self.stall_s * 1e3 + 2.0) if r == STRAGGLER else 2.0
            telemetry.emit("span", rank=r, name="step", epoch=0, step=s,
                           dur_ms=dur_ms,
                           phases=[{"name": "device", "dur_ms": dur_ms}])


def run(args):
    dev = _bench.card(args.cpu, "bench_controller")
    smoke = bool(args.smoke)
    dim, hidden, classes, batch, n_rows, epochs, stall_s = shapes(smoke)
    steps_per_epoch = n_rows // batch
    X, y = sub.mlp_data(n_rows, dim, classes)
    telemetry.measured_peak_flops(device=dev)

    def run_fit(name, faults, ctl=None, co=None):
        telemetry.reset()
        model = sub.build_mlp(hidden, classes, epochs, dev, world=WORLD)
        tmp = tempfile.mkdtemp(prefix=f"mxtorch_ctl_bench_{name}_")
        t0 = time.perf_counter()
        try:
            # False, not None: the environment's MXNET_TPU_ELASTIC and
            # MXNET_TPU_CONTROLLER must not arm the clean and static fits
            model.fit(X, y, batch_size=batch,
                      elastic=co if co is not None else False,
                      controller=ctl if ctl is not None else False,
                      sharded_checkpoint_dir=os.path.join(tmp, "ckpt")
                      if co is not None else None,
                      batch_end_callback=faults,
                      telemetry=telemetry.TelemetryConfig(timeline=False,
                                                          memory=False))
        finally:
            faults.close()
        sub.synchronize(dev)
        return time.perf_counter() - t0

    clean = FaultHarness(steps_per_epoch, stall_s, inject=False)
    wall_clean = run_fit("clean", clean)
    static = FaultHarness(steps_per_epoch, stall_s)
    wall_static = run_fit("static", static)
    co = ElasticCoordinator(WORLD, heartbeat_timeout=0.5)
    ctl = controller()
    armed = FaultHarness(steps_per_epoch, stall_s, co)
    wall_ctl = run_fit("armed", armed, ctl, co)

    step_clean = clean.final_epoch_step_s()
    step_static = static.final_epoch_step_s()
    step_ctl = armed.final_epoch_step_s()
    tpc_clean = 1.0 / (step_clean * WORLD) if step_clean else None
    tpc_static = 1.0 / (step_static * WORLD) if step_static else None
    tpc_ctl = 1.0 / (step_ctl * co.world_size) if step_ctl else None
    recovered = None
    if None not in (tpc_clean, tpc_static, tpc_ctl) and \
            tpc_clean > tpc_static:
        recovered = (tpc_ctl - tpc_static) / (tpc_clean - tpc_static)

    def actuated(lever):
        return [d for d in ctl.decisions
                if d["lever"] == lever and d["outcome"] == "actuated"]

    def ms(s):
        return round(s * 1e3, 3) if s else None

    result = {
        "metric": METRIC,
        "value": round(recovered, 4) if recovered is not None else None,
        "unit": "frac",
        "vs_baseline": round(tpc_ctl / tpc_static, 4)
        if tpc_ctl and tpc_static else None,
        "tpc_clean": round(tpc_clean, 4) if tpc_clean else None,
        "tpc_static": round(tpc_static, 4) if tpc_static else None,
        "tpc_controller": round(tpc_ctl, 4) if tpc_ctl else None,
        "final_step_ms": {"clean": ms(step_clean), "static": ms(step_static),
                          "controller": ms(step_ctl)},
        "wall_clean_s": round(wall_clean, 3),
        "wall_static_s": round(wall_static, 3),
        "wall_controller_s": round(wall_ctl, 3),
        "stall_ms": stall_s * 1e3,
        "evicted": [d.get("rank") for d in actuated("evict")],
        "backfilled": [d.get("rank") for d in actuated("backfill")],
        "tier_chosen": ctl._comm_mode,
        "retier_actions": [d["action"] for d in actuated("retier")],
        "resizes": co.resizes,
        "worlds": [h["to"] for h in co.history],
        "breaker_state": ctl.breaker.state,
        "decisions_total": len(ctl.decisions),
        "epochs": epochs, "steps_per_epoch": steps_per_epoch,
        "batch": batch, "full_world": WORLD, "smoke": smoke,
        "device": _bench.card_identity(dev),
        "notes": (
            "headline = the share of the straggler's lost per-replica "
            "throughput the armed controller won back, in each fit's last "
            "epoch (the static fleet still pays the stall there; the armed "
            "one has evicted the straggler and settled on its world and "
            "tier). Whole-run walls carry the controller's own costs "
            "(resizes, retier rebuilds). The stall dominates the MLP's "
            "step, so the fraction is larger than a fleet of real steps "
            "would see; the loop (blame, evict, backfill, retier) is what "
            "is measured. " + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "controller", args)


def check(result):
    """The bench's gates: rank 7 evicted, the breaker closed; on the card,
    rank 6 backfilled after its outage (on the CPU the smoke fit's last
    step may come before the controller's probation ends)."""
    sub.require(result["evicted"] == [STRAGGLER]
                and result["breaker_state"] == "closed",
                f"bench_controller: the controller evicted "
                f"{result['evicted']} (rank {STRAGGLER}), breaker "
                f"{result['breaker_state']}")
    if sub.on_card(result):
        sub.require(result["backfilled"] == [FLAKY],
                    f"bench_controller: the controller backfilled "
                    f"{result['backfilled']} (rank {FLAKY})")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
