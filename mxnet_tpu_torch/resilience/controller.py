"""FleetController: close the loop from telemetry to actuation.

Counterpart of ``mxnet_tpu/resilience/controller.py``, with the same
policy functions, levers, rails and decision records: fed the same span
stream and coordinator under the same clock, either package's controller
makes the same decisions. The telemetry senses per-phase straggler blame
(telemetry.distributed), goodput and badput (telemetry.mfu), memory
watermarks (telemetry.memory) and heartbeat deaths (resilience.elastic),
and ``ElasticCoordinator`` can act. This module is the policy loop
between them: it reads the telemetry through the sensor layer
(telemetry/sensors.py) and acts through the existing levers, never
around them.

**Levers** (each gated by config on its own):

  evict     a rank blamed by the straggler detector in >= ``evict_k`` of
            the last ``evict_n`` policy windows is evicted via
            ``ElasticCoordinator.kill(reason="evicted")``: K-of-N
            hysteresis, so a one-off retry spike never costs a worker. A
            rank evicted ``max_evictions`` times is quarantined (never
            readmitted by this controller).
  backfill  departed ranks are readmitted via ``join(reason="backfill")``
            once their probation (``rejoin_after``) lapses, and a
            heartbeat-dead rank must also be *beating again* first
            (``last_heartbeat`` newer than its departure).
  retier    the compression tier (none/bf16/int8/twobit) and the overlap
            byte cap are chosen from the MEASURED comm:compute ratio per
            (model, world) (:func:`select_tier`,
            :func:`select_overlap_bytes`) instead of static config. The
            controller only *stages* the choice; the fit loop applies it
            on the training thread (``take_retier``), rebuilding the
            exchange on the new tier between two steps.
  world     the world size is chosen to maximize measured goodput per
            chip (:func:`choose_world`) under the chip budget, actuated
            via ``request_world`` (which prefers the blamed rank as its
            shrink victim: elastic.record_blame).
  ckpt      the checkpoint cadence follows the measured save cost
            (:func:`select_ckpt_cadence`), staged like retier.
  health    RECOMMEND-ONLY: a persistent per-layer anomaly from the bound
            telemetry.HealthMonitor surfaces as a ``controller`` decision
            event, and evict/retier decisions carry the blamed layer; the
            controller never acts on model health (the guards own
            non-finite steps).

**Safety rails**:

  - hysteresis everywhere: K-of-N blame voting, an EWMA fleet metric, a
    ``world_margin`` improvement threshold before any world move;
  - per-lever cooldowns, a global ``max_actions_per_hour`` rate limit and
    the coordinator's ``min_world`` floor;
  - ``dry_run``: every decision is emitted as ``outcome="recommended"``
    and nothing is ever actuated;
  - a :class:`~mxnet_tpu_torch.resilience.retry.CircuitBreaker` (its
    state exported as ``circuit_breaker_*{breaker="controller"}`` gauges
    and ``breaker`` incidents): an actuation that raises, or whose fleet
    metric afterwards regresses past ``regress_tolerance``, records a
    failure; the breaker opens and the controller FREEZES (decisions keep
    flowing as ``outcome="frozen"``) until a half-open probe succeeds.
    The training loop itself is never killed.
  - every decision (inputs, policy, action, outcome) is a ``controller``
    event (flight-recorder incident ring and the hub counter
    ``controller_decisions_total{lever,outcome}``), so ``telemetry diff``
    and ``flight show`` can gate and examine the controller like any
    other subsystem.

Drive it either way: ``FeedForward.fit(controller=...)`` ticks it
synchronously once a step (deterministic; the default), or
:meth:`FleetController.start` runs the same ``tick()`` on its own
``mx-fleet-ctl`` daemon thread. Either way the actuations that must run
on the training thread (retier, ckpt cadence) are staged and taken by
the fit loop (:meth:`take_retier`, :meth:`take_ckpt_cadence`).
"""

from __future__ import annotations

import collections
import logging
import math
import os
import threading
import time

from ..analysis.lockwatch import named_lock
from ..base import MXNetError
from .retry import CircuitBreaker

__all__ = ["FleetControllerConfig", "FleetController", "select_tier",
           "select_overlap_bytes", "choose_world"]

_ON_VALUES = ("1", "on", "true", "yes", "armed")
_DRY_VALUES = ("dry", "dry_run", "dry-run", "recommend")


# -- pure policy functions (unit-testable without a fleet) ---------------------

def select_tier(ratio):
    """Compression tier for a measured comm:compute ratio (fp32-wire
    seconds / compute seconds). More comm-bound -> more aggressive
    quantization; ``None`` in -> ``None`` out (no data, no opinion)."""
    if ratio is None:
        return None
    ratio = float(ratio)
    if ratio <= 0.05:
        return "none"
    if ratio <= 0.25:
        return "bf16"
    if ratio <= 1.0:
        return "int8"
    return "twobit"


def select_overlap_bytes(ratio, base=None):
    """Overlap bucket byte-cap for a comm:compute ratio, or None (wire
    negligible: one fused bucket beats per-bucket launch overhead).
    More comm-bound -> smaller buckets, so the first reduce-scatter
    starts earlier under backward; floor 1 MB."""
    if ratio is None:
        return None
    if base is None:
        from ..comm import DEFAULT_BUCKET_BYTES

        base = DEFAULT_BUCKET_BYTES
    ratio = float(ratio)
    if ratio <= 0.1:
        return None
    if ratio <= 0.25:
        cap = base
    elif ratio <= 0.5:
        cap = base // 2
    elif ratio <= 1.0:
        cap = base // 4
    else:
        cap = base // 8
    return max(int(cap), 1 << 20)


def choose_world(perf, current, lo, hi, margin=0.1):
    """World size maximizing measured goodput-per-chip.

    ``perf``: {world_size: per-chip-throughput} (higher is better) from
    the controller's EWMA bookkeeping. Only MEASURED worlds inside
    [lo, hi] are candidates — the policy never explores blind — and a
    move needs a > ``margin`` relative improvement over the current
    world's measurement (hysteresis: noise must not thrash the fleet).
    Returns the chosen world (== ``current`` when no move is justified).
    """
    current = int(current)
    cur_perf = perf.get(current)
    if cur_perf is None or cur_perf <= 0:
        return current
    best, best_perf = current, cur_perf
    for world, p in perf.items():
        if not lo <= int(world) <= hi or p is None:
            continue
        if p > best_perf:
            best, best_perf = int(world), p
    if best != current and best_perf > cur_perf * (1.0 + float(margin)):
        return best
    return current


def select_ckpt_cadence(save_seconds, step_seconds, current,
                        target_overhead=0.05, floor=1, cap=1024):
    """Checkpoint cadence (steps between snapshots) so the measured save
    cost stays near ``target_overhead`` of training time: cadence ~=
    save_seconds / (target * step_seconds), clamped to [floor, cap].

    Hysteresis: a move smaller than 25% of the current cadence returns
    ``current`` — noise in one save measurement must not thrash the
    cadence (and with it the recovery window). None in -> ``current``
    out (no data, no opinion)."""
    current = max(int(current), 1)
    if not save_seconds or not step_seconds or step_seconds <= 0:
        return current
    target = max(float(target_overhead), 1e-6)
    ideal = float(save_seconds) / (target * float(step_seconds))
    proposed = min(max(int(math.ceil(ideal)), int(floor)), int(cap))
    if abs(proposed - current) < max(1, int(0.25 * current)):
        return current
    return proposed


class FleetControllerConfig:
    """Knobs of the policy loop; defaults are production-shaped (tests
    shrink the clocks). See the module docstring for what each lever and
    rail does."""

    def __init__(self, interval=1.0, dry_run=False, window=32,
                 min_report_steps=None, evict_k=3, evict_n=5,
                 max_evictions=2, rejoin_after=30.0, cooldowns=None,
                 max_actions_per_hour=12, min_world=None, chip_budget=None,
                 auto_evict=True, auto_backfill=True, auto_tier=True,
                 auto_world=False, auto_ckpt=True,
                 ckpt_target_overhead=0.05,
                 world_margin=0.1, regress_tolerance=0.25,
                 evaluate_after=10.0, ewma_alpha=0.5, wire_gbps=None,
                 breaker=None):
        self.interval = float(interval)
        self.dry_run = bool(dry_run)
        self.window = int(window)
        # blame needs at least a window's worth of fleet spans behind it
        self.min_report_steps = int(window if min_report_steps is None
                                    else min_report_steps)
        self.evict_k = int(evict_k)
        self.evict_n = int(evict_n)
        if not 1 <= self.evict_k <= self.evict_n:
            raise MXNetError("need 1 <= evict_k <= evict_n")
        self.max_evictions = int(max_evictions)
        self.rejoin_after = float(rejoin_after)
        self.cooldowns = {"evict": 30.0, "backfill": 5.0, "retier": 60.0,
                          "world": 120.0, "ckpt": 60.0}
        if cooldowns:
            self.cooldowns.update(cooldowns)
        self.max_actions_per_hour = int(max_actions_per_hour)
        self.min_world = min_world
        self.chip_budget = chip_budget
        self.auto_evict = bool(auto_evict)
        self.auto_backfill = bool(auto_backfill)
        self.auto_tier = bool(auto_tier)
        self.auto_world = bool(auto_world)
        self.auto_ckpt = bool(auto_ckpt)
        self.ckpt_target_overhead = float(ckpt_target_overhead)
        self.world_margin = float(world_margin)
        self.regress_tolerance = float(regress_tolerance)
        self.evaluate_after = float(evaluate_after)
        self.ewma_alpha = float(ewma_alpha)
        if wire_gbps is None:
            raw = os.environ.get("MXNET_TPU_WIRE_GBPS", "").strip()
            wire_gbps = float(raw) if raw else 16.0
        self.wire_gbps = float(wire_gbps)
        self.breaker = breaker

    def __repr__(self):
        return (f"FleetControllerConfig(dry_run={self.dry_run}, "
                f"evict={self.evict_k}-of-{self.evict_n}, "
                f"levers=[{'evict ' if self.auto_evict else ''}"
                f"{'retier ' if self.auto_tier else ''}"
                f"{'world' if self.auto_world else ''}])")


class FleetController:
    """The policy loop. Construct (optionally with a config or config
    kwargs), ``bind()`` it to a run (``fit(controller=...)`` does this),
    then either let fit tick it per step or ``start()`` the
    ``mx-fleet-ctl`` daemon thread. Thread-safe: one lock guards all
    mutable policy state (tick, take_retier, bind can race)."""

    ARMED, DRY_RUN, FROZEN = "armed", "dry_run", "frozen"
    _STATE_CODE = {ARMED: 0.0, DRY_RUN: 1.0, FROZEN: 2.0}

    def __init__(self, config=None, **kwargs):
        if config is None:
            config = FleetControllerConfig(**kwargs)
        elif kwargs:
            raise MXNetError("pass a FleetControllerConfig OR kwargs")
        self.cfg = config
        self.breaker = config.breaker or CircuitBreaker(
            failure_threshold=2, reset_after=60.0, name="controller")
        from ..telemetry.sensors import StreamingStragglerDetector

        self.detector = StreamingStragglerDetector(window=config.window)
        self._lock = named_lock("resilience.FleetController")
        self._co = None
        self._health = None           # telemetry.HealthMonitor
        self._model_key = None
        self._comm_mode = "none"
        self._can_retier = False
        self._fp32_wire_bytes = 0.0
        self._logger = logging
        self._bound_world = 1
        self._last_tick = 0.0
        self._blame_hist = collections.deque(maxlen=config.evict_n)
        self._action_times = collections.deque()
        self._last_action = {}        # lever -> monotonic ts
        self._last_decision = {}      # lever -> (action, outcome) dedupe
        self._pending_retier = None
        self._ckpt_every = None       # live cadence; None = lever disarmed
        self._pending_ckpt = None
        # [{"lever","action","baseline","deadline"}]: every actuation
        # gets its regression check, even when actions cluster inside
        # one evaluate_after window (bounded: rate limiter caps arrivals)
        self._pending_evals = []
        self._departed = {}           # rank -> {"t": ts, "reason": str}
        self._evictions = {}          # rank -> count
        self._prev_alive = None
        self._world_perf = {}         # world -> EWMA per-chip throughput
        self._tier_cache = {}         # (model_key, world) -> mode
        self._thread = None
        self._stop = threading.Event()
        self.decisions = []           # recent decisions (bounded, for tests)

    # -- lifecycle -------------------------------------------------------------
    @classmethod
    def resolve(cls, value):
        """Normalize fit()'s ``controller`` argument: None -> env gate
        ``MXNET_TPU_CONTROLLER`` (truthy = armed, ``dry`` = dry-run),
        True -> default config, an instance passes through."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_CONTROLLER", "").strip().lower()
            if raw in _DRY_VALUES:
                return cls(dry_run=True)
            if raw not in _ON_VALUES:
                return None
            value = True
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, FleetControllerConfig):
            return cls(config=value)
        raise MXNetError(
            f"controller= must be True/False/None, a FleetControllerConfig "
            f"or a FleetController, got {value!r}")

    def bind(self, coordinator=None, model_key=None, world_size=None,
             comm_mode="none", can_retier=False, fp32_wire_bytes=0.0,
             health=None, ckpt_every=None, logger=None):
        """Attach the controller to one run's levers and identity. The
        membership levers need a ``coordinator``; without one they stay
        disabled (logged). ``fp32_wire_bytes`` is the closed-form per-step
        uncompressed wire cost — the tier policy's fallback when the span
        window carries no measured wire phase. ``health`` (a telemetry.
        HealthMonitor) adds model-health context: blamed-layer
        fields on evict/retier decisions and a recommend-only ``health``
        lever — the controller never actuates on model health."""
        with self._lock:
            self._co = coordinator
            self._health = health
            self._model_key = model_key
            self._bound_world = int(world_size or
                                    (coordinator.world_size
                                     if coordinator is not None else 1))
            self._comm_mode = comm_mode or "none"
            self._can_retier = bool(can_retier)
            self._fp32_wire_bytes = float(fp32_wire_bytes or 0.0)
            self._logger = logger or logging
            self._prev_alive = None if coordinator is None \
                else set(coordinator.alive)
            if coordinator is not None:
                # ranks already departed before this controller took
                # over are backfill candidates too — seed their
                # probation clocks at bind
                gone = set(range(coordinator.full_world_size)) \
                    - set(coordinator.alive)
                for rank in gone:
                    self._departed.setdefault(
                        rank, {"t": time.monotonic(),
                               "reason": "pre-bind"})
            self._pending_retier = None
            # checkpoint-cadence lever: armed only when the
            # run checkpoints per-step (ckpt_every is the live cadence)
            self._ckpt_every = None if ckpt_every is None \
                else max(1, int(ckpt_every))
            self._pending_ckpt = None
        self.detector.attach()
        # -- ledger warm start: a read-only sensor. When this
        # (model, world) has trained before, seed the tier cache with the
        # historically best compression mode from the cross-run ledger so
        # the retier lever's first proposal starts from evidence instead
        # of the static default. Never actuates here — the normal lever
        # path (rate limits, dry-run, regression evals) still governs.
        if self._can_retier and model_key is not None and \
                (model_key, self._bound_world) not in self._tier_cache:
            try:
                from ..telemetry import ledger as ledger_mod

                hist = ledger_mod.warm_start_tier(
                    str(model_key), self._bound_world)
            except Exception:
                hist = None
            if hist is not None and hist.get("mode") and \
                    hist["mode"] != self._comm_mode:
                with self._lock:
                    self._tier_cache[(model_key, self._bound_world)] = \
                        hist["mode"]
                self._emit(
                    "retier",
                    f"warm-start tier {hist['mode']} from ledger "
                    f"({hist.get('runs', 0)} prior runs)",
                    "warm_start", force=True, mode=hist["mode"],
                    record_id=hist.get("record_id"))
        if coordinator is None and (self.cfg.auto_evict or
                                    self.cfg.auto_world):
            (logger or logging).info(
                "controller: no elastic coordinator bound — membership "
                "levers (evict/backfill/world) disabled; pass "
                "fit(elastic=..., controller=...) to arm them")
        self._publish_state()
        return self

    def unbind(self):
        with self._lock:
            self._co = None
            self._health = None
            self._pending_retier = None
            self._pending_ckpt = None
            self._ckpt_every = None
        self.detector.detach()

    def start(self, interval=None):
        """Run ``tick()`` on a daemon thread named ``mx-fleet-ctl`` (for
        loops the controller does not own; ``fit(controller=...)`` ticks
        synchronously instead). Idempotent; :meth:`stop` joins it."""
        if self._thread is not None and self._thread.is_alive():
            return self._thread
        period = self.cfg.interval if interval is None else float(interval)
        self._stop.clear()

        def run():
            while not self._stop.wait(period):
                try:
                    self.tick()
                except Exception:  # the autopilot must never kill the job
                    self._logger.exception("controller: tick failed")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mx-fleet-ctl")
        self._thread.start()
        return self._thread

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    @property
    def threaded(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- state -----------------------------------------------------------------
    @property
    def state(self) -> str:
        if self.cfg.dry_run:
            return self.DRY_RUN
        if self.breaker.state != CircuitBreaker.CLOSED:
            return self.FROZEN
        return self.ARMED

    def _publish_state(self):
        from .. import telemetry

        telemetry.gauge("controller_state", self._STATE_CODE[self.state])
        # a healthy CLOSED breaker must be scrapeable, not absent
        self.breaker.publish_state()

    # -- decision plumbing -----------------------------------------------------
    def _emit(self, lever, action, outcome, force=False, **fields):
        """One decision record: hub event (-> flight incident ring) +
        counters. Consecutive identical (action, outcome) pairs per lever
        are deduped so a held cooldown cannot flood the incident ring."""
        from .. import telemetry

        key = (str(action), outcome)
        if not force and self._last_decision.get(lever) == key and \
                outcome not in ("actuated", "failed"):
            # dry-run recommendations dedupe too: a persistent condition
            # must not evict real incidents from the flight ring at one
            # identical event per tick
            return
        self._last_decision[lever] = key
        telemetry.counter("controller_decisions_total", lever=lever,
                          outcome=outcome)
        if outcome == "actuated":
            telemetry.counter("controller_actuations_total", lever=lever)
        record = {"lever": lever, "action": str(action),
                  "outcome": outcome, "dry_run": self.cfg.dry_run,
                  **fields}
        telemetry.emit("controller", **record)
        self.decisions.append(record)
        del self.decisions[:-256]
        self._logger.info("controller: [%s] %s -> %s%s", lever, action,
                          outcome, f" ({fields})" if fields else "")

    def _rate_limited(self, now):
        while self._action_times and now - self._action_times[0] > 3600.0:
            self._action_times.popleft()
        return len(self._action_times) >= self.cfg.max_actions_per_hour

    def _act(self, lever, action, fn, now, **fields):
        """Gate + execute one actuation. Returns True iff actuated."""
        if self.cfg.dry_run:
            self._emit(lever, action, "recommended", **fields)
            return False
        cooldown = self.cfg.cooldowns.get(lever, 0.0)
        last = self._last_action.get(lever)
        if last is not None and now - last < cooldown:
            self._emit(lever, action, "cooldown", **fields)
            return False
        if self._rate_limited(now):
            self._emit(lever, action, "rate_limited", **fields)
            return False
        if not self.breaker.allow():
            self._emit(lever, action, "frozen", **fields)
            self._publish_state()
            return False
        try:
            fn()
        except Exception as e:
            self.breaker.record_failure()
            self._emit(lever, action, "failed", error=repr(e), **fields)
            self._publish_state()
            return False
        self._last_action[lever] = now
        self._action_times.append(now)
        self._emit(lever, action, "actuated", **fields)
        # arm the outcome check: the fleet metric must not regress
        self._pending_evals.append(
            {"lever": lever, "action": str(action),
             "baseline": self._fleet_metric(),
             "deadline": now + self.cfg.evaluate_after})
        return True

    def actuation_failed(self, lever, exc, logger=None):
        """The fit loop applied a staged actuation and it blew up (e.g.
        the re-tiered exchange failed to build): count it against the
        breaker and freeze — without killing the fit."""
        with self._lock:
            self.breaker.record_failure()
            self._pending_evals = [p for p in self._pending_evals
                                   if p["lever"] != lever]
            self._emit(lever, "apply", "failed", force=True,
                       error=repr(exc))
            self._publish_state()
        (logger or self._logger).warning(
            "controller: %s actuation failed (%s); breaker %s", lever,
            exc, self.breaker.state)

    # -- sensors ---------------------------------------------------------------
    def _fleet_metric(self):
        """Per-chip throughput (1 / (mean step seconds * world)) over the
        detector window — per-chip so eviction/world moves stay
        comparable across sizes. None without data."""
        report = self._last_report
        if not report:
            return None
        ranks = report["membership"]["final_ranks"] or \
            sorted(report["ranks"])
        meds = [report["ranks"][r]["median_step_seconds"] for r in ranks
                if r in report["ranks"] and
                report["ranks"][r]["median_step_seconds"] > 0]
        if not meds:
            return None
        meds.sort()
        step_s = meds[len(meds) // 2]
        world = self._co.world_size if self._co is not None \
            else max(len(ranks), 1)
        if step_s <= 0 or world <= 0:
            return None
        return 1.0 / (step_s * world)

    def _comm_ratio(self, step_s):
        """comm:compute ratio — measured from the tick's span window
        when wire phases exist, else the closed-form fp32-wire estimate
        over the configured bandwidth."""
        from ..telemetry import sensors

        measured = sensors.comm_compute_ratio(self._last_window or {})
        if measured is not None:
            return measured
        if self._fp32_wire_bytes <= 0 or not step_s:
            return None
        wire_s = self._fp32_wire_bytes / (self.cfg.wire_gbps * 1e9)
        return wire_s / step_s

    # -- the policy loop -------------------------------------------------------
    def tick(self, now=None):
        """One policy pass: refresh sensors, evaluate the previous
        actuation, then run the levers (backfill -> evict -> retier ->
        world). Rate-limited by ``cfg.interval``; safe to call every
        step. Returns the straggler report it judged (or None)."""
        now = time.monotonic() if now is None else float(now)
        with self._lock:
            if now - self._last_tick < self.cfg.interval:
                return None
            self._last_tick = now
            self._publish_state()

            report = None
            self._last_window = None
            if self.detector.steps_seen >= self.cfg.min_report_steps:
                # ONE snapshot per tick, shared by the report and the
                # comm-ratio sensor (each costs O(window x ranks))
                self._last_window = self.detector.snapshot()
                report = self.detector.report(publish=True,
                                              events=self._last_window)
            self._last_report = report
            self._update_world_perf()
            self._evaluate(now)
            self._note_departures(now)

            blamed = None
            if report and report["stragglers"]:
                top = max(report["stragglers"],
                          key=lambda s: s["excess_seconds"])
                blamed = top["rank"]
            from .. import telemetry

            # -1 = nobody blamed right now (rank 0 is a real rank, and a
            # stale blame must not outlive the straggler on dashboards)
            telemetry.gauge("controller_blamed_rank",
                            -1.0 if blamed is None else float(blamed))
            self._blame_hist.append(blamed)
            if self._co is not None:
                self._co.record_blame(blamed)

            if self._co is not None:
                if self.cfg.auto_backfill:
                    self._lever_backfill(now)
                if self.cfg.auto_evict:
                    self._lever_evict(now, blamed, report)
            if self.cfg.auto_tier and self._can_retier:
                self._lever_retier(now)
            if self.cfg.auto_world and self._co is not None:
                self._lever_world(now)
            if self.cfg.auto_ckpt and self._ckpt_every is not None:
                self._lever_ckpt(now)
            if self._health is not None:
                self._lever_health()
            return report

    _last_report = None
    _last_window = None

    def _update_world_perf(self):
        metric = self._fleet_metric()
        if metric is None:
            return
        world = self._co.world_size if self._co is not None \
            else self._bound_world
        prev = self._world_perf.get(world)
        a = self.cfg.ewma_alpha
        self._world_perf[world] = metric if prev is None \
            else (1 - a) * prev + a * metric
        from .. import telemetry

        telemetry.gauge("controller_goodput_per_chip",
                        self._world_perf[world], world=world)

    def _evaluate(self, now):
        """Close the loop on every actuation past its deadline:
        regression past tolerance is a breaker failure; recovery/holding
        is a success (which also closes a half-open probe). Each
        actuation keeps its own check even when actions cluster inside
        one evaluate_after window."""
        due = [p for p in self._pending_evals if now >= p["deadline"]]
        if not due:
            return
        self._pending_evals = [p for p in self._pending_evals
                               if now < p["deadline"]]
        current = self._fleet_metric()
        for p in due:
            if p["baseline"] is None or current is None:
                continue  # no data: neither punish nor absolve
            if current < p["baseline"] * (1.0 - self.cfg.regress_tolerance):
                self.breaker.record_failure()
                self._emit(p["lever"], p["action"], "regressed",
                           force=True, baseline=round(p["baseline"], 6),
                           current=round(current, 6))
            else:
                self.breaker.record_success()
                self._emit(p["lever"], p["action"], "verified",
                           force=True, baseline=round(p["baseline"], 6),
                           current=round(current, 6))
        self._publish_state()

    def _note_departures(self, now):
        """Track who left the committed world since the last tick (the
        backfill lever's probation clock starts here)."""
        if self._co is None:
            return
        alive = set(self._co.alive)
        prev = self._prev_alive if self._prev_alive is not None else alive
        for rank in prev - alive:
            self._departed.setdefault(rank, {"t": now, "reason": "unknown"})
        # a rank is "back" only when committed alive AND not pending
        # removal — a just-evicted rank stays committed until the fit
        # loop polls/commits, and dropping its record here would lose
        # the eviction reason and restart its probation clock
        ev = self._co.poll()
        target = set(ev.ranks) if ev is not None else alive
        for rank in alive & target:
            self._departed.pop(rank, None)
        self._prev_alive = alive

    # -- levers ----------------------------------------------------------------
    def _lever_evict(self, now, blamed, report):
        if blamed is None or report is None:
            return
        votes = sum(1 for b in self._blame_hist if b == blamed)
        if votes < self.cfg.evict_k:
            return
        co = self._co
        # floor/membership checks against the TARGET world: an uncommitted
        # shrink may already be pending between fit's polls
        ev = co.poll()
        target = ev.ranks if ev is not None else co.alive
        if blamed not in target:
            return  # already on its way out (or never in)
        floor = max(co.min_world, int(self.cfg.min_world or 0))
        if len(target) - 1 < floor:
            self._emit("evict", f"evict rank {blamed}", "floor_held",
                       votes=votes, floor=floor)
            return
        if self._evictions.get(blamed, 0) >= self.cfg.max_evictions:
            self._emit("evict", f"evict rank {blamed}", "quarantined",
                       evictions=self._evictions[blamed])
            return
        top = next(s for s in report["stragglers"] if s["rank"] == blamed)

        def do():
            if self._co.kill(blamed, reason="evicted") is None:
                raise MXNetError(f"rank {blamed} already departed")

        if self._act("evict", f"evict rank {blamed}", do, now,
                     rank=blamed, blame=top["blame"], votes=votes,
                     excess_seconds=top["excess_seconds"],
                     **self._health_ctx()):
            self._evictions[blamed] = self._evictions.get(blamed, 0) + 1
            self._departed[blamed] = {"t": now, "reason": "evicted"}
            self._blame_hist.clear()

    def _lever_backfill(self, now):
        co = self._co
        budget = int(self.cfg.chip_budget or co.full_world_size)
        for rank, info in sorted(self._departed.items()):
            ev = co.poll()  # budget against the TARGET world (pending
            cur = ev.world_size if ev is not None else co.world_size
            if cur >= budget:  # joins count before fit commits them)
                return
            if ev is not None and rank in ev.ranks:
                continue  # already rejoining (someone else got there)
            if now - info["t"] < self.cfg.rejoin_after:
                continue
            if self._evictions.get(rank, 0) >= self.cfg.max_evictions:
                continue  # quarantined: stays out
            if co.heartbeat_timeout:
                # heartbeat-disciplined fleet: a departed rank must be
                # BEATING AGAIN (recovered hosts heartbeat before they
                # are readmitted) — probation alone never rejoins a
                # still-silent corpse
                beat = co.last_heartbeat(rank)
                if beat is None or \
                        time.monotonic() - beat > co.heartbeat_timeout:
                    continue
            def do(r=rank):
                # a None return means the join was a no-op (lost race):
                # that must not count as a successful actuation
                if co.join(r, reason="backfill") is None:
                    raise MXNetError(f"rank {r} already rejoined")

            self._act("backfill", f"rejoin rank {rank}", do, now,
                      rank=rank, departed_reason=info["reason"])

    def _lever_retier(self, now):
        report = self._last_report
        metric_step = None
        if report:
            ranks = report["membership"]["final_ranks"] or \
                sorted(report["ranks"])
            meds = sorted(report["ranks"][r]["median_step_seconds"]
                          for r in ranks if r in report["ranks"])
            metric_step = meds[len(meds) // 2] if meds else None
        ratio = self._comm_ratio(metric_step)
        world = self._co.world_size if self._co is not None \
            else self._bound_world
        cache_key = (self._model_key, world)
        mode = self._tier_cache.get(cache_key)
        if mode is None:
            mode = select_tier(ratio)
            if mode is None:
                return
            self._tier_cache[cache_key] = mode
        if mode == self._comm_mode or self._pending_retier is not None:
            return
        cap = select_overlap_bytes(ratio)
        action = f"retier {self._comm_mode} -> {mode}" + \
            (f" (overlap {cap >> 20} MB)" if cap else "")

        def stage():
            self._pending_retier = {"mode": mode, "bucket_bytes": cap,
                                    "ratio": ratio}

        self._act("retier", action, stage, now, mode=mode,
                  bucket_bytes=cap, ratio=None if ratio is None
                  else round(ratio, 4), **self._health_ctx())

    def _lever_world(self, now):
        co = self._co
        floor = max(co.min_world, int(self.cfg.min_world or 0))
        budget = int(self.cfg.chip_budget or co.full_world_size)
        if self._departed:
            return  # never grow into a probation/quarantine hole
        target = choose_world(self._world_perf, co.world_size, floor,
                              budget, margin=self.cfg.world_margin)
        if target == co.world_size:
            return
        self._act("world", f"resize world {co.world_size} -> {target}",
                  lambda: co.request_world(target, reason="goodput"), now,
                  target=target,
                  perf={str(k): round(v, 6)
                        for k, v in self._world_perf.items()})

    def _lever_ckpt(self, now):
        """Checkpoint-cadence lever: widen/narrow the snapshot
        cadence so the MEASURED save cost (the ``checkpoint_save_seconds``
        hub histogram: T0 snapshot stall + background write wall) tracks
        ``cfg.ckpt_target_overhead`` of step time. Staged like retier —
        the fit loop owns the live cadence and applies via
        :meth:`take_ckpt_cadence` — and recommend-capable: dry-run mode
        emits the move without staging it."""
        from .. import telemetry

        if self._pending_ckpt is not None:
            return
        report = self._last_report
        step_s = None
        if report:
            ranks = report["membership"]["final_ranks"] or \
                sorted(report["ranks"])
            meds = sorted(report["ranks"][r]["median_step_seconds"]
                          for r in ranks if r in report["ranks"])
            step_s = meds[len(meds) // 2] if meds else None
        hist = telemetry.hub().snapshot()["histograms"].get(
            "checkpoint_save_seconds")
        save_s = (hist["sum"] / hist["count"]) if hist and hist["count"] \
            else None
        target = select_ckpt_cadence(
            save_s, step_s, self._ckpt_every,
            target_overhead=self.cfg.ckpt_target_overhead)
        if target == self._ckpt_every:
            return

        def stage():
            self._pending_ckpt = {"every": int(target)}

        self._act("ckpt",
                  f"ckpt cadence {self._ckpt_every} -> {target}", stage,
                  now, every=int(target),
                  save_seconds=None if save_s is None else round(save_s, 4),
                  step_seconds=None if step_s is None else round(step_s, 4))

    def _health_ctx(self):
        """Model-health decision context: the currently-blamed layer (if
        the health monitor flagged one recently). Attached to evict and
        retier decisions so a post-mortem can correlate a fleet move with
        the model state it happened under."""
        if self._health is None:
            return {}
        blamed = self._health.blamed_layer()
        if blamed is None:
            return {}
        return {"health_layer": blamed[0], "health_reason": blamed[1]}

    def _lever_health(self):
        """Recommend-only model-health lever: a persistent
        layer anomaly surfaces as a ``controller`` decision event with
        outcome ``recommended`` — the autopilot NEVER actuates on model
        health (hyperparameters are the user's contract; the guard layer
        already owns NaN steps). Deduped by _emit, so a sustained anomaly
        costs one incident, not one per tick."""
        blamed = self._health.blamed_layer()
        if blamed is None:
            return
        layer, reason = blamed
        self._emit("health", f"inspect layer {layer}: {reason}",
                   "recommended", layer=layer, reason=reason)

    # -- staged actuations (applied by the fit loop) ---------------------------
    def take_retier(self):
        """Pop the staged tier change (or None). The fit loop applies it
        on the training thread and reports back via
        :meth:`retier_applied` / :meth:`actuation_failed`."""
        with self._lock:
            action, self._pending_retier = self._pending_retier, None
            return action

    def take_ckpt_cadence(self):
        """Pop the staged cadence change (or None); the fit loop applies
        it on the host (the cadence is a step-loop counter; nothing is
        rebuilt) and reports back via :meth:`ckpt_cadence_applied`."""
        with self._lock:
            action, self._pending_ckpt = self._pending_ckpt, None
            return action

    def ckpt_cadence_applied(self, action):
        """The fit loop adopted the staged checkpoint cadence."""
        from .. import telemetry

        with self._lock:
            self._ckpt_every = max(1, int(action["every"]))
            telemetry.gauge("controller_ckpt_cadence",
                            float(self._ckpt_every))
            telemetry.emit("controller", lever="ckpt",
                           action=f"applied every {self._ckpt_every}",
                           outcome="applied", dry_run=False)

    def retier_applied(self, action, seconds):
        """The fit loop rebuilt the exchange on the new tier."""
        from .. import telemetry
        from ..comm import CompressionSpec

        with self._lock:
            self._comm_mode = action["mode"]
            world = self._co.world_size if self._co is not None \
                else self._bound_world
            self._tier_cache[(self._model_key, world)] = action["mode"]
            # gauge encoding follows the comm layer's canonical mode
            # order — one source of truth for tier identity
            telemetry.gauge("controller_comm_tier", float(
                CompressionSpec.MODES.index(action["mode"])))
            telemetry.emit("controller", lever="retier",
                           action=f"applied {action['mode']}",
                           outcome="applied", seconds=round(seconds, 4),
                           dry_run=False)
