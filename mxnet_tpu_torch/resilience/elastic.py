"""Elastic training: resize the world of replicas mid-run.

Counterpart of ``mxnet_tpu/resilience/elastic.py``, with the same names,
the same coalescing, epochs and history, and the same chaos sites: the
same calls on either package's coordinator give the same
:class:`ResizeEvent`\\ s. Losing a worker does not end the job: training
goes on over the survivors and takes capacity back when it returns. This
module is the control plane for that:

  **membership**: an :class:`ElasticCoordinator` owns the set of alive
  workers (in the port, the replicas of a ctx list, one rank a replica).
  Deaths arrive as ``kill()`` (detected failures: a kvstore timeout, an
  expired heartbeat, chaos), graceful departures as ``leave()``, returning
  capacity as ``join()``/``join_all()``. Every committed change bumps a
  **membership epoch**, the generation tag the kvstore layer stamps on
  its rounds, so a round that spans a change is detected, not hung.

  **the resize protocol** (driven by ``FeedForward.fit(elastic=...)``,
  model.py): on a pending change the trainer *quiesces* (synchronizes the
  replicas' device), *restores* the parameters, the optimizer state and
  the error-feedback residuals from the freshest snapshot of the peer
  tier, or else from the newest CRC-manifest checkpoint on disk
  (residuals survive only when their layout key still matches, which a
  changed world never does), *re-plans* (a fresh overlap plan for the
  new world), *rebuilds* the replicas and their exchange, and *resumes*
  the fit loop in the same process. The interrupted epoch is redone on
  the new world from the snapshot's step, the contract preemption resume
  has.

  **accounting**: each resize is an event (kind ``resize``) and a span of
  kind ``resize`` in the step timeline, its downtime is ``resize`` badput
  in goodput (telemetry/mfu.py), and the hub's world-size labels are
  re-stamped so metrics after a resize carry the new world.

Hang promotion: :class:`MembershipTimeout` (a :class:`MembershipChanged`)
is what the kvstore layer raises when a round stalls past its deadline
(kvstore.py ``_GroupServer``, kvstore_async.py barrier rounds): a worker
dead mid-round becomes a detected membership change, not a stall.

Chaos sites (resilience/chaos.py; armed tests only): ``elastic.kill``
fires -> the coordinator kills the highest alive rank; ``elastic.rejoin``
fires -> every departed rank rejoins. The elastic fit loop calls
``chaos_poll()`` once a step.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from ..analysis.lockwatch import named_lock
from ..base import MXNetError

__all__ = ["MembershipChanged", "MembershipTimeout", "ResizeEvent",
           "ElasticCoordinator"]


class MembershipChanged(MXNetError):
    """The worker set changed while an operation was in flight; the caller
    should consult the coordinator and resize instead of retrying."""

    def __init__(self, message, membership_epoch=None):
        super().__init__(message)
        self.membership_epoch = membership_epoch


class MembershipTimeout(MembershipChanged):
    """A collective round stalled past its per-op deadline — promoted to a
    presumed membership change (dead worker) instead of an indefinite
    hang. Raised by the kvstore layer's membership-epoch-tagged barrier
    and BSP accumulate rounds."""


class ResizeEvent:
    """One pending membership change: the target alive set and why.

    ``ranks`` is the COALESCED target (several kills/joins between polls
    collapse into one resize), sorted; ``membership_epoch`` is the epoch
    the change will commit as."""

    __slots__ = ("kind", "ranks", "reason", "membership_epoch")

    def __init__(self, kind, ranks, reason, membership_epoch):
        self.kind = kind
        self.ranks = tuple(ranks)
        self.reason = reason
        self.membership_epoch = int(membership_epoch)

    @property
    def world_size(self):
        return len(self.ranks)

    def __repr__(self):
        return (f"ResizeEvent({self.kind!r}, world={len(self.ranks)}, "
                f"reason={self.reason!r}, epoch={self.membership_epoch})")


_ON_VALUES = ("1", "on", "true", "yes")


class ElasticCoordinator:
    """Membership authority for one elastic training run.

    The full world is the rank set ``0..world_size-1`` (one rank a
    replica of the ctx list). Control-plane calls (``kill`` /
    ``leave`` / ``join`` / ``request_world`` / heartbeat expiry) mutate a
    *target* set; the data plane (the fit loop) calls :meth:`poll` once
    per step and, on a pending change, quiesces and :meth:`commit`\\ s it.
    Changes between polls coalesce — killing two workers back-to-back is
    ONE resize, not two.

    ``min_world`` bounds shrinkage (a production job would rather die
    than limp on one replica forever; it defaults to 2 because the world
    of replicas the trainer resizes needs at least two, so a kill cascade
    can never shrink an armed run into a world fit cannot rebuild). ``heartbeat_timeout`` arms death detection by
    silence: ranks that have ever :meth:`heartbeat`-ed and then go quiet
    for longer than the timeout are killed by :meth:`check_heartbeats`.
    """

    def __init__(self, world_size, min_world=None, heartbeat_timeout=None):
        world_size = int(world_size)
        if world_size < 1:
            raise MXNetError("elastic world_size must be >= 1")
        if min_world is None:
            min_world = min(2, world_size)
        self.min_world = int(min_world)
        if not 1 <= self.min_world <= world_size:
            raise MXNetError(
                f"min_world must be in [1, {world_size}], got "
                f"{self.min_world}")
        self.heartbeat_timeout = heartbeat_timeout
        self._lock = named_lock("elastic.ElasticCoordinator")
        self._all = tuple(range(world_size))
        self._alive = set(self._all)
        self._target = set(self._all)
        self._reasons: list = []
        self._beats: dict = {}
        self._last_blamed = None  # newest straggler-detector blame
        self.membership_epoch = 0
        self.resizes = 0
        self._hb_thread = None
        self._hb_stop = threading.Event()
        # committed resize records: {"from", "to", "ranks", "reason",
        # "membership_epoch", "downtime_s"}
        self.history: list = []

    @classmethod
    def resolve(cls, value, world_size):
        """Normalize fit()'s ``elastic`` argument: None -> env gate
        ``MXNET_TPU_ELASTIC``, True -> a fresh coordinator over
        ``world_size`` ranks, a coordinator passes through."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_ELASTIC", "").strip().lower()
            if raw not in _ON_VALUES:
                return None
            value = True
        if value is False:
            return None
        if value is True:
            return cls(world_size)
        if isinstance(value, cls):
            return value
        raise MXNetError(
            f"elastic= must be True/False/None or an ElasticCoordinator, "
            f"got {value!r}")

    # -- introspection ---------------------------------------------------------
    @property
    def world_size(self) -> int:
        """Size of the COMMITTED world (what training currently runs on)."""
        with self._lock:
            return len(self._alive)

    @property
    def alive(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._alive))

    @property
    def full_world_size(self) -> int:
        return len(self._all)

    # -- control plane ---------------------------------------------------------
    def _remove_locked(self, rank, kind, reason, strict=True):
        if rank not in self._target:
            return None  # already gone: kill after leave coalesces silently
        if len(self._target) - 1 < self.min_world:
            if not strict:
                return None  # caller holds the floor instead of raising
            raise MXNetError(
                f"cannot {kind} rank {rank}: world would shrink below "
                f"min_world={self.min_world}")
        self._target.discard(rank)
        self._beats.pop(rank, None)
        self._reasons.append(f"{kind}:{rank}:{reason}")
        return rank

    def kill(self, rank=None, reason="failure"):
        """A worker died (kvstore timeout, heartbeat expiry, chaos). With
        ``rank=None`` the highest alive rank is the victim (deterministic
        for seeded chaos schedules). Returns the killed rank, or None if
        it was already out."""
        with self._lock:
            if rank is None:
                if not self._target:
                    return None
                rank = max(self._target)
            rank = self._remove_locked(int(rank), "kill", reason)
        if rank is not None:
            logging.warning("elastic: rank %d declared dead (%s); resize "
                            "pending", rank, reason)
        return rank

    def leave(self, rank, reason="requested"):
        """Graceful departure request for ``rank``."""
        with self._lock:
            return self._remove_locked(int(rank), "leave", reason)

    def join(self, rank=None, reason="rejoin"):
        """A worker (re)joined. With ``rank=None`` the lowest departed
        rank joins. Returns the joining rank, or None when the world is
        already full."""
        with self._lock:
            departed = set(self._all) - self._target
            if rank is None:
                if not departed:
                    return None
                rank = min(departed)
            rank = int(rank)
            if rank not in self._all:
                raise MXNetError(
                    f"rank {rank} is not part of this world "
                    f"(0..{len(self._all) - 1})")
            if rank in self._target:
                return None
            self._target.add(rank)
            self._reasons.append(f"join:{rank}:{reason}")
        logging.info("elastic: rank %d rejoining; resize pending", rank)
        return rank

    def join_all(self, reason="rejoin"):
        """Every departed rank rejoins (the capacity-returned event)."""
        joined = []
        while True:
            rank = self.join(reason=reason)
            if rank is None:
                return joined
            joined.append(rank)

    def record_blame(self, rank):
        """Remember the rank the straggler detector most recently blamed
        (the fleet controller calls this each policy tick). A shrink via
        :meth:`request_world` prefers this rank as its victim — capacity
        reductions should shed the slowest worker, not an arbitrary one."""
        with self._lock:
            self._last_blamed = None if rank is None else int(rank)

    def last_heartbeat(self, rank):
        """Monotonic time of ``rank``'s newest beat, or None (never
        beat / departed). The controller's backfill policy uses this to
        readmit a heartbeat-dead rank only once it is beating again."""
        with self._lock:
            return self._beats.get(int(rank))

    def request_world(self, n, reason="requested"):
        """Explicit resize to ``n`` workers: a shrink prefers the rank the
        straggler detector most recently blamed (:meth:`record_blame`),
        then drops the highest ranks; grow readmits the lowest departed
        ones."""
        n = int(n)
        if not self.min_world <= n <= len(self._all):
            raise MXNetError(
                f"requested world {n} outside "
                f"[{self.min_world}, {len(self._all)}]")
        while True:
            with self._lock:
                cur = len(self._target)
                # pick the victim under the lock: concurrent kill/join
                # threads mutate the target set
                victim = None
                if cur > n:
                    blamed = self._last_blamed
                    victim = blamed if blamed in self._target \
                        else max(self._target)
            if cur == n:
                return n
            if victim is not None:
                self.leave(victim, reason=reason)
            else:
                self.join(reason=reason)

    # -- liveness --------------------------------------------------------------
    def heartbeat(self, rank):
        """Record a liveness beat for ``rank`` (monotonic clock)."""
        with self._lock:
            self._beats[int(rank)] = time.monotonic()

    def check_heartbeats(self):
        """Kill every rank whose last heartbeat is older than
        ``heartbeat_timeout``. Ranks that never beat are not judged (they
        predate the heartbeat wire-up). Expiries that would breach
        ``min_world`` are logged and HELD, not killed — a mass heartbeat
        lapse must degrade the world to its floor, never crash the
        training loop that polls this. Returns the killed ranks."""
        if not self.heartbeat_timeout:
            return []
        now = time.monotonic()
        killed, held = [], []
        with self._lock:
            # scan + removal under ONE lock acquisition: a concurrent
            # leave()/kill() between a separate check and removal could
            # push the world to the floor and turn the removal into the
            # MXNetError this method promises never to raise
            stale = [r for r, t in self._beats.items()
                     if r in self._target and
                     now - t > self.heartbeat_timeout]
            for rank in sorted(stale):
                if self._remove_locked(rank, "kill", "heartbeat",
                                       strict=False) is not None:
                    killed.append(rank)
                elif rank in self._target:
                    held.append(rank)
        for rank in killed:
            logging.warning("elastic: rank %d declared dead (heartbeat); "
                            "resize pending", rank)
        for rank in held:
            logging.warning(
                "elastic: rank %d heartbeat expired but the world is at "
                "its min_world=%d floor — holding it (beat or raise the "
                "floor policy to change this)", rank, self.min_world)
        return killed

    def start_heartbeat_monitor(self, interval=None):
        """Background death-by-silence detection: a daemon thread (named
        ``mx-heartbeat`` so lockwatch reports and faulthandler tracebacks
        attribute it by role) runs :meth:`check_heartbeats` every
        ``interval`` seconds (default: half the heartbeat timeout), so
        expiry is detected even while the fit loop is stalled inside a
        long step or a collective. No-op without a ``heartbeat_timeout``;
        idempotent. Returns the thread (or None)."""
        if not self.heartbeat_timeout:
            return None
        if self._hb_thread is not None and self._hb_thread.is_alive():
            return self._hb_thread
        if interval is None:
            interval = max(self.heartbeat_timeout / 2.0, 0.01)
        self._hb_stop.clear()

        def monitor():
            while not self._hb_stop.wait(interval):
                self.check_heartbeats()

        self._hb_thread = threading.Thread(target=monitor, daemon=True,
                                           name="mx-heartbeat")
        self._hb_thread.start()
        return self._hb_thread

    def stop_heartbeat_monitor(self):
        """Stop the background monitor (joined; safe to call twice)."""
        self._hb_stop.set()
        t, self._hb_thread = self._hb_thread, None
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    # -- chaos wiring ----------------------------------------------------------
    def chaos_poll(self):
        """Advance the ``elastic.kill`` / ``elastic.rejoin`` chaos sites
        (one occurrence per call; the fit loop calls this once per step).
        No-op cost when chaos is disarmed: one global read per site."""
        from . import chaos as chaos_mod

        if chaos_mod.active() is None:
            return
        if chaos_mod.fires("elastic.kill"):
            self.kill(reason="chaos")
        if chaos_mod.fires("elastic.rejoin"):
            self.join_all(reason="chaos")

    # -- data plane ------------------------------------------------------------
    def poll(self):
        """The fit loop's per-step membership check: a coalesced
        :class:`ResizeEvent` when the target world differs from the
        committed one, else None."""
        with self._lock:
            if self._target == self._alive:
                return None
            kind = "shrink" if len(self._target) < len(self._alive) \
                else ("grow" if len(self._target) > len(self._alive)
                      else "reshape")
            return ResizeEvent(kind, sorted(self._target),
                               ";".join(self._reasons) or kind,
                               self.membership_epoch + 1)

    @staticmethod
    def _reason_kinds(reason: str) -> str:
        """Sorted, comma-joined categories behind one coalesced resize —
        the trailing field of each ``kind:rank:why`` entry (``evicted``,
        ``failure``, ``heartbeat``, ``chaos``, ``rejoin``, ...), so an
        eviction the controller chose is distinguishable from a failure
        the fleet suffered on every resize event and counter label."""
        kinds = set()
        for part in str(reason).split(";"):
            bits = part.split(":", 2)
            kinds.add(bits[2] if len(bits) == 3 else part)
        return ",".join(sorted(k for k in kinds if k))

    def commit(self, event: ResizeEvent, logger=None):
        """Apply a polled resize: the target becomes the committed world,
        the membership epoch bumps, the hub world labels re-stamp, and a
        ``resize`` event lands in the telemetry ring. The trainer calls
        this AFTER quiescing and before rebuilding replicas/plans/state."""
        from .. import telemetry

        with self._lock:
            old = len(self._alive)
            self._alive = set(event.ranks)
            self.membership_epoch += 1
            epoch = self.membership_epoch
            self.resizes += 1
            self._reasons = []
            self.history.append({
                "from": old, "to": len(self._alive),
                "ranks": tuple(sorted(self._alive)),
                "reason": event.reason, "membership_epoch": epoch,
                "downtime_s": None})
        # re-stamp the world labels: every post-resize hub event and
        # exported metric family carries the new world size
        telemetry.set_world(telemetry.current_rank(), len(event.ranks))
        telemetry.gauge("elastic_world_size", float(len(event.ranks)))
        reason_kinds = self._reason_kinds(event.reason)
        telemetry.counter("elastic_resizes_total", reason=reason_kinds)
        telemetry.emit("resize", from_world=old, to_world=len(event.ranks),
                       reason=event.reason, reason_kinds=reason_kinds,
                       membership_epoch=epoch, resize_kind=event.kind)
        (logger or logging).info(
            "elastic: world resized %d -> %d (%s; membership epoch %d)",
            old, len(event.ranks), event.reason, epoch)
        return epoch

    def record_downtime(self, seconds):
        """Attach the measured quiesce->resume downtime of the newest
        committed resize (fit calls this once the new world is built); the
        same seconds are priced into goodput as ``resize`` badput by the
        epoch report."""
        from .. import telemetry

        seconds = float(seconds)
        with self._lock:
            if self.history:
                self.history[-1]["downtime_s"] = seconds
        telemetry.observe("elastic_resize_downtime_seconds", seconds)
        return seconds
