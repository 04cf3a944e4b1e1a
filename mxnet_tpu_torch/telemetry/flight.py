"""Flight recorder: the always-on black box for crash forensics.

A training process that dies mid-step takes its telemetry with it — the
hub's event ring and the timeline live in memory, and the JSONL sink (if
any) ends wherever the stream was cut. The flight recorder keeps a small,
always-on window of recent history and knows how to get it onto disk when
things go wrong:

  **rings** — the last K complete step spans (full phase breakdowns when
  the timeline is on; lightweight ``step_lite`` marks from the fit loop
  otherwise), the most recent hub events, and every guard/chaos/retry/
  dedup/watchdog *incident* (incidents get their own ring so a noisy event
  stream cannot evict the one retry that explains the crash). The recorder
  is a hub sink attached at import and re-attached across ``reset()`` —
  recording costs one lock + deque append per event.

  **atomic dumps** — ``dump(path)`` writes one JSON file via the
  checkpoint discipline: serialize to a tmp file in the target directory,
  ``os.replace`` into place, with a CRC32 of the canonical payload
  embedded so a reader can prove the dump wasn't torn or corrupted
  (:func:`validate_flight`). Dumps fire on watchdog trips, guard-retry
  exhaustion, preemption (SIGTERM flush), unhandled exceptions (chained
  ``sys.excepthook``), and on demand via ``model.telemetry.dump_flight()``
  or :func:`dump`.

Automatic dumps need a destination: set ``MXNET_TPU_FLIGHT_DIR`` and every
trigger writes ``flight-r<rank>-<reason>-<pid>.json`` there (unset, the
triggers no-op — a library must not scatter files by default). On-demand
dumps with an explicit path always work. ``python -m mxnet_tpu_torch.telemetry
flight show <dump>`` renders the post-mortem.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import zlib

from ..analysis.lockwatch import named_lock
from .hub import hub as _hub, on_hub_create

__all__ = ["FlightRecorder", "INCIDENT_KINDS", "recorder", "reset",
           "note_step", "dump", "auto_dump", "validate_flight",
           "install", "flight_dir"]

FLIGHT_FORMAT = 1

# event kinds that are incidents: the "what went wrong" ring
INCIDENT_KINDS = frozenset({
    "retry", "circuit_open", "step_event", "server_dedup", "watchdog",
    "chaos", "badput", "guard_trip", "preempt", "memory_leak", "lockwatch",
    "controller", "breaker", "health_anomaly", "checkpoint",
})


def flight_dir():
    """Destination for automatic dumps (None = auto-dumps disabled)."""
    d = os.environ.get("MXNET_TPU_FLIGHT_DIR", "").strip()
    return d or None


class FlightRecorder:
    """Fixed-size rings of recent steps / incidents + CRC dumps.

    Thread-safe; registered as a hub sink so every ``emit`` feeds it. Step
    spans (kind="span") land in the step ring, incident kinds in the
    incident ring — their own ring, so a noisy event stream cannot evict
    the one retry that explains a crash. Ordinary events are NOT copied:
    the hub's own ring already holds them, and ``snapshot``/``dump`` read
    the recent window from there — so the per-emit sink cost for a
    non-span, non-incident event is one dict get + one set lookup."""

    def __init__(self, k_steps=64, k_events=512, k_incidents=256):
        self._lock = named_lock("telemetry.flight.FlightRecorder")
        self._k_events = int(k_events)
        self._steps = collections.deque(maxlen=int(k_steps))
        self._incidents = collections.deque(maxlen=int(k_incidents))
        self.dump_count = 0

    # -- recording (hub sink protocol) ----------------------------------------
    def write_event(self, event):
        kind = event.get("kind")
        if kind == "span":
            with self._lock:
                self._steps.append(event)
        elif kind in INCIDENT_KINDS:
            with self._lock:
                self._incidents.append(event)

    def note_step(self, epoch, step, kind="step", **fields):
        """Lightweight step mark for loops running WITHOUT a timeline —
        the flight recorder still shows the last K steps (identity +
        timestamp; durations come from consecutive marks)."""
        h = _hub()
        from .distributed import current_rank, mint_span_id, trace_id

        rank = current_rank()
        rec = {"kind": "step_lite", "name": kind, "epoch": int(epoch),
               "step": int(step), "rank": rank,
               "span_id": mint_span_id(rank, epoch, step, kind),
               "trace_id": trace_id(), "wall_ts": h.now(), **fields}
        with self._lock:
            self._steps.append(rec)
        return rec

    def clear(self):
        with self._lock:
            self._steps.clear()
            self._incidents.clear()

    # -- dumping ---------------------------------------------------------------
    def snapshot(self, only_rank=None):
        """Point-in-time copy of the black box (optionally one rank's view
        — the in-process multi-worker harness shares one recorder).
        Recent ordinary events come from the hub's own ring."""
        events = _hub().events(limit=self._k_events)
        with self._lock:
            steps = list(self._steps)
            incidents = list(self._incidents)
        if only_rank is not None:
            keep = lambda e: int(e.get("rank", 0)) == int(only_rank)  # noqa: E731
            steps = [e for e in steps if keep(e)]
            events = [e for e in events if keep(e)]
            incidents = [e for e in incidents if keep(e)]
        return steps, events, incidents

    def dump(self, path, reason="manual", only_rank=None):
        """Atomically write the black box to ``path``: tmp file + rename,
        CRC32 of the canonical payload embedded (the checkpoint-manifest
        discipline — a dump that lies is worse than none)."""
        from . import distributed as dist_mod
        from .exporters import SCHEMA_VERSION

        h = _hub()
        steps, events, incidents = self.snapshot(only_rank=only_rank)
        rank = dist_mod.current_rank() if only_rank is None else int(only_rank)
        try:
            # allocator + ledger + top-plans snapshot (forensics);
            # a failing section degrades to absence — the black box must
            # always land, with or without its memory page
            from . import memory as memory_mod

            mem_snapshot = memory_mod.forensics_snapshot()
        except Exception:
            mem_snapshot = None
        try:
            # last device-profile capture: the measured hotspot
            # view of the run that died — same graceful-absence contract
            # as the memory page (old dumps simply lack the section)
            from . import profiling as profiling_mod

            prof_snapshot = profiling_mod.last_capture_summary()
        except Exception:
            prof_snapshot = None
        payload = {
            "format": FLIGHT_FORMAT,
            "v": SCHEMA_VERSION,
            # run identity: the dump joins to ledger records
            # and event streams on run_id (old dumps simply lack the key)
            "run_id": getattr(h, "run_id", None),
            "trace_id": dist_mod.trace_id(),
            "rank": rank,
            "world_size": dist_mod.world_size(),
            "reason": str(reason),
            "pid": os.getpid(),
            "dumped_at": h.now(),
            "steps": steps,
            "events": events,
            "incidents": incidents,
            "counters": {k: v for k, v in
                         h.snapshot()["counters"].items() if v},
        }
        if mem_snapshot is not None:
            payload["memory"] = mem_snapshot
        if prof_snapshot is not None:
            payload["profile"] = prof_snapshot
        body = json.dumps(payload, sort_keys=True, default=str)
        blob = {"format": FLIGHT_FORMAT,
                "crc32": zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF,
                "payload": json.loads(body)}
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory,
                           f".{os.path.basename(path)}.tmp{os.getpid()}")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(blob, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with self._lock:
            # dump() runs from the excepthook chain, preempt flush, and
            # manual calls concurrently — count under the ring lock
            self.dump_count += 1
        h.emit("flight_dump", reason=str(reason), path=path,
               steps=len(steps), incidents=len(incidents))
        return path


def validate_flight(path):
    """(ok, payload-or-error): re-derive the CRC over the canonical
    payload and compare — a torn or bit-flipped dump fails closed."""
    try:
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable flight dump: {e}"
    if not isinstance(blob, dict) or "payload" not in blob:
        return False, "not a flight dump (no payload)"
    body = json.dumps(blob["payload"], sort_keys=True, default=str)
    crc = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    if crc != blob.get("crc32"):
        return False, f"CRC mismatch: {crc} != {blob.get('crc32')}"
    return True, blob["payload"]


# -- process-global recorder ---------------------------------------------------

_RECORDER = None
_LOCK = named_lock("telemetry.flight.global")
_INSTALLED = False
_PREV_EXCEPTHOOK = None


def recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        with _LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder()
    return _RECORDER


def reset():
    """Clear the rings (tests); the recorder object and its hub
    attachment survive."""
    recorder().clear()
    return recorder()


def note_step(epoch, step, kind="step", **fields):
    return recorder().note_step(epoch, step, kind=kind, **fields)


def dump(path, reason="manual", only_rank=None):
    return recorder().dump(path, reason=reason, only_rank=only_rank)


def auto_dump(reason):
    """Dump to MXNET_TPU_FLIGHT_DIR on a crash-path trigger (watchdog,
    guard exhaustion, preemption, unhandled exception). No directory
    configured -> no-op; a failing dump must never mask the original
    failure, so errors are swallowed after a log line."""
    directory = flight_dir()
    if directory is None:
        return None
    from .distributed import current_rank

    path = os.path.join(
        directory, f"flight-r{current_rank()}-{reason}-{os.getpid()}.json")
    try:
        return recorder().dump(path, reason=reason)
    except Exception as e:  # the trigger's own failure takes precedence
        import logging

        logging.warning("flight recorder: dump on %s failed: %s", reason, e)
        return None


def _excepthook(exc_type, exc, tb):
    if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
        auto_dump("exception")
    if _PREV_EXCEPTHOOK is not None:
        _PREV_EXCEPTHOOK(exc_type, exc, tb)


def install():
    """Attach the recorder as a hub sink (now and on every future hub)
    and chain sys.excepthook so an unhandled exception leaves a black box
    behind. The hook is chained unconditionally — whether it WRITES is
    decided at fire time by auto_dump's flight_dir() check, so setting
    MXNET_TPU_FLIGHT_DIR after import still arms the exception dump.
    Idempotent; called at telemetry import."""
    global _INSTALLED, _PREV_EXCEPTHOOK
    with _LOCK:
        if _INSTALLED:
            return recorder()
        _INSTALLED = True
    rec = recorder()
    kinds = frozenset({"span"}) | INCIDENT_KINDS

    def _attach(h):
        if not h.has_sink(rec):
            # kind-filtered: ordinary events cost the emit hot path one
            # dict lookup, not a sink call (they are read back from the
            # hub's own ring at dump time)
            h.add_sink(rec, kinds=kinds)

    on_hub_create(_attach)
    _attach(_hub())
    _PREV_EXCEPTHOOK = sys.excepthook
    sys.excepthook = _excepthook
    return rec
