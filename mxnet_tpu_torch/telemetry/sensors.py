"""Sensor-read APIs over the live hub: what a policy loop consumes.

The telemetry layer so far is built for *people* — JSONL streams, Chrome
traces, Prometheus scrapes, post-hoc ``detect_stragglers`` over exported
files. The fleet controller (resilience/controller.py) needs
the same signals **live, incrementally, and cheaply**, once per policy
tick, without re-parsing anything:

  :class:`StreamingStragglerDetector`
      an incremental front-end for :func:`detect_stragglers`: it
      registers as a kind-filtered hub sink (``kinds=("span",)``) so each
      step span costs one lock + deque append at emit time, retains the
      last ``window`` fleet steps per rank, and ``report()`` runs the
      EXACT batch detector over that window — agreement with the batch
      path on the same window is a unit-tested contract
      (tests/test_controller.py), so the controller's blame can never
      drift from what ``telemetry straggle`` would print.

  :func:`comm_compute_ratio`
      measured comm:compute ratio from a window of span events (wire/
      kvstore phases + hidden ``overlap`` subs vs the device phase) —
      the input to the controller's compression-tier policy. Returns
      None when the window carries no phase attribution (the in-jit
      mesh path hides comm inside the fused step; the controller then
      falls back to the closed-form wire-plan estimate).

Guide: doc/developer-guide/resilience.md, "Fleet controller".
"""

from __future__ import annotations

import collections

from ..analysis.lockwatch import named_lock
from .distributed import detect_stragglers
from .hub import hub as _hub

__all__ = ["StreamingStragglerDetector", "comm_compute_ratio"]


class StreamingStragglerDetector:
    """Incremental straggler detection over the live hub event ring.

    Attach with :meth:`attach` (a kind-filtered hub sink: only ``span``
    events reach :meth:`write_event`); each poll of :meth:`report` costs
    O(window x ranks), bounded by construction — never a function of run
    length or JSONL file size. ``window`` is the fleet-step window the
    batch detector is run over, so ``report()`` == ``detect_stragglers``
    on the same trailing window of events.
    """

    def __init__(self, window=32, mad_k=3.5, abs_floor=1e-3,
                 min_flagged_frac=0.5, span_name="step"):
        self.window = int(window)
        self.mad_k = float(mad_k)
        self.abs_floor = float(abs_floor)
        self.min_flagged_frac = float(min_flagged_frac)
        self.span_name = span_name
        self._lock = named_lock("telemetry.sensors.StreamingStragglerDetector")
        self._by_rank: dict = {}   # rank -> deque of span events
        self._steps_seen = 0
        self._attached = None

    # -- hub sink protocol -----------------------------------------------------
    def write_event(self, event):
        """One span event from the hub (attach() filters kinds for us,
        but direct feeding — tests, replay — passes anything)."""
        if event.get("kind") != "span" or \
                event.get("name", "step") != self.span_name:
            return
        rank = int(event.get("rank", 0))
        with self._lock:
            ring = self._by_rank.get(rank)
            if ring is None:
                ring = self._by_rank[rank] = collections.deque(
                    maxlen=self.window)
            ring.append(event)
            self._steps_seen += 1

    def feed(self, events):
        """Manual ingestion (tests / replaying an exported stream)."""
        for e in events:
            self.write_event(e)

    def attach(self, h=None):
        """Register as a kind-filtered sink on ``h`` (default: the process
        hub). Idempotent per hub; returns self."""
        h = h or _hub()
        if self._attached is not h and not h.has_sink(self):
            h.add_sink(self, kinds=("span",))
            self._attached = h
        return self

    def detach(self):
        if self._attached is not None:
            self._attached.remove_sink(self)
            self._attached = None

    # -- queries ---------------------------------------------------------------
    @property
    def steps_seen(self):
        with self._lock:
            return self._steps_seen

    def snapshot(self):
        """{rank: [span events]} trimmed to the last ``window`` distinct
        fleet step keys — exactly the window ``report()`` judges, and the
        hygiene pass that forgets ranks whose every span has aged out."""
        with self._lock:
            events = {r: list(d) for r, d in self._by_rank.items() if d}
        keys = sorted({(e.get("epoch", 0), e.get("step", 0))
                       for evs in events.values() for e in evs})
        keep = set(keys[-self.window:])
        trimmed = {r: [e for e in evs
                       if (e.get("epoch", 0), e.get("step", 0)) in keep]
                   for r, evs in events.items()}
        return {r: evs for r, evs in trimmed.items() if evs}

    def report(self, publish=False, events=None):
        """The batch detector's report over the current window (same
        keys: ``stragglers``/``skew_seconds``/``ranks``/``membership``).
        ``events`` reuses a snapshot the caller already paid for (the
        controller's tick feeds one snapshot to both the report and the
        comm-ratio sensor)."""
        return detect_stragglers(
            self.snapshot() if events is None else events,
            mad_k=self.mad_k, abs_floor=self.abs_floor,
            min_flagged_frac=self.min_flagged_frac, window=self.window,
            publish=publish)

    def clear(self):
        with self._lock:
            self._by_rank.clear()
            self._steps_seen = 0


def comm_compute_ratio(events_by_rank):
    """Measured comm:compute ratio over a window of span events.

    comm = ``wire`` + ``kvstore`` phase seconds plus hidden ``overlap``
    sub-spans; compute = ``device`` phase seconds. Returns comm/compute,
    or None when the window carries no attribution for EITHER side —
    a device-only window means the comm is invisible here (timeline off,
    or the in-jit mesh path where the collective is fused into the
    step), not that it is free; callers fall back to the closed-form
    wire-plan estimate."""
    comm_s = 0.0
    device_s = 0.0
    for events in events_by_rank.values():
        for e in events:
            if e.get("kind", "span") != "span":
                continue
            for p in e.get("phases", ()):
                dur = float(p.get("dur_ms", 0.0)) / 1e3
                if p.get("name") == "device":
                    device_s += dur
                elif p.get("name") in ("wire", "kvstore"):
                    comm_s += dur
            for s in e.get("subs", ()):
                if s.get("name") == "overlap":
                    comm_s += float(s.get("dur_ms", 0.0)) / 1e3
    if device_s <= 0.0 or comm_s <= 0.0:
        return None
    return comm_s / device_s
