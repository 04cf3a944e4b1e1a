"""StepTimeline: per-step span tracing for the training loop.

The reference framework answered "where does each step's time go?" with
engine debug logs; the profiler (utils/profiler) answers it with a full
device trace — too heavy to leave on. The timeline is the always-
viable middle: the fit/eval/predict loops record one **span per step**,
split into ordered, non-overlapping **phases**:

  data_wait   blocked on the (prefetching) data feed
  dispatch    host work to launch the step: the optimizer's per-step
              values onto the card, the batch into the step's static
              buffers, the program lookup, the graph replay's enqueue
  device      the step's device time — measured by the host waiting on
              a CUDA event recorded after the step's replay (the port's
              counterpart of ``jax.block_until_ready`` on the result;
              the optimizer update is inside the captured step)
  kvstore     parameter-host round trip (dist_async push_pull), when any
  wire        stale-sync mode (``fit(overlap=...)`` on dist_async): only
              the UN-hidden tail of the previous round's pipelined push —
              the hidden portion lands as an ``overlap`` sub-span from
              ``AsyncKVStore.push_pull_stale``, and the
              ``comm_overlap_efficiency`` gauge summarizes the split
  host        metric update + callbacks until the next batch is requested

plus **instant events** (guard retries, skipped steps, checkpoint flushes)
anchored to the step they landed in. Spans are mirrored into the hub's
event ring (kind="span") so the JSONL exporter and the CLI see them, and
dump as Chrome-trace JSON (chrome://tracing / Perfetto load it directly).

Synchronizing on every step's outputs trades pipelining for attribution —
that is the point of a timeline run, and it is opt-in (``fit(telemetry=
True)``); ``TelemetryConfig(sync=False)`` keeps the async dispatch and
folds device time into the host-side phases instead.

A thread-local *current span* lets lower layers (kvstore, checkpoint)
attach phases to whatever step is in flight without threading a timeline
handle through every call: see :func:`current_span` / :func:`phase`.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

from . import distributed as _dist
from .hub import hub as _hub

__all__ = ["Span", "StepTimeline", "current_span", "clear_current_span",
           "phase", "timed"]

_TLS = threading.local()

# Phase-boundary memory sampler (telemetry.memory.attach_sampler installs
# it): called with the span at every phase mark and span finish, so the
# live-array ledger's gauges/watermark track intra-step boundaries. None
# (the default) keeps the hot path at one global None check.
_MEM_SAMPLER = None


def current_span():
    """The span currently open on this thread, or None."""
    return getattr(_TLS, "span", None)


def clear_current_span():
    """Drop the thread-local span slot. Loops that can exit with a span
    still open (exception mid-step, preemption) call this in their
    ``finally`` so later phase() calls cannot attach work to a dead span."""
    _TLS.span = None


@contextlib.contextmanager
def phase(name):
    """Record a named sub-phase on the current span (no-op without one) and
    a duration histogram either way. The hook lower layers use: kvstore
    push/pull and checkpoint flushes call this, so their time lands inside
    whatever step span is in flight."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _hub().observe(f"{name}_seconds", dt)
        span = current_span()
        if span is not None:
            span.add_sub(name, t0, dt)


@contextlib.contextmanager
def timed(name, **labels):
    """Time a host-side block into a hub histogram (``<name>_seconds``).
    The sanctioned replacement for ad-hoc ``time.time()`` deltas around
    device dispatch: for device work, prefer
    utils.profiler.Timer which blocks on the outputs first."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _hub().observe(f"{name}_seconds",
                              time.perf_counter() - t0, **labels)


class Span:
    """One traced step: ordered phase marks + nested sub-phases + events.

    Usage: ``span.mark("dispatch")`` closes the previous phase and opens
    ``dispatch``; ``span.end()`` closes the last one. Phases are therefore
    non-overlapping by construction. Every span carries the run's
    ``trace_id``, its own deterministic ``span_id``, and the recording
    ``rank`` — the join keys of the cross-rank merge (telemetry
    .distributed); kvstore server handling parents onto ``span_id``.
    Spans work as context managers (``with tl.begin_step(...) as span:``
    — exit closes the span)."""

    __slots__ = ("kind", "epoch", "step", "start", "end_ts", "_marks",
                 "subs", "events", "_timeline", "span_id", "trace_id",
                 "rank")

    def __init__(self, timeline, kind, epoch, step, start, data_wait=0.0):
        self._timeline = timeline
        self.kind = kind
        self.epoch = epoch
        self.step = step
        self.rank = _dist.current_rank()
        self.trace_id = _dist.trace_id()
        self.span_id = _dist.mint_span_id(self.rank, epoch, step, kind)
        # the span covers the data wait that preceded batch availability
        self.start = start - data_wait
        self._marks = [("data_wait", self.start)] if data_wait else []
        self.end_ts = None
        self.subs = []      # (name, start, dur) nested records (kvstore, ..)
        self.events = []    # instant events (retry, skip, ...)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.end_ts is None:
            self.end()
        return False

    def mark(self, name, ts=None):
        self._marks.append((name, time.perf_counter() if ts is None else ts))
        if _MEM_SAMPLER is not None:
            _MEM_SAMPLER(self)
        return self

    def add_sub(self, name, start, dur):
        self.subs.append((name, start, dur))

    def event(self, name, **fields):
        self.events.append({"name": name,
                            "ts": time.perf_counter(), **fields})
        _hub().emit("step_event", span_kind=self.kind,
                           epoch=self.epoch, step=self.step,
                           name=name, **fields)

    def end(self, ts=None):
        self.end_ts = time.perf_counter() if ts is None else ts
        if self._timeline is not None:
            self._timeline._finish(self)
        return self

    @property
    def duration(self):
        return (self.end_ts or time.perf_counter()) - self.start

    def phases(self):
        """[(name, start, dur)] — consecutive, non-overlapping."""
        out = []
        marks = self._marks
        for i, (name, ts) in enumerate(marks):
            nxt = marks[i + 1][1] if i + 1 < len(marks) else self.end_ts
            if nxt is None:
                nxt = ts
            out.append((name, ts, max(nxt - ts, 0.0)))
        return out

    def to_dict(self):
        return {
            "name": self.kind, "epoch": self.epoch, "step": self.step,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "rank": self.rank,
            "ts": self.start, "wall_ts": _hub().to_wall(self.start),
            "dur_ms": self.duration * 1e3,
            # rel_ms: offset from span start — the envelope "ts" of a
            # hub-emitted span event is the (wall-clock) emit time, so
            # consumers must NOT rebase phases against it; rel_ms is the
            # clock-free join the cross-rank merge uses
            "phases": [{"name": n, "ts": t, "dur_ms": d * 1e3,
                        "rel_ms": (t - self.start) * 1e3}
                       for n, t, d in self.phases()],
            "subs": [{"name": n, "ts": t, "dur_ms": d * 1e3,
                      "rel_ms": (t - self.start) * 1e3}
                     for n, t, d in self.subs],
            "events": list(self.events),
        }


class StepTimeline:
    """Collects step spans for one training/eval/predict run.

    The loop drives it with ``note_data_wait`` (time blocked on the feed)
    + ``begin_step``/``Span.mark``/``Span.end``; everything else —
    per-phase histograms, hub span events, Chrome-trace/JSONL export —
    falls out. ``spans`` holds every finished span in order."""

    def __init__(self, max_spans=100_000):
        self.spans = []
        self._max_spans = max_spans
        self._pending_wait = 0.0
        self._hub = _hub()

    # -- recording ------------------------------------------------------------
    def clock(self):
        return time.perf_counter()

    def note_data_wait(self, seconds):
        """Bank feed-wait time; consumed by the next begin_step."""
        self._pending_wait += seconds
        self._hub.observe("data_wait_seconds", seconds)

    def begin_step(self, epoch, step, kind="step"):
        wait, self._pending_wait = self._pending_wait, 0.0
        span = Span(self, kind, epoch, step, time.perf_counter(),
                    data_wait=wait)
        _TLS.span = span
        return span

    def _finish(self, span):
        if getattr(_TLS, "span", None) is span:
            _TLS.span = None
        if len(self.spans) < self._max_spans:
            self.spans.append(span)
        for name, _, dur in span.phases():
            self._hub.observe(f"step_phase_{name}_seconds", dur)
        self._hub.observe("step_seconds", span.duration,
                          kind=span.kind)
        self._hub.emit("span", **span.to_dict())
        if _MEM_SAMPLER is not None:
            _MEM_SAMPLER(span)

    # -- queries --------------------------------------------------------------
    def steps(self, kind="step"):
        return [s for s in self.spans if s.kind == kind]

    def total_phase_seconds(self, name):
        return sum(d for s in self.spans
                   for n, _, d in s.phases() if n == name)

    def mean_step_seconds(self, kind="step"):
        steps = self.steps(kind)
        if not steps:
            return None
        return sum(s.duration for s in steps) / len(steps)

    # -- export ---------------------------------------------------------------
    def to_chrome_trace(self):
        """Chrome-trace JSON object (``chrome://tracing`` / Perfetto).

        One complete ("X") event per span and per phase; nesting is by
        time containment on a single track, which both UIs render as a
        flame. Timestamps are microseconds from the first span."""
        if not self.spans:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        t0 = min(s.start for s in self.spans)
        tid_of = {}
        events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                   "args": {"name": "mxnet_tpu_torch train loop"}}]
        for span in self.spans:
            tid = tid_of.setdefault(span.kind, len(tid_of))
            base = {"pid": 0, "tid": tid, "cat": span.kind}
            events.append({**base, "name": f"{span.kind}[{span.step}]",
                           "ph": "X", "ts": (span.start - t0) * 1e6,
                           "dur": span.duration * 1e6,
                           "args": {"epoch": span.epoch, "step": span.step}})
            for name, ts, dur in span.phases():
                events.append({**base, "name": name, "ph": "X",
                               "ts": (ts - t0) * 1e6, "dur": dur * 1e6,
                               "args": {"step": span.step}})
            for name, ts, dur in span.subs:
                events.append({**base, "name": name, "ph": "X",
                               "ts": (ts - t0) * 1e6, "dur": dur * 1e6,
                               "args": {"step": span.step, "nested": True}})
            for ev in span.events:
                events.append({**base, "name": ev["name"], "ph": "i",
                               "ts": (ev["ts"] - t0) * 1e6, "s": "t"})
        for kind, tid in tid_of.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": kind}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def dump_jsonl(self, path):
        """Schema-versioned JSONL of the spans (exporters.write_jsonl)."""
        from . import distributed, exporters

        world = distributed.world_size()
        return exporters.write_jsonl(
            path, (s.to_dict() | {"kind": "span", "world_size": world}
                   for s in self.spans))

    def dump_flight(self, path=None, reason="manual"):
        """Write the process flight recorder's black box (last K steps +
        incidents, CRC-sealed) — ``model.telemetry.dump_flight()`` is the
        on-demand crash-forensics entry point. Without ``path``, dumps
        into MXNET_TPU_FLIGHT_DIR (error if neither is given)."""
        from . import flight

        if path is not None:
            return flight.dump(path, reason=reason)
        out = flight.auto_dump(reason)
        if out is None:
            raise ValueError(
                "dump_flight() needs a path or MXNET_TPU_FLIGHT_DIR")
        return out
