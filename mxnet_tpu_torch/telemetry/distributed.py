"""Distributed tracing: trace identity, rank labeling, cross-rank merge.

Every process has a MetricsHub and a per-step StepTimeline — but the
system is distributed (data-parallel ranks plus the ps-lite-heritage
kvstore worker/server topology), and a per-process JSONL stream has no
shared identity another rank's stream can be joined on. This module adds
the three missing pieces:

  **trace identity** — a run-scoped ``trace_id`` (minted once, adopted by
  every rank through the kvstore: rank 0 publishes it, workers fetch it at
  connect) and a per-step ``span_id`` minted deterministically from
  (trace_id, rank, epoch, step). Every span, retry incident, and
  server-side kvstore handling event carries them, so a fleet of JSONL
  streams joins into one tree: server handling and replay-dedup hits are
  child spans of the worker step whose push caused them.

  **rank labeling** — a (rank, world_size) identity with a process-wide
  default (set from the active kvstore at creation) and a thread-local
  override (``rank_scope``; the in-process multi-worker group harness runs
  one worker per thread). The hub stamps it onto every emitted event and
  every exported metric family (hub.set_rank_provider).

  **cross-rank merge + straggler detection** — ``merge_traces`` joins N
  per-rank JSONL streams on (trace_id, rank, step), clock-aligns ranks via
  exchanged offset beacons (``clock_beacon`` events record a
  send/peer/recv triple per rank; offset = t_peer - midpoint, the classic
  NTP estimate), and emits one fleet Chrome trace with per-rank process
  tracks and kvstore server spans parented under the originating worker
  steps. ``detect_stragglers`` flags ranks whose per-phase time exceeds a
  MAD-based envelope across the fleet, blames the phase (data_wait vs
  device vs wire), and publishes a ``skew_seconds`` gauge back through
  the hub.

Clocks: all cross-rank timestamps use ``hub().now()`` — perf_counter
resolution anchored to the wall-clock epoch — so they are comparable
across processes up to NTP skew; beacons correct the residual offset.
Alignment caveats live in doc/developer-guide/telemetry.md.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import threading

from ..analysis.lockwatch import named_lock
from .hub import hub as _hub, set_rank_provider

__all__ = ["trace_id", "set_trace_id", "set_world", "current_rank",
           "world_size", "rank_scope", "mint_span_id", "trace_ctx",
           "emit_server_span", "record_clock_beacon", "clock_offsets",
           "merge_traces", "detect_stragglers", "load_rank_streams"]

_LOCK = named_lock("telemetry.distributed.identity")
_TLS = threading.local()
_STATE = {"trace_id": None, "rank": 0, "world_size": 1}

# phases blamed by the straggler detector; kvstore time is wire time
_BLAME_OF = {"kvstore": "wire", "data_wait": "data_wait",
             "device": "device", "dispatch": "dispatch", "host": "host"}


# -- trace identity ------------------------------------------------------------

def trace_id() -> str:
    """The run-scoped trace id (minted lazily; MXNET_TPU_TRACE_ID
    overrides — the launcher can pin one id across all processes)."""
    with _LOCK:
        if _STATE["trace_id"] is None:
            env = os.environ.get("MXNET_TPU_TRACE_ID", "").strip()
            _STATE["trace_id"] = env or os.urandom(8).hex()
        return _STATE["trace_id"]


def set_trace_id(tid, adopt=False):
    """Install a propagated trace id. With ``adopt=True`` an id already
    minted locally wins (the server adopts the first worker's id but never
    re-brands a run that already has one)."""
    if not tid:
        return trace_id()
    with _LOCK:
        if not (adopt and _STATE["trace_id"] is not None):
            _STATE["trace_id"] = str(tid)
        return _STATE["trace_id"]


# -- rank identity -------------------------------------------------------------

_SCOPED = False  # flips (permanently) the first time a rank_scope opens:
                 # until then the hot path never touches thread-local
                 # storage (a TLS getattr costs ~10x a dict index, and
                 # emit() runs on every event)


def set_world(rank, world_size):
    """Process-wide default (rank, world_size) — called by kvstore.create
    and fit(); every hub event and exported metric family carries it."""
    with _LOCK:
        _STATE["rank"] = int(rank)
        _STATE["world_size"] = max(int(world_size), 1)


def _current_world():
    """(rank, world_size) — the thread-local scope when one is active,
    the process default otherwise. The emit()-hot path."""
    if _SCOPED:
        over = getattr(_TLS, "world", None)
        if over is not None:
            return over
    return _STATE["rank"], _STATE["world_size"]


def current_rank() -> int:
    return _current_world()[0]


def world_size() -> int:
    return _current_world()[1]


@contextlib.contextmanager
def rank_scope(rank, world=None):
    """Thread-local (rank, world) override: the in-process multi-worker
    harness (kvstore.create_group, one thread per worker) runs each
    worker's loop under its own rank so spans/events/metrics are labeled
    per worker even though the process is shared."""
    global _SCOPED
    _SCOPED = True
    prev = getattr(_TLS, "world", None)
    _TLS.world = (int(rank),
                  int(world) if world is not None else world_size())
    try:
        yield
    finally:
        _TLS.world = prev


set_rank_provider(_current_world)


def mint_span_id(rank, epoch, step, kind="step"):
    """Deterministic span identity: any rank can re-derive another rank's
    span id for the same (epoch, step) — the join key of the merge."""
    base = trace_id()[:8]
    if kind == "step":
        return f"{base}-r{rank}-e{epoch}-s{step}"
    return f"{base}-r{rank}-e{epoch}-s{step}-{kind}"


def trace_ctx():
    """The context a kvstore envelope carries: trace id, origin rank, and
    the in-flight step's span id (None between steps). Cheap — two
    thread-local reads and a dict build."""
    from .timeline import current_span

    span = current_span()
    return {"trace_id": trace_id(), "rank": current_rank(),
            "span_id": getattr(span, "span_id", None)}


def emit_server_span(op, trace, t0, *, dedup=False, key=None,
                     origin_rank=None, wait_s=0.0):
    """Emit the ``server_span`` (and, on a replay hit, ``server_dedup``)
    events for one server-side handling of a traced worker request.

    The event shape is a wire contract (EVENT_GOLDEN_KEYS, the merge
    CLI's parenting) — every kvstore server path goes through here so a
    field can't drift in one copy. ``dur_ms`` is handling time only:
    ``wait_s`` (time blocked on the rest of a BSP round) is subtracted
    and reported as ``barrier_wait_ms`` so collective wait on a slow rank
    never renders as server time on the fast ranks' traces."""
    h = _hub()
    fields = {"op": op,
              "origin_rank": trace.get("rank") if origin_rank is None
              else origin_rank,
              "parent_span": trace.get("span_id"),
              "trace_id": trace.get("trace_id")}
    if key is not None:
        fields["key"] = key
    if dedup:
        h.emit("server_dedup", **fields)
    h.emit("server_span", start_ts=t0,
           dur_ms=max(0.0, h.now() - t0 - wait_s) * 1e3,
           barrier_wait_ms=wait_s * 1e3, dedup=dedup, **fields)


# -- clock beacons -------------------------------------------------------------

def record_clock_beacon(peer, t_send, t_peer, t_recv):
    """Record one offset-exchange beacon: local clock at send/recv, peer
    clock in between. The merge estimates offset = t_peer - midpoint (NTP
    style; RTT/2 error bound) and aligns this rank onto the peer clock."""
    return _hub().emit("clock_beacon", peer=str(peer),
                       t_send=float(t_send), t_peer=float(t_peer),
                       t_recv=float(t_recv))


def clock_offsets(events_by_rank):
    """Per-rank clock offset (seconds to ADD to a rank's timestamps to land
    on the peer/server clock), the median over that rank's beacons."""
    offsets = {}
    for rank, events in events_by_rank.items():
        deltas = []
        for e in events:
            if e.get("kind") != "clock_beacon":
                continue
            try:
                mid = (float(e["t_send"]) + float(e["t_recv"])) / 2.0
                deltas.append(float(e["t_peer"]) - mid)
            except (KeyError, TypeError, ValueError):
                continue
        offsets[rank] = _median(deltas) if deltas else 0.0
    return offsets


def _median(xs):
    return float(statistics.median(xs)) if xs else 0.0


# -- stream loading ------------------------------------------------------------

def load_rank_streams(paths):
    """Read N JSONL files (schema v1 or v2) and group events by rank.
    Files are just streams — the rank label on each event is the truth
    (one file may carry several ranks: the in-process group harness
    shares one hub). Returns {rank: [events]} in file order."""
    from .exporters import read_events

    by_rank = {}
    for path in paths:
        for e in read_events(path):
            by_rank.setdefault(int(e.get("rank", 0)), []).append(e)
    return by_rank


def _span_wall(e):
    """Comparable start time of a span event: wall_ts (v2) or raw ts."""
    return float(e.get("wall_ts", e.get("ts", 0.0)))


# -- cross-rank merge ----------------------------------------------------------

def merge_traces(paths, out=None):
    """Join per-rank JSONL streams into one fleet Chrome trace.

    Returns ``(trace_dict, report)``. ``trace_dict`` is Chrome-trace JSON:
    pid = rank (one process track per rank), tids split worker span kinds
    from the ``kvstore_server`` track; server-side handling events are
    placed on the ORIGIN worker's pid with ``args.parent`` naming the
    worker step span they belong to (the replay-dedup hits carry
    ``dedup: true``). Ranks are clock-aligned by their beacon offsets
    before the common origin is subtracted. ``report`` summarizes the
    join: ranks seen, spans/server spans matched, orphan server spans,
    trace ids. ``out`` writes the trace JSON to a path. ``paths`` may be
    an already-loaded ``{rank: events}`` dict (load_rank_streams output),
    so a caller feeding both the merge and the straggler detector parses
    the fleet's streams once."""
    import json

    by_rank = paths if isinstance(paths, dict) else load_rank_streams(paths)
    offsets = clock_offsets(by_rank)
    spans, server_spans, trace_ids = [], [], set()
    for rank, events in by_rank.items():
        for e in events:
            if e.get("kind") == "span":
                spans.append((rank, e))
                if e.get("trace_id"):
                    trace_ids.add(e["trace_id"])
            elif e.get("kind") == "server_span":
                server_spans.append((rank, e))

    if not spans and not server_spans:
        trace = {"traceEvents": [], "displayTimeUnit": "ms"}
        if out:  # the caller was promised a file either way
            with open(out, "w") as f:
                json.dump(trace, f)
        return trace, {
            "ranks": sorted(by_rank), "spans": 0, "server_spans": 0,
            "orphan_server_spans": 0, "trace_ids": []}

    # Clock comparability check: v2 timestamps are wall-anchored (~1e9 s)
    # while v1 files carry raw perf_counter values (~seconds since their
    # process start). Mixing them under one origin would separate the runs
    # by decades in the trace — when the per-rank start times span more
    # than ~3 years, degrade to a per-rank origin (tracks still render,
    # cross-rank deltas are no longer meaningful and the report says so).
    rank_min = {}
    for r, e in spans:
        ts = _span_wall(e)
        rank_min[r] = min(rank_min.get(r, ts), ts)
    for r, e in server_spans:
        ts = float(e.get("start_ts", e.get("ts", 0.0)))
        rank_min[r] = min(rank_min.get(r, ts), ts)
    incomparable = rank_min and \
        max(rank_min.values()) - min(rank_min.values()) > 1e8
    rank_origin = dict(rank_min) if incomparable else {}

    def aligned(rank, ts):
        return ts - rank_origin.get(rank, 0.0) \
            + offsets.get(rank, 0.0)

    t0 = min([aligned(r, _span_wall(e)) for r, e in spans] +
             [aligned(r, float(e.get("start_ts", e.get("ts", 0.0))))
              for r, e in server_spans])

    events = []
    span_ids = {}          # span_id -> (rank, step) for parenting checks
    tid_of = {}            # (rank, kind) -> tid
    SERVER_TID = 64        # fixed high track: kvstore server spans

    def tid_for(rank, kind):
        return tid_of.setdefault((rank, kind), len(
            [k for k in tid_of if k[0] == rank]))

    for rank in sorted(by_rank):
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "args": {"name": f"rank {rank}"}})
    for rank, e in spans:
        if e.get("span_id"):
            span_ids[e["span_id"]] = (rank, e.get("step"))
        start = aligned(rank, _span_wall(e)) - t0
        tid = tid_for(rank, e.get("name", "step"))
        base = {"pid": rank, "tid": tid, "cat": e.get("name", "step")}
        events.append({**base,
                       "name": f"{e.get('name', 'step')}[{e.get('step')}]",
                       "ph": "X", "ts": start * 1e6,
                       "dur": float(e.get("dur_ms", 0.0)) * 1e3,
                       "args": {"epoch": e.get("epoch"),
                                "step": e.get("step"),
                                "span_id": e.get("span_id"),
                                "trace_id": e.get("trace_id")}})
        # phase sub-events: rel_ms (v2) is the span-relative offset and is
        # clock-free. The fallback for old files rebases raw phase ts
        # against the event ts — valid for dump_jsonl streams where both
        # share the perf_counter origin, but a hub-sink stream's envelope
        # ts is the WALL emit time, so an implausible offset (outside the
        # span) degrades to phase-at-span-start rather than placing the
        # box billions of seconds away.
        dur_s = float(e.get("dur_ms", 0.0)) / 1e3
        p0 = float(e.get("ts", 0.0))
        for p in e.get("phases", ()):
            if "rel_ms" in p:
                off = float(p["rel_ms"]) / 1e3
            else:
                off = float(p["ts"]) - p0
                if not (-1e-3 <= off <= dur_s + 1.0):
                    off = 0.0
            events.append({**base, "name": p["name"], "ph": "X",
                           "ts": (start + off) * 1e6,
                           "dur": float(p["dur_ms"]) * 1e3,
                           "args": {"step": e.get("step")}})

    orphans = 0
    for rank, e in server_spans:
        origin = int(e.get("origin_rank", rank))
        parent = e.get("parent_span")
        if parent is not None and parent not in span_ids:
            orphans += 1
        start = aligned(rank, float(e.get("start_ts", e.get("ts", 0.0)))) - t0
        events.append({
            "pid": origin, "tid": SERVER_TID, "cat": "kvstore_server",
            "name": f"server:{e.get('op', '?')}", "ph": "X",
            "ts": start * 1e6, "dur": float(e.get("dur_ms", 0.0)) * 1e3,
            "args": {"parent": parent, "op": e.get("op"),
                     "key": e.get("key"), "origin_rank": origin,
                     "dedup": bool(e.get("dedup", False)),
                     # BSP pushes: time this rank sat waiting on the rest
                     # of the round (NOT in the box's dur — see
                     # _GroupServer.push)
                     "barrier_wait_ms": float(
                         e.get("barrier_wait_ms", 0.0)),
                     "served_by_rank": rank}})
    for rank in sorted(by_rank):
        events.append({"name": "thread_name", "ph": "M", "pid": rank,
                       "tid": SERVER_TID,
                       "args": {"name": "kvstore_server"}})

    trace = {"traceEvents": events, "displayTimeUnit": "ms"}
    report = {
        "ranks": sorted(by_rank), "spans": len(spans),
        "server_spans": len(server_spans),
        "orphan_server_spans": orphans,
        "trace_ids": sorted(trace_ids),
        "clock_offsets": {r: round(o, 6) for r, o in offsets.items()},
        "clock_mode": "per-rank-origin" if incomparable else "aligned",
    }
    if out:
        with open(out, "w") as f:
            json.dump(trace, f)
    return trace, report


# -- straggler / anomaly detection ---------------------------------------------

def _phase_durs(span_event):
    """{phase: seconds} for one span event (data_wait/dispatch/device/
    kvstore/host; kvstore sub-phases fold into 'kvstore')."""
    out = {}
    for p in span_event.get("phases", ()):
        out[p["name"]] = out.get(p["name"], 0.0) + float(p["dur_ms"]) / 1e3
    for s in span_event.get("subs", ()):
        if "kvstore" in s.get("name", ""):
            out["kvstore"] = out.get("kvstore", 0.0) \
                + float(s["dur_ms"]) / 1e3
    return out


def detect_stragglers(events_by_rank, mad_k=3.5, abs_floor=1e-3,
                      min_flagged_frac=0.5, window=32, publish=True):
    """Flag ranks that run consistently outside the fleet envelope.

    For every step present on >=2 ranks, each phase's duration is compared
    across ranks against a robust envelope: median + ``mad_k`` * MAD
    (+ ``abs_floor`` so microsecond jitter on near-zero phases never
    flags), computed over a rolling ``window`` of recent steps. A rank is
    a straggler when at least ``min_flagged_frac`` of its comparable
    steps breach the envelope; blame goes to the phase with the largest
    accumulated excess (kvstore time is blamed as "wire"). Returns::

        {"stragglers": [{rank, blame, flagged_steps, steps,
                         excess_seconds, mean_step_seconds}],
         "skew_seconds": <slowest rank's median step - fleet median>,
         "ranks": {...per-rank stats...},
         "membership": {segments, final_ranks, departed}}

    and (``publish=True``) mirrors ``skew_seconds`` plus per-rank
    ``straggler_excess_seconds`` gauges back through the hub.

    Elastic runs: the rank set is NOT assumed fixed. The
    reporting rank set of each step defines a membership *segment*; at a
    segment boundary (a rank departed or rejoined — per-device step time
    legitimately changes when the world resizes) the rolling envelope
    resets so old-world durations never judge new-world steps, and only
    ranks still reporting near the run's end can be flagged as
    stragglers — departed ranks are reported under
    ``membership.departed`` instead of being blamed for steps they were
    dead for. (``skew_seconds`` keeps its historical all-ranks
    definition so fixed-fleet baselines stay comparable.)
    """
    # (step key -> {rank: {phase: dur}}) over step spans only
    table = {}
    step_dur = {}
    for rank, events in events_by_rank.items():
        for e in events:
            if e.get("kind") != "span" or e.get("name", "step") != "step":
                continue
            key = (e.get("epoch", 0), e.get("step", 0))
            table.setdefault(key, {})[rank] = _phase_durs(e)
            step_dur.setdefault(rank, []).append(
                float(e.get("dur_ms", 0.0)) / 1e3)

    flagged = {r: 0 for r in events_by_rank}
    comparable = {r: 0 for r in events_by_rank}
    excess = {r: {} for r in events_by_rank}     # rank -> phase -> seconds
    breaches = {r: {} for r in events_by_rank}   # rank -> phase -> #steps
    recent = []                                   # rolling envelope window
    ordered = sorted(table)
    # membership: a rank is DEPARTED when it stopped reporting well before
    # the run's end (position-based, so a one-step gap from thread racing
    # never buries a live rank); segment commits likewise need TWO
    # consecutive steps with the same new rank set before the envelope
    # resets — transient per-step flicker is not a resize
    last_seen = {}
    for i, key in enumerate(ordered):
        for r in table[key]:
            last_seen[r] = i
    tail = max(2, min(window, len(ordered)) // 4)
    final_ranks = {r for r, i in last_seen.items()
                   if i >= len(ordered) - tail}
    if not final_ranks:
        final_ranks = set(events_by_rank)
    segments = 0
    cur_members = None
    pending = None                                # (candidate set, streak)
    for key in ordered:
        per_rank = table[key]
        if len(per_rank) < 2:
            continue
        ranks_here = frozenset(per_rank)
        if cur_members is None:
            cur_members = ranks_here
            segments = 1
        elif ranks_here != cur_members:
            pending = (ranks_here, pending[1] + 1) \
                if pending and pending[0] == ranks_here else (ranks_here, 1)
            if pending[1] >= 2:
                # committed membership change: resized worlds have
                # different per-device step times, so the envelope must
                # not carry over
                cur_members = ranks_here
                pending = None
                segments += 1
                recent.clear()
        else:
            pending = None
        recent.append(per_rank)
        if len(recent) > window:
            recent.pop(0)
        phases = {p for durs in per_rank.values() for p in durs}
        step_flagged = set()
        for phase in phases:
            pool = [durs.get(phase, 0.0) for row in recent
                    for durs in row.values()]
            med = _median(pool)
            mad = _median([abs(v - med) for v in pool])
            envelope = med + mad_k * mad + abs_floor
            over = [rank for rank, durs in per_rank.items()
                    if durs.get(phase, 0.0) > envelope]
            if len(over) * 2 > len(per_rank):
                # more than half the fleet breached together: that is a
                # fleet-wide event (shared input stall, global barrier),
                # not a straggler — an intermittent phase like data_wait
                # collapses the envelope to abs_floor and would otherwise
                # flag every rank at once
                continue
            for rank in over:
                v = per_rank[rank].get(phase, 0.0)
                step_flagged.add(rank)
                excess[rank][phase] = excess[rank].get(phase, 0.0) \
                    + (v - med)
                breaches[rank][phase] = breaches[rank].get(phase, 0) + 1
        for rank in per_rank:
            comparable[rank] += 1
            if rank in step_flagged:
                flagged[rank] += 1

    medians = {r: _median(d) for r, d in step_dur.items() if d}
    fleet_median = _median(list(medians.values())) if medians else 0.0
    skew = max((m - fleet_median for m in medians.values()), default=0.0)

    departed = sorted(r for r in events_by_rank if r not in final_ranks)
    stragglers = []
    for rank in sorted(events_by_rank):
        if not comparable[rank]:
            continue
        if rank not in final_ranks:
            continue  # departed: listed under membership, never blamed
        frac = flagged[rank] / comparable[rank]
        if frac >= min_flagged_frac and excess[rank]:
            # blame the CONSISTENTLY breaching phase (most steps outside
            # the envelope), not the biggest one-off spike — a retry
            # backoff can dwarf a steady device skew in raw seconds while
            # appearing on one step; accumulated excess breaks ties
            blame_phase = max(
                excess[rank],
                key=lambda p: (breaches[rank].get(p, 0), excess[rank][p]))
            stragglers.append({
                "rank": rank,
                "blame": _BLAME_OF.get(blame_phase, blame_phase),
                "flagged_steps": flagged[rank],
                "steps": comparable[rank],
                "excess_seconds": round(sum(excess[rank].values()), 6),
                "mean_step_seconds": round(
                    sum(step_dur[rank]) / len(step_dur[rank]), 6)
                if step_dur.get(rank) else None,
            })
    report = {
        "stragglers": stragglers,
        "skew_seconds": round(skew, 6),
        "ranks": {r: {"median_step_seconds": round(
                          _median(step_dur.get(r, [])), 6),
                      "flagged_steps": flagged[r],
                      "comparable_steps": comparable[r]}
                  for r in sorted(events_by_rank)},
        "membership": {"segments": segments,
                       "final_ranks": sorted(final_ranks),
                       "departed": departed},
    }
    if publish:
        h = _hub()
        h.gauge("skew_seconds", skew)
        for s in stragglers:
            h.gauge("straggler_excess_seconds", s["excess_seconds"],
                    straggler_rank=s["rank"], blame=s["blame"])
    return report
