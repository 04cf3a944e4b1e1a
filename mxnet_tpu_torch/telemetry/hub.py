"""MetricsHub: the process-wide metric store every subsystem reports into.

Before this layer the framework had four *disjoint* stat sources — the
compile registry (utils/compile.ProgramRegistry), the comm registry
(comm.CommRegistry), the Monitor stat queue, and the resilience counters
scattered over model.fit/guard state. Each kept its own schema and its own
reporting path. The hub gives them one meeting point:

  - **counters / gauges / histograms with labels** — push-style metrics
    any layer updates via ``telemetry.counter()/gauge()/observe()``. A
    histogram keeps (count, sum, min, max) plus a bounded reservoir of
    recent observations for percentile queries.
  - **ring-buffered events** — ``telemetry.emit(kind, **fields)`` appends
    a timestamped dict to a fixed-size deque (O(1), a few microseconds; no
    I/O on the hot path). Exporters drain the ring; an optional streaming
    sink (exporters.JsonlWriter) mirrors events to disk.
  - **collectors** — pull-style adapters over the REGISTRIES THAT ALREADY
    EXIST. The compile and comm registries stay the source of truth (their
    ``compile_report()``/``comm_stats()`` APIs keep working unchanged);
    the hub polls them at export time and presents their totals as gauges,
    so one Prometheus scrape sees every subsystem.

Everything here is stdlib-only (threading + collections + time); the
adapters import framework modules lazily so the hub can be imported from
any layer without cycles.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from ..analysis.lockwatch import named_lock

__all__ = ["MetricsHub", "Histogram", "hub", "reset", "DEFAULT_COUNTERS",
           "set_rank_provider", "on_hub_create"]

# (rank, world_size) identity provider — installed by telemetry.distributed
# (thread-local rank scopes for the in-process multi-worker harness, the
# active kvstore's rank otherwise). Every emitted event and every exported
# metric family is stamped with it, so per-rank streams stay joinable.
_RANK_PROVIDER = None


def set_rank_provider(fn):
    """``fn() -> (rank, world_size)``; see telemetry.distributed."""
    global _RANK_PROVIDER
    _RANK_PROVIDER = fn


def _rank_world():
    if _RANK_PROVIDER is None:
        return 0, 1
    return _RANK_PROVIDER()

# Pre-declared counter families: wired subsystems increment these at
# runtime, but they exist (at zero) from hub creation so a Prometheus
# scrape of a fresh process already shows the full schema — absence of
# traffic and absence of instrumentation must look different.
DEFAULT_COUNTERS = (
    "resilience_step_retries_total",
    "resilience_skipped_steps_total",
    "resilience_kv_retries_total",
    "resilience_circuit_open_total",
    "io_prefetch_batches_total",
    "io_prefetch_wait_seconds_total",
    "kvstore_push_pull_total",
    "checkpoint_saves_total",
    "executor_forward_total",
    "executor_backward_total",
    "badput_compile_seconds_total",
)

_RESERVOIR = 2048  # per-histogram retained observations (percentile window)


class Histogram:
    """Count/sum/min/max plus a bounded reservoir of recent values.

    Percentiles are computed over the reservoir with numpy-style linear
    interpolation (exact while fewer than ``maxlen`` observations have
    been made; a sliding window over the most recent ones after that).
    """

    __slots__ = ("count", "sum", "min", "max", "_ring")

    def __init__(self, maxlen=_RESERVOIR):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._ring = collections.deque(maxlen=maxlen)

    def observe(self, value):
        value = float(value)
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value
        self._ring.append(value)

    def percentile(self, q):
        """q in [0, 100], numpy 'linear' interpolation over the window."""
        if not self._ring:
            return None
        data = sorted(self._ring)
        if len(data) == 1:
            return data[0]
        rank = (float(q) / 100.0) * (len(data) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(data) - 1)
        frac = rank - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def snapshot(self):
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean}

    def copy(self):
        """Consistent point-in-time copy (exporters read histograms outside
        the hub lock; iterating a live deque races concurrent observes)."""
        c = Histogram.__new__(Histogram)
        c.count, c.sum, c.min, c.max = self.count, self.sum, self.min, self.max
        c._ring = collections.deque(self._ring, maxlen=self._ring.maxlen)
        return c


def _label_key(labels: dict):
    return tuple(sorted(labels.items())) if labels else ()


class MetricsHub:
    """Process-wide counters/gauges/histograms + event ring + collectors.

    Thread-safe; every mutation holds one lock for a few dict/deque
    operations (the lock-cheap contract: ``emit`` is a dict build + deque
    append, measured in single-digit microseconds)."""

    def __init__(self, ring_size=8192):
        # run identity: every hub mints one — unlike trace_id,
        # which only distributed runs adopt from rank 0 — so single-
        # process runs and tests all carry a joinable
        # id on their events, flight dumps, and ledger records. reset()
        # builds a fresh hub, so a fresh run_id.
        self.run_id = os.urandom(6).hex()
        self._lock = named_lock("telemetry.hub.MetricsHub")
        self._counters = {}          # (name, labelkey) -> float
        self._gauges = {}            # (name, labelkey) -> float
        self._hists = {}             # (name, labelkey) -> Histogram
        self._events = collections.deque(maxlen=ring_size)
        self._collectors = {}        # family -> callable() -> {name: value}
        self._sinks = []             # streaming event sinks (JsonlWriter)
        self._kind_sinks = {}        # kind -> [sinks]: filtered sinks (the
                                     # flight recorder) cost one dict.get
                                     # per emit instead of a call per event
        self._epoch = time.time() - time.perf_counter()
        for name in DEFAULT_COUNTERS:
            self._counters[(name, ())] = 0.0

    # -- clock ----------------------------------------------------------------
    def now(self):
        """Monotonic-derived wall-clock seconds (perf_counter resolution,
        epoch-anchored so event timestamps are comparable across files)."""
        return self._epoch + time.perf_counter()

    def to_wall(self, perf_ts):
        """Convert a time.perf_counter() reading into this hub's
        epoch-anchored wall clock (the clock cross-rank merge aligns)."""
        return self._epoch + float(perf_ts)

    # -- push metrics ---------------------------------------------------------
    def counter(self, name, value=1.0, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + float(value)

    def gauge(self, name, value, **labels):
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name, value, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            h.observe(value)

    def percentile(self, name, q, **labels):
        with self._lock:
            h = self._hists.get((name, _label_key(labels)))
            return None if h is None else h.percentile(q)

    # -- events ---------------------------------------------------------------
    def emit(self, kind, **fields):
        """Append one timestamped event to the ring (and any sinks).
        Every event is stamped with the emitting rank/world_size (explicit
        fields win — a server emitting on behalf of a worker labels it)."""
        rank, world = _rank_world()
        # kind/ts are the envelope and always win over payload fields;
        # rank/world/run_id are identity defaults explicit fields may
        # override (a server emitting on behalf of a worker, a replayed
        # stream keeping its original run)
        event = {"rank": rank, "world_size": world, "run_id": self.run_id,
                 **fields, "kind": kind, "ts": self.now()}
        with self._lock:
            self._events.append(event)
            sinks = tuple(self._sinks)
            ksinks = self._kind_sinks.get(kind)
            if ksinks:
                sinks += tuple(ksinks)
        for sink in sinks:
            sink.write_event(event)
        return event

    def events(self, kind=None, limit=None):
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-limit:] if limit else evs

    def add_sink(self, sink, kinds=None):
        """Register a streaming event sink. With ``kinds`` (an iterable of
        event kinds) the sink only sees those kinds — and costs the hot
        path one dict lookup instead of a call per event (the flight
        recorder's contract); without, it sees everything (JsonlWriter)."""
        with self._lock:
            if kinds is None:
                self._sinks.append(sink)
            else:
                for k in kinds:
                    self._kind_sinks.setdefault(k, []).append(sink)
        return sink

    def remove_sink(self, sink):
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
            for lst in self._kind_sinks.values():
                if sink in lst:
                    lst.remove(sink)

    def has_sink(self, sink):
        with self._lock:
            return sink in self._sinks or \
                any(sink in lst for lst in self._kind_sinks.values())

    # -- pull adapters --------------------------------------------------------
    def register_collector(self, family, fn):
        """``fn() -> {metric_name: value}``, polled at export time. The
        adapter layer over the pre-existing registries: the registry keeps
        its own API; the hub only reads it."""
        with self._lock:
            self._collectors[family] = fn

    def collect(self):
        """Poll every collector; a failing collector contributes an error
        marker instead of killing the export."""
        out = {}
        with self._lock:
            collectors = dict(self._collectors)
        for family, fn in collectors.items():
            try:
                for name, value in fn().items():
                    out[f"{family}_{name}"] = value
            except Exception as e:  # collector drift must not kill a scrape
                out[f"{family}_collector_errors"] = 1.0
                out[f"{family}_collector_error_msg"] = str(e)
        return out

    # -- snapshots ------------------------------------------------------------
    def snapshot(self):
        """Full structured dump: push metrics + polled collector gauges."""
        with self._lock:
            counters = {self._fmt_key(k): v for k, v in self._counters.items()}
            gauges = {self._fmt_key(k): v for k, v in self._gauges.items()}
            hists = {self._fmt_key(k): h.snapshot()
                     for k, h in self._hists.items()}
            n_events = len(self._events)
        return {"counters": counters, "gauges": gauges, "histograms": hists,
                "collected": self.collect(), "events": n_events}

    @staticmethod
    def _fmt_key(key):
        name, labels = key
        if not labels:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

    def iter_metrics(self):
        """(type, name, labels-dict, value-or-Histogram) rows for export.
        Histograms are copied under the lock: the /metrics HTTP thread
        reads them while the train loop observes into the live ones.
        Every family carries rank/world_size labels (injected at export
        time so the hot-path keys stay tiny; explicit labels win)."""
        rank, world = _rank_world()
        ident = {"rank": rank, "world_size": world}
        with self._lock:
            rows = [("counter", n, {**ident, **dict(l)}, v)
                    for (n, l), v in self._counters.items()]
            rows += [("gauge", n, {**ident, **dict(l)}, v)
                     for (n, l), v in self._gauges.items()]
            rows += [("histogram", n, {**ident, **dict(l)}, h.copy())
                     for (n, l), h in self._hists.items()]
        return rows


_HUB = None
_HUB_LOCK = named_lock("telemetry.hub.global")
_ON_CREATE = []  # callbacks run on every fresh hub (flight recorder attach)


def on_hub_create(fn):
    """Register ``fn(hub)`` to run on every hub creation — including after
    :func:`reset` — so always-on attachments (the flight recorder sink)
    survive test-style hub replacement. Runs immediately if a hub exists."""
    _ON_CREATE.append(fn)
    with _HUB_LOCK:
        h = _HUB
    if h is not None:
        fn(h)
    return fn


def _install_default_collectors(h: MetricsHub):
    """Adapters over the pre-existing registries (lazy imports: the
    registries stay the owners of their data and their public APIs)."""

    def _compile():
        from ..utils import compile as compile_mod

        s = compile_mod.registry().snapshot()
        return {"compiles_total": s["compiles"],
                "compile_seconds_total": s["compile_seconds"],
                "jit_hits_total": s["hits"],
                "jit_misses_total": s["misses"],
                "persistent_cache_hits_total": s["persistent_cache_hits"],
                "persistent_cache_saved_seconds_total":
                    s["persistent_cache_saved_seconds"]}

    def _comm():
        from .. import comm as comm_mod

        s = comm_mod.registry().snapshot()
        return {"sync_steps_total": s["steps"],
                "wire_bytes_total": s["wire_bytes"],
                "fp32_wire_bytes_total": s["fp32_wire_bytes"],
                "host_bytes_total": s["host_bytes"]}

    h.register_collector("compile", _compile)
    h.register_collector("comm", _comm)


def hub() -> MetricsHub:
    """The process-wide MetricsHub (created on first use, with the
    compile/comm registry adapters installed)."""
    global _HUB
    if _HUB is None:
        with _HUB_LOCK:
            if _HUB is None:
                h = MetricsHub()
                _install_default_collectors(h)
                # attach hooks run BEFORE the hub is published: a
                # concurrent emit() must never reach a hub missing its
                # always-on sinks (the flight recorder would drop the one
                # incident that explains a crash). Callbacks get the hub
                # as an argument and must not call hub() themselves.
                for fn in list(_ON_CREATE):
                    fn(h)
                _HUB = h
    return _HUB


def reset():
    """Replace the hub with a fresh one (tests)."""
    global _HUB
    with _HUB_LOCK:
        _HUB = None
    return hub()
