"""Telemetry exporters: schema-versioned JSONL, Prometheus text
exposition, an optional background HTTP endpoint, and a console summary.

The JSONL schema is **contract surface**, byte for byte the JAX package's
(``mxnet_tpu/telemetry/exporters.py``): the CLI (``python -m
mxnet_tpu_torch.telemetry``), the golden-key test in
tests/test_torch_telemetry.py, and any downstream log shipper key on it,
and either package reads the other's files. Every line is one JSON object
carrying at least ``{"v": SCHEMA_VERSION, "kind", "ts"}``; the per-kind
required keys are declared in :data:`EVENT_GOLDEN_KEYS` next to the code
that writes them, so adding a field is additive and removing one fails the
schema-stability test before it breaks a consumer.
"""

from __future__ import annotations

import json
import threading

from ..analysis.lockwatch import named_lock
from .hub import hub as _hub, _rank_world

__all__ = ["SCHEMA_VERSION", "EVENT_GOLDEN_KEYS", "JsonlWriter",
           "write_jsonl", "read_jsonl", "read_events", "prom_dump",
           "serve_http", "stop_http", "summary"]

# v2: every event carries rank/world_size; spans additionally
# carry trace_id/span_id/wall_ts; new distributed-tracing kinds
# (server_span, clock_beacon, server_stats, flight_dump, watchdog, chaos).
# v1 files stay readable: read_events() fills the v2 identity defaults.
SCHEMA_VERSION = 2

# kind -> keys every event of that kind must carry (beyond v/kind/ts and
# the v2 envelope rank/world_size).
# Additive evolution only: new fields are fine, these may never disappear.
EVENT_GOLDEN_KEYS = {
    "span": ("name", "epoch", "step", "dur_ms", "phases",
             "trace_id", "span_id", "rank"),
    "step_event": ("span_kind", "epoch", "step", "name"),
    "badput": ("reason", "seconds"),
    "epoch_summary": ("epoch", "steps", "seconds"),
    "checkpoint": ("step", "seconds", "tier"),
    "retry": ("op", "attempt"),
    "circuit_open": ("op",),
    "monitor": ("rows",),
    # distributed tracing (v2)
    "server_span": ("op", "dur_ms", "origin_rank", "start_ts"),
    "server_dedup": ("op", "origin_rank"),
    "clock_beacon": ("peer", "t_send", "t_peer", "t_recv"),
    "server_stats": ("update_count",),
    "flight_dump": ("reason", "path"),
    "watchdog": ("deadline",),
    "chaos": ("site",),
    # concurrency watchdog: cycle/stall incidents
    "lockwatch": ("what",),
    # elastic training
    "resize": ("from_world", "to_world", "reason", "membership_epoch"),
    # fleet controller: every policy decision is an event —
    # inputs, lever, action, and what actually happened to it
    "controller": ("lever", "action", "outcome"),
    # circuit-breaker state transitions (the trips used
    # to be invisible to the flight recorder)
    "breaker": ("breaker", "state", "from_state", "failures"),
    # memory observability
    "memory_plan": ("program", "argument_bytes", "output_bytes",
                    "temp_bytes", "total_bytes"),
    "memory_watermark": ("epoch", "watermark_bytes", "live_bytes"),
    "memory_leak": ("epoch", "drift_bytes", "watermark_bytes"),
    "memory_preflight": ("what", "total_bytes", "fits"),
    # training-health observability: per-step in-graph layer
    # stats + the anomaly incidents the streaming detectors raise
    "health": ("epoch", "step", "loss", "stats"),
    "health_anomaly": ("reason", "epoch", "step", "layer"),
    # device-time profiler: capture lifecycle + the attributed
    # summary (phase = "start" | "capture" | "summary"; summaries carry
    # the hotspot table, per-layer ms, measured roofline + MFU blocks)
    "profile": ("phase", "steps", "device_ms", "coverage_pct"),
    # cross-run ledger: one event per appended RunRecord —
    # the in-stream pointer joining a JSONL trace to its ledger entry
    # (source = "fit" | "predict" | "bench")
    "run_summary": ("run_id", "fingerprint", "backend", "source"),
}


# -- JSONL ---------------------------------------------------------------------

class JsonlWriter:
    """Streaming JSONL sink; register with ``hub().add_sink(...)`` to
    mirror every emitted event to disk as it happens. ``only_rank``
    filters to one rank's events — the per-rank stream writer for the
    in-process multi-worker harness, where every thread shares one hub."""

    def __init__(self, path, only_rank=None):
        self.path = path
        self.only_rank = only_rank
        self._lock = named_lock("telemetry.exporters.JsonlWriter")
        self._f = open(path, "a", encoding="utf-8")

    def write_event(self, event):
        if self.only_rank is not None and \
                int(event.get("rank", 0)) != int(self.only_rank):
            return
        line = json.dumps({"v": SCHEMA_VERSION, **event},
                          default=str, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")

    def close(self):
        with self._lock:
            self._f.flush()
            self._f.close()


def write_jsonl(path, events):
    """Write an iterable of event dicts as schema-versioned JSONL."""
    with open(path, "w", encoding="utf-8") as f:
        for event in events:
            f.write(json.dumps({"v": SCHEMA_VERSION, **event},
                               default=str, sort_keys=True) + "\n")
    return path


def read_jsonl(path):
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def read_events(path):
    """Schema-aware reader: the backward-compat path for v1 files. Rows
    from schema 1 (pre-distributed-tracing) gain the v2 identity defaults
    — rank 0 of world 1, no trace/span id — so the CLI and the cross-rank
    merge consume old and new logs uniformly."""
    rows = read_jsonl(path)
    for row in rows:
        # run identity postdates both schemas additively:
        # rows written before hubs minted run_ids read as "no run id"
        row.setdefault("run_id", None)
        if int(row.get("v", 1)) < 2:
            row.setdefault("rank", 0)
            row.setdefault("world_size", 1)
            if row.get("kind") == "span":
                row.setdefault("trace_id", None)
                row.setdefault("span_id", None)
                row.setdefault("wall_ts", row.get("ts", 0.0))
        # health events written by early/hand-rolled producers:
        # fill the additive fields so the CLI and detectors consume old
        # and new streams uniformly
        if row.get("kind") == "health":
            row.setdefault("stats", {})
            row.setdefault("finite", True)
        elif row.get("kind") == "health_anomaly":
            row.setdefault("layer", None)
        elif row.get("kind") == "checkpoint":
            # pre-PR-17 rows predate the multi-tier plane: everything was
            # a synchronous durable-disk save
            row.setdefault("tier", "t2")
        elif row.get("kind") == "run_summary":
            # rows from early/hand-rolled producers: fill the additive
            # identity fields so ledger joins degrade to None, not KeyError
            row.setdefault("fingerprint", None)
            row.setdefault("backend", None)
            row.setdefault("source", "fit")
            row.setdefault("record_id", None)
        elif row.get("kind") == "profile":
            # rows from early/hand-rolled producers: fill the
            # additive fields so the CLI/diff consume old streams uniformly
            row.setdefault("phase", "summary")
            row.setdefault("steps", 0)
            row.setdefault("device_ms", 0.0)
            row.setdefault("coverage_pct", None)
            row.setdefault("top", [])
    return rows


# -- Prometheus text exposition ------------------------------------------------

def _prom_name(name):
    safe = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not safe or not (safe[0].isalpha() or safe[0] in "_:"):
        safe = "_" + safe
    return "mxtpu_" + safe


def _prom_labels(labels):
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        val = str(v).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{val}"')
    return "{" + ",".join(parts) + "}"


def prom_dump(h=None) -> str:
    """Prometheus text-format exposition of the whole hub: push metrics
    (counters/gauges/histogram summaries) plus the registry adapters'
    polled gauges (compile/comm), so one scrape covers every subsystem."""
    h = h or _hub()
    lines = []
    seen_types = set()

    def _type_line(name, mtype):
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {mtype}")

    for mtype, name, labels, value in sorted(
            h.iter_metrics(), key=lambda r: (r[1], sorted(r[2].items()))):
        pname = _prom_name(name)
        if mtype == "counter":
            _type_line(pname, "counter")
            lines.append(f"{pname}{_prom_labels(labels)} {value:g}")
        elif mtype == "gauge":
            _type_line(pname, "gauge")
            lines.append(f"{pname}{_prom_labels(labels)} {value:g}")
        else:  # histogram -> summary (count/sum + quantile gauges)
            _type_line(pname, "summary")
            for q in (0.5, 0.9, 0.99):
                v = value.percentile(q * 100)
                if v is not None:
                    lines.append(
                        f"{pname}{_prom_labels({**labels, 'quantile': q})}"
                        f" {v:g}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{value.count:g}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} {value.sum:g}")
    # collector-adapter families carry the same rank/world identity as the
    # push metrics: per-rank /metrics endpoints scraped into one Prometheus
    # must not collapse different ranks' compile/comm series into one
    rank, world = _rank_world()
    ident = {"rank": rank, "world_size": world}
    for name, value in sorted(h.collect().items()):
        if not isinstance(value, (int, float)):
            continue  # collector error messages are not exposable samples
        pname = _prom_name(name)
        _type_line(pname, "gauge")
        lines.append(f"{pname}{_prom_labels(ident)} {value:g}")
    return "\n".join(lines) + "\n"


# -- background HTTP endpoint --------------------------------------------------

_SERVER = None
_SERVER_LOCK = named_lock("telemetry.exporters.http")


def serve_http(port):
    """Start a daemon-thread HTTP server exposing ``/metrics`` (Prometheus
    text) and ``/healthz``. Returns the bound port (pass 0 for ephemeral).
    Idempotent; :func:`stop_http` shuts it down."""
    global _SERVER
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.split("?")[0] not in ("/metrics", "/healthz"):
                self.send_error(404)
                return
            body = (prom_dump() if self.path.startswith("/metrics")
                    else "ok\n").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # keep the training log clean
            pass

    with _SERVER_LOCK:
        if _SERVER is not None:
            return _SERVER.server_address[1]
        server = http.server.ThreadingHTTPServer(("0.0.0.0", int(port)),
                                                 Handler)
        thread = threading.Thread(target=server.serve_forever,
                                  name="mx-metrics-http", daemon=True)
        thread.start()
        _SERVER = server
        return server.server_address[1]


def stop_http():
    global _SERVER
    with _SERVER_LOCK:
        if _SERVER is not None:
            _SERVER.shutdown()
            _SERVER.server_close()
            _SERVER = None


# -- console summary -----------------------------------------------------------

def summary(h=None) -> str:
    """Human-readable one-screen digest of the hub (counters, gauges,
    histogram p50/p99, registry adapters)."""
    h = h or _hub()
    lines = ["telemetry summary"]
    rows = h.iter_metrics()
    for mtype, name, labels, value in sorted(rows,
                                             key=lambda r: (r[0], r[1])):
        label_s = ("{" + ",".join(f"{k}={v}"
                                  for k, v in sorted(labels.items())) + "}"
                   if labels else "")
        if mtype == "histogram":
            if not value.count:
                continue
            lines.append(
                f"  {name}{label_s}: n={value.count} mean={value.mean:.6g} "
                f"p50={value.percentile(50):.6g} "
                f"p99={value.percentile(99):.6g} max={value.max:.6g}")
        elif value:  # zero-valued counters/gauges add noise, not signal
            lines.append(f"  {name}{label_s}: {value:g}")
    collected = [f"  {k}: {v:g}" for k, v in sorted(h.collect().items())
                 if isinstance(v, (int, float)) and v]
    if collected:
        lines.append("registry adapters:")
        lines.extend(collected)
    return "\n".join(lines)
