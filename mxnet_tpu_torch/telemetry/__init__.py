"""Unified telemetry: metrics hub, step timeline, MFU/goodput, exporters,
flight recorder, memory, training health, device profiling, run ledger.

The port's counterpart of ``mxnet_tpu/telemetry`` (its JSONL, flight and
ledger files are the JAX package's formats: either package reads the
other's). One stable surface for every subsystem to report through:

    from mxnet_tpu_torch import telemetry

    telemetry.counter("my_events_total")          # monotonic counter
    telemetry.gauge("queue_depth", 3)             # point-in-time value
    telemetry.observe("push_ms", 1.2, key="w1")   # histogram sample
    telemetry.emit("retry", op="push", attempt=2) # ring-buffered event
    with telemetry.timed("stage"): ...            # host-block timing

    print(telemetry.prom_dump())                  # Prometheus text
    print(telemetry.summary())                    # console digest
    telemetry.serve_http(9100)                    # background /metrics

Training integration: ``FeedForward.fit(telemetry=True, health=True,
profile=True)`` (env gates ``MXNET_TPU_TELEMETRY``, ``MXNET_TPU_HEALTH``,
``MXNET_TPU_PROFILE``) attaches a :class:`StepTimeline` + MFU/goodput
accounting, the in-step health statistics and a bounded profile window to
the train loop; the timeline lands on ``model.telemetry`` with
Chrome-trace / JSONL export. ``python -m mxnet_tpu_torch.telemetry
tail|summarize run.jsonl`` inspects exported event logs.

The hub does not replace the compile/comm registries — they stay the
owners of their counters (``compile_stats()``/``comm_stats()`` unchanged)
and the hub polls them through registered collectors, so one Prometheus
scrape covers every subsystem.
"""

from __future__ import annotations

import os

from .hub import (MetricsHub, Histogram, hub, reset, DEFAULT_COUNTERS,
                  on_hub_create)
from .distributed import (trace_id, set_trace_id, set_world, current_rank,
                          world_size, rank_scope, mint_span_id, trace_ctx,
                          emit_server_span, record_clock_beacon,
                          merge_traces, detect_stragglers,
                          load_rank_streams)
from .timeline import (StepTimeline, Span, current_span,
                       clear_current_span, phase, timed)
from .mfu import (MFUAccountant, resolve_peak_flops, measured_peak_flops,
                  record_compile_badput)
from .exporters import (SCHEMA_VERSION, EVENT_GOLDEN_KEYS, JsonlWriter,
                        write_jsonl, read_jsonl, read_events, prom_dump,
                        serve_http, stop_http, summary)
from . import flight
from .flight import FlightRecorder, validate_flight
from . import memory
from .memory import (ArrayLedger, MemoryPreflightError, track_arrays,
                     plan_table, forensics_snapshot)
from . import sensors
from .sensors import StreamingStragglerDetector, comm_compute_ratio
from . import health
from .health import HealthConfig, HealthMonitor
from . import profiling
from .profiling import ProfileConfig, ProfileSession
from . import ledger
from .ledger import (LEDGER_SCHEMA, ledger_dir, read_ledger, trend_gate,
                     knob_attribution, warm_start_tier)

# the black box records from import on (and survives hub resets)
flight.install()
# memory plans publish as hub gauges/events from the first capture on
memory.install()

__all__ = [
    "MetricsHub", "Histogram", "hub", "reset", "DEFAULT_COUNTERS",
    "on_hub_create",
    "trace_id", "set_trace_id", "set_world", "current_rank", "world_size",
    "rank_scope", "mint_span_id", "trace_ctx", "emit_server_span",
    "record_clock_beacon", "merge_traces", "detect_stragglers",
    "load_rank_streams",
    "StepTimeline", "Span", "current_span", "clear_current_span", "phase",
    "timed",
    "MFUAccountant", "resolve_peak_flops", "measured_peak_flops",
    "record_compile_badput",
    "SCHEMA_VERSION", "EVENT_GOLDEN_KEYS", "JsonlWriter", "write_jsonl",
    "read_jsonl", "read_events", "prom_dump", "serve_http", "stop_http",
    "summary",
    "flight", "FlightRecorder", "validate_flight",
    "memory", "ArrayLedger", "MemoryPreflightError", "track_arrays",
    "plan_table", "forensics_snapshot",
    "sensors", "StreamingStragglerDetector", "comm_compute_ratio",
    "health", "HealthConfig", "HealthMonitor",
    "profiling", "ProfileConfig", "ProfileSession",
    "ledger", "LEDGER_SCHEMA", "ledger_dir", "read_ledger", "trend_gate",
    "knob_attribution", "warm_start_tier",
    "counter", "gauge", "observe", "emit", "TelemetryConfig",
    "maybe_serve_http_from_env",
]

_OFF_VALUES = ("", "0", "off", "false", "no")


# -- module-level conveniences (the API other layers call) ---------------------

def counter(name, value=1.0, **labels):
    hub().counter(name, value, **labels)


def gauge(name, value, **labels):
    hub().gauge(name, value, **labels)


def observe(name, value, **labels):
    hub().observe(name, value, **labels)


def emit(kind, **fields):
    return hub().emit(kind, **fields)


class TelemetryConfig:
    """What ``fit(telemetry=...)`` turns on.

    ``timeline``: per-step span tracing; ``mfu``: FLOP/goodput accounting;
    ``sync``: block on each step's outputs for exact device-phase timing
    (the attribution/pipelining trade — see timeline.py); ``jsonl``: a
    path to stream every hub event to as it happens; ``memory``: the
    live-array ledger + phase-boundary watermark sampler + epoch leak
    detector (memory.py — host-side bookkeeping, <2% of a step)."""

    def __init__(self, timeline=True, mfu=True, sync=True, jsonl=None,
                 memory=True):
        self.timeline = bool(timeline)
        self.mfu = bool(mfu)
        self.sync = bool(sync)
        self.jsonl = jsonl
        self.memory = bool(memory)

    def __repr__(self):
        return (f"TelemetryConfig(timeline={self.timeline}, mfu={self.mfu}, "
                f"sync={self.sync}, jsonl={self.jsonl!r}, "
                f"memory={self.memory})")

    @classmethod
    def resolve(cls, value):
        """Normalize fit()'s ``telemetry`` argument: None -> env gate
        ``MXNET_TPU_TELEMETRY`` (unset/falsy = off; a path value streams
        JSONL there); True -> defaults; str -> JSONL path; TelemetryConfig
        -> itself."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_TELEMETRY", "").strip()
            if raw.lower() in _OFF_VALUES:
                return None
            value = True if raw.lower() in ("1", "on", "true", "yes") else raw
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        return cls(jsonl=str(value))


def maybe_serve_http_from_env():
    """Start the background /metrics endpoint iff MXNET_TPU_METRICS_PORT
    is set (called once at package import; explicit serve_http still
    works). Returns the bound port or None."""
    raw = os.environ.get("MXNET_TPU_METRICS_PORT", "").strip()
    if raw.lower() in _OFF_VALUES:
        return None
    try:
        return serve_http(int(raw))
    except Exception as e:  # a busy port must not break `import mxnet_tpu_torch`
        import logging

        logging.warning("telemetry: /metrics endpoint unavailable on "
                        "port %r: %s", raw, e)
        return None
