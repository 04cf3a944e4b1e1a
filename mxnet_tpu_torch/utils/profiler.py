"""Profiling: trace capture, annotated regions, honest timers and per-op
tables.

The port's counterpart of ``mxnet_tpu/utils/profiler.py``. Capture routes
through ``telemetry.profiling`` — the one doorway to ``torch.profiler``:
every capture is a hub event, stop is always finally-safe, and the
layer-attribution machinery (``fit(profile=...)``, ``telemetry profile``)
shares the same window bookkeeping. This module stays the low-level
per-op toolkit: ``trace_op_stats`` aggregates raw device time; the
attribution / measured-roofline report lives in telemetry/profiling.py.
"""

from __future__ import annotations

import collections
import contextlib
import tempfile
import time

import torch

__all__ = ["start_trace", "stop_trace", "profile_scope", "Timer",
           "OpStat", "trace_op_stats", "profile_step", "compile_report",
           "comm_report"]


def start_trace(log_dir: str):
    """Start a trace capture through the ONE capture path
    (telemetry.profiling): the capture becomes a hub event a JSONL sink
    sees, concurrent windows fail soft, and :func:`stop_trace` is safe to
    call unconditionally from a ``finally``."""
    from ..telemetry import profiling

    return profiling.start_capture(log_dir, owner="profiler")


def stop_trace():
    from ..telemetry import profiling

    profiling.stop_capture()


@contextlib.contextmanager
def profile_scope(name: str):
    """Annotate a region: a ``torch.profiler.record_function`` range, so
    the device-time profiler's attribution names its kernels exactly like
    a framework layer's."""
    with torch.profiler.record_function(name):
        yield


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _wait(outputs):
    """Wait until the work that produced ``outputs`` has run: the devices
    they lie on are synchronized (the card's work is queued on streams;
    the CPU's has run when the call returned)."""
    devices = {t.device for t in _tensors(outputs) if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock timer that waits for device work for honest
    measurements (≙ dmlc/timer.h + WaitForAll in the reference's engine
    benchmarks).

    Register the computation's outputs with :meth:`block` inside the
    ``with`` body::

        with Timer() as t:
            out = step(x)
            t.block(out)          # tensors, or lists/dicts of them
        print(t.elapsed)

    On exit the timer synchronizes every card that holds a registered
    output BEFORE reading the clock, so a launched-but-unfinished step is
    fully counted. When nothing was registered it synchronizes the current
    card, if there is one."""

    def __init__(self):
        self._outputs = []

    def block(self, *outputs):
        """Register outputs to be waited on at exit. Returns the single
        output (or the tuple) for call-through convenience."""
        self._outputs.extend(outputs)
        return outputs[0] if len(outputs) == 1 else outputs

    def __enter__(self):
        self._outputs = []
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is None:
            if self._outputs:
                _wait(self._outputs)
            elif torch.cuda.is_available():
                torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self.start
        return False


class OpStat(collections.namedtuple("OpStat", "name total_us count")):
    """Aggregated device time for one op across a trace."""

    __slots__ = ()

    def __str__(self):
        return f"{self.total_us / 1e3:10.3f} ms  x{self.count:<6d} {self.name}"


def trace_op_stats(log_dir: str, device_substr: str = "", top: int | None = None):
    """Parse a captured trace directory into per-op device-time stats.

    A rollup over the ONE trace parser
    (``telemetry.profiling.parse_trace_dir``: the card's kernels, or the
    CPU's top-level operations, named ``<ranges>/<op>``) by the trailing
    operation, rows sorted by total time: the op breakdown the profiler UI
    shows, available programmatically. The layer-attributed view is
    telemetry.profiling.build_report.
    """
    from ..telemetry import profiling

    rows = profiling.parse_trace_dir(log_dir, device_substr=device_substr)
    by: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for (_module, instr), row in rows.items():
        key = instr.rsplit("/", 1)[-1]
        by[key] += row["us"]
        counts[key] += row["count"]
    stats = [OpStat(name, us, counts[name]) for name, us in by.most_common()]
    return stats[:top] if top else stats


def compile_report(stats: dict | None = None) -> str:
    """Human-readable compile accounting table: per-function compile counts,
    compile-seconds, and cache hits/misses from the program registry (see
    utils/compile.ProgramRegistry — the same counters fit() logs per epoch;
    a CUDA graph's capture is the port's compile).
    """
    from . import compile as compile_mod

    stats = stats if stats is not None else compile_mod.compile_stats()
    lines = [
        f"compiles={stats['compiles']} "
        f"compile_s={stats['compile_seconds']:.2f} "
        f"jit_hits={stats['hits']} misses={stats['misses']} "
        f"persistent_hits={stats['persistent_cache_hits']} "
        f"saved_s={stats['persistent_cache_saved_seconds']:.2f}"
    ]
    per_fn = sorted(stats.get("per_function", {}).items(),
                    key=lambda kv: -kv[1]["compile_seconds"])
    for name, c in per_fn:
        lines.append(
            f"  {c['compile_seconds']:8.2f}s  x{c['compiles']:<3d} "
            f"hits={c['hits']:<6d} misses={c['misses']:<3d} "
            f"programs={c.get('programs', 0):<3d} {name}")
    return "\n".join(lines)


def comm_report(stats: dict | None = None) -> str:
    """Human-readable wire accounting: per-program comm plans, sync-step
    counts, and cumulative wire bytes vs the fp32 baseline, from the
    gradient-communication registry (mxnet_tpu_torch.comm — the same counters
    fit() logs per epoch as ``Comm:`` lines)."""
    from .. import comm as comm_mod

    stats = stats if stats is not None else comm_mod.comm_stats()
    ratio = stats.get("ratio")
    lines = [
        f"sync_steps={stats['steps']} "
        f"wire_mb={stats['wire_bytes'] / 1e6:.2f} "
        f"fp32_mb={stats['fp32_wire_bytes'] / 1e6:.2f} "
        + (f"ratio={ratio:.2f}x" if ratio else "ratio=n/a")
        + (f" host_sent_mb={stats['host_bytes']['sent'] / 1e6:.2f}"
           f" host_recv_mb={stats['host_bytes']['received'] / 1e6:.2f}"
           if stats.get("host_bytes", {}).get("sent")
           or stats.get("host_bytes", {}).get("received") else "")
    ]
    for name, p in sorted(stats.get("per_program", {}).items(),
                          key=lambda kv: -kv[1]["total_wire_bytes"]):
        lines.append(
            f"  {p['mode']:>6s}  x{p['steps']:<6d} "
            f"{p['wire_bytes'] / 1e3:9.2f} kB/step "
            f"(fp32 {p['fp32_wire_bytes'] / 1e3:.2f} kB, "
            f"{p['ratio']:.2f}x)  {name}")
        for row in p.get("collectives", ()):
            lines.append(
                f"          {row['op']:<18s} x{row['count']:<3d} "
                f"payload={row['payload_bytes'] / 1e3:.2f} kB "
                f"wire={row['wire_bytes'] / 1e3:.2f} kB")
    return "\n".join(lines)


def profile_step(fn, *args, iters: int = 3, log_dir: str | None = None,
                 top: int | None = 20, return_compile: bool = False):
    """Trace ``iters`` calls of a function and return its op stats.

    Convenience wrapper: warms up once, captures a trace, digests it with
    :func:`trace_op_stats`. Returns ``(stats, log_dir)``; ``log_dir``
    defaults to a kept temp dir so the full trace can still be opened in
    chrome://tracing. Any captures the profiled window triggered (warmup
    included) are logged via :func:`compile_report`, and
    ``return_compile=True`` returns ``(stats, log_dir, compile_delta)``."""
    import logging

    from . import compile as compile_mod
    from ..telemetry import profiling

    before = compile_mod.registry().snapshot()
    out = fn(*args)
    _wait(out)
    log_dir = log_dir or tempfile.mkdtemp(prefix="mxtpu_profile_")
    with profiling.capture(log_dir, owner="profile_step"):
        for _ in range(iters):
            out = fn(*args)
        _wait(out)
    after = compile_mod.registry().snapshot()
    delta = {k: after[k] - before[k] for k in after}
    if delta["compiles"]:
        logging.info("profile_step: %d compile(s), %.2fs, in the "
                     "profiled window\n%s", delta["compiles"],
                     delta["compile_seconds"], compile_report())
    if return_compile:
        return trace_op_stats(log_dir, top=top), log_dir, delta
    return trace_op_stats(log_dir, top=top), log_dir
