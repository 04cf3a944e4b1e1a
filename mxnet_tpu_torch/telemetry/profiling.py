"""Device-time profiler: measured per-layer/per-kernel attribution.

The port's counterpart of ``mxnet_tpu/telemetry/profiling.py``. MFU, the
timeline's ``device`` phase and the kernel bounds are totals; this module
says where inside a step the device time went:

  **provenance in** — while a capture is active the executor runs every
  symbol op under ``torch.profiler.record_function("<layer>/<op>")``
  (``executor.exec_node``; the counterpart of the JAX package's
  ``jax.named_scope``), and the training step ranges its non-graph stages
  (``loss``/``comm``/``optimizer``/``metric``/``health``). A backward
  operation carries its forward operation's sequence number, so it is
  named by the ranges its forward ran under, as a JAX transpose inherits
  its scope. A hand-written kernel's device event is named by its CUDA
  symbol, mapped to its registry ``name=`` (``kernels/registry.py``).

  **capture** — ``fit(profile=...)`` / ``predict(profile=...)`` / env
  ``MXNET_TPU_PROFILE`` arm a bounded K-step capture window through
  ``torch.profiler`` (:func:`start_capture`/:func:`stop_capture`/
  :func:`capture` — the one doorway to the profiler here). Windows open
  only after warmup and never in a capturing step. A CUDA graph's replay
  gives the profiler kernels tied to ``cudaGraphLaunch``, not to any
  range, so the window's steps run eager with the ranges on (counted
  under the ``profile window`` eager reason), and the window's wall time
  is priced as a ``profile`` badput bucket.

  **attribution** — :func:`parse_trace_dir` reads the chrome trace
  ``torch.profiler`` exports and keeps the device events (kernels, copies
  and sets on a card; the top-level CPU operations on the CPU, where the
  host is the device); each is joined, through the CUDA runtime call that
  launched it, to the ranges open on the launching thread, and
  :func:`build_report` names its layer with :func:`attribute_op_name`.
  The report carries an attribution **coverage ratio** and an explicit
  ``unattributed`` row — measured time that cannot be named (the feed's
  copies, autograd's gradient accumulation) is reported, never hidden.

  **measured roofline** — measured per-operation seconds join the FLOP
  counter's rows (``telemetry.mfu``, kernel-registry rows included) into
  roofline rows stamped ``source: "measured"``, and MFU gets a measured
  numerator to reconcile against the modeled one (``mfu`` block).

Surface: ``profile`` events in the JSONL schema, per-layer ``profile_*``
hub gauges, ``python -m mxnet_tpu_torch.telemetry profile run.jsonl``
hotspot tables, and the last capture summary in flight-recorder dumps.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import logging
import os
import re
import tempfile
import time

from ..analysis.lockwatch import named_lock
from ..base import ENV_OFF_VALUES
from .hub import hub as _hub

__all__ = ["ProfileConfig", "ProfileSession", "ProfileReport",
           "start_capture", "stop_capture", "capture", "capture_active",
           "ranges_on", "scope", "parse_trace_dir", "attribute_op_name",
           "build_report", "measured_peak_bandwidth",
           "last_capture_summary", "CATEGORY_SCOPES", "WRAPPER_SEGMENTS"]

# scope segments the train step emits for its non-graph stages; attribution
# treats them as pseudo-layers so optimizer/comm/metric time is named, not
# lost to the unattributed row
CATEGORY_SCOPES = frozenset({"optimizer", "comm", "metric", "guards",
                             "health", "loss"})

# transform/partitioning wrapper segments the JAX package's op_name
# metadata carries around user scopes ("jit(step)/jit(main)/transpose(
# jvp(f))/fc1/...") — never a layer; kept so both packages attribute the
# same names alike. Parenthesized segments are skipped structurally.
WRAPPER_SEGMENTS = frozenset({
    "jit", "pjit", "jvp", "vjp", "transpose", "vmap", "pmap", "scan",
    "while", "body", "cond", "branch", "checkpoint", "remat", "shmap",
    "shmap_body", "shard_map", "custom_jvp", "custom_vjp",
    "custom_vjp_call", "main",
})

_OFF = ENV_OFF_VALUES
_ON_VALUES = ("1", "on", "true", "yes")

# per-process window counter: each ProfileSession window captures into its
# own subdirectory of an explicit cfg.log_dir (see ProfileSession._begin)
import itertools as _itertools

_WINDOW_SEQ = _itertools.count()


class ProfileConfig:
    """What ``fit(profile=...)`` / ``predict(profile=...)`` turns on.

    ``steps``: capture-window length in steps. ``warmup``: observed steps
    to skip before the window may open (and the window additionally waits
    for a compile-quiet step — never trace a capture). ``log_dir``:
    where the raw trace lands (None = a kept temp dir, so the full trace
    can still be opened in chrome://tracing or Perfetto). ``top_k``: hotspot-table
    length. ``gauges``: export per-layer ``profile_*`` gauges."""

    def __init__(self, steps=6, warmup=2, log_dir=None, top_k=12,
                 gauges=True):
        self.steps = max(int(steps), 1)
        self.warmup = max(int(warmup), 0)
        self.log_dir = log_dir
        self.top_k = max(int(top_k), 1)
        self.gauges = bool(gauges)

    def __repr__(self):
        return (f"ProfileConfig(steps={self.steps}, warmup={self.warmup}, "
                f"log_dir={self.log_dir!r}, top_k={self.top_k})")

    @classmethod
    def resolve(cls, value):
        """Normalize the ``profile`` argument: None -> env gate
        ``MXNET_TPU_PROFILE`` (unset/falsy = off; an integer = window
        steps; any other value = defaults), True -> defaults, int ->
        window steps, ProfileConfig -> itself."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_PROFILE", "").strip()
            if not raw or raw.lower() in _OFF:
                return None
            value = int(raw) if raw.isdigit() and raw.lower() not in \
                _ON_VALUES else True
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, int):
            # 0 means off, like the env gate's MXNET_TPU_PROFILE=0 — a
            # computed "no window" must not silently become a 1-step one
            return cls(steps=value) if value > 0 else None
        raise ValueError(
            f"profile must be bool/None/int/ProfileConfig, got {type(value)}")


# -- capture: the one doorway to torch.profiler -----------------------------------
# the profiler is process-global (one trace at a time); every capture goes
# through here so concurrent windows fail soft instead of crashing the
# run, and every capture is a hub event a JSONL sink sees.

_CAPTURE_LOCK = named_lock("telemetry.profiling.capture")
_CAPTURE = {"dir": None, "t0": None, "owner": None, "prof": None}
_LAST_SUMMARY = [None]  # most recent capture summary (flight-recorder page)
# the executor's and the step's ranges are emitted only while a capture
# is active (one list read otherwise)
_RANGES = [False]


def capture_active():
    """The active capture's log dir, or None."""
    with _CAPTURE_LOCK:
        return _CAPTURE["dir"]


def ranges_on():
    """True while a capture is active: the ranges are worth emitting."""
    return _RANGES[0]


def scope(name):
    """``torch.profiler.record_function(name)`` while a capture is active,
    else a no-op context: the range ``<layer>/<op>`` or ``<stage>/<what>``
    the attribution joins device events to."""
    if not _RANGES[0]:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def start_capture(log_dir=None, owner="manual"):
    """Start a trace capture (``torch.profiler``: the CPU, and the card's
    activity when CUDA is available).

    Returns the log dir. Raises RuntimeError if a capture is already
    active — the caller decides whether that is fatal (the fit session
    skips its window instead)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="mxtpu_profile_")
    with _CAPTURE_LOCK:
        if _CAPTURE["dir"] is not None:
            raise RuntimeError(
                f"a profile capture is already active "
                f"(owner={_CAPTURE['owner']!r}, dir={_CAPTURE['dir']!r})")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _CAPTURE.update(dir=log_dir, t0=time.perf_counter(), owner=owner,
                        prof=prof)
        _RANGES[0] = True
    _hub().emit("profile", phase="start", owner=str(owner),
                log_dir=str(log_dir), steps=0, device_ms=0.0,
                coverage_pct=None)
    _hub().counter("profile_captures_total")
    return log_dir


def stop_capture():
    """Stop the active capture and write its chrome trace
    (``<log_dir>/<host>.<pid>.pt.trace.json.gz``); returns ``(log_dir,
    wall_seconds)`` (or ``(None, 0.0)`` when none is active — a
    finally-guarded stop must be safe to call unconditionally). The
    seconds run to the profiler's stop, before the trace is written."""
    import socket

    with _CAPTURE_LOCK:
        if _CAPTURE["dir"] is None:
            return None, 0.0
        log_dir, t0 = _CAPTURE["dir"], _CAPTURE["t0"]
        owner, prof = _CAPTURE["owner"], _CAPTURE["prof"]
        _RANGES[0] = False
        try:
            prof.stop()
        finally:
            _CAPTURE.update(dir=None, t0=None, owner=None, prof=None)
    seconds = time.perf_counter() - t0
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json.gz"))
    _hub().emit("profile", phase="capture", owner=str(owner),
                log_dir=str(log_dir), seconds=seconds, steps=0,
                device_ms=0.0, coverage_pct=None)
    _hub().gauge("profile_capture_seconds", seconds)
    return log_dir, seconds


@contextlib.contextmanager
def capture(log_dir=None, owner="manual"):
    """Context-managed capture window (finally-guarded stop)."""
    log_dir = start_capture(log_dir, owner=owner)
    try:
        yield log_dir
    finally:
        stop_capture()


# -- trace parsing ---------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_BACKWARD = "autograd::engine::evaluate_function: "


def _load_trace(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _stacks(intervals, points):
    """For each ``(t, key)`` of ``points``, the intervals
    ``(start, end, payload)`` (properly nested, one thread's) open at
    ``t``, outermost first: ``{key: [payload, ...]}``."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points, key=lambda p: p[0]):
        while i < len(intervals) and intervals[i][0] <= t:
            iv = intervals[i]
            while stack and stack[-1][1] <= iv[0]:
                stack.pop()
            stack.append(iv)
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out[key] = [iv[2] for iv in stack if iv[1] > t]
    return out


def _short_symbol(name):
    base = name.split("(")[0].replace("void ", "").strip()
    base = base.split("<")[0]
    return base.rsplit("::", 1)[-1] or name


def _aten_name(name):
    if name.startswith(_BACKWARD):
        return name[len(_BACKWARD):]
    return name.split("::", 1)[-1] if name.startswith("aten::") else name


def parse_trace_dir(log_dir, device_substr=""):
    """Aggregate device time from the chrome trace(s) under ``log_dir``
    (``*.trace.json.gz`` / ``*.trace.json``, recursively).

    Device events are the card's kernels, copies and sets; in a trace with
    none (a CPU run) they are the top-level CPU operations of each
    thread. Each is named ``<ranges>/<op>``: the ``record_function``
    ranges open on the thread that launched it (a backward operation
    takes its forward operation's ranges, through the autograd sequence
    number) and its operation — the registry name of a hand-written
    kernel, else the ATen operation that launched it, else the kernel's
    short symbol. ``device_substr`` keeps only device events whose
    ``device`` arg contains it. A torch trace has no wrapper
    instructions, so the JAX package's ``drop_wrappers`` has nothing to
    drop here.

    Returns ``{(module, instr): {"us": total, "count": n, "op_name":
    instr}}``, ``module`` ``"cuda"`` or ``"cpu"``."""
    from ..kernels.registry import kernel_of_symbol

    files = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*.trace.json"),
                    recursive=True))
    if not files:
        raise FileNotFoundError(f"no trace.json(.gz) under {log_dir!r}")
    rows: dict = {}
    for path in files:
        events = [e for e in _load_trace(path) if e.get("ph") == "X"]
        by_tid: dict = collections.defaultdict(list)
        fwd_ranges: dict = {}
        device, runtime = [], {}
        for e in events:
            cat = e.get("cat", "")
            args = e.get("args") or {}
            if cat in _DEVICE_CATS:
                if device_substr and device_substr not in \
                        str(args.get("device", "")):
                    continue
                device.append(e)
            elif cat in _RUNTIME_CATS:
                runtime[args.get("correlation")] = e
            elif cat in ("user_annotation", "cpu_op"):
                ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
                by_tid[e.get("tid")].append(
                    (ts, ts + dur, (cat, e.get("name", ""),
                                    args.get("Sequence number"), e)))
        # the ranges open at each forward operation, by sequence number
        points = collections.defaultdict(list)
        for tid, ivs in by_tid.items():
            for iv in ivs:
                cat, name, seq, e = iv[2]
                if cat == "cpu_op" and seq is not None and \
                        not name.startswith(_BACKWARD):
                    points[tid].append((iv[0], ("fwd", id(e), seq)))
        module = "cuda" if device else "cpu"
        queries = collections.defaultdict(list)
        launched = {}
        if device:
            for e in device:
                r = runtime.get((e.get("args") or {}).get("correlation"))
                if r is None:
                    continue
                key = ("dev", id(e))
                queries[r.get("tid")].append((float(r["ts"]), key))
                launched[key] = e
        else:
            for tid, ivs in by_tid.items():
                ops = sorted((iv for iv in ivs if iv[2][0] == "cpu_op"),
                             key=lambda iv: (iv[0], -iv[1]))
                top_end = None
                for iv in ops:
                    if top_end is not None and iv[0] < top_end:
                        continue  # inside the current top-level op
                    top_end = iv[1]
                    key = ("dev", id(iv[2][3]))
                    queries[tid].append((iv[0], key))
                    launched[key] = iv[2][3]
        for tid, ivs in by_tid.items():
            found = _stacks(ivs, points[tid] + queries[tid])
            for (kind, _eid, seq), stack in (
                    (k, v) for k, v in found.items() if k[0] == "fwd"):
                ranges = [p[1] for p in stack if p[0] == "user_annotation"]
                fwd_ranges.setdefault(seq, ranges)
            for key, stack in ((k, v) for k, v in found.items()
                               if k[0] == "dev"):
                launched[key] = (launched[key], stack)
        for key, item in launched.items():
            if not isinstance(item, tuple):
                e, stack = item, []
            else:
                e, stack = item
            ranges = [p[1] for p in stack if p[0] == "user_annotation"]
            ops = [p for p in stack if p[0] == "cpu_op"]
            back = next((p for p in ops if p[1].startswith(_BACKWARD)),
                        None)
            if back is not None and back[2] is not None:
                ranges = fwd_ranges.get(back[2], []) + ranges
            name = e.get("name", "")
            op = kernel_of_symbol(name) if module == "cuda" else None
            if op is None:
                aten = [p[1] for p in ops if p[1].startswith("aten::")]
                if aten:
                    op = _aten_name(aten[0])
                elif back is not None:
                    op = _aten_name(back[1])
                elif module == "cpu":
                    op = _aten_name(name)
                else:
                    op = _short_symbol(name)
            instr = "/".join(ranges + [op])
            row = rows.get((module, instr))
            if row is None:
                row = rows[(module, instr)] = {"us": 0.0, "count": 0,
                                               "op_name": instr}
            row["us"] += float(e.get("dur", 0.0))
            row["count"] += 1
    return rows


# -- attribution ---------------------------------------------------------------

# transform applications in the JAX package's op_name metadata nest the
# user scopes INSIDE the parens — "transpose(jvp(fc1/FullyConnected))/dot_general" —
# so wrappers unwrap (drop "name(" and ")") rather than drop wholesale
_TRANSFORM_OPEN_RE = re.compile(r"[\w.\-]+\(")


def _scope_segments(op_name):
    """The named-scope path of an op_name: transform applications
    unwrapped, wrapper segments dropped."""
    flat = _TRANSFORM_OPEN_RE.sub("", op_name).replace(")", "")
    return [seg for seg in flat.split("/")
            if seg and seg not in WRAPPER_SEGMENTS]


def attribute_op_name(op_name, layers, categories=CATEGORY_SCOPES):
    """``(layer-or-category, primitive)`` for one metadata op_name, or
    ``(None, primitive)`` when no segment names a known layer. The
    primitive is the trailing segment (the operation the measured
    roofline joins on)."""
    segs = _scope_segments(op_name)
    prim = segs[-1] if segs else op_name
    for seg in segs:
        if seg in layers:
            return seg, prim
        if seg in categories:
            return seg, prim
    return None, prim


class ProfileReport:
    """One capture window, attributed. ``to_dict()`` is the JSONL/flight
    payload; the fit session publishes it as the ``profile`` summary
    event plus ``profile_*`` gauges."""

    def __init__(self, steps, window_seconds, total_us, attributed_us,
                 layers, ops, roofline, mfu, log_dir=None, epoch=None):
        self.steps = int(steps)
        self.window_seconds = float(window_seconds)
        self.total_us = float(total_us)
        self.attributed_us = float(attributed_us)
        self.layers = layers          # {layer: us}
        self.ops = ops                # hotspot rows, sorted by us desc
        self.roofline = roofline      # measured roofline rows
        self.mfu = mfu                # measured-vs-modeled reconciliation
        self.log_dir = log_dir
        self.epoch = epoch

    @property
    def coverage_pct(self):
        if not self.total_us:
            return 0.0
        return 100.0 * self.attributed_us / self.total_us

    @property
    def unattributed_us(self):
        return self.total_us - self.attributed_us

    def to_dict(self, top_k=None):
        top = self.ops[:top_k] if top_k else list(self.ops)
        return {
            "steps": self.steps,
            "window_seconds": self.window_seconds,
            "device_ms": self.total_us / 1e3,
            "attributed_ms": self.attributed_us / 1e3,
            "unattributed_ms": self.unattributed_us / 1e3,
            "coverage_pct": self.coverage_pct,
            "layers": {k: v / 1e3 for k, v in sorted(
                self.layers.items(), key=lambda kv: -kv[1])},
            "top": top,
            "roofline": list(self.roofline),
            "mfu": dict(self.mfu),
            "log_dir": self.log_dir,
            "epoch": self.epoch,
        }

    def table(self, top_k=10):
        """Human-readable hotspot table (the fit log / CLI rendering)."""
        lines = [f"device profile: {self.total_us / 1e3:.2f} ms over "
                 f"{self.steps} step(s), coverage "
                 f"{self.coverage_pct:.1f}% "
                 f"(unattributed {self.unattributed_us / 1e3:.2f} ms)"]
        for row in self.ops[:top_k]:
            lines.append(
                f"  {row['us'] / 1e3:9.3f} ms {row['pct']:5.1f}%  "
                f"{row['layer'] or '<unattributed>':<20s} {row['op']}")
        return "\n".join(lines)


def build_report(trace_rows, hlo_maps, layers, categories=None, steps=1,
                 window_seconds=0.0, audit_rows=None, flops_per_step=None,
                 num_devices=1, peak_flops=None, log_dir=None, epoch=None):
    """Join parsed trace rows to layers/kernels and the FLOP/byte models.

    ``trace_rows``: :func:`parse_trace_dir` output (a row's ``op_name``
    names it). ``hlo_maps``: list of ``{instruction: op_name}`` maps, the
    JAX package's HLO metadata join; an instruction found there takes
    that name. ``layers``: known layer names (symbol node names + param
    layers). ``audit_rows``: the FLOP counter's per-operation rows of
    the profiled step (``flops``/``bytes`` PER STEP) — the
    measured-roofline join; kernel-registry rows arrive as
    ``kernel::<name>`` (the JAX package's ``pallas::<name>``).
    ``flops_per_step``/``num_devices``/``peak_flops``: the MFU
    reconciliation inputs (aggregate peak)."""
    categories = set(categories if categories is not None
                     else CATEGORY_SCOPES)
    try:
        from ..kernels import registry as kreg

        categories |= set(kreg.kernel_names())
    except Exception:
        pass
    merged = {}
    for m in hlo_maps:
        merged.update(m)

    total_us = attributed_us = 0.0
    layer_us: dict = collections.defaultdict(float)
    op_rows: dict = {}
    prim_us: dict = collections.defaultdict(float)
    for (module, instr), row in trace_rows.items():
        us = row["us"]
        total_us += us
        op_name = merged.get(instr, row.get("op_name"))
        layer = prim = None
        if op_name is not None:
            layer, prim = attribute_op_name(op_name, layers, categories)
        if layer is None and op_name is None:
            # fusions carry their root's metadata; a bare instruction with
            # no map entry keeps its HLO opcode as the "primitive"
            prim = instr.split(".")[0]
        if layer is not None:
            attributed_us += us
            layer_us[layer] += us
        prim_us[prim] += us
        key = (layer, prim)
        orow = op_rows.get(key)
        if orow is None:
            orow = op_rows[key] = {"layer": layer, "op": prim, "us": 0.0,
                                   "count": 0, "program": module}
        orow["us"] += us
        orow["count"] += row["count"]

    ops = sorted(op_rows.values(), key=lambda r: -r["us"])
    for row in ops:
        row["pct"] = 100.0 * row["us"] / total_us if total_us else 0.0
        row["ms_per_step"] = row["us"] / 1e3 / max(steps, 1)

    roofline = _measured_roofline(prim_us, audit_rows, steps, num_devices,
                                  peak_flops)
    mfu = _reconcile_mfu(total_us, steps, num_devices, flops_per_step,
                         peak_flops, window_seconds)
    return ProfileReport(steps, window_seconds, total_us, attributed_us,
                         dict(layer_us), ops, roofline, mfu,
                         log_dir=log_dir, epoch=epoch)


def _measured_roofline(prim_us, audit_rows, steps, num_devices, peak_flops):
    """Measured roofline rows: per-operation measured seconds joined to
    the FLOP counter's / kernel-registry FLOP+byte models. Rows are stamped
    ``source: "measured"`` — the field that keeps interpret-mode CPU
    estimates (``source: "interpret"``) and pure models (``source:
    "model"``) from ever being read as device measurements."""
    if not audit_rows:
        return []
    peak_bw = None
    rows = []
    steps = max(int(steps), 1)
    ndev = max(int(num_devices), 1)
    for arow in audit_rows:
        prim = arow.get("primitive")
        flops = float(arow.get("flops", 0.0))
        nbytes = float(arow.get("bytes", 0.0))
        us = prim_us.get(prim)
        for prefix in ("pallas::", "kernel::"):
            if us is None and prim and prim.startswith(prefix):
                us = prim_us.get(prim[len(prefix):])
        if not us or flops <= 0:
            continue
        # the trace sums each device's time; the counted FLOPs are
        # global — per-device time is the roofline clock
        sec_per_step = us / 1e6 / steps / ndev
        achieved = flops / sec_per_step
        row = {"op": prim, "source": "measured",
               "model_flops": flops, "model_bytes": nbytes,
               "measured_ms_per_step": round(us / 1e3 / steps, 4),
               "achieved_gflops_s": round(achieved / 1e9, 3),
               "intensity_flops_per_byte":
                   round(flops / nbytes, 3) if nbytes else None}
        if peak_flops:
            row["pct_of_peak"] = round(100.0 * achieved / peak_flops, 3)
            if peak_bw is None:
                peak_bw = measured_peak_bandwidth() * ndev
            ridge = peak_flops / peak_bw if peak_bw else None
            if ridge is not None and nbytes:
                row["bound"] = ("compute" if flops / nbytes >= ridge
                                else "bandwidth")
        rows.append(row)
    rows.sort(key=lambda r: -r["measured_ms_per_step"])
    return rows


def _reconcile_mfu(total_us, steps, num_devices, flops_per_step, peak_flops,
                   window_seconds):
    """Measured-vs-modeled MFU: the modeled number divides model FLOPs by
    *wall* time; the measured one divides the same FLOPs by measured
    per-device *device* time — the gap is everything the wall clock hides
    (host work, dispatch, data waits, unattributed device time)."""
    out = {"measured_device_ms_per_step": None, "measured_mfu_pct": None,
           "modeled_mfu_pct": None, "delta_pct": None}
    steps = max(int(steps), 1)
    ndev = max(int(num_devices), 1)
    if total_us:
        out["measured_device_ms_per_step"] = total_us / 1e3 / steps / ndev
    if not (flops_per_step and peak_flops):
        return out
    if total_us:
        dev_s = total_us / 1e6 / steps / ndev
        out["measured_mfu_pct"] = \
            100.0 * flops_per_step / dev_s / peak_flops
    if window_seconds:
        wall_s = window_seconds / steps
        out["modeled_mfu_pct"] = \
            100.0 * flops_per_step / wall_s / peak_flops
    if out["measured_mfu_pct"] is not None and \
            out["modeled_mfu_pct"] is not None:
        out["delta_pct"] = out["measured_mfu_pct"] - out["modeled_mfu_pct"]
    return out


_MEASURED_BW = {}


def measured_peak_bandwidth(n_mb=32, iters=4, device=None):
    """One-time measured memory bandwidth (bytes/s per device) — the
    roofline ridge's denominator (cached per device): ``iters`` passes of
    ``x + 1`` over ``n_mb`` MB (256 MB on a card), between CUDA events on
    a card."""
    import torch

    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    key = str(device)
    if key in _MEASURED_BW:
        return _MEASURED_BW[key]
    if device.type == "cuda":
        n_mb = max(int(n_mb), 256)
    n = int(n_mb) * (1 << 20) // 4
    x = torch.zeros(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    torch.add(x, 1.0, out=y)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            torch.add(x, 1.0, out=y)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            torch.add(x, 1.0, out=y)
        seconds = time.perf_counter() - t0
    # each iteration streams the buffer in and out once
    bw = 2.0 * n * 4 * iters / max(seconds, 1e-9)
    _MEASURED_BW[key] = bw
    return bw


def last_capture_summary():
    """The most recent capture's summary dict (flight-recorder page), or
    None when no attributed capture has completed in this process."""
    return _LAST_SUMMARY[0]


def _set_last_summary(summary):
    _LAST_SUMMARY[0] = summary


# -- the fit/predict window ----------------------------------------------------

class ProfileSession:
    """Drives one bounded capture window inside a train/predict loop.

    The loop calls :meth:`before_step` right before each step with the
    compile registry's cumulative compile count; it returns True when the
    step belongs to the window, and the loop then runs that step eager
    (not from its graph) so the ranges name its kernels. The session waits
    out ``cfg.warmup`` observed steps AND a compile-quiet step (a capture
    must never be traced), opens the window, counts ``cfg.steps`` steps
    through :meth:`after_step`, waits for the card, stops, attributes and
    publishes. After the window closes every further ``before_step`` is a
    single attribute check.

    ``after_step`` returns the window's wall seconds when it just closed
    (the loop's ``profile`` badput contribution), else 0.0.
    """

    def __init__(self, cfg, layers, num_devices=1, mfu_acct=None,
                 logger=None, owner="fit", device=None):
        self.cfg = cfg
        self.layers = frozenset(layers)
        self.num_devices = max(int(num_devices), 1)
        self.mfu_acct = mfu_acct
        self.logger = logger or logging
        self.owner = owner
        self.device = device
        self.report = None
        self._state = "armed"        # armed -> open -> done | disabled
        self._observed = 0
        self._window_steps = 0
        self._compiles_prev = None
        self._log_dir = None
        self._t0 = None

    @property
    def pending(self):
        """True while the window has not opened yet."""
        return self._state == "armed"

    @property
    def open(self):
        return self._state == "open"

    # -- loop hooks -----------------------------------------------------------
    def before_step(self, compiles_now):
        """Maybe open the window; True when this step is a window step."""
        if self._state == "armed":
            self._observed += 1
            quiet = self._compiles_prev is not None and \
                compiles_now == self._compiles_prev
            self._compiles_prev = compiles_now
            if self._observed > self.cfg.warmup and quiet:
                self._begin()
        return self._state == "open"

    def _begin(self):
        # every window gets its OWN directory: parse_trace_dir globs
        # recursively, and a reused cfg.log_dir would fold the previous
        # window's events into this one's report
        log_dir = self.cfg.log_dir
        if log_dir is not None:
            log_dir = os.path.join(
                log_dir, f"window-{os.getpid()}-{next(_WINDOW_SEQ)}")
        self._sync()
        try:
            self._log_dir = start_capture(log_dir, owner=self.owner)
        except RuntimeError as e:
            # someone else owns the profiler: skip this window rather
            # than fight over it
            self.logger.warning("profiling: window skipped: %s", e)
            self._state = "disabled"
            return
        self._t0 = time.perf_counter()
        self._state = "open"
        self._window_steps = 0

    def _sync(self):
        import torch

        device = self.device
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def after_step(self, outputs=None, epoch=None):
        if self._state != "open":
            return 0.0
        self._window_steps += 1
        if self._window_steps < self.cfg.steps:
            return 0.0
        return self._finish(outputs, epoch=epoch)

    def close(self, outputs=None, epoch=None):
        """Force-close an open window (epoch boundary / loop exit). Safe
        to call in any state; returns the window seconds if one closed."""
        if self._state != "open":
            return 0.0
        if self._window_steps == 0:
            # nothing captured: drop the trace, don't publish a 0-step row
            stop_capture()
            self._state = "done"
            return time.perf_counter() - self._t0
        return self._finish(outputs, epoch=epoch)

    # -- window close + publish -----------------------------------------------
    def _finish(self, outputs, epoch=None):
        """Close the window. Returns the FULL observation cost — capture
        wall plus the trace export, parse and report — so the `profile`
        badput bucket prices everything the profiler took from the step
        loop, not just the traced span."""
        del outputs
        # the trace must hold the window's full device time, not its
        # launch prefix
        self._sync()
        log_dir, seconds = stop_capture()
        self._state = "done"
        t_post = time.perf_counter()
        try:
            trace_rows = parse_trace_dir(log_dir)
        except Exception as e:
            self.logger.warning("profiling: trace parse failed: %s", e)
            return seconds + (time.perf_counter() - t_post)
        acct = self.mfu_acct
        report = build_report(
            trace_rows, [], self.layers, steps=self._window_steps,
            window_seconds=seconds,
            audit_rows=getattr(acct, "audit_rows", None),
            flops_per_step=getattr(acct, "flops_per_step", None),
            num_devices=self.num_devices,
            peak_flops=acct.peak_flops if acct is not None
            and getattr(acct, "flops_per_step", None) else None,
            log_dir=log_dir, epoch=epoch)
        self.report = report
        self.publish(report)
        return seconds + (time.perf_counter() - t_post)

    def publish(self, report):
        h = _hub()
        summary = report.to_dict(top_k=self.cfg.top_k)
        h.emit("profile", phase="summary", owner=self.owner, **summary)
        _set_last_summary({"owner": self.owner, **summary})
        if self.cfg.gauges:
            h.gauge("profile_coverage_pct", report.coverage_pct)
            h.gauge("profile_device_ms", report.total_us / 1e3)
            h.gauge("profile_unattributed_ms", report.unattributed_us / 1e3)
            h.gauge("profile_window_seconds", report.window_seconds)
            for layer, us in report.layers.items():
                h.gauge("profile_layer_device_ms", us / 1e3, layer=layer)
            if report.mfu.get("measured_mfu_pct") is not None:
                h.gauge("profile_measured_mfu_pct",
                        report.mfu["measured_mfu_pct"])
        self.logger.info("%s", report.table(top_k=self.cfg.top_k))
        mfu = report.mfu
        if mfu.get("measured_mfu_pct") is not None and \
                mfu.get("modeled_mfu_pct") is not None:
            self.logger.info(
                "profile MFU: measured %.2f%% (device clock) vs modeled "
                "%.2f%% (wall clock), delta %+.2f%%",
                mfu["measured_mfu_pct"], mfu["modeled_mfu_pct"],
                mfu["delta_pct"])
