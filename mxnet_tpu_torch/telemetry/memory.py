"""Memory observability: memory plans, live-array ledger, OOM preflight.

The port's counterpart of ``mxnet_tpu/telemetry/memory.py``. The telemetry
stack observes *time* exhaustively (spans, MFU, goodput, traces, flight
recorder) — this module is the *bytes* side, the replacement for the
reference's storage-manager stats and ``GraphExecutor::Print``'s "Total N
MB allocated" line. Four cooperating pieces:

  **Memory plans** — every captured CUDA graph registers its plan
  (argument / output / temp bytes, the temporaries being its memory
  pool's) in the compile ProgramRegistry, keyed by the same program label
  as the compile stats (utils/compile.py). This module
  subscribes to those recordings and exports each plan as labeled hub
  gauges (``memory_plan_*_bytes{program=...}``) plus a ``memory_plan``
  event, so the Prometheus dump and the JSONL stream both answer "how many
  bytes does this program need" without re-lowering anything.
  ``plan_table()`` renders the ``--jaxpr-table``-style console table; the
  CLI twin is ``python -m mxnet_tpu_torch.telemetry mem run.jsonl``.

  **Live-array ledger** — :func:`track_arrays` installs a weakref hook on
  NDArray creation: every live NDArray tensor is accounted by bytes /
  count / device type with O(1) add and GC-callback removal, maintaining a
  continuous high watermark. The StepTimeline samples the ledger at phase
  boundaries into hub gauges (``live_array_bytes``,
  ``live_array_watermark_bytes``); :func:`epoch_mark` closes each epoch's
  watermark window and runs the leak detector — a watermark that drifts up
  ``MXNET_TPU_MEM_LEAK_EPOCHS`` consecutive epochs by more than
  ``MXNET_TPU_MEM_LEAK_BYTES`` emits a ``memory_leak`` hub event (an
  incident kind: it lands in the flight recorder's incident ring).
  Everything is host-side bookkeeping over shapes/dtypes — no device ops,
  no new program inputs, so the captured steps stay as they are with
  tracking on. The trainer's own parameters are tensors, not NDArrays:
  the ledger sees what a user holds as NDArrays, as in the JAX package.

  **OOM preflight** — before ``fit`` commits, sum the resident state
  (params + optimizer state + aux + EF residuals) plus the largest
  registered program's temp+output bytes against :func:`hbm_budget`
  (``MXNET_TPU_HBM_BYTES``, else the card's ``bytes_limit``) and fail fast
  with a ranked largest-allocations report (:class:`MemoryPreflightError`)
  instead of a mid-epoch OOM. A program's plan exists only once it was
  captured (the JAX package's AOT plans exist before the first step), so
  the first fit of a trainer checks the resident state alone, and a later
  fit of the same trainer adds its captured programs' plans; a budget of
  the card's own limit is therefore armed on the card and never refuses a
  fit whose state fits.

  **Forensics** — :func:`forensics_snapshot` packages the allocator stats,
  the ledger (with top live arrays), and the top program plans; the flight
  recorder embeds it in every dump and ``flight show`` renders it.

Everything here imports only stdlib + the hub + utils/compile (the owner
of the plan schema); other framework modules are imported lazily so any
layer can use it without cycles.
"""

from __future__ import annotations

import logging
import os
import weakref

from ..analysis.lockwatch import named_lock, named_rlock
from ..base import MXNetError
from ..utils.compile import MEMORY_PLAN_FIELDS as PLAN_FIELDS
from .hub import hub as _hub, on_hub_create

__all__ = [
    "PLAN_FIELDS", "plans", "plan_table", "publish_plan", "install",
    "ArrayLedger", "ledger", "track_arrays", "tracking_enabled",
    "sample", "attach_sampler", "detach_sampler",
    "epoch_mark", "reset_leak_tracker",
    "MemoryPreflightError", "hbm_budget", "named_bytes", "largest_plan",
    "program_step_bytes", "preflight_entries", "preflight",
    "forensics_snapshot",
]

_OFF_VALUES = ("", "0", "off", "false", "no")

_MB = float(1 << 20)


# -- static memory plans -------------------------------------------------------

def plans():
    """All registered per-program memory plans ({label: plan dict}) — the
    compile ProgramRegistry is the owner; this is a read-through."""
    from ..utils import compile as compile_mod

    return compile_mod.registry().memory_plans()


def publish_plan(label, plan, h=None, emit=True):
    """Export one program's plan as labeled hub gauges (+ one
    ``memory_plan`` event unless ``emit=False`` — the re-publish after a
    hub reset must not duplicate the event stream)."""
    h = h or _hub()
    fields = {f: int(plan.get(f, 0)) for f in PLAN_FIELDS}
    for field, value in fields.items():
        h.gauge(f"memory_plan_{field}", value, program=label)
    if emit:
        h.emit("memory_plan", program=label, **fields)


def plan_table(plan_map=None) -> str:
    """``--jaxpr-table``-style console table of the registered plans,
    largest program first (MB; total = temp + output)."""
    plan_map = plans() if plan_map is None else plan_map
    if not plan_map:
        return "no memory plans registered (AOT-compile via precompile())"
    lines = [f"{'program':<48s} {'args MB':>9s} {'out MB':>8s} "
             f"{'temp MB':>9s} {'total MB':>9s}"]
    rows = sorted(plan_map.items(),
                  key=lambda kv: -kv[1].get("total_bytes", 0))
    for label, plan in rows:
        name = label if len(label) <= 48 else label[:45] + "..."
        lines.append(
            f"{name:<48s} {plan.get('argument_bytes', 0) / _MB:9.3f} "
            f"{plan.get('output_bytes', 0) / _MB:8.3f} "
            f"{plan.get('temp_bytes', 0) / _MB:9.3f} "
            f"{plan.get('total_bytes', 0) / _MB:9.3f}")
    total = sum(p.get("total_bytes", 0) for p in plan_map.values())
    lines.append(f"{len(plan_map)} program(s), "
                 f"{total / _MB:.3f} MB total planned (temp+output)")
    return "\n".join(lines)


_INSTALLED = False


def install():
    """Wire the plan pipeline: compile-registry recordings publish hub
    gauges + events, and a fresh hub (telemetry.reset()) gets every known
    plan re-published as gauges. Idempotent; called at telemetry import."""
    global _INSTALLED
    if _INSTALLED:
        return
    _INSTALLED = True
    from ..utils import compile as compile_mod

    compile_mod.add_memory_plan_listener(
        lambda label, plan: publish_plan(label, plan))

    def _republish(h):
        try:
            for label, plan in plans().items():
                publish_plan(label, plan, h=h, emit=False)
        except Exception:  # a gauge re-publish must never break hub()
            logging.debug("memory-plan republish failed", exc_info=True)

    on_hub_create(_republish)


# -- live-array ledger ---------------------------------------------------------

class ArrayLedger:
    """Weakref accounting of live NDArray device buffers.

    ``add`` is called from ``NDArray.__init__`` (only while tracking is
    enabled — see :func:`track_arrays`): one weakref + one locked dict
    insert, with a GC callback decrementing on collection. Shape and dtype
    are frozen at registration (NDArray's mutation facade rebinds values
    but never shape/dtype), so byte accounting needs no device syncs —
    everything is host-side metadata. The high watermark is maintained
    continuously on add; :meth:`reset_watermark` closes a window (the
    per-epoch leak detector's unit)."""

    def __init__(self):
        # RLock: a GC cycle collected while THIS thread holds the lock
        # (e.g. the dict insert in add() triggers collection of a tracked
        # NDArray) runs _on_dead synchronously on the same thread — a
        # plain Lock would self-deadlock inside NDArray.__init__
        self._lock = named_rlock("telemetry.memory.ArrayLedger")
        # buffer-keyed accounting: NDArray(existing) / same-device
        # as_in_context share ONE tensor — counting wrappers would
        # double-book the buffer and fake watermark drift. Keyed by
        # id(buffer); safe against id reuse because an entry only lives
        # while some wrapper holds the buffer alive.
        self._bufs = {}  # id(data) -> [wrapper_refs, shape, dtype, nbytes,
                         #              platform]
        self._refs = set()  # keeps wrapper weakrefs alive: a dropped
                            # weakref object never fires its callback
        self.total_bytes = 0
        self.total_count = 0
        self.watermark_bytes = 0

    def add(self, arr):
        try:
            data = arr._data
            buf_id = id(data)
            shape = tuple(data.shape)
            dtype = str(data.dtype).replace("torch.", "")
            nbytes = int(data.numel()) * int(data.element_size())
        except Exception:  # pragma: no cover - exotic buffer types
            return
        try:
            ref = weakref.ref(arr, self._make_callback(buf_id))
        except TypeError:  # pragma: no cover - non-weakrefable subclass
            return
        with self._lock:
            self._refs.add(ref)
            entry = self._bufs.get(buf_id)
            if entry is not None:  # another wrapper of the same buffer
                entry[0] += 1
                return
            try:
                platform = data.device.type
            except Exception:
                platform = "unknown"
            self._bufs[buf_id] = [1, shape, str(dtype), nbytes, platform]
            self.total_bytes += nbytes
            self.total_count += 1
            if self.total_bytes > self.watermark_bytes:
                self.watermark_bytes = self.total_bytes

    def _make_callback(self, buf_id):
        def _on_dead(ref):
            with self._lock:
                self._refs.discard(ref)
                entry = self._bufs.get(buf_id)
                if entry is None:
                    return
                entry[0] -= 1
                if entry[0] > 0:
                    return
                del self._bufs[buf_id]
                self.total_bytes -= entry[3]
                self.total_count -= 1
        return _on_dead

    # -- queries --------------------------------------------------------------
    def live_bytes(self):
        return self.total_bytes

    def stats(self):
        with self._lock:
            by_platform = {}
            for _, _, _, nbytes, platform in self._bufs.values():
                row = by_platform.setdefault(platform,
                                             {"bytes": 0, "count": 0})
                row["bytes"] += nbytes
                row["count"] += 1
            return {"live_bytes": self.total_bytes,
                    "live_count": self.total_count,
                    "watermark_bytes": self.watermark_bytes,
                    "by_platform": by_platform}

    def top_arrays(self, n=10):
        """The ``n`` largest live buffers: [{bytes, shape, dtype,
        platform}] — the "name" a framework without named storage can
        give (the ranked-allocations half of the forensics story)."""
        with self._lock:
            entries = sorted(self._bufs.values(), key=lambda e: -e[3])[:n]
        return [{"bytes": nbytes, "shape": list(shape), "dtype": dtype,
                 "platform": platform}
                for _, shape, dtype, nbytes, platform in entries]

    def reset_watermark(self):
        with self._lock:
            self.watermark_bytes = self.total_bytes
        return self.watermark_bytes

    def clear(self):
        with self._lock:
            self._bufs.clear()
            self._refs.clear()
            self.total_bytes = self.total_count = 0
            self.watermark_bytes = 0


_LEDGER = ArrayLedger()


def ledger() -> ArrayLedger:
    """The process-wide live-array ledger."""
    return _LEDGER


def track_arrays(enable=True):
    """Enable/disable NDArray creation tracking. Returns the previous
    state so callers (fit) can restore it. Disabled costs the NDArray hot
    path one module-global None check."""
    from .. import ndarray as ndarray_mod

    prev = ndarray_mod._LEDGER is not None
    ndarray_mod._LEDGER = _LEDGER if enable else None
    return prev


def tracking_enabled():
    from .. import ndarray as ndarray_mod

    return ndarray_mod._LEDGER is not None


# -- phase-boundary sampler ----------------------------------------------------

def sample(span=None):
    """Publish the ledger's current state as hub gauges. Installed as the
    StepTimeline's phase-boundary sampler (see :func:`attach_sampler`);
    host-side reads only — nothing touches a program key."""
    del span
    h = _hub()
    led = _LEDGER
    h.gauge("live_array_bytes", led.total_bytes)
    h.gauge("live_array_count", led.total_count)
    h.gauge("live_array_watermark_bytes", led.watermark_bytes)


def attach_sampler():
    """Install :func:`sample` as the timeline's phase-boundary hook."""
    from . import timeline as timeline_mod

    timeline_mod._MEM_SAMPLER = sample


def detach_sampler():
    from . import timeline as timeline_mod

    timeline_mod._MEM_SAMPLER = None


# -- epoch watermarks + leak detector ------------------------------------------

_LEAK_LOCK = named_lock("telemetry.memory.leak")
_EPOCH_MARKS: list = []   # (epoch, watermark_bytes)
_LEAK_STREAK = [0]


def reset_leak_tracker():
    """Start a fresh watermark history (fit calls this per run)."""
    with _LEAK_LOCK:
        _EPOCH_MARKS.clear()
        _LEAK_STREAK[0] = 0
    _LEDGER.reset_watermark()


def epoch_mark(epoch, drift_bytes=None, consecutive=None, logger=None):
    """Close the epoch's watermark window: emit a ``memory_watermark``
    event, compare against the previous epoch's watermark, and raise a
    ``memory_leak`` hub event (incident-ringed by the flight recorder)
    when the watermark has drifted UP for ``consecutive`` epochs in a row
    by more than ``drift_bytes`` each (env overrides
    ``MXNET_TPU_MEM_LEAK_BYTES`` / ``MXNET_TPU_MEM_LEAK_EPOCHS``).
    Steady-state training rewrites the same buffers every step, so a
    monotonically climbing watermark is a leak, not a workload."""
    if drift_bytes is None:
        drift_bytes = int(float(
            os.environ.get("MXNET_TPU_MEM_LEAK_BYTES", str(1 << 20))))
    if consecutive is None:
        consecutive = int(
            os.environ.get("MXNET_TPU_MEM_LEAK_EPOCHS", "2"))
    led = _LEDGER
    stats = led.stats()
    mark = stats["watermark_bytes"]
    h = _hub()
    h.emit("memory_watermark", epoch=int(epoch), watermark_bytes=mark,
           live_bytes=stats["live_bytes"], live_count=stats["live_count"])
    h.gauge("epoch_watermark_bytes", mark)
    leak = None
    with _LEAK_LOCK:
        if _EPOCH_MARKS:
            drift = mark - _EPOCH_MARKS[-1][1]
            _LEAK_STREAK[0] = _LEAK_STREAK[0] + 1 \
                if drift > drift_bytes else 0
            if _LEAK_STREAK[0] >= consecutive:
                leak = {"epoch": int(epoch), "drift_bytes": int(drift),
                        "epochs": int(_LEAK_STREAK[0]),
                        "watermark_bytes": int(mark)}
        _EPOCH_MARKS.append((int(epoch), mark))
    if leak is not None:
        h.emit("memory_leak", **leak)
        (logger or logging).warning(
            "memory: live-array watermark drifted up %d consecutive "
            "epoch(s) (+%.2f MB last epoch, watermark %.2f MB) — "
            "epoch-over-epoch growth in steady state is a leak",
            leak["epochs"], leak["drift_bytes"] / _MB, mark / _MB)
    led.reset_watermark()
    return leak


# -- OOM preflight -------------------------------------------------------------

class MemoryPreflightError(MXNetError):
    """The preflight sum exceeds the HBM budget — raised BEFORE any step
    runs, with the ranked largest-allocations report in the message."""


def hbm_budget():
    """Per-device memory budget in bytes: ``MXNET_TPU_HBM_BYTES`` (0/off
    disables), else the card's ``bytes_limit`` (``utils.memory``; 0 on the
    CPU → no budget → preflight is a no-op). Returns None when no budget
    resolves."""
    raw = os.environ.get("MXNET_TPU_HBM_BYTES", "").strip().lower()
    if raw not in _OFF_VALUES:
        try:
            budget = int(float(raw))
            return budget if budget > 0 else None
        except ValueError:
            logging.warning("MXNET_TPU_HBM_BYTES=%r is not a byte count; "
                            "ignoring", raw)
            return None
    if raw in ("0", "off", "false", "no"):
        return None
    try:
        from ..utils.memory import memory_stats

        limits = [row.get("bytes_limit", 0)
                  for row in memory_stats().values()]
        budget = max(limits) if limits else 0
        return budget or None
    except Exception:
        return None


def _flatten_with_path(tree, path=()):
    """(path, leaf) pairs in the JAX package's tree order: dict keys
    sorted, path entries written as its key reprs (``['w']``, ``[0]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (f"[{i}]",))
    elif tree is not None:
        yield path, tree


def _leaf_bytes(leaf):
    import numpy as np

    numel = getattr(leaf, "numel", None)
    if callable(numel) and hasattr(leaf, "element_size"):
        return int(numel()) * int(leaf.element_size())
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return None
    return int(np.prod(shape, dtype=np.int64)) * \
        int(np.dtype(dtype).itemsize)


def named_bytes(tree, prefix):
    """Flatten a tree (dicts, lists, tuples) of tensors or arrays into
    [(name, bytes)] entries, names derived from the tree paths, as the
    JAX package names them (``prefix['key']``) — preflight's input."""
    out = []
    for i, (path, leaf) in enumerate(_flatten_with_path(tree)):
        nbytes = _leaf_bytes(leaf)
        if nbytes is None:
            continue
        key = "".join(path) if path else f"[{i}]"
        out.append((f"{prefix}{key}", nbytes))
    return out


def program_step_bytes(plan):
    """What running this program costs BEYOND the resident state: temp +
    output bytes minus the aliased bytes (0 for a captured graph, which
    writes the resident state in place)."""
    return max(int(plan.get("total_bytes", 0))
               - int(plan.get("alias_bytes", 0)), 0)


def largest_plan(prefixes=("train_step:",), labels=None):
    """(label, plan) of the largest registered program (by
    :func:`program_step_bytes`), picked from explicit ``labels`` when
    given, else from labels starting with any of ``prefixes``. Returns
    (None, None) when nothing matches."""
    best_label, best = None, None
    plan_map = plans()
    candidates = labels if labels is not None else [
        label for label in plan_map
        if any(label.startswith(p) for p in prefixes)]
    for label in candidates:
        plan = plan_map.get(label)
        if plan is None:
            continue
        if best is None or program_step_bytes(plan) > \
                program_step_bytes(best):
            best_label, best = label, plan
    return best_label, best


def preflight_entries(params, opt_state, aux, *, resid=None, ndev=1,
                      plan_label=None, plan=None):
    """The shared entry builder for fit's and precompile's gates: named
    resident-state bytes (params + optimizer state + aux), the EF
    residual's PER-DEVICE share (the (ndev, Lp) ledger is P("dp")
    row-sharded — one row per device, and the budget is per-device), and
    the largest program's step bytes (temp+output net of donation
    aliasing)."""
    entries = (named_bytes(params, "param:")
               + named_bytes(opt_state, "opt_state:")
               + named_bytes(aux, "aux:"))
    if resid is not None:
        ndev = max(int(ndev), 1)
        entries += [(name, nbytes // ndev)
                    for name, nbytes in named_bytes(resid, "ef_residual:")]
    if plan is not None:
        entries.append((f"program temp+output: {plan_label}",
                        program_step_bytes(plan)))
    return entries


def preflight(entries, budget=None, *, what="fit", logger=None,
              raise_on_exceed=True, top_n=15):
    """Check summed ``entries`` ([(name, bytes)]) against ``budget``.

    Publishes ``memory_preflight_total_bytes``/``_budget_bytes`` gauges
    and a ``memory_preflight`` event either way. Over budget: raise
    :class:`MemoryPreflightError` carrying the ranked largest-allocations
    report (or return the report dict with ``fits=False`` when
    ``raise_on_exceed`` is off). ``budget=None`` resolves via
    :func:`hbm_budget`; still-None skips the gate (report only)."""
    if budget is None:
        budget = hbm_budget()
    entries = [(str(n), int(b)) for n, b in entries if b]
    total = sum(b for _, b in entries)
    ranked = sorted(entries, key=lambda e: -e[1])
    fits = budget is None or total <= budget
    h = _hub()
    h.gauge("memory_preflight_total_bytes", total)
    if budget is not None:
        h.gauge("memory_preflight_budget_bytes", budget)
    h.emit("memory_preflight", what=str(what), total_bytes=total,
           budget_bytes=budget, fits=bool(fits))
    report = {"what": str(what), "total_bytes": total,
              "budget_bytes": budget, "fits": bool(fits),
              "entries": ranked}
    if fits:
        if budget is not None:
            (logger or logging).info(
                "memory preflight (%s): %.2f MB of %.2f MB budget "
                "(%d allocation(s))", what, total / _MB, budget / _MB,
                len(entries))
        return report
    lines = [f"memory preflight ({what}): {total / _MB:.2f} MB needed "
             f"exceeds the {budget / _MB:.2f} MB HBM budget "
             f"(MXNET_TPU_HBM_BYTES / backend bytes_limit). "
             f"Largest allocations:"]
    for name, nbytes in ranked[:top_n]:
        lines.append(f"  {nbytes / _MB:10.3f} MB  {name}")
    if len(ranked) > top_n:
        rest = sum(b for _, b in ranked[top_n:])
        lines.append(f"  {rest / _MB:10.3f} MB  "
                     f"(+{len(ranked) - top_n} smaller allocations)")
    message = "\n".join(lines)
    if raise_on_exceed:
        raise MemoryPreflightError(message)
    (logger or logging).warning("%s", message)
    return report


# -- forensics -----------------------------------------------------------------

def forensics_snapshot(top_arrays=8, top_plans=8):
    """JSON-serializable memory snapshot for flight-recorder dumps:
    allocator stats, the live-array ledger (with the largest arrays), and
    the largest registered program plans. Every section degrades to
    absence instead of failing the dump."""
    snap = {"tracking": False}
    try:
        snap["tracking"] = bool(tracking_enabled())
    except Exception:
        pass
    try:
        from ..utils.memory import memory_stats

        snap["allocator"] = memory_stats()
    except Exception:
        pass
    try:
        led = _LEDGER
        snap["ledger"] = led.stats()
        snap["top_arrays"] = led.top_arrays(top_arrays)
    except Exception:
        pass
    try:
        rows = sorted(plans().items(),
                      key=lambda kv: -kv[1].get("total_bytes", 0))
        snap["plans"] = {label: plan for label, plan in rows[:top_plans]}
    except Exception:
        pass
    return snap
