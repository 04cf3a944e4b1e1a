"""Program accounting, shape padding, and the captured step.

Counterpart of ``mxnet_tpu/utils/compile.py``. The JAX package compiles each
step once per shape with ``jax.jit`` and dispatches the executable many
times; its registry counts the compiles. The port's counterpart of that
compile is a ``torch.cuda.CUDAGraph`` captured once per **program key** and
replayed: the key is the graph's fingerprint, the bucket key, the input
shapes and dtypes, ``compute_dtype``, ``pad_policy.key()`` and train or
eval. :class:`ProgramRegistry` counts a key's first sight as one compile
(``compiles``, and ``misses`` unless a ``precompile`` saw it first) on
every device, and later sights as hits, so
on the CPU, where nothing is captured, its counts can be held to the JAX
package's. On the card it also counts captures, their seconds and the bytes
of the graphs' memory pools, and each step that ran eager with its reason.

:class:`CapturedProgram` is one captured step: warm-up calls run eager on a
side stream, one a device a thread shared by every program (cuDNN's
algorithm search and cuBLAS's workspace happen there),
then the function is captured into a graph, with the generators it draws
from registered, and every later call replays it. :class:`CapturedPair` is
a training forward and its backward captured into two graphs that share a
memory pool (the JAX package's separate ``fwd_res`` and ``bwd`` programs):
what autograd saves stays in the pool between the two replays. The kernel
wrappers count
their launches through :func:`..kernels._common.count_launch`: under capture
the launches go into the program's record, and each replay adds them to the
wrappers' counters, so a replayed step counts what an eager one counts.

``configure_persistent_cache`` keeps its name and its environment variable
(``MXNET_TPU_COMPILE_CACHE``), but nothing of a capture persists: a CUDA
graph lives and dies with its process. The only artifacts that outlive a
process are the kernels' shared libraries, which ``kernels/_common.py``
builds once per source hash. The function reports that and returns None.
The JAX package's AOT executables and persistent-cache counters have no
counterpart here (``persistent_cache_*`` read 0).

Memory plans (``MEMORY_PLAN_FIELDS``, :meth:`ProgramRegistry.
record_memory_plan`, :func:`memory_plan_for`) are recorded at each capture:
``argument_bytes`` are the bytes of the tensors the graph reads (its static
inputs and the state it steps), ``output_bytes`` those of what it returns,
``temp_bytes`` the bytes its memory pool reserved, and ``total_bytes``
temp plus output, the JAX package's rule. Where XLA's ``memory_analysis()``
plans a program before it runs, a CUDA graph's plan exists only after its
capture, its temporaries are the caching allocator's pool rather than a
static buffer assignment, ``generated_code_bytes`` is 0 (the kernels' code
is not the graph's) and ``alias_bytes`` is 0 (in-place writes alias
nothing that a donation would).
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import logging
import os
import threading
import time

import numpy as np
import torch

from ..analysis.lockwatch import named_lock
from ..base import ENV_OFF_VALUES, ENV_ON_VALUES, MXNetError

__all__ = [
    "configure_persistent_cache", "ProgramRegistry", "registry", "compile_stats", "reset_compile_stats",
    "graph_fingerprint", "program_key", "RecompileTracker", "RecompileError",
    "PadPolicy", "CapturedProgram", "CapturedPair", "graphs_enabled",
    "eager_reason", "note_eager", "persistent_cache_dir",
    "maybe_enable_persistent_cache_from_env", "DEFAULT_CACHE_DIR",
    "MEMORY_PLAN_FIELDS", "add_memory_plan_listener", "memory_plan_for",
    "memory_plans", "memory_plan_from_tensors",
]

_OFF_VALUES = ("",) + ENV_OFF_VALUES


# -- 1. the persistent cache: nothing persists -------------------------------

def configure_persistent_cache(cache_dir=None, min_compile_seconds=None):
    """Resolve ``MXNET_TPU_COMPILE_CACHE`` as the JAX package does and
    report what persists: nothing. Captured graphs cannot be saved, and the
    kernels' libraries are kept under ``build/mxnet_tpu_torch`` whatever
    this says. Returns None."""
    del min_compile_seconds
    if cache_dir is None:
        raw = os.environ.get("MXNET_TPU_COMPILE_CACHE", "")
        if raw.strip().lower() in _OFF_VALUES:
            return None
        cache_dir = raw
    logging.info("compile cache %r not used: CUDA graphs do not outlive "
                 "their process; the CUDA kernels' libraries are cached "
                 "under build/mxnet_tpu_torch by source hash", cache_dir)
    return None


DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                                 "mxnet_tpu", "xla_cache")


def persistent_cache_dir():
    """The persistent cache directory in effect: None, as nothing of a
    capture persists (:func:`configure_persistent_cache`), where the JAX
    package returns its compilation cache's directory when one is on."""
    return None


def maybe_enable_persistent_cache_from_env():
    """The JAX package's opt-in at import: resolves
    ``MXNET_TPU_COMPILE_CACHE`` through :func:`configure_persistent_cache`,
    which keeps nothing here. Returns None."""
    if os.environ.get("MXNET_TPU_COMPILE_CACHE", "").strip().lower() \
            in _OFF_VALUES:
        return None
    return configure_persistent_cache()


# -- 2. the program registry --------------------------------------------------

_UNTRACKED = "<untracked>"

# Memory plans: every captured program registers one under its label (the
# fields and order of the JAX package's); the telemetry layer subscribes
# through add_memory_plan_listener to publish them as hub gauges/events.
MEMORY_PLAN_FIELDS = ("argument_bytes", "output_bytes", "temp_bytes",
                      "generated_code_bytes", "alias_bytes", "total_bytes")

_MEMORY_PLAN_LISTENERS: list = []


def add_memory_plan_listener(fn):
    """Register ``fn(label, plan_dict)`` to run whenever a program's memory
    plan is (re)recorded (the telemetry layer's hook)."""
    _MEMORY_PLAN_LISTENERS.append(fn)
    return fn


def _tensor_bytes(tensors) -> int:
    seen, total = set(), 0
    for t in _flat_tensors(tensors):
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def memory_plan_from_tensors(arguments, outputs, temp_bytes) -> dict:
    """A memory plan from what a captured graph reads (``arguments``),
    what it returns (``outputs``; nested lists, tuples and dicts of
    tensors) and the bytes its pool reserved. ``total_bytes`` is temp plus
    output, as the JAX package's ``memory_plan_from_compiled``."""
    plan = {"argument_bytes": _tensor_bytes(arguments),
            "output_bytes": _tensor_bytes(outputs),
            "temp_bytes": int(temp_bytes),
            "generated_code_bytes": 0, "alias_bytes": 0}
    plan["total_bytes"] = plan["temp_bytes"] + plan["output_bytes"]
    return plan


def _label_counters():
    return {"hits": 0, "misses": 0, "aot_hits": 0, "precompiles": 0,
            "compiles": 0, "compile_seconds": 0.0, "captures": 0,
            "capture_seconds": 0.0, "pool_bytes": 0, "replays": 0,
            "signatures": set()}


class ProgramRegistry:
    """Process-wide accounting of programs, by label. ``compiles`` counts
    first sights of a program key, ``misses`` those at a dispatch and
    ``precompiles`` those through a ``precompile``, ``hits`` later ones; ``captures``,
    ``capture_seconds`` and ``pool_bytes`` the CUDA graphs; ``eager`` the
    steps that ran eager, by reason. :meth:`attribute` names the program
    dispatching on this thread (:meth:`current_label`), and
    :meth:`record_call` takes the JAX package's dispatch kinds."""

    def __init__(self):
        self._lock = named_lock("compile.ProgramRegistry")
        self._tls = threading.local()
        self._memory_plans = {}
        self.reset()

    def reset(self):
        with self._lock:
            self._labels = {}
            self._memory_plans = {}
            self._totals = {"hits": 0, "misses": 0, "compiles": 0,
                            "compile_seconds": 0.0,
                            "persistent_cache_hits": 0,
                            "persistent_cache_saved_seconds": 0.0,
                            "captures": 0, "capture_seconds": 0.0,
                            "pool_bytes": 0, "replays": 0}
            self._eager = {}

    # -- label attribution (thread-local) -------------------------------------
    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_label(self):
        """The label of the program dispatching on this thread, or None."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def attribute(self, label):
        """Name the program that work on this thread belongs to."""
        stack = self._stack()
        stack.append(label)
        try:
            yield
        finally:
            stack.pop()

    def record_call(self, label, kind, seconds=0.0, signature=None):
        """One dispatch of ``label``: ``kind`` is ``"hit"``, ``"miss"``,
        ``"aot_hit"`` or ``"precompile"``, as in the JAX package (a
        ``"miss"`` is one compile of ``seconds``)."""
        with self._lock:
            c = self._labels.setdefault(label, _label_counters())
            if kind == "hit":
                c["hits"] += 1
                self._totals["hits"] += 1
            elif kind == "aot_hit":
                c["aot_hits"] += 1
                c["hits"] += 1
                self._totals["hits"] += 1
            elif kind == "miss":
                c["misses"] += 1
                c["compiles"] += 1
                c["compile_seconds"] += seconds
                self._totals["misses"] += 1
                self._totals["compiles"] += 1
                self._totals["compile_seconds"] += seconds
                if signature is not None:
                    c["signatures"].add(signature)
            elif kind == "precompile":
                c["precompiles"] += 1
                if signature is not None:
                    c["signatures"].add(signature)
        if kind == "miss":
            _notify_trackers(label, signature)

    # -- memory plans -----------------------------------------------------------
    def record_memory_plan(self, label, plan):
        """Store a program's memory plan under its label (a re-record
        wins) and notify the plan listeners."""
        plan = dict(plan)
        with self._lock:
            self._memory_plans[label] = plan
        for fn in list(_MEMORY_PLAN_LISTENERS):
            try:
                fn(label, dict(plan))
            except Exception:  # noqa: BLE001 - a sink must not fail a capture
                logging.debug("memory-plan listener failed for %r", label,
                              exc_info=True)

    def memory_plan_for(self, label):
        with self._lock:
            plan = self._memory_plans.get(label)
            return None if plan is None else dict(plan)

    def memory_plans(self):
        with self._lock:
            return {k: dict(v) for k, v in self._memory_plans.items()}

    def snapshot(self):
        """A copy of the totals, for before/after differences."""
        with self._lock:
            return dict(self._totals)

    def compiles_for(self, label):
        with self._lock:
            c = self._labels.get(label)
            return 0 if c is None else c["compiles"]

    def see(self, label, key, seen: set, precompile=False):
        """Count one sight of program ``key`` under ``label`` by an owner
        whose programs ``seen`` holds (a trainer, an executor, a
        predictor: each compiles its own, as each JAX object has its own
        jit cache); True on its first sight (a compile)."""
        with self._lock:
            c = self._labels.setdefault(label, _label_counters())
            first = (label, key) not in seen
            if first:
                seen.add((label, key))
                c["signatures"].add(key)
                c["compiles"] += 1
                self._totals["compiles"] += 1
                if precompile:
                    # ahead of time, as the JAX package's AOT compile: no
                    # dispatch missed a cache
                    c["precompiles"] += 1
                else:
                    c["misses"] += 1
                    self._totals["misses"] += 1
            else:
                c["hits"] += 1
                self._totals["hits"] += 1
        if first:
            _notify_trackers(label, key)
        return first

    def record_capture(self, label, seconds, pool_bytes):
        with self._lock:
            c = self._labels.setdefault(label, _label_counters())
            c["captures"] += 1
            c["capture_seconds"] += seconds
            c["compile_seconds"] += seconds
            c["pool_bytes"] += pool_bytes
            self._totals["captures"] += 1
            self._totals["capture_seconds"] += seconds
            self._totals["compile_seconds"] += seconds
            self._totals["pool_bytes"] += pool_bytes

    def record_replay(self, label):
        with self._lock:
            self._labels.setdefault(label, _label_counters())["replays"] += 1
            self._totals["replays"] += 1

    def record_eager(self, reason):
        """Count one eager run under ``reason``; True at its first."""
        with self._lock:
            first = reason not in self._eager
            self._eager[reason] = self._eager.get(reason, 0) + 1
        return first

    def stats(self):
        with self._lock:
            labels = {k: {**{f: v for f, v in c.items() if f != "signatures"},
                          "programs": len(c["signatures"])}
                      for k, c in self._labels.items()}
            return {**self._totals, "per_function": labels,
                    "eager": dict(self._eager)}

_REGISTRY = ProgramRegistry()


def registry() -> ProgramRegistry:
    """The process-wide :class:`ProgramRegistry`."""
    return _REGISTRY


def compile_stats():
    """The registry's counters: the JAX package's keys (``compiles``,
    ``compile_seconds``, ``misses``, ``hits``, ``per_function``) and the
    port's (``captures``, ``capture_seconds``, ``pool_bytes``,
    ``replays``, ``eager``)."""
    return registry().stats()


def reset_compile_stats():
    registry().reset()


def memory_plan_for(label):
    """The memory plan recorded for ``label``'s captured program, or
    None (nothing captured under it yet)."""
    return registry().memory_plan_for(label)


def memory_plans():
    """Every recorded memory plan, by label."""
    return registry().memory_plans()


def graph_fingerprint(symbol) -> str:
    """The JAX package's identity of a graph: the symbol's JSON (or, for a
    graph that cannot serialize, its topological node names and op types)
    with the fusion and remat settings, hashed; the same digest for the
    same symbol JSON."""
    try:
        graph = symbol.tojson()
    except Exception:  # noqa: BLE001 - _Native nodes hold live objects
        graph = ";".join(
            f"{n.name}:{'var' if n.is_variable else type(n.op).__name__}"
            for n in symbol._topo())
    payload = "|".join([
        graph,
        "fuse=" + os.environ.get("MXNET_TPU_FUSE", "1"),
        "remat=" + os.environ.get("MXNET_TPU_REMAT", ""),
    ])
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def program_key(fingerprint, bucket_key, arrays: dict, compute_dtype,
                pad_policy, train: bool):
    """The identity of one program: what a new capture is needed for."""
    shapes = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                          for k, v in arrays.items()))
    return (fingerprint, bucket_key, shapes, str(compute_dtype),
            None if pad_policy is None else pad_policy.key(),
            "train" if train else "eval")


# -- 3. the recompile guard -----------------------------------------------------

class RecompileError(MXNetError):
    """An armed :class:`RecompileTracker` saw a new program."""


_ACTIVE_TRACKERS: list = []


def _notify_trackers(label, signature):
    for tracker in list(_ACTIVE_TRACKERS):
        tracker._observe(label, signature)


class RecompileTracker:
    """Observes every first sight of a program key. Armed (``arm()`` or as
    a context manager), each one is recorded in ``recompiles``, logged,
    mirrored into a ``Monitor``'s rows when one is given, and raised as
    :class:`RecompileError` with ``raise_on_recompile=True``."""

    def __init__(self, raise_on_recompile=False, logger=None, monitor=None):
        self.raise_on_recompile = raise_on_recompile
        self.logger = logger or logging.getLogger(__name__)
        self.monitor = monitor
        self.recompiles: list = []
        self.armed = False

    def arm(self):
        self.armed = True
        if self not in _ACTIVE_TRACKERS:
            _ACTIVE_TRACKERS.append(self)
        return self

    def disarm(self):
        self.armed = False
        if self in _ACTIVE_TRACKERS:
            _ACTIVE_TRACKERS.remove(self)
        return self

    def __enter__(self):
        return self.arm()

    def __exit__(self, *exc):
        self.disarm()
        return False

    def _observe(self, label, signature):
        if not self.armed:
            return
        self.recompiles.append((label, signature))
        self.logger.warning("RecompileTracker: %r compiled while armed (new "
                            "program: %s) — steady-state shape drift",
                            label, signature)
        if self.monitor is not None:
            sink = getattr(self.monitor, "_recompile_events", None)
            if sink is None:
                sink = self.monitor.queue
            sink.append((getattr(self.monitor, "step", 0),
                         f"recompile/{label}", 1))
        if self.raise_on_recompile:
            raise RecompileError(
                f"recompile of {label!r} while RecompileTracker armed "
                f"(program {signature}); pad tail batches (PadPolicy) or "
                "precompile all shapes up front")

    def assert_no_recompiles(self):
        if self.recompiles:
            raise RecompileError(
                f"{len(self.recompiles)} recompile(s) while armed: "
                + ", ".join(label for label, _ in self.recompiles))


# -- 4. the shape-padding policy ----------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


class PadPolicy:
    """Fold odd shapes into known ones: ``"bucket"`` pads to the batch size
    or bucket (one program a bucket), ``"pow2"`` to the next power of two
    (at most log2 of the largest size programs). ``fit`` pads a short tail
    batch and masks the padded rows out of the loss and the metric;
    ``BucketSentenceIter`` assigns buckets with :meth:`round_length`."""

    MODES = ("bucket", "pow2")

    def __init__(self, mode="bucket"):
        if mode not in self.MODES:
            raise MXNetError(
                f"PadPolicy mode must be one of {self.MODES}, got {mode!r}")
        self.mode = mode

    def __repr__(self):
        return f"PadPolicy(mode={self.mode!r})"

    def key(self):
        """Hashable identity (a component of the program key)."""
        return ("pad_policy", self.mode)

    @classmethod
    def resolve(cls, value):
        """``fit``'s ``pad_policy``: None reads ``MXNET_TPU_PAD_POLICY``
        (unset or off: no policy; on: bucket; else the mode), True is
        bucket, a string names the mode, a PadPolicy is itself."""
        if value is None:
            raw = os.environ.get("MXNET_TPU_PAD_POLICY", "").strip().lower()
            if raw in _OFF_VALUES:
                return None
            value = "bucket" if raw in ENV_ON_VALUES else raw
        if value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        return cls(str(value))

    def round_rows(self, rows: int, target: int) -> int:
        """The padded row count of a batch of ``rows`` for batch size
        ``target``."""
        if rows >= target:
            return rows
        if self.mode == "pow2":
            return min(target, _next_pow2(rows))
        return target

    def round_length(self, length: int, buckets=None):
        """The bucket of a sequence of ``length``: the smallest bucket that
        fits (bucket), or the next power of two, moved up into ``buckets``
        when given (pow2); None when none fits."""
        if self.mode == "pow2":
            target = _next_pow2(length)
            if not buckets:
                return target
            for b in buckets:
                if target <= b:
                    return b
            return None
        if not buckets:
            raise MXNetError("PadPolicy('bucket').round_length needs buckets")
        for b in buckets:
            if length <= b:
                return b
        return None

    def pad_arrays(self, arrays: dict, target_rows: int, pad: int = 0):
        """Pad every array along axis 0 to ``target_rows`` by repeating its
        last row; ``pad`` counts the iterator's wrap-around rows already
        present. Returns ``(arrays, num_valid)``. Takes numpy arrays or
        tensors and returns the same kind."""
        rows = None
        for v in arrays.values():
            shape = getattr(v, "shape", None)
            if shape:
                rows = int(shape[0])
                break
        if rows is None:
            raise MXNetError("pad_arrays: no array inputs to pad")
        num_valid = rows - int(pad)
        extra = int(target_rows) - rows
        if extra <= 0:
            return arrays, num_valid
        out = {}
        for k, v in arrays.items():
            if isinstance(v, torch.Tensor):
                out[k] = v if v.dim() == 0 or v.shape[0] != rows else \
                    torch.cat([v, v[-1:].expand(extra, *v.shape[1:])])
                continue
            a = np.asarray(v)
            if a.ndim == 0 or a.shape[0] != rows:
                out[k] = v
                continue
            out[k] = np.concatenate([a, np.repeat(a[-1:], extra, axis=0)],
                                    axis=0)
        return out, num_valid


# -- 5. the captured step -----------------------------------------------------

def graphs_enabled() -> bool:
    """``MXTPU_CUDA_GRAPHS``: on unless set to an off value (0), which runs
    every step eager so that captured and eager runs compare in one
    process."""
    return os.environ.get("MXTPU_CUDA_GRAPHS", "1").strip().lower() \
        not in ENV_OFF_VALUES


def eager_reason(device, native=False):
    """Why a program on ``device`` runs eager, or None when it is captured:
    the cases every captured entry point shares, in the order they are
    checked (``native``: the graph holds a ``_Native`` node). A fit adds
    its own (``FeedForward._eager_reason``)."""
    if device.type != "cuda":
        return "cpu context"
    if native:
        return "a _Native node (numpy on the host)"
    if not graphs_enabled():
        return "MXTPU_CUDA_GRAPHS=0"
    return None


def _record_on(tensors, stream):
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            t.record_stream(stream)


def _flat_tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _flat_tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _flat_tensors(v)]
    return []


_SIDE = threading.local()


def _side_stream(device):
    """The side stream this thread's programs on ``device`` warm up and
    capture on: one a device a thread, shared by every program, as
    ``torch.cuda.graph`` shares one capture stream. The caching allocator
    keeps what a stream freed for that stream alone, and PyTorch keeps a
    cuBLAS workspace for each handle and stream it sees (32 MiB on Hopper)
    for the process's life: with a stream a program, a long run held some
    50 workspaces on 30 streams, and a program's warm-up could not reuse
    the blocks the others had freed (it ran out of memory with 63.5 GB of
    the card reserved and idle)."""
    device = torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    if index not in streams:
        streams[index] = torch.cuda.Stream(index)
    return streams[index]


def _on_side(side, device, fn, *args):
    """``fn(*args)`` eager on the side stream ``side``, ordered after and
    before the current stream's work; its outputs are marked used on the
    current stream."""
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn(*args)
    cur.wait_stream(side)
    _record_on(_flat_tensors(out), cur)
    return out


def _capture(device, side, steps):
    """Capture each ``(graph, fn)`` of ``steps`` in turn on ``side`` (one
    memory pool for all of them), ``fn`` called with the list of the
    earlier functions' outputs. Returns each function's output,
    each graph's launch record, the seconds taken and the bytes the
    graphs' pool reserved.

    Garbage from earlier programs is collected first and the collector
    held off during the captures: a CUDA graph destroyed while another is
    being captured invalidates that capture (torch no longer collects
    before a capture by default). The capture empties the allocator's
    cache first; so do we, so that what is reserved after it is the
    graphs' pool."""
    from ..kernels import _common

    cur = torch.cuda.current_stream(device)
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(device)
    pool = torch.cuda.graph_pool_handle()
    outs, records = [], []
    t0 = time.perf_counter()
    side.wait_stream(cur)
    gc.disable()
    try:
        for graph, fn in steps:
            with _common.capture_launches() as counts:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    outs.append(fn(outs))
            records.append(dict(counts))
    finally:
        gc.enable()
    cur.wait_stream(side)
    seconds = time.perf_counter() - t0
    return (outs, records, seconds,
            max(0, torch.cuda.memory_reserved(device) - before))


def _graph(generators=()):
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    return graph


def _replay(graph, launch_counts, label):
    graph.replay()
    for fn, n in launch_counts.items():
        fn.launches += n
    registry().record_replay(label)


class CapturedProgram:
    """One step function ``fn()`` (no arguments: it reads static buffers
    and writes its results into them or returns them) captured into a CUDA
    graph on ``device``.

    The first ``warmup`` calls run ``fn`` eager on a side stream; the next
    captures it (each generator in ``generators`` registered with the
    graph, so every replay draws what the eager call would) and replays
    it; every later call replays. The outputs of the capture are the
    graph's static outputs, overwritten by each replay. Each program has
    a memory pool of its own. ``launch_counts`` holds the kernel launches
    the graph holds, added to the wrappers' counters at each replay. A
    graph holds raw pointers: every buffer ``fn`` reads must stay
    referenced for as long as the program lives. ``inputs`` (tensors, or a
    callable giving them) are what the graph reads, for its memory plan,
    recorded at the capture under ``label``."""

    def __init__(self, fn, device, label, warmup=1, generators=(),
                 inputs=()):
        self.fn, self.device, self.label = fn, torch.device(device), label
        self.warmup, self.generators = int(warmup), list(generators)
        self.inputs = inputs
        self.graph = None
        self.outputs = None
        self.calls = 0
        self.launch_counts = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._side = _side_stream(self.device)

    @property
    def captured(self):
        return self.graph is not None

    def capture(self):
        """Capture the graph now (``fn`` does not run)."""
        graph = _graph(self.generators)
        (out,), (counts,), self.capture_seconds, self.pool_bytes = _capture(
            self.device, self._side, [(graph, lambda _: self.fn())])
        self.graph, self.outputs, self.launch_counts = graph, out, counts
        registry().record_capture(self.label, self.capture_seconds,
                                  self.pool_bytes)
        inputs = self.inputs() if callable(self.inputs) else self.inputs
        registry().record_memory_plan(self.label, memory_plan_from_tensors(
            inputs, out, self.pool_bytes))
        return out

    def replay(self):
        _replay(self.graph, self.launch_counts, self.label)
        return self.outputs

    def __call__(self):
        self.calls += 1
        if self.graph is None:
            if self.calls <= self.warmup:
                return _on_side(self._side, self.device, self.fn)
            self.capture()
        return self.replay()


class CapturedPair:
    """A training forward and its backward over bound tensors, captured
    into two CUDA graphs that share one memory pool, in the manner of
    ``torch.cuda.make_graphed_callables``.

    ``forward()`` takes no arguments (it reads static buffers, writes the
    auxiliary states in place) and returns the outputs autograd
    differentiates; ``backward(outputs)`` runs autograd from them, reading
    a static head-gradient buffer the caller fills, and writes the
    gradients into static buffers; it keeps the autograd graph
    (``retain_graph``), so one forward may be followed by several
    backwards. The first ``warmup`` forwards (and the backwards after
    them) run eager on a side stream; the next forward captures both
    graphs: the forward's keeps what autograd saves in the pool, where the
    backward's reads it. Then every forward and backward replays. The
    captured outputs are overwritten by each forward replay. Launches and
    replays are counted as :class:`CapturedProgram` counts them, under
    ``labels`` (forward, backward), and each label gets a memory plan
    (``inputs``: what the pair reads, as :class:`CapturedProgram`'s; the
    pool is split between the two, as the capture seconds are)."""

    def __init__(self, forward, backward, device, labels, warmup=1,
                 generators=(), inputs=()):
        self.forward, self.backward = forward, backward
        self.inputs = inputs
        self.device = torch.device(device)
        self.labels = tuple(labels)
        self.warmup, self.generators = int(warmup), list(generators)
        self.graphs = None
        self.outputs = None
        self.calls = 0
        self.launch_counts = ({}, {})
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self._eager_outs = None
        self._side = _side_stream(self.device)

    @property
    def captured(self):
        return self.graphs is not None

    def capture(self):
        """Capture both graphs now (neither function runs)."""
        self._eager_outs = None  # the warm-up's autograd graph
        graphs = (_graph(self.generators), _graph())
        # the backward captured from the forward's outputs: what autograd
        # saved stays referenced through them, in the pool it reads
        (outs, _), counts, self.capture_seconds, self.pool_bytes = _capture(
            self.device, self._side,
            [(graphs[0], lambda _: self.forward()),
             (graphs[1], lambda done: self.backward(done[0]))])
        self.graphs, self._graph_outs = graphs, outs
        self.outputs = [o.detach() for o in outs]
        self.launch_counts = tuple(counts)
        inputs = self.inputs() if callable(self.inputs) else self.inputs
        for label, out in zip(self.labels, (self.outputs, ())):
            registry().record_capture(label, self.capture_seconds / 2,
                                      self.pool_bytes // 2)
            registry().record_memory_plan(label, memory_plan_from_tensors(
                inputs, out, self.pool_bytes // 2))
        return self.outputs

    def run_forward(self):
        """The forward: eager during warm-up, else a replay (capturing
        first). Returns the outputs."""
        self.calls += 1
        if self.graphs is None:
            if self.calls <= self.warmup:
                self._eager_outs = _on_side(self._side, self.device,
                                            self.forward)
                return [o.detach() for o in self._eager_outs]
            self.capture()
        _replay(self.graphs[0], self.launch_counts[0], self.labels[0])
        return self.outputs

    def run_backward(self):
        """The backward of the last forward: eager after an eager forward,
        else a replay."""
        if self.graphs is None:
            if self._eager_outs is None:
                raise MXNetError("backward before a forward")
            _on_side(self._side, self.device, self.backward,
                     self._eager_outs)
            return
        _replay(self.graphs[1], self.launch_counts[1], self.labels[1])


def note_eager(reason, logger=None):
    """Count one eager run under ``reason`` and log it: a fit, a
    ``predict`` or ``score`` call, a ``Predictor``'s program (at its first
    request) or an ``Executor.precompile``."""
    registry().record_eager(reason)
    (logger or logging).info("steps run eager: %s", reason)
