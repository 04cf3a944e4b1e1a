"""Wire-byte accounting: comm plans, the process registry, and the
collective tables of a compiled program or a profiled one.

Counterpart of ``mxnet_tpu/comm/stats.py``. Three sources of the same
rows:

  1. **Plan arithmetic** (:func:`allreduce_plan`, :func:`overlap_plan`):
     exact from shapes, with the ring-algorithm wire factors

         all-reduce          2·(n-1)/n · payload
         all-gather          (n-1)/n · output bytes
         reduce-scatter      (n-1)/n · input bytes
         all-to-all          (n-1)/n · payload
         collective-permute  1 · payload

  2. **The CommRegistry**: per-program plans and per-step counters behind
     ``comm_stats()``.

  3. **The collectives that ran.** ``hlo_collective_table`` and its
     companions are the JAX package's parsers of compiled HLO text, copied
     (``stats.py:243-470``): pure text, no JAX. Their torch counterparts
     (:func:`collective_table`, :func:`collective_rows`,
     :func:`collective_wire_bytes`, :func:`elementwise_table`,
     :func:`quantize_pass_count`) read a ``torch.profiler`` trace into the
     same rows under the same factors.

Where a profiled row's dtype and element count come from: the profiler
gives gloo's collectives (``c10d::allgather_``, ``c10d::alltoall_base_``)
their shapes but not their dtypes (a TensorList argument has an empty
``Input type``), and the port sends every payload as raw bytes anyway.
So each collective of ``comm/allreduce.py`` opens a ``record_function``
range named ``comm.collective:<op>:<dtype>:<elements>:<group size>``
while the profiler runs (:func:`collective_range`): the payload's own
dtype in the HLO spelling and the elements of the collective's result,
as the HLO result shape counts them (an all-gather's whole gathered
buffer, an all-to-all's every row). A gloo rank and a ``ReplicaGroup``
call record one range a call, as one SPMD program holds one instruction.
The port sends an int8 payload's codes and scales as two collectives
where the compiled reference may send one tuple, so its counts can be
larger while each op's payload and wire bytes are the same.
"""

from __future__ import annotations

import contextlib
import json
import re
import threading

import torch

from .compression import CompressionSpec, payload_nbytes, quantization_unit
from ..analysis.lockwatch import named_lock

__all__ = ["allreduce_plan", "overlap_plan", "fp32_allreduce_wire_bytes",
           "CommRegistry", "registry", "comm_stats", "reset_comm_stats",
           "hlo_collective_table", "hlo_collective_rows",
           "hlo_collective_wire_bytes",
           "hlo_elementwise_table", "hlo_quantize_pass_count",
           "collective_range", "collective_rows", "collective_table",
           "collective_wire_bytes", "elementwise_table",
           "quantize_pass_count"]


def fp32_allreduce_wire_bytes(num_elements: int, axis_size: int) -> float:
    """Ring all-reduce wire cost of the uncompressed baseline."""
    n = int(axis_size)
    return 2.0 * (n - 1) / n * 4.0 * int(num_elements)


def allreduce_plan(num_elements: int, axis_size: int,
                   compression=None) -> dict:
    """Exact per-step comm plan for one fused gradient allreduce.

    Returns ``{"collectives": [rows], "payload_bytes", "wire_bytes",
    "fp32_wire_bytes", "ratio", ...}`` where each row is
    ``{"op", "count", "payload_bytes", "wire_bytes"}`` and ``ratio`` is
    fp32-wire / this-wire (>1 = the compression saves bytes).
    """
    n = int(axis_size)
    L = int(num_elements)
    spec = CompressionSpec.resolve(compression)
    fp32_wire = fp32_allreduce_wire_bytes(L, n)
    if spec is None:
        rows = [{"op": "all-reduce", "count": 1, "payload_bytes": 4 * L,
                 "wire_bytes": fp32_wire}]
        mode = "none"
    else:
        unit = quantization_unit(spec) * n
        Lp = -(-L // unit) * unit
        per = Lp // n
        p1 = payload_nbytes(spec, Lp)             # stage-1 rows, all ranks
        gspec = CompressionSpec("bf16") if spec.mode == "twobit" else spec
        p2 = payload_nbytes(gspec, per)           # stage-2 reduced shard
        rows = [
            {"op": "all-to-all", "count": 1, "payload_bytes": p1,
             "wire_bytes": (n - 1) / n * p1},
            {"op": "all-gather", "count": 1, "payload_bytes": n * p2,
             "wire_bytes": (n - 1) * p2},
        ]
        mode = spec.mode
    payload = sum(r["payload_bytes"] for r in rows)
    wire = sum(r["wire_bytes"] for r in rows)
    return {
        "mode": mode, "num_elements": L, "axis_size": n,
        "collectives": rows, "payload_bytes": payload, "wire_bytes": wire,
        "fp32_wire_bytes": fp32_wire,
        "ratio": fp32_wire / wire if wire else float("inf"),
    }


def overlap_plan(bucket_elems, axis_size, compression=None) -> dict:
    """Exact per-step comm plan of an overlapped per-bucket schedule.

    ``bucket_elems``: ``[(bucket_name, num_elements), ...]`` in schedule
    order (``OverlapPlan.bucket_elems()``). Each bucket gets its own
    :func:`allreduce_plan`; the merged rows sum the integer payload bytes
    first and apply the wire factor to the sum, so, payload bytes being
    linear in the padded length, the totals equal the fused plan over the
    same padded total exactly (``matches_fused``). The padding slack is
    ``padded_elements - num_elements``."""
    n = int(axis_size)
    spec = CompressionSpec.resolve(compression)
    buckets = [{"bucket": name, **allreduce_plan(num, n, spec)}
               for name, num in bucket_elems]
    merged: dict = {}
    for b in buckets:
        for r in b["collectives"]:
            row = merged.setdefault(r["op"], {"op": r["op"], "count": 0,
                                              "payload_bytes": 0})
            row["count"] += r["count"]
            row["payload_bytes"] += r["payload_bytes"]
    raw_total = sum(int(num) for _, num in bucket_elems)
    if spec is None:
        padded_total = raw_total
        for row in merged.values():
            row["wire_bytes"] = 2.0 * (n - 1) / n * row["payload_bytes"]
    else:
        unit = quantization_unit(spec) * n
        padded_total = sum(-(-int(num) // unit) * unit
                           for _, num in bucket_elems)
        # both compressed rows carry (n-1)/n of their payload on the wire
        for row in merged.values():
            row["wire_bytes"] = (n - 1) / n * row["payload_bytes"]
    rows = sorted(merged.values(), key=lambda r: r["op"])
    payload = sum(r["payload_bytes"] for r in rows)
    wire = sum(r["wire_bytes"] for r in rows)
    fused = allreduce_plan(padded_total, n, spec)
    fp32_wire = fp32_allreduce_wire_bytes(raw_total, n)
    return {
        "mode": "none" if spec is None else spec.mode,
        "num_elements": raw_total, "padded_elements": padded_total,
        "axis_size": n, "num_buckets": len(buckets), "buckets": buckets,
        "collectives": rows, "payload_bytes": payload, "wire_bytes": wire,
        "fp32_wire_bytes": fp32_wire,
        "ratio": fp32_wire / wire if wire else float("inf"),
        "fused_wire_bytes": fused["wire_bytes"],
        "matches_fused": wire == fused["wire_bytes"],
    }


class CommRegistry:
    """Per-program comm plans + per-step wire counters (thread-safe)."""

    def __init__(self):
        self._lock = named_lock("comm.CommRegistry")
        self.reset()

    def reset(self):
        with self._lock:
            self._plans = {}
            self._steps = {}
            self._extra_bytes = {"sent": 0.0, "received": 0.0}

    def register_plan(self, label: str, plan: dict):
        with self._lock:
            self._plans[label] = dict(plan)
            self._steps.setdefault(label, 0)

    def record_step(self, label: str, count: int = 1):
        """One (or ``count``) dispatches of ``label``'s per-step plan."""
        with self._lock:
            self._steps[label] = self._steps.get(label, 0) + int(count)

    def record_host_bytes(self, sent=0, received=0):
        """Fold host-transport traffic (kvstore sockets) into the totals."""
        with self._lock:
            self._extra_bytes["sent"] += int(sent)
            self._extra_bytes["received"] += int(received)

    def snapshot(self) -> dict:
        """Totals for before/after differences (epoch logs)."""
        with self._lock:
            steps = sum(self._steps.values())
            wire = sum(self._steps.get(k, 0) * p["wire_bytes"]
                       for k, p in self._plans.items())
            fp32 = sum(self._steps.get(k, 0) * p["fp32_wire_bytes"]
                       for k, p in self._plans.items())
            host = self._extra_bytes["sent"] + self._extra_bytes["received"]
            return {"steps": steps, "wire_bytes": wire + host,
                    "fp32_wire_bytes": fp32, "host_bytes": host}

    def stats(self) -> dict:
        with self._lock:
            per = {}
            for label, plan in self._plans.items():
                steps = self._steps.get(label, 0)
                per[label] = {**plan, "steps": steps,
                              "total_wire_bytes": steps * plan["wire_bytes"]}
            steps = sum(self._steps.values())
            wire = sum(c["total_wire_bytes"] for c in per.values())
            fp32 = sum(self._steps.get(k, 0) * p["fp32_wire_bytes"]
                       for k, p in self._plans.items())
            host = dict(self._extra_bytes)
            return {
                "steps": steps,
                "wire_bytes": wire + host["sent"] + host["received"],
                "collective_wire_bytes": wire,
                "fp32_wire_bytes": fp32,
                "ratio": (fp32 / wire) if wire else None,
                "host_bytes": host,
                "per_program": per,
            }


_REGISTRY = None
_REGISTRY_LOCK = threading.Lock()


def registry() -> CommRegistry:
    """The process's registry, created at first use."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        if _REGISTRY is None:
            _REGISTRY = CommRegistry()
        return _REGISTRY


def comm_stats() -> dict:
    """Process-wide wire accounting (see CommRegistry)."""
    return registry().stats()


def reset_comm_stats():
    registry().reset()


# -- HLO extraction ------------------------------------------------------------

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
                "f32": 4, "s32": 4, "u32": 4,
                "f64": 8, "s64": 8, "u64": 8}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# "%name = <result-shape> <opcode>(..." — result shape may be a tuple;
# async variants appear as <opcode>-start (skip -done: same traffic)
_INSTR_RE = re.compile(
    r"=\s*(\([^)]*\)|\S+)\s+(" + "|".join(_COLLECTIVES) + r")(-start)?\(")
_SHAPE_RE = re.compile(r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|"
                       r"u64)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_FULL_GROUPS_RE = re.compile(r"replica_groups=(\{\{.*?\}\})")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _typed_shapes(shape_str: str) -> list:
    """Every ``dtype[dims]`` token in a result shape as
    ``{"dtype", "elements", "bytes"}`` — one entry per tuple member."""
    parts = []
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        n = 1
        for d in filter(None, dims.split(",")):
            n *= int(d)
        parts.append({"dtype": dtype, "elements": n,
                      "bytes": n * _DTYPE_BYTES[dtype]})
    return parts


def _replica_groups(line: str, default: int):
    """``(num_groups, group_size)`` of an instruction's replica groups;
    ``num_groups`` is ``None`` when the HLO names no groups (then
    ``group_size`` is the caller's default)."""
    m = _FULL_GROUPS_RE.search(line)
    if m:
        text = m.group(1)
        first = _GROUPS_RE.search(line)
        ids = [g for g in first.group(1).split(",") if g.strip()] \
            if first else []
        size = max(len(ids), 1)
        return max(text.count("{") - 1, 1), size
    m = _IOTA_GROUPS_RE.search(line)
    if m:  # iota form [num_groups, group_size]<=[...]
        return max(int(m.group(1)), 1), max(int(m.group(2)), 1)
    return None, default


def _group_size(line: str, default: int) -> int:
    return _replica_groups(line, default)[1]


def _wire_bytes(op: str, result_bytes: int, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "all-gather":          # result is the full gathered buffer
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":      # result is one shard; input was n shards
        return float((n - 1) * result_bytes)
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    return float(result_bytes)      # collective-permute


def _table(rows) -> list:
    """Per-instance rows merged by op (counts, summed bytes and elements,
    sorted dtypes and group shapes), largest wire first."""
    by_op: dict = {}
    for r in rows:
        row = by_op.setdefault(r["op"], {
            "op": r["op"], "count": 0, "payload_bytes": 0,
            "wire_bytes": 0.0, "elements": 0, "dtypes": set(),
            "replica_groups": set()})
        row["count"] += 1
        row["payload_bytes"] += r["payload_bytes"]
        row["wire_bytes"] += r["wire_bytes"]
        row["elements"] += sum(p["elements"] for p in r["parts"])
        row["dtypes"].update(p["dtype"] for p in r["parts"])
        row["replica_groups"].add(r["replica_groups"])
    for row in by_op.values():
        row["dtypes"] = sorted(row["dtypes"])
        row["replica_groups"] = sorted(
            row["replica_groups"], key=lambda g: (g[0] is None, g))
    return sorted(by_op.values(), key=lambda r: -r["wire_bytes"])


def hlo_collective_rows(hlo_text: str, default_group_size: int = 1) -> list:
    """Per-INSTANCE collective rows from compiled HLO — the detailed form
    the MX802 reconciliation (analysis/sharding.py) audits.

    Each row: ``{"op", "async", "payload_bytes", "wire_bytes",
    "group_size", "replica_groups", "parts"}`` where ``replica_groups``
    is ``(num_groups, group_size)`` (``num_groups`` None when the HLO
    names no groups) and ``parts`` is the per-dtype payload breakdown
    ``[{"dtype", "elements", "bytes"}, ...]`` — one part per tuple member
    for combined collectives, exactly the logical payload member for
    async ``-start`` halves (``-done`` halves are skipped).
    """
    rows = []
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        is_async = bool(m.group(3))
        if is_async and shape_str.startswith("("):
            # async -start: result is a tuple aliasing operand and result
            # buffers; the op's logical result is the LARGEST member
            # (== result for all-gather, == either for all-reduce) except
            # for reduce-scatter, whose result is the small shard
            members = _typed_shapes(shape_str)
            if members:
                pick = min if op == "reduce-scatter" else max
                parts = [pick(members, key=lambda p: p["bytes"])]
                payload = parts[0]["bytes"]
            else:
                parts = []
                payload = _shape_bytes(shape_str) // 2
        else:
            parts = _typed_shapes(shape_str)
            payload = _shape_bytes(shape_str)
        num_groups, n = _replica_groups(line, default_group_size)
        rows.append({
            "op": op, "async": is_async, "payload_bytes": payload,
            "wire_bytes": _wire_bytes(op, payload, n),
            "group_size": n, "replica_groups": (num_groups, n),
            "parts": parts,
        })
    return rows


def hlo_collective_table(hlo_text: str, default_group_size: int = 1) -> list:
    """Parse compiled HLO into per-opcode collective byte rows.

    Each row: ``{"op", "count", "payload_bytes", "wire_bytes"}`` — payload
    is the summed result-shape bytes of every instance; wire applies the
    ring factors above with the instruction's replica-group size
    (``default_group_size`` when the HLO names no groups). ``-start``
    async variants count once; ``-done`` halves are skipped. Also carries
    the per-collective detail: ``"elements"`` (summed
    payload element count), ``"dtypes"`` (sorted payload dtypes), and
    ``"replica_groups"`` (sorted distinct ``(num_groups, group_size)``
    shapes) — aggregated from :func:`hlo_collective_rows`.
    """
    return _table(hlo_collective_rows(hlo_text, default_group_size))


def hlo_collective_wire_bytes(hlo_text: str,
                              default_group_size: int = 1) -> float:
    """Total wire bytes of every collective in a compiled HLO module."""
    return sum(r["wire_bytes"] for r in
               hlo_collective_table(hlo_text, default_group_size))


# -- elementwise-pass extraction ----------------------------------------------
# The encode/decode cost the fused comm kernels (ops/pallas/comm_kernels)
# exist to remove shows up in HLO as full-slab elementwise instructions:
# each quantize stage is a chain of round/clamp/divide/... ops whose
# result covers the whole gradient slab. Counting instructions at or
# above a slab-sized element threshold measures exactly that — the
# kernel path's quantize math lives inside per-BLOCK kernel bodies, so
# its instructions stay under the threshold and the full-slab count
# drops (asserted by tests/test_pallas_kernels.py and --kernel-bench).

_GENERIC_INSTR_RE = re.compile(
    r"=\s*((?:pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64)"
    r"\[[\d,]*\])\S*\s+([a-z][a-z0-9-]*)\(")

# the opcodes a quantize/dequantize stage is made of
_QUANTIZE_OPS = frozenset({
    "round-nearest-even", "round-nearest-afz", "clamp", "divide",
    "multiply", "abs", "maximum", "minimum",
})


def _shape_elems(shape_str: str) -> int:
    m = _SHAPE_RE.match(shape_str)
    if not m:
        return 0
    n = 1
    for d in filter(None, m.group(2).split(",")):
        n *= int(d)
    return n


def hlo_elementwise_table(hlo_text: str, min_elements: int = 0,
                          ops=None) -> list:
    """Per-opcode counts of (large) elementwise-shaped HLO instructions.

    Each row: ``{"op", "count", "elements"}`` for instructions whose
    result holds at least ``min_elements`` elements; ``ops`` restricts to
    an opcode set (default: every matched opcode). Fusion-computation
    bodies count too — a pass is a pass wherever XLA parked it."""
    by_op: dict[str, dict] = {}
    for line in hlo_text.splitlines():
        m = _GENERIC_INSTR_RE.search(line)
        if not m:
            continue
        shape_str, op = m.group(1), m.group(2)
        if ops is not None and op not in ops:
            continue
        elems = _shape_elems(shape_str)
        if elems < min_elements:
            continue
        row = by_op.setdefault(op, {"op": op, "count": 0, "elements": 0})
        row["count"] += 1
        row["elements"] += elems
    return sorted(by_op.values(), key=lambda r: (-r["count"], r["op"]))


def hlo_quantize_pass_count(hlo_text: str, min_elements: int) -> int:
    """How many full-slab quantize-shaped passes a compiled module runs:
    the encode/decode HLO op-count metric the fused comm kernels are
    measured by (lower is better; the wire bits are identical)."""
    return sum(r["count"] for r in
               hlo_elementwise_table(hlo_text, min_elements,
                                     ops=_QUANTIZE_OPS))


# -- the profiled collectives --------------------------------------------------

COLLECTIVE_PREFIX = "comm.collective:"

# torch dtype -> its HLO spelling
_HLO_DTYPE = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
              torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int16: "s16", torch.float32: "f32", torch.int32: "s32",
              torch.float64: "f64", torch.int64: "s64"}


def collective_range(op: str, dtype, elements: int, group_size: int):
    """A ``record_function`` range naming one collective, while a profiler
    runs in the process (a no-op context otherwise): ``op`` in the HLO
    vocabulary, the payload's ``dtype``, the ``elements`` of the
    collective's result and the group's size. The overlapped schedule
    issues its buckets from a thread of its own, which a profiler records
    only when it is made with ``experimental_config=torch._C._profiler.
    _ExperimentalConfig(profile_all_threads=True)``."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(
        f"{COLLECTIVE_PREFIX}{op}:{_HLO_DTYPE[dtype]}:{int(elements)}:"
        f"{int(group_size)}")


def _trace_events(trace):
    """``(name, input shapes, thread, start, end)`` of every host-side
    event of ``trace``: a ``torch.profiler.profile``, a chrome trace it
    exported (a path, or the loaded dict)."""
    if hasattr(trace, "events"):
        out = []
        for e in trace.events():
            if e.device_type != torch.autograd.DeviceType.CPU:
                continue
            out.append((e.name, list(e.input_shapes or []), e.thread,
                        e.time_range.start, e.time_range.end))
        return out
    if isinstance(trace, (str, bytes)) or hasattr(trace, "__fspath__"):
        with open(trace) as f:
            trace = json.load(f)
    out = []
    for e in trace.get("traceEvents", []):
        # host ranges and ops only: a gpu_user_annotation repeats its range
        if e.get("ph") != "X" or e.get("cat") not in ("user_annotation",
                                                     "cpu_op"):
            continue
        start = float(e["ts"])
        out.append((e["name"], e.get("args", {}).get("Input Dims") or [],
                    e.get("tid"), start, start + float(e.get("dur", 0.0))))
    return out


def collective_rows(trace, default_group_size: int = 1) -> list:
    """One row a profiled collective, in :func:`hlo_collective_rows`'s
    form: ``{"op", "async", "payload_bytes", "wire_bytes", "group_size",
    "replica_groups", "parts"}``, with ``replica_groups`` ``(1, n)`` (one
    group of the range's size; ``default_group_size`` where a range names
    none)."""
    rows = []
    events = sorted(_trace_events(trace), key=lambda e: e[3])
    for name, _shapes, _tid, _t0, _t1 in events:
        if not name.startswith(COLLECTIVE_PREFIX):
            continue
        fields = name[len(COLLECTIVE_PREFIX):].split(":")
        op, dtype, elements = fields[0], fields[1], int(fields[2])
        n = int(fields[3]) if len(fields) > 3 and fields[3] \
            else int(default_group_size)
        payload = elements * _DTYPE_BYTES[dtype]
        rows.append({
            "op": op, "async": False, "payload_bytes": payload,
            "wire_bytes": _wire_bytes(op, payload, n),
            "group_size": n, "replica_groups": (1, n),
            "parts": [{"dtype": dtype, "elements": elements,
                       "bytes": payload}],
        })
    return rows


def collective_table(trace, default_group_size: int = 1) -> list:
    """Per-op rows of a profiled program, as :func:`hlo_collective_table`
    gives them: ``{"op", "count", "payload_bytes", "wire_bytes",
    "elements", "dtypes", "replica_groups"}``, largest wire first."""
    return _table(collective_rows(trace, default_group_size))


def collective_wire_bytes(trace, default_group_size: int = 1) -> float:
    """Total wire bytes of every profiled collective."""
    return sum(r["wire_bytes"] for r in
               collective_table(trace, default_group_size))


# aten op -> the HLO opcode of the same elementwise pass
_ATEN_ELEMENTWISE = {
    "round": "round-nearest-even", "clamp": "clamp", "clamp_min": "clamp",
    "clamp_max": "clamp", "div": "divide", "mul": "multiply", "abs": "abs",
    "maximum": "maximum", "minimum": "minimum",
}


def _aten_opcode(name: str):
    if not name.startswith("aten::"):
        return None
    base = name[len("aten::"):]
    if base.endswith("_") and not base.endswith("__"):
        base = base[:-1]  # the in-place form is the same pass
    return _ATEN_ELEMENTWISE.get(base)


def _elements(shapes) -> int:
    """The elements of an op's result: its largest input (elementwise ops
    broadcast to it)."""
    best = 0
    for shape in shapes:
        if isinstance(shape, (list, tuple)) and shape and \
                all(isinstance(d, int) for d in shape):
            n = 1
            for d in shape:
                n *= d
            best = max(best, n)
    return best


def elementwise_table(trace, min_elements: int = 0, ops=None) -> list:
    """Per-opcode counts of the profiled elementwise passes over at least
    ``min_elements`` elements, as :func:`hlo_elementwise_table` counts
    HLO instructions: rows ``{"op", "count", "elements"}``, ``op`` the HLO
    opcode of the aten op (``round`` -> ``round-nearest-even``, ``div`` ->
    ``divide``, ``mul`` -> ``multiply``, ``clamp``, ``abs``,
    ``maximum``, ``minimum``; in-place forms count as theirs). ``ops``
    restricts to a set of those opcodes. An op run inside another counted
    op is not counted again. Needs a trace taken with
    ``record_shapes=True``."""
    by_op: dict = {}
    stacks: dict = {}
    for name, shapes, tid, t0, t1 in sorted(_trace_events(trace),
                                            key=lambda e: (e[3], -e[4])):
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1] <= t0:
            stack.pop()
        op = _aten_opcode(name)
        if op is None or stack:
            continue
        if ops is not None and op not in ops:
            continue
        elems = _elements(shapes)
        if elems < min_elements:
            continue
        stack.append(t1)
        row = by_op.setdefault(op, {"op": op, "count": 0, "elements": 0})
        row["count"] += 1
        row["elements"] += elems
    return sorted(by_op.values(), key=lambda r: (-r["count"], r["op"]))


def quantize_pass_count(trace, min_elements: int) -> int:
    """How many slab-sized quantize-shaped passes a profiled program ran
    as torch operations (the counterpart of
    :func:`hlo_quantize_pass_count`): the codec path's full-slab passes,
    which the fused comm kernels replace."""
    return sum(r["count"] for r in
               elementwise_table(trace, min_elements, ops=_QUANTIZE_OPS))
