"""The sharding audit: a data-parallel step's collectives against its plan.

Counterpart of ``mxnet_tpu/analysis/sharding.py``. The comm layer prices
every step's wire traffic in closed form (``comm.allreduce_plan``,
``comm.overlap_plan``); this pass checks that the collectives a step
really issues are the plan's:

  MX802  collective-set drift: the collectives reconcile EXACTLY (element
         totals per op kind and payload dtype) against the plan; every
         unplanned all-gather / all-to-all / collective-permute /
         reduce-scatter is named, and unplanned all-reduces are allowed
         only below a small-payload threshold (the step's loss, metric,
         guard and health scalars)
  MX804  degenerate partition specs over the port's mesh
         (``parallel.mesh``): an axis the mesh does not have, or a batch
         unsharded under dp > 1

over two kinds of evidence:

- **HLO text** (:func:`audit_collective_drift`): a compiled program's
  collectives, read by the ``hlo_*`` parsers of ``comm.stats``, so the
  JAX package's compiled exchange audits here with the JAX package's
  findings and reconciliation rows.
- **The port's own steps** (:func:`audit_profiled_drift`,
  :func:`audit_step_program`): one step run under ``torch.profiler``
  (every thread, so the overlapped schedule's comm thread is seen), its
  collectives read from the ``comm.collective:<op>:<dtype>:<elements>:<n>``
  ranges ``comm/allreduce.py`` opens (``comm.stats.collective_rows``).
  The port sends an int8 payload's codes and scales as two collectives
  where the plan counts one tuple: the element totals reconcile as they
  are, and the doubled instance counts are a named note of the report
  (``report.reconciliation["notes"]``), never a finding. A step that
  averages its float auxiliary states (``_GradSync.aux``: BatchNorm's
  running statistics under compression) issues one f32 all-reduce of them
  a step; the gate passes their element count (``aux_elements``) and it
  reconciles as a planned row, where the JAX package leaves it to the
  small-all-reduce allowance (ROADMAP C.2).

MX801 (large replicated intermediates) and MX803 (collectives inside
``scan``/``while`` bodies) read a jaxpr, and are JAX-only (ROADMAP C.2):
the port's step is a sequence of calls with no sharding constraint and no
loop body, and a collective issued once a loop iteration is one profiled
instance each time, so its elements land in MX802's totals.

Entry points: :func:`audit_step_program`, :func:`audit_collective_drift`,
:func:`audit_profiled_drift`, and the ``fit``/``precompile``
``shard_audit=`` gate (env ``MXNET_TPU_SHARD_AUDIT``), which audits one
step of each program before any real step runs; :func:`selfcheck_report`
audits the repo's own full-stack step over eight replicas.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .rules import Finding, get_rule

__all__ = ["ShardAuditReport", "expected_collectives",
           "audit_collective_drift", "audit_profiled_drift",
           "check_partition_specs", "audit_step_program",
           "shard_audit_enabled", "selfcheck_report", "profile_step",
           "DEFAULT_SMALL_ALLREDUCE_BYTES", "DEFAULT_MIN_REPLICATED_BYTES"]

# unplanned all-reduces at or below this payload are the step's own
# bookkeeping scalars (loss, metric, health, guard flags) — anything
# larger is the fp32 gradient sync sneaking back
DEFAULT_SMALL_ALLREDUCE_BYTES = 64 * 1024
# the JAX package's MX801 threshold (MX801 is JAX-only here)
DEFAULT_MIN_REPLICATED_BYTES = 1 << 20

# dtypes a CPU backend's HLO normalizes to f32 on the wire (allow_widen)
_WIDEN_TO_F32 = ("bf16", "f16")

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1,
                "bf16": 2, "f16": 2, "s16": 2, "u16": 2,
                "f32": 4, "s32": 4, "u32": 4,
                "f64": 8, "s64": 8, "u64": 8}

_UNPLANNED_ERROR_OPS = ("all-gather", "all-to-all", "collective-permute",
                        "reduce-scatter")

JAX_ONLY_NOTE = ("MX801/MX803 skipped: they read a jaxpr (large replicated "
                 "intermediates, collectives in scan/while bodies); the "
                 "port's step has neither, and MX802 prices every "
                 "collective instance it issues (ROADMAP C.2)")


@dataclass
class ShardAuditReport:
    """One audit's findings plus the evidence they were judged on."""

    findings: list = field(default_factory=list)
    table: list = field(default_factory=list)        # collective table
    reconciliation: dict = field(default_factory=dict)  # MX802 evidence
    notes: list = field(default_factory=list)        # skipped sub-checks

    @property
    def errors(self):
        return [f for f in self.findings if f.is_error]

    def merged_with(self, other: "ShardAuditReport") -> "ShardAuditReport":
        return ShardAuditReport(
            findings=self.findings + other.findings,
            table=self.table or other.table,
            reconciliation=self.reconciliation or other.reconciliation,
            notes=self.notes + other.notes)


def shard_audit_enabled(value=None) -> bool:
    """Resolve the runtime gate: an explicit argument wins; otherwise the
    ``MXNET_TPU_SHARD_AUDIT`` env var ('' / '0' / 'false' / 'off' = off)."""
    if value is not None:
        return bool(value)
    env = os.environ.get("MXNET_TPU_SHARD_AUDIT", "").strip().lower()
    return env not in ("", "0", "false", "off", "no")


# -- MX802: collective-set drift ----------------------------------------------

def expected_collectives(plan, compression=None) -> list:
    """Decompose a closed-form comm plan into per-(op, dtype) element
    groups — the exact shape the collectives must reconcile against
    (mxnet_tpu/analysis/sharding.py:expected_collectives).

    ``plan`` is an ``allreduce_plan``/``overlap_plan`` dict.
    ``compression`` (spec/str/None) supplies the quantization chunk size;
    when omitted it is re-resolved from ``plan['mode']``.

    Rows: ``{"op", "dtype", "elements", "bytes"}``: stage 1 is one
    all-to-all per payload key (int8: the s8 codes plus one f32 scale per
    chunk), stage 2 one all-gather per key of the reduced shard (twobit
    gathers in bf16). Their payload bytes are checked equal to the plan's
    own rows.
    """
    from ..comm.compression import CompressionSpec, quantization_unit

    mode = plan.get("mode", "none")
    spec = CompressionSpec.resolve(compression)
    if spec is None and mode != "none":
        spec = CompressionSpec.resolve(mode)
    if spec is not None and spec.mode != mode:
        raise ValueError(
            f"expected_collectives: compression mode {spec.mode!r} does "
            f"not match plan mode {mode!r}")
    n = int(plan["axis_size"])
    groups: dict = {}

    def add(op, dtype, elems):
        if elems:
            groups[(op, dtype)] = groups.get((op, dtype), 0) + int(elems)

    for b in (plan.get("buckets") or [plan]):
        L = int(b["num_elements"])
        if spec is None:
            add("all-reduce", "f32", L)
            continue
        unit = quantization_unit(spec) * n
        Lp = -(-L // unit) * unit
        if spec.mode == "bf16":
            add("all-to-all", "bf16", Lp)
            add("all-gather", "bf16", Lp)
        elif spec.mode == "int8":
            add("all-to-all", "s8", Lp)
            add("all-to-all", "f32", Lp // spec.chunk)
            add("all-gather", "s8", Lp)
            add("all-gather", "f32", Lp // spec.chunk)
        elif spec.mode == "twobit":
            add("all-to-all", "u8", Lp // 4)
            add("all-gather", "bf16", Lp)
        else:  # pragma: no cover - CompressionSpec validates modes
            raise ValueError(f"unknown compression mode {spec.mode!r}")

    rows = [{"op": op, "dtype": dt, "elements": el,
             "bytes": el * _DTYPE_BYTES[dt]}
            for (op, dt), el in sorted(groups.items())]
    by_op: dict = {}
    for r in rows:
        by_op[r["op"]] = by_op.get(r["op"], 0) + r["bytes"]
    plan_by_op = {r["op"]: int(r["payload_bytes"])
                  for r in plan["collectives"]}
    if by_op != plan_by_op:  # pragma: no cover - decomposition invariant
        raise RuntimeError(
            f"expected_collectives decomposition drifted from the plan: "
            f"{by_op} != {plan_by_op}")
    return rows


def _reconcile(inst_rows, plan, expected, *, allow_widen,
               small_allreduce_bytes):
    """MX802 over per-instance collective rows (HLO or profiled):
    ``(findings, matched, widened, stat_rows, unplanned)``."""
    if small_allreduce_bytes is None:
        small_allreduce_bytes = DEFAULT_SMALL_ALLREDUCE_BYTES
    groups: dict = {}
    for r in inst_rows:
        for p in r["parts"]:
            g = groups.setdefault((r["op"], p["dtype"]),
                                  {"elements": 0, "count": 0})
            g["elements"] += p["elements"]
            g["count"] += 1

    findings: list = []
    matched: list = []
    widened: list = []
    remaining = {k: dict(v) for k, v in groups.items()}
    rule = get_rule("MX802")

    def settle(op, dtype, exp_elems, got, via=None):
        """One expected group against the group it resolved to; at most
        one finding."""
        got_elems = got["elements"]
        entry = {"op": op, "dtype": dtype, "expected_elements": exp_elems,
                 "hlo_elements": got_elems, "hlo_dtype": via or dtype,
                 "instances": got["count"]}
        if got_elems == exp_elems:
            (widened if via else matched).append(entry)
            return
        extra = got_elems - exp_elems
        if op == "all-reduce" and extra > 0 and \
                extra * _DTYPE_BYTES[dtype] <= small_allreduce_bytes:
            # the step's bookkeeping scalars in the same (op, dtype) group
            # as a planned all-reduce — same wire, accounted
            entry["stat_elements"] = extra
            (widened if via else matched).append(entry)
            return
        findings.append(Finding(
            rule,
            f"planned {op} ({dtype}) expects {exp_elems} elements but the "
            f"compiled program moves {got_elems} "
            f"({got['count']} instance(s)"
            + (f", lowered as {via}" if via else "") + ")",
            node=f"{op}:{dtype}", extra=entry))

    unresolved = []
    for e in expected:
        got = remaining.pop((e["op"], e["dtype"]), None)
        if got is not None:
            settle(e["op"], e["dtype"], e["elements"], got)
        else:
            unresolved.append(e)
    for e in unresolved:
        got = via = None
        if allow_widen and e["dtype"] in _WIDEN_TO_F32:
            got = remaining.pop((e["op"], "f32"), None)
            via = "f32"
        if got is not None:
            settle(e["op"], e["dtype"], e["elements"], got, via=via)
        else:
            findings.append(Finding(
                rule,
                f"planned {e['op']} ({e['dtype']}, {e['elements']} "
                f"elements) is missing from the compiled program — the "
                f"planned collective never lowered (compression dropped, "
                f"or the plan describes a different program)",
                node=f"{e['op']}:{e['dtype']}", extra=dict(e)))

    stat_rows: list = []
    unplanned: list = []
    for (op, dtype), g in sorted(remaining.items()):
        nbytes = g["elements"] * _DTYPE_BYTES[dtype]
        entry = {"op": op, "dtype": dtype, "elements": g["elements"],
                 "bytes": nbytes, "instances": g["count"]}
        if op == "all-reduce" and nbytes <= small_allreduce_bytes:
            stat_rows.append(entry)
            continue
        unplanned.append(entry)
        findings.append(Finding(
            rule,
            f"unplanned {op}: {dtype}[{g['elements']}] "
            f"({nbytes} payload bytes, {g['count']} instance(s)) has no "
            f"counterpart in the comm plan"
            + ("" if op in _UNPLANNED_ERROR_OPS
               else " and exceeds the small-all-reduce allowance"),
            node=f"{op}:{dtype}", extra=entry))
    return findings, matched, widened, stat_rows, unplanned


def audit_collective_drift(hlo_text, plan, *, compression=None,
                           default_group_size=None, allow_widen=True,
                           small_allreduce_bytes=None):
    """MX802: reconcile a compiled program's collective set (its HLO text)
    against its closed-form plan. Returns ``(findings, report_dict)``, as
    the JAX package's pass does on the same text.

    Reconciliation is per (op kind, payload dtype) ELEMENT totals — robust
    to a compiler splitting or combining collectives, and to a CPU
    backend's bf16-to-f32 payload normalization (``allow_widen``; each
    accepted widening lands in ``report["widened"]``). Unplanned
    all-reduces at or below ``small_allreduce_bytes`` are ``stat_rows``;
    everything else unplanned, and every planned group that is missing or
    moves the wrong element count, is a finding.
    """
    from ..comm.stats import hlo_collective_rows, hlo_collective_table

    n = int(default_group_size or plan["axis_size"])
    expected = expected_collectives(plan, compression)
    findings, matched, widened, stat_rows, unplanned = _reconcile(
        hlo_collective_rows(hlo_text, n), plan, expected,
        allow_widen=allow_widen, small_allreduce_bytes=small_allreduce_bytes)
    report = {
        "expected": expected,
        "table": hlo_collective_table(hlo_text, n),
        "matched": matched,
        "widened": widened,
        "stat_rows": stat_rows,
        "unplanned": unplanned,
        "axis_size": n,
        "plan_wire_bytes": plan["wire_bytes"],
    }
    return findings, report


def _instance_notes(table, plan, steps, mode):
    """Where the profiled instance counts differ from the plan's while the
    bytes agree: int8's codes and scales go as two collectives where the
    plan counts one tuple. Each such op is one note row."""
    planned = {r["op"]: r for r in plan["collectives"]}
    notes = []
    for row in table:
        want = planned.get(row["op"])
        if want is None or row["count"] == steps * int(want["count"]) \
                or row["payload_bytes"] != steps * int(want["payload_bytes"]):
            continue
        notes.append({
            "note": ("int8 codes and scales as two collectives"
                     if mode == "int8" and
                     row["count"] == 2 * steps * int(want["count"])
                     else "instance count differs from the plan"),
            "op": row["op"], "plan_count": steps * int(want["count"]),
            "profiled_count": row["count"],
            "payload_bytes": row["payload_bytes"],
            "plan_payload_bytes": steps * int(want["payload_bytes"]),
            "wire_bytes": row["wire_bytes"],
            "plan_wire_bytes": steps * float(want["wire_bytes"])})
    return notes


def audit_profiled_drift(trace, plan, *, compression=None,
                         default_group_size=None, allow_widen=True,
                         small_allreduce_bytes=None, aux_elements=0,
                         steps=1):
    """MX802 over the collectives of ``steps`` profiled steps of the
    port's program (``trace``: a ``torch.profiler.profile`` or its
    exported chrome trace), each range ``comm.stats.collective_rows``
    reads an instance. ``aux_elements``: the float auxiliary states one
    step averages over the members (one f32 all-reduce a step), a planned
    row. Returns ``(findings, report_dict)`` with the HLO form's keys,
    plus ``notes``: ops whose instance counts differ from the plan's
    (int8's codes and scales), each with its payload and wire bytes
    beside the plan's."""
    from ..comm.stats import collective_rows, collective_table

    n = int(default_group_size or plan["axis_size"])
    expected = [dict(e, elements=e["elements"] * steps,
                     bytes=e["bytes"] * steps)
                for e in expected_collectives(plan, compression)]
    if aux_elements:
        aux = steps * int(aux_elements)
        for e in expected:
            if (e["op"], e["dtype"]) == ("all-reduce", "f32"):
                e["elements"] += aux
                e["bytes"] += 4 * aux
                break
        else:
            expected.append({"op": "all-reduce", "dtype": "f32",
                             "elements": aux, "bytes": 4 * aux})
    findings, matched, widened, stat_rows, unplanned = _reconcile(
        collective_rows(trace, n), plan, expected,
        allow_widen=allow_widen, small_allreduce_bytes=small_allreduce_bytes)
    table = collective_table(trace, n)
    report = {
        "expected": expected,
        "table": table,
        "matched": matched,
        "widened": widened,
        "stat_rows": stat_rows,
        "unplanned": unplanned,
        "axis_size": n,
        "plan_wire_bytes": plan["wire_bytes"],
        "aux_elements": int(aux_elements),
        "steps": int(steps),
        "notes": _instance_notes(table, plan, steps, plan.get("mode")),
    }
    return findings, report


# -- MX804: degenerate partition specs ----------------------------------------

def _spec_axes(spec):
    """Flatten a PartitionSpec/tuple into the mesh axis names it uses."""
    axes = []
    for entry in tuple(spec or ()):
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.extend(str(e) for e in entry if e is not None)
        else:
            axes.append(str(entry))
    return axes


def check_partition_specs(specs, mesh, batch=()) -> list:
    """MX804 over declared partition specs.

    ``specs``: name -> ``parallel.mesh.PartitionSpec`` (or tuple of axis
    names / None). ``mesh``: a ``parallel.mesh`` mesh (its ``shape``
    mapping is read) or a name->size dict. ``batch``: names whose leading
    dim carries the batch — under dp>1 their spec must shard over 'dp'.
    """
    axes = dict(getattr(mesh, "shape", mesh))
    findings: list = []
    rule = get_rule("MX804")
    for name, spec in specs.items():
        for ax in _spec_axes(spec):
            if ax not in axes:
                findings.append(Finding(
                    rule,
                    f"PartitionSpec for '{name}' names axis '{ax}' which "
                    f"the mesh does not have (axes: {sorted(axes)}) — XLA "
                    f"replicates the dim and the sharding silently never "
                    f"happens",
                    node=name, extra={"axis": ax, "mesh": dict(axes)}))
    dp = int(axes.get("dp", 1))
    if dp > 1:
        for name in batch:
            if name not in specs:
                continue
            if "dp" not in _spec_axes(specs[name]):
                findings.append(Finding(
                    rule,
                    f"batch input '{name}' is unsharded over 'dp' while "
                    f"the mesh has dp={dp} — every device computes the "
                    f"full batch",
                    node=name, extra={"dp": dp}))
    return findings


# -- the combined program audit -----------------------------------------------

def profile_step(step):
    """Run ``step()`` once under ``torch.profiler`` on every thread (the
    overlapped schedule issues its buckets from a comm thread); returns
    ``(result, profile)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    # a raw profiler (pragma below): the audit reads the profile object of
    # every thread, which a capture window does not give; one step, closed
    # by the block
    with profile(activities=[ProfilerActivity.CPU],  # mxlint: disable=MX314
                 experimental_config=every_thread) as prof:
        result = step()
    return result, prof


def audit_step_program(step=None, *, trace=None, hlo_text=None, plan=None,
                       compression=None, axis_size=None, mesh=None,
                       aux_elements=0, steps=1, small_allreduce_bytes=None,
                       allow_widen=True) -> ShardAuditReport:
    """Audit one step program end to end (mxnet_tpu/analysis/sharding.py:
    audit_step_program): MX802 over its collectives against ``plan``.

    The evidence is ``hlo_text`` (a compiled program), else ``trace`` (a
    profiled run of ``steps`` steps), else one run of ``step()`` under
    :func:`profile_step`. ``axis_size`` (else the mesh's dp, else the
    plan's) is the group size of ranges that name none. A sub-check that
    cannot run (no plan, no evidence) is a note, never silently skipped.
    """
    report = ShardAuditReport(notes=[JAX_ONLY_NOTE])
    if hlo_text is None and trace is None and step is not None:
        _, trace = profile_step(step)
    if hlo_text is None and trace is None:
        report.notes.append("MX802 skipped (no step, trace or HLO text)")
        return report
    if axis_size is None and mesh is not None:
        axis_size = dict(mesh.shape).get("dp", 1)
    n = int(axis_size or (plan["axis_size"] if plan is not None else 1))
    if plan is None:
        from ..comm.stats import collective_table, hlo_collective_table

        report.table = hlo_collective_table(hlo_text, n) \
            if hlo_text is not None else collective_table(trace, n)
        report.notes.append("MX802 skipped (no comm plan supplied)")
        return report
    if hlo_text is not None:
        fs, rec = audit_collective_drift(
            hlo_text, plan, compression=compression, default_group_size=n,
            allow_widen=allow_widen,
            small_allreduce_bytes=small_allreduce_bytes)
    else:
        fs, rec = audit_profiled_drift(
            trace, plan, compression=compression, default_group_size=n,
            allow_widen=allow_widen,
            small_allreduce_bytes=small_allreduce_bytes,
            aux_elements=aux_elements, steps=steps)
        report.notes.extend(f"{r['op']}: {r['note']} ({r['profiled_count']}"
                            f" profiled, {r['plan_count']} planned; "
                            f"{r['payload_bytes']} payload bytes, plan "
                            f"{r['plan_payload_bytes']})"
                            for r in rec["notes"])
    report.findings.extend(fs)
    report.table = rec["table"]
    report.reconciliation = rec
    return report


# -- the repo's own full-stack self-check -------------------------------------

def selfcheck_report(dp=8, compression="int8", overlap=True,
                     comm_kernels=True, health=True, guards=True,
                     batch=40, features=10, hidden=64,
                     classes=3) -> ShardAuditReport:
    """Build the repo's own dp-``dp`` FULL-STACK train step (compression
    + overlap + the comm kernels + health statistics + guards) over
    ``dp`` CPU replicas of one process and audit it, as the JAX package
    audits its dp-8 fused step. Zero findings is the contract.

    ``[cpu(i) for i in range(dp)]`` are ``dp`` replicas when
    ``XLA_FLAGS`` holds ``--xla_force_host_platform_device_count`` of at
    least ``dp`` (``context.distinct_contexts``); raises RuntimeError when
    the list collapses to fewer."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.context import distinct_contexts

    ctx = [mt.cpu(i) for i in range(dp)]
    if len(distinct_contexts(ctx)) < dp:
        raise RuntimeError(
            f"shardcheck needs {dp} replicas, found "
            f"{len(distinct_contexts(ctx))} — set XLA_FLAGS="
            f"--xla_force_host_platform_device_count={dp} before the "
            f"first context is made")
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, name="fc1", num_hidden=hidden)
    net = sym.Activation(data=net, name="relu1", act_type="relu")
    net = sym.FullyConnected(data=net, name="fc2", num_hidden=classes)
    net = sym.SoftmaxOutput(data=net, name="softmax")
    model = mt.FeedForward(net, ctx=ctx, num_epoch=1, learning_rate=0.5)
    out = model.precompile(
        data_shapes={"data": (batch, features)},
        label_shapes={"softmax_label": (batch,)},
        compression=compression, overlap=overlap,
        comm_kernels=comm_kernels, health=health, guards=guards,
        shard_audit="report")
    merged = ShardAuditReport()
    for rep in out.get("shard_audit", ()):
        merged = merged.merged_with(rep)
    return merged
