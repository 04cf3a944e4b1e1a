"""The program audit: what one step of the port's program runs, op by op.

Counterpart of ``mxnet_tpu/analysis/jaxpr_audit.py``. The JAX package
audits the traced jaxpr of a bound executor; the port has no jaxpr, so it
audits what runs: one eager step under a ``TorchDispatchMode``, the one
that prices ATen calls for MFU (:class:`~..telemetry.mfu.FlopCounter`,
``jaxpr_audit.py:94-123``'s rules). :class:`ProgramAudit` is a FlopCounter
whose record of each call also checks it, so the cost rows are the
counter's own numbers. It reports

  MX501  host round trips inside the step: ``aten::_local_scalar_dense``
         (a tensor read as a Python number), a copy from a CUDA tensor to
         the CPU, and a ``_Native`` node (the user's numpy runs on the
         host, where the JAX package's ``pure_callback`` round-trips),
  MX502  dtype promotions: an operation whose floating inputs are all
         ``intended_dtype`` and whose floating output is wider, except at
         the reference's rounding points: contractions and convolutions
         (an f32 accumulator), BatchNorm (statistics in f32) and the loss
         heads (softmax and the loss in f32). The JAX audit flags every
         upcast but a contraction's; the node an operation belongs to is
         read from the executor's ``<node>/<op>`` ranges, on for the
         audited step (``telemetry.profiling.node_ranges``),

and per-operation FLOP/byte rows: contraction FLOPs equal FlopCounter's
exactly, and a hand-written kernel's call is one ``kernel::<name>`` row
priced from ``kernels/registry.py``, the operations inside it unseen (as
the JAX audit prices a registered ``pallas_call``). ``comm_rows`` list the
``torch.distributed`` collectives the step issued.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..telemetry.mfu import CONTRACTIONS, FlopCounter, _nbytes
from .rules import Finding, get_rule

__all__ = ["AuditReport", "ProgramAudit", "audit_executor", "audit_program",
           "cost_rows", "HOST_TRANSFER_OPS"]

# ATen operations that read a device value on the host
HOST_TRANSFER_OPS = ("_local_scalar_dense",)

_COPIES = ("_to_copy", "copy_", "copy", "to")

# op names whose node computes in f32 by design (the reference's rounding
# points, ROADMAP C.2 "bf16 compute_dtype"), besides the loss heads
_ROUNDING_OPS = ("BatchNorm",)


@dataclass
class AuditReport:
    findings: list = field(default_factory=list)
    totals: dict = field(default_factory=dict)    # {'flops': .., 'bytes': ..}
    rows: list = field(default_factory=list)      # per-operation table
    comm_rows: list = field(default_factory=list)  # per-collective table

    @property
    def errors(self):
        return [f for f in self.findings if f.is_error]


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _torch_dtype(dtype):
    if dtype is None:
        return None
    from ..ndarray import _torch_dtype as torch_dtype
    from ..ops.registry import as_dtype

    return torch_dtype(as_dtype(dtype))


def _rounding_op(op_name) -> bool:
    """Does a node of op ``op_name`` compute in f32 by design?"""
    from ..ops import OPS

    if op_name in _ROUNDING_OPS:
        return True
    try:
        return bool(OPS.get(op_name).is_loss)
    except Exception:  # noqa: BLE001 - not an op name: no rounding point
        return False


class ProgramAudit(FlopCounter):
    """A :class:`FlopCounter` that also checks each ATen call for MX501 and
    MX502. Use as a context manager around one step; the ranges of the
    executor's nodes are on while it is entered. ``rounding_ranges``:
    further range names (``<node>/<op>``) that are rounding points (a
    BatchNorm fused into the add that follows it runs in the add's
    range)."""

    def __init__(self, intended_dtype=None, rounding_ranges=()):
        super().__init__()
        self.intended = _torch_dtype(intended_dtype)
        self.rounding_ranges = frozenset(rounding_ranges)
        self.findings = []
        self.by_coll = {}
        self._ranges = []  # the open ranges' names, innermost last
        self._ranges_cm = None

    def __enter__(self):
        from ..telemetry import profiling

        self._ranges_cm = profiling.node_ranges()
        self._ranges_cm.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._ranges_cm.__exit__(*exc)
            self._ranges_cm = None

    # -- the record of one call -----------------------------------------------
    def _record(self, func, args, kwargs, out):
        if func.namespace == "profiler":
            self._range_event(func, args)
            return
        super()._record(func, args, kwargs, out)
        name = func.overloadpacket.__name__
        if func.namespace == "c10d":
            row = self.by_coll.setdefault(
                name, {"op": name, "count": 0, "payload_bytes": 0})
            row["count"] += 1
            row["payload_bytes"] += _nbytes(args)
            return
        if self._in_native():
            return  # the node's host call is its one finding
        self._check_host(name, args, kwargs, out)
        self._check_promotion(name, args, kwargs, out)

    def _range_event(self, func, args):
        name = func.overloadpacket.__name__
        if name.startswith("_record_function_enter"):
            label = next((a for a in args if isinstance(a, str)), "")
            self._ranges.append(label)
            node, _, op = label.partition("/")
            if op == "_Native":
                self.findings.append(Finding(
                    get_rule("MX501"),
                    f"node '{node}' runs the user's numpy on the host: its "
                    f"inputs are copied out and its outputs back inside "
                    f"the step", node=node))
        elif name.startswith("_record_function_exit") and self._ranges:
            self._ranges.pop()

    def _in_native(self):
        return any(r.endswith("/_Native") for r in self._ranges)

    def _at(self):
        return f" in '{self._ranges[-1]}'" if self._ranges else ""

    def _check_host(self, name, args, kwargs, out):
        if name in HOST_TRANSFER_OPS:
            self.findings.append(Finding(
                get_rule("MX501"),
                f"'{name}' reads a device value on the host inside the "
                f"step{self._at()}", node=name))
            return
        if name not in _COPIES:
            return
        srcs = [t for t in _tensors(args) if t.is_cuda]
        dsts = [t for t in _tensors(out) if not t.is_cuda]
        if name == "copy_":  # copy_(dst, src): dst is the first argument
            dsts = [args[0]] if not args[0].is_cuda else []
            srcs = [args[1]] if isinstance(args[1], torch.Tensor) and \
                args[1].is_cuda else []
        if srcs and dsts:
            self.findings.append(Finding(
                get_rule("MX501"),
                f"'{name}' copies {_nbytes(srcs[0])} bytes from the card "
                f"to the host inside the step{self._at()}", node=name))

    def _exempt(self, name):
        if name in CONTRACTIONS or name.startswith(
                ("_scaled_dot_product", "_flash_attention",
                 "_efficient_attention")):
            return True
        for label in self._ranges:
            op = label.partition("/")[2]
            if label in self.rounding_ranges or _rounding_op(op):
                return True
        return False

    def _check_promotion(self, name, args, kwargs, out):
        intended = self.intended
        if intended is None:
            return
        ins = [t for t in _tensors(args) if t.is_floating_point()]
        if name == "copy_":
            ins = [t for t in _tensors(args[1:]) if t.is_floating_point()]
            out = args[0]
        if not ins or any(t.dtype != intended for t in ins):
            return
        for o in _tensors(out):
            if o.is_floating_point() and o.dtype.itemsize > intended.itemsize:
                if self._exempt(name):
                    return
                self.findings.append(Finding(
                    get_rule("MX502"),
                    f"'{name}' promotes {intended} input(s) to {o.dtype} "
                    f"(shape {tuple(o.shape)}){self._at()}", node=name))
                return

    # -- results --------------------------------------------------------------
    def report(self) -> AuditReport:
        report = AuditReport(findings=list(self.findings))
        report.rows = sorted(self.rows, key=lambda r: r["bytes"],
                             reverse=True)
        report.comm_rows = sorted(self.by_coll.values(),
                                  key=lambda r: r["payload_bytes"],
                                  reverse=True)
        report.totals = {
            "flops": self.flops,
            "bytes": self.bytes,
            "contraction_flops": self.contraction_flops,
            "eqns": sum(r["count"] for r in report.rows),
            "comm_payload_bytes": sum(r["payload_bytes"]
                                      for r in report.comm_rows),
        }
        return report


def audit_program(fn, *args, intended_dtype=None, attribute_kernels=True,
                  rounding_ranges=(), **kwargs) -> AuditReport:
    """Run ``fn(*args, **kwargs)`` once under a :class:`ProgramAudit` and
    return its report (the port's ``audit_jaxpr``: the program is the
    calls one run makes). ``attribute_kernels=False`` leaves the
    hand-written kernels unpriced: their plain versions' operations are
    counted on the CPU, and nothing of a launch on the card."""
    from ..kernels import _common

    audit = ProgramAudit(intended_dtype, rounding_ranges)
    with audit:
        if not attribute_kernels:
            _common.flop_counters.remove(audit)
        try:
            fn(*args, **kwargs)
        finally:
            if not attribute_kernels:
                _common.flop_counters.append(audit)
    return audit.report()


def rounding_ranges(symbol):
    """The ranges of ``symbol``'s nodes that compute a BatchNorm fused into
    the add after it (``executor._fusion_plan``): rounding points too."""
    from ..executor import _fusion_plan

    _, _, _, fused_add = _fusion_plan(symbol)
    return {f"{n.name}/{n.op.name}" for n in symbol._topo()
            if not n.is_variable and id(n) in fused_add}


def audit_executor(executor, is_train=False,
                   intended_dtype=None) -> AuditReport:
    """Audit one forward of a bound Executor's program (the graph function
    it runs, fusion plan and remat blocks included) on its bound tensors.
    A training forward draws from a generator of its own, so the global
    random state and the executor's tensors are left as they were."""
    from ..executor import _build_graph_fn

    symbol = executor._symbol
    fn = _build_graph_fn(symbol, is_train)
    dev = executor._ctx.torch_device
    gen = torch.Generator(device=dev).manual_seed(0)
    args = dict(executor.arg_dict)
    aux = {k: v.clone() for k, v in executor.aux_dict.items()}

    def run():
        with torch.no_grad():
            fn(args, aux, gen)

    return audit_program(run, intended_dtype=intended_dtype,
                         rounding_ranges=rounding_ranges(symbol))


def cost_rows(fn, *example_args, intended_dtype=None,
              attribute_kernels=True):
    """Per-operation FLOP/byte rows and totals of one call of ``fn`` on
    ``example_args``; a hand-written kernel's call is a ``kernel::<name>``
    row priced by the kernel registry."""
    report = audit_program(fn, *example_args, intended_dtype=intended_dtype,
                           attribute_kernels=attribute_kernels)
    return report.rows, report.totals
