"""Roofline of the ResNet-50 train step on the card: the port's
counterpart of ``tools/bench_roofline.py``.

The JAX tool sets its step against a measured HBM bandwidth to tell a
bandwidth-bound step from headroom. This does the same for the port's f32
step at batch 256 (SGD with momentum over ``_build_graph_fn(is_train=
True)``, ``_bench.build_resnet50_train_step``; TF32 off, ``"highest"``,
for the run):

1. the card's streaming bandwidth, measured (``telemetry.profiling
   .measured_peak_bandwidth``: ``x + 1`` over 256 MB, one read and one
   write an element, between CUDA events);
2. the step's traffic. The JAX tool reads XLA's ``cost_analysis()`` of the
   compiled step; the port has no compiler, and in eager torch each
   dispatched operation reads its operands and writes its output, so the
   traffic model is that count, from ``analysis.program_audit.cost_rows``
   over one step (the FLOP and byte counter the program audit uses), less
   what it charges the operations that move no bytes: views and aliases
   (every result aliases an input it does not write) and allocations, as
   the JAX tool charges nothing to ``parameter``, ``constant``,
   ``get-tuple-element``, ``tuple`` and ``bitcast``;
3. the floors that implies (traffic over bandwidth; the JAX tool's
   analytic ideal-fusion minimum, :func:`analytic_min_traffic_gb`, over
   bandwidth; the step's FLOPs over the measured bf16 GEMM rate) against
   the measured step, ``--iters`` replays of the step captured into a CUDA
   graph between CUDA events.

:func:`per_op_bytes_table` ranks the step's operations by operand and
output bytes, each named by the Symbol node it ran for (the executor's
``<node>/<op>`` ranges; a backward operation by the node whose forward made
its autograd node, ``... (backward)``; the update by ``update/
sgd_momentum``), as the JAX tool ranks the compiled step's instructions by
the same charge with XLA's ``op_name`` as the source.

    python -m mxnet_tpu_torch.tools.bench_roofline [--out ROOFLINE_torch.json]
    python -m mxnet_tpu_torch.tools.bench_roofline --analyze-only --cpu \\
        --batch-size 2

``--analyze-only`` times nothing (with ``--cpu`` it runs on the CPU, as the
JAX tool's does). The JSON keeps the JAX tool's keys where the quantity is
the same; a key that names XLA has a name of the port's own, and
``jax_keys`` says which JAX key each stands for. It goes to ``--out``
(never the JAX tool's ``ROOFLINE_r*.json``), with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os

import numpy as np
import torch

from ..analysis.program_audit import ProgramAudit
from ..base import MXNetError, get_matmul_precision, set_matmul_precision
from ..telemetry.mfu import _nbytes
from ..utils.compile import CapturedProgram
from . import _bench

# the port's keys that stand for the JAX tool's keys naming XLA
JAX_KEYS = {
    "port_bytes_accessed_gb": "xla_bytes_accessed_gb",
    "port_flops_g": "xla_flops_g",
    "memory_floor_port_traffic_ms": "memory_floor_xla_traffic_ms",
}
# allocations that write nothing, and views whose schema marks no alias
ZERO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "lift_fresh", "_unsafe_view", "alias",
                "_reshape_alias")


def analytic_min_traffic_gb(batch_size, act_bytes=2):
    """The JAX tool's first-principles minimum traffic of the train step,
    GB: every node output ``*_output`` of the graph crosses memory about 3
    times in a perfectly fused step (written in the forward, read by its
    consumer's backward, its gradient written and read), at ``act_bytes``
    an element (2: the JAX tool's bf16 activations), and the parameters,
    gradients and momenta about 6 times the f32 parameter bytes. Pure shape
    arithmetic over the Symbol at the JAX tool's layout (NHWC; the byte
    count is the same in either)."""
    from ..models import resnet50

    sym = resnet50(num_classes=1000, layout="NHWC")
    internals = sym.get_internals()
    outs = internals.list_outputs()
    shapes = {"data": (batch_size, 224, 224, 3),
              "softmax_label": (batch_size,)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    _, ishapes, _ = internals.infer_shape(**shapes)
    act = sum(int(np.prod(s)) * act_bytes for n, s in zip(outs, ishapes)
              if n.endswith("_output"))
    params = sum(int(np.prod(s)) * 4
                 for n, s in zip(sym.list_arguments(), arg_shapes)
                 if n not in ("data", "softmax_label"))
    return (3 * act + 6 * params) / 1e9


def moves_bytes(func) -> bool:
    """Does one ATen call move bytes? Not a view or alias (each result
    aliases an input it does not write) nor an allocation."""
    if func.overloadpacket.__name__ in ZERO_TRAFFIC:
        return False
    rets = func._schema.returns
    return not (rets and all(r.alias_info is not None
                             and not r.alias_info.is_write for r in rets))


def _shape_str(out):
    t = out[0] if isinstance(out, (tuple, list)) and out else out
    if not isinstance(t, torch.Tensor):
        return ""
    dtype = {torch.float32: "f32", torch.bfloat16: "bf16",
             torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
             torch.uint8: "u8", torch.int8: "s8", torch.bool: "pred"
             }.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{dtype}[{','.join(map(str, t.shape))}]"


class OpTable(ProgramAudit):
    """The program audit (``analysis.program_audit.ProgramAudit``, the
    counter ``cost_rows`` runs) with a row for every ATen call made while
    entered: ``{"name", "opcode", "bytes", "charged", "source", "shape"}``.
    ``charged`` is the counter's operand + output bytes; ``bytes`` is the
    same, or 0 for a call that moves none (:func:`moves_bytes`). ``source``
    is the innermost open range (the executor's ``<node>/<op>``, or the
    update's), and for a backward call the range its autograd node was made
    in, ``" (backward)"`` added (the node's name where it was made in
    none); else None.

    The node's range is found by its sequence number: each range's start
    and end marks the thread's next number, and a node made between two
    marks belongs to the range open there."""

    def __init__(self):
        super().__init__()
        self.calls = []
        self._marks = ([], [])  # sequence numbers, the range open from each

    @property
    def traffic_bytes(self) -> int:
        return sum(c["bytes"] for c in self.calls)

    @property
    def charged_bytes(self) -> int:
        return sum(c["charged"] for c in self.calls)

    def _range_event(self, func, args):
        super()._range_event(func, args)
        self._marks[0].append(torch._C._autograd._get_sequence_nr())
        self._marks[1].append(self._ranges[-1] if self._ranges else None)

    def _source(self):
        node = torch._C._current_autograd_node()
        if node is None:
            return self._ranges[-1] if self._ranges else None
        i = bisect.bisect_right(self._marks[0], node._sequence_nr()) - 1
        made_in = self._marks[1][i] if i >= 0 else None
        return f"{made_in or node.name()} (backward)"

    def _record(self, func, args, kwargs, out):
        super()._record(func, args, kwargs, out)
        if func.namespace == "profiler":
            return
        name = func.overloadpacket.__name__
        charged = _nbytes(args) + _nbytes(out)
        self.calls.append({
            "name": f"{name}.{len(self.calls)}", "opcode": name,
            "bytes": charged if moves_bytes(func) else 0,
            "charged": charged, "source": self._source(),
            "shape": _shape_str(out)})


def per_op_bytes_table(table, top_k=25):
    """``(rows, totals_by_opcode)`` of an :class:`OpTable`: the calls that
    move bytes, largest first (``gbytes`` their operand + output bytes), the
    first ``top_k`` of them, and the GB of every opcode, largest first, as
    the JAX tool's ``per_op_bytes_table`` gives them for the compiled
    step's instructions."""
    rows = sorted(({"name": c["name"], "opcode": c["opcode"],
                    "gbytes": c["bytes"] / 1e9, "source": c["source"],
                    "shape": c["shape"]} for c in table.calls if c["bytes"]),
                  key=lambda r: -r["gbytes"])
    totals = {}
    for r in rows:
        totals[r["opcode"]] = totals.get(r["opcode"], 0.0) + r["gbytes"]
    totals = dict(sorted(totals.items(), key=lambda kv: -kv[1]))
    return rows[:top_k], totals


def step_traffic(run):
    """One call of ``run`` (a train step) under an :class:`OpTable`:
    ``(rows, totals, table)``, the cost rows and totals ``program_audit
    .cost_rows`` gives (every call's operands and outputs) and the table
    of calls."""
    with OpTable() as table:
        run()
    report = table.report()
    return report.rows, report.totals, table


def step_inputs(batch_size, device):
    """The JAX tool's seeded batch: normal data, labels in [0, 1000)."""
    rng = np.random.RandomState(0)
    data = rng.randn(*_bench._data_shape(batch_size, "NCHW")).astype(
        np.float32)
    label = rng.randint(0, 1000, (batch_size,)).astype(np.float32)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(label).to(device))


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--out", default="ROOFLINE_torch.json")
    ap.add_argument("--iters", type=int, default=16,
                    help="timed replays of the captured step")
    ap.add_argument("--analyze-only", action="store_true",
                    help="one counted step and the per-op traffic table, "
                         "no timed runs")
    ap.add_argument("--cpu", action="store_true",
                    help="with --analyze-only: run on the CPU")
    ap.add_argument("--remat", nargs="?", const=r"unit\d+_out$", default="",
                    help="set MXNET_TPU_REMAT for the run, to compare the "
                         "step's traffic and time under rematerialization "
                         "with the plain step (bare --remat = ResNet unit "
                         "boundaries)")
    ap.add_argument("--jaxpr-table", action="store_true",
                    help="also print program_audit.cost_rows' FLOP and byte "
                         "totals by ATen operation: every dispatched call's "
                         "operands and outputs, views included (the port's "
                         "counterpart of the JAX tool's pre-fusion jaxpr "
                         "table)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.cpu and not args.analyze_only:
        raise MXNetError("bench_roofline: only --analyze-only runs on the "
                         "CPU; a timed run needs the card")
    device = _bench.card(args.cpu, what="bench_roofline")
    prior_remat = os.environ.get("MXNET_TPU_REMAT")
    prior_precision = get_matmul_precision()
    if args.remat:
        os.environ["MXNET_TPU_REMAT"] = args.remat
    set_matmul_precision("highest")
    try:
        return _run(args, device)
    finally:
        set_matmul_precision(prior_precision)
        if prior_remat is None:
            os.environ.pop("MXNET_TPU_REMAT", None)
        else:
            os.environ["MXNET_TPU_REMAT"] = prior_remat


def _run(args, device):
    ident = _bench.card_identity(device)
    print(f"card={ident}", flush=True)
    if not args.analyze_only:
        bw = _bench.measured_hbm_bandwidth_gbs(device)
        print(f"measured streaming bandwidth: {bw:.1f} GB/s ({ident})")

    step, params, moms, aux = _bench.build_resnet50_train_step(
        args.batch_size, device=device)
    data, label = step_inputs(args.batch_size, device)

    def run():
        return step(params, moms, aux, data, label)

    rows, totals, table = step_traffic(run)
    traffic = table.traffic_bytes
    print(f"port bytes accessed per step: {traffic / 1e9:.2f} GB "
          f"(every call's operands and outputs: "
          f"{totals['bytes'] / 1e9:.2f} GB)")
    top_rows, op_totals = per_op_bytes_table(table)
    print("top traffic operations (operand+output bytes):")
    for r in top_rows[:15]:
        src = f"  <- {r['source']}" if r.get("source") else ""
        print(f"  {r['gbytes']:7.3f} GB  {r['opcode']:<28} {r['name']}{src}")
    print("traffic by opcode:",
          {k: round(v, 2) for k, v in list(op_totals.items())[:8]})
    if args.jaxpr_table:
        print(f"cost_rows: {totals['eqns']} calls, "
              f"{totals['flops'] / 1e9:.2f} GFLOP, "
              f"{totals['bytes'] / 1e9:.2f} GB operand+output bytes")
        for r in rows[:15]:
            print(f"  {r['bytes'] / 1e9:7.3f} GB  {r['flops'] / 1e9:8.3f} GF "
                  f" {r['primitive']:<28} x{r['count']}")

    out = {
        "card": ident,
        "batch_size": args.batch_size,
        "remat": os.environ.get("MXNET_TPU_REMAT") or None,
        "matmul_precision": get_matmul_precision(),
        "analytic_min_traffic_gb": analytic_min_traffic_gb(args.batch_size),
        "analytic_min_traffic_gb_f32_activations": analytic_min_traffic_gb(
            args.batch_size, act_bytes=4),
        "port_bytes_accessed_gb": traffic / 1e9,
        "port_op_bytes_gb": totals["bytes"] / 1e9,
        "port_flops_g": totals["flops"] / 1e9,
        "per_op_top": top_rows,
        "per_opcode_gb": op_totals,
        "jax_keys": JAX_KEYS,
    }
    if args.analyze_only:
        _bench.write_json(args.out, out)
        print(f"wrote {args.out} (analyze-only)")
        return out

    # the counted step's freed blocks are cached for the current stream;
    # the capture's warm-up runs on a side stream and needs them back
    gc.collect()
    torch.cuda.empty_cache()
    prog = CapturedProgram(run, device, "bench_roofline")
    prog()
    prog()
    ms = _bench.replay_ms(prog, args.iters, samples=1)
    peak = _bench.measured_matmul_peak_tflops(device)
    from ..kernels.registry import H100_PEAK_OPS

    floor_ideal_ms = out["analytic_min_traffic_gb"] / bw * 1e3
    floor_f32_ms = out["analytic_min_traffic_gb_f32_activations"] / bw * 1e3
    floor_port_ms = traffic / (bw * 1e9) * 1e3
    floor_flops_ms = totals["flops"] / (peak * 1e12) * 1e3
    out.update({
        "measured_step_ms": ms,
        "measured_hbm_bw_gbs": bw,
        "measured_matmul_peak_tflops": peak,
        "step_tflops": totals["flops"] / ms / 1e9,
        "memory_floor_ideal_fusion_ms": floor_ideal_ms,
        "memory_floor_ideal_fusion_f32_activations_ms": floor_f32_ms,
        "memory_floor_port_traffic_ms": floor_port_ms,
        "compute_floor_ms_at_matmul_peak": floor_flops_ms,
        "compute_floor_ms_at_published_f32_peak":
            totals["flops"] / H100_PEAK_OPS["f32"] * 1e3,
        "step_vs_ideal_memory_floor": ms / floor_ideal_ms,
        "step_vs_port_traffic_floor": ms / floor_port_ms,
        "verdict": (
            "memory floors (ideal %.1f ms, f32 activations %.1f ms, the "
            "port's traffic %.1f ms) against a %.1f ms compute floor at the "
            "measured bf16 GEMM rate; the measured %.1f ms step is %.0f%% "
            "above the port's traffic floor (%s)"
            % (floor_ideal_ms, floor_f32_ms, floor_port_ms, floor_flops_ms,
               ms, (ms / floor_port_ms - 1) * 100, ident)),
    })
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("per_op_top", "per_opcode_gb")}, indent=1))
    _bench.write_json(args.out, out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
