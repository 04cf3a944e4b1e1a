"""MFU / goodput accounting: the two numbers a user asks for first.

The port's counterpart of ``mxnet_tpu/telemetry/mfu.py``.

**MFU** (model FLOPs utilization) = model FLOPs actually computed per
second / peak FLOPs. The numerator is counted once, over one eager step of
the port's own program (:class:`FlopCounter`, a ``TorchDispatchMode``
that sees every ATen operation of the forward, the backward and the
update), under the JAX package's pricing rules
(``mxnet_tpu/analysis/jaxpr_audit.py:94-123``): contractions at 2·MACs
(``mm``/``addmm``/``bmm`` as ``dot_general``; a convolution's forward,
input gradient and weight gradient each as the ``conv_general_dilated``
the JAX transpose makes), reductions at their input size, layout ops at
0, and everything else at one FLOP per output element. The hand-written
kernels are opaque to the mode: each call is priced from its cost model
in ``kernels/registry.py`` (``kernel::<name>`` rows), as the JAX audit
prices a registered ``pallas_call``, and the torch operations inside its
plain version are not counted. The contraction FLOPs match the JAX
package's count of the same net exactly; the elementwise rest follows each
package's decomposition of its ops (``contraction_flops`` keeps the two
apart). The denominator resolves, in order:

  1. ``MXNET_TPU_PEAK_FLOPS`` — peak FLOP/s **per device**, set by the
     user;
  2. a one-time measured peak on the actual device
     (:func:`measured_peak_flops`: a bf16 GEMM on a card, an f32 matmul
     chain on the CPU). No datasheet number is used.

**Goodput** = fraction of wall time spent on steps that advanced
training. The badput side is attributed from what already knows:
compile seconds (the CUDA-graph captures' seconds in the compile
registry), data stalls (the timeline's data-wait phase), checkpoint
flushes and the profiler's window.
"""

from __future__ import annotations

import logging
import os
import time

from .hub import hub as _hub

__all__ = ["MFUAccountant", "resolve_peak_flops", "measured_peak_flops",
           "record_compile_badput", "FlopCounter", "CONTRACTIONS"]

_MEASURED_PEAK = {}  # backend platform -> measured FLOP/s per device

# Watermark on the compile registry's CUMULATIVE compile-seconds: both the
# Speedometer (per reporting window) and epoch_report (per epoch) observe
# the same registry deltas, so counting each observation would double-book
# a compile into badput_compile_seconds_total. Every counter increment
# goes through record_compile_badput, which only counts seconds above the
# high-water mark.
from ..analysis.lockwatch import named_lock as _named_lock

_COMPILE_WM_LOCK = _named_lock("telemetry.mfu.compile_wm")
_COMPILE_WM = [None]  # None until the first observation window


def record_compile_badput(total_seconds, window_seconds, epoch=None):
    """Fold the compile seconds in ``(total - window, total]`` that have
    not been counted yet into ``badput_compile_seconds_total`` (+ a
    ``badput`` event). ``total_seconds`` is the compile registry's
    cumulative counter; idempotent across overlapping observers. Returns
    the newly-counted seconds."""
    with _COMPILE_WM_LOCK:
        if _COMPILE_WM[0] is None or total_seconds < _COMPILE_WM[0]:
            # first observation — or the cumulative counter went BACKWARD,
            # which means the compile registry was reset
            # (utils.compile.reset_compile_stats): re-baseline instead of
            # letting the stale high-water mark eat every future window
            _COMPILE_WM[0] = total_seconds - window_seconds
        start = max(_COMPILE_WM[0], total_seconds - window_seconds)
        delta = total_seconds - start
        if delta <= 0:
            return 0.0
        _COMPILE_WM[0] = total_seconds
    h = _hub()
    h.counter("badput_compile_seconds_total", delta)
    h.emit("badput", reason="compile", seconds=delta, epoch=epoch)
    return delta


def _device_key(device):
    import torch

    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    return torch.device(device)


def measured_peak_flops(n=None, iters=None, device=None):
    """One-time matmul-derived peak FLOP/s of one device (cached per
    device). On a card: the best of three timings of ``iters`` chained
    bf16 GEMMs of ``n`` x ``n`` (8192 and 16 by default), between CUDA
    events; on the CPU the JAX package's probe, an f32 ``tanh(x @ a)``
    chain of ``n`` = 384, 8 deep."""
    import torch

    device = _device_key(device)
    key = str(device)
    if key in _MEASURED_PEAK:
        return _MEASURED_PEAK[key]
    gen = torch.Generator().manual_seed(0)
    if device.type == "cuda":
        n = int(n or 8192)
        iters = int(iters or 16)
        a = torch.randn(n, n, generator=gen).to(device, torch.bfloat16) / \
            float(n) ** 0.5
        b = torch.randn(n, n, generator=gen).to(device, torch.bfloat16)
        out = torch.empty_like(a)
        torch.mm(a, b, out=out)  # cuBLAS's heuristics outside the timing
        best = None
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                torch.mm(a, b, out=out)
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
            best = sec if best is None else min(best, sec)
        peak = 2.0 * n * n * n * iters / max(best, 1e-9)
    else:
        n = int(n or 384)
        iters = int(iters or 8)
        a = torch.randn(n, n, generator=gen)

        def run():
            x = a
            for _ in range(iters):
                x = torch.tanh(x @ a)
            return x

        run()
        t0 = time.perf_counter()
        run()
        peak = 2.0 * n * n * n * iters / max(time.perf_counter() - t0, 1e-9)
    _MEASURED_PEAK[key] = peak
    logging.info("telemetry: measured matmul peak %.2f GFLOP/s on %s "
                 "(set MXNET_TPU_PEAK_FLOPS to override)", peak / 1e9, key)
    return peak


# -- the FLOP count of one step --------------------------------------------------

CONTRACTIONS = ("mm", "addmm", "bmm", "baddbmm", "convolution",
                "convolution_backward", "_scaled_dot_product_attention")

_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax",
    "argmin", "cumsum", "logsumexp", "_log_softmax", "_softmax", "var",
    "std", "var_mean", "norm", "linalg_vector_norm", "_foreach_norm",
    "nansum", "all", "any", "count_nonzero"})

_LAYOUT = frozenset({
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "cat", "stack",
    "_to_copy", "to", "copy_", "copy", "clone", "contiguous", "detach",
    "alias", "as_strided", "split", "split_with_sizes", "unbind",
    "narrow", "index_select", "gather", "scatter", "scatter_add",
    "index", "index_put", "index_put_", "constant_pad_nd", "flip",
    "arange", "zeros", "zeros_like", "empty", "empty_like", "full",
    "full_like", "ones", "ones_like", "new_zeros", "new_empty",
    "new_full", "new_ones", "empty_strided", "lift_fresh", "repeat",
    "expand_as", "view_as", "fill_", "zero_", "_reshape_alias",
    "unfold", "diagonal", "movedim", "set_", "resize_", "_foreach_copy_",
    "split_copy", "slice_scatter", "select_scatter", "roll",
    "scalar_tensor", "_local_scalar_dense", "lift", "randperm"})


def _numel(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return 0


def _nbytes(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _conv_flops(w_numel, w_out, groups, out_numel):
    # jaxpr_audit: out_size * (2 * rhs.size // rhs.shape[O] // groups)
    return out_numel * (2 * w_numel // max(w_out, 1) // max(groups, 1))


def _op_flops(name, args, kwargs, out):
    """FLOPs of one ATen call under the JAX package's rules, as
    ``(flops, contraction)``."""
    if name == "mm":
        m, k = args[0].shape
        n = args[1].shape[1]
        return 2 * m * n * k, True
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
        if name == "addmm":
            m, k = a.shape
            n = b.shape[1]
            return 2 * m * n * k, True
        bt, m, k = a.shape
        return 2 * bt * m * b.shape[2] * k, True
    if name == "bmm":
        bt, m, k = args[0].shape
        return 2 * bt * m * args[1].shape[2] * k, True
    if name == "convolution":
        x, w = args[0], args[1]
        groups = args[8] if len(args) > 8 else kwargs.get("groups", 1)
        transposed = args[6] if len(args) > 6 else False
        if transposed:
            # a transposed conv is the input gradient of its forward
            return 2 * x.numel() * w.numel() // w.shape[0], True
        return _conv_flops(w.numel(), w.shape[0], groups, out.numel()), True
    if name == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        groups = args[9] if len(args) > 9 else 1
        mask = args[10] if len(args) > 10 else (True, True, True)
        flops = 0
        if mask[0]:
            # input gradient: a conv whose rhs is the weight with its
            # feature dims swapped (out features = x's channels)
            c_in = x.shape[1]
            flops += _conv_flops(w.numel(), c_in, groups, x.numel())
        if mask[1]:
            # weight gradient: a conv whose rhs is the output gradient
            # (out features = its channels)
            flops += _conv_flops(grad_out.numel(), grad_out.shape[1],
                                 groups, w.numel())
        return flops, True
    if name.startswith("_scaled_dot_product") or \
            name.startswith("_efficient_attention") or \
            name.startswith("_flash_attention"):
        q, k = args[0], args[1]
        b = q.numel() // (q.shape[-2] * q.shape[-1])
        fwd = 4 * b * q.shape[-2] * k.shape[-2] * q.shape[-1]
        return (2 * fwd if "backward" in name else fwd), True
    if name in _REDUCTIONS:
        return _numel([a for a in args if hasattr(a, "numel")]), False
    if name in _LAYOUT or name.rstrip("_") in _LAYOUT:
        return 0, False
    return _numel(out), False


class FlopCounter:
    """A ``TorchDispatchMode`` counting FLOPs and bytes of every ATen call
    made while it is entered, by operation, under the JAX package's
    pricing rules (this module's docstring). Use as a context manager;
    then ``rows`` (``[{"primitive", "count", "flops", "bytes"}]``, the
    jaxpr audit's row layout), ``flops``, ``bytes`` and
    ``contraction_flops``. A hand-written kernel's call is one
    ``kernel::<name>`` row priced from its registry cost model
    (:meth:`kernel`); the operations inside it are not counted."""

    def __init__(self):
        self.by_prim = {}
        self._kernel_depth = 0
        self._mode = None

    # -- the dispatch mode ------------------------------------------------------
    def _make_mode(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                if counter._kernel_depth == 0:
                    counter._record(func, args, kwargs, out)
                return out

        return _Mode()

    def _record(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        try:
            flops, contraction = _op_flops(name, args, kwargs, out)
        except Exception:  # noqa: BLE001 - an odd signature: elementwise
            flops, contraction = _numel(out), False
        row = self.by_prim.setdefault(name, {
            "primitive": name, "count": 0, "flops": 0, "bytes": 0,
            "contraction": contraction})
        row["count"] += 1
        row["flops"] += int(flops)
        row["bytes"] += _nbytes(args) + _nbytes(out)

    def kernel(self, name, ins, outs, **static):
        """Price one hand-written kernel call from its registry model."""
        from ..kernels import registry as kreg

        spec = kreg.get_kernel(name)
        if spec is None:
            return
        cost = spec.cost(ins, outs, **static)
        key = f"kernel::{name}"
        row = self.by_prim.setdefault(key, {
            "primitive": key, "count": 0, "flops": 0, "bytes": 0,
            "contraction": False})
        row["count"] += 1
        row["flops"] += int(cost.flops)
        row["bytes"] += int(cost.bytes)

    def __enter__(self):
        from ..kernels import _common

        self._mode = self._make_mode()
        self._mode.__enter__()
        _common.flop_counters.append(self)
        return self

    def __exit__(self, *exc):
        from ..kernels import _common

        _common.flop_counters.remove(self)
        self._mode.__exit__(*exc)
        self._mode = None
        return False

    # -- results --------------------------------------------------------------
    @property
    def rows(self):
        return sorted(({k: v for k, v in r.items() if k != "contraction"}
                       for r in self.by_prim.values()),
                      key=lambda r: -r["flops"])

    @property
    def flops(self):
        return sum(r["flops"] for r in self.by_prim.values())

    @property
    def bytes(self):
        return sum(r["bytes"] for r in self.by_prim.values())

    @property
    def contraction_flops(self):
        return sum(r["flops"] for r in self.by_prim.values()
                   if r["contraction"])


def resolve_peak_flops(num_devices=1, device=None):
    """Aggregate peak FLOP/s for ``num_devices`` devices (env override
    first, measured fallback on ``device``, default the current one)."""
    raw = os.environ.get("MXNET_TPU_PEAK_FLOPS", "").strip()
    per_device = float(raw) if raw else measured_peak_flops(device=device)
    return per_device * max(int(num_devices), 1)


class MFUAccountant:
    """Per-run FLOP/step resolution + per-epoch MFU/goodput reporting.

    :meth:`count_step` runs the FIRST step of a fit under a
    :class:`FlopCounter` (an eager step: a captured program's warm-up step
    is one) and keeps its FLOPs, bytes and per-operation rows. Counted
    once per run; a failure leaves MFU n/a rather than failing the
    step."""

    def __init__(self, num_devices=1, peak_flops=None, device=None):
        self.num_devices = max(int(num_devices), 1)
        self.device = device
        self._peak = peak_flops
        self.flops_per_step = None
        self.bytes_per_step = None
        # per-operation FLOP/byte rows of the counted step — the
        # measured-roofline join key for the device-time profiler
        self.audit_rows = None
        self.contraction_flops = None

    @property
    def peak_flops(self):
        if self._peak is None:
            self._peak = resolve_peak_flops(self.num_devices, self.device)
        return self._peak

    def set_num_devices(self, num_devices):
        """Elastic resize: the world changed size mid-run. The aggregate
        peak re-resolves for the new device count; FLOPs/step stay — the
        fused step computes the same GLOBAL batch regardless of how many
        devices the dp axis splits it over, so the model-FLOPs numerator
        is resize-invariant."""
        num_devices = max(int(num_devices), 1)
        if num_devices != self.num_devices:
            self.num_devices = num_devices
            self._peak = None
        return self.num_devices

    # -- FLOP resolution ------------------------------------------------------
    @property
    def wants_count(self):
        return self.flops_per_step is None

    def count_step(self, fn):
        """Run ``fn()`` (one whole eager training step) under a
        :class:`FlopCounter` and keep its count (once); returns ``fn``'s
        result."""
        if self.flops_per_step is not None:
            return fn()
        counter = FlopCounter()
        with counter:
            result = fn()
        try:
            self.flops_per_step = float(counter.flops)
            self.bytes_per_step = float(counter.bytes)
            self.contraction_flops = float(counter.contraction_flops)
            self.audit_rows = counter.rows
        except Exception as e:  # noqa: BLE001 - never fail a train step
            logging.debug("telemetry: FLOP count failed (%s)", e)
            self.flops_per_step = None
        if self.flops_per_step:
            _hub().gauge("model_flops_per_step", self.flops_per_step)
        return result

    # -- epoch reporting ------------------------------------------------------
    def epoch_report(self, epoch, steps, wall_seconds, *, compile_seconds=0.0,
                    data_wait_seconds=0.0, skipped_steps=0, step_retries=0,
                    checkpoint_seconds=0.0, resize_seconds=0.0,
                    profile_seconds=0.0, logger=None):
        """Compute + log + export the epoch's MFU and goodput lines.

        Badput buckets (non-overlapping slices of ``wall_seconds``):
        compile (the captures' seconds), data stalls, checkpoint flushes, elastic resizes
        (quiesce + reshard + replan + rewarm downtime plus the aborted
        partial attempt the resize threw away), profile capture windows
        (the device-time profiler's bounded traces — observation is not
        throughput), and wasted steps — retried dispatches plus
        non-finite skipped steps, each costed at the epoch's mean step
        time. Returns the report dict."""
        logger = logger or logging
        h = _hub()
        steps = max(int(steps), 0)
        wall = max(float(wall_seconds), 1e-9)
        mean_step = wall / steps if steps else 0.0
        wasted_steps = int(skipped_steps) + int(step_retries)
        badput = {
            "compile": min(float(compile_seconds), wall),
            "data_wait": min(float(data_wait_seconds), wall),
            "checkpoint": min(float(checkpoint_seconds), wall),
            "resize": min(float(resize_seconds), wall),
            "profile": min(float(profile_seconds), wall),
            "wasted_steps": min(wasted_steps * mean_step, wall),
        }
        bad_total = min(sum(badput.values()), wall)
        goodput = 100.0 * (wall - bad_total) / wall
        report = {"epoch": int(epoch), "steps": steps, "seconds": wall,
                  "mean_step_seconds": mean_step, "goodput_pct": goodput,
                  "badput": badput, "mfu_pct": None,
                  "flops_per_step": self.flops_per_step}
        if self.flops_per_step and steps:
            achieved = self.flops_per_step * steps / wall
            report["achieved_flops_per_sec"] = achieved
            report["mfu_pct"] = 100.0 * achieved / self.peak_flops
            h.gauge("mfu_pct", report["mfu_pct"])
            h.gauge("achieved_flops_per_sec", achieved)
            logger.info(
                "Epoch[%d] MFU: %.1f%% (%.3g GFLOP/step, %.2f ms/step, "
                "peak %.3g GFLOP/s over %d device(s))", epoch,
                report["mfu_pct"], self.flops_per_step / 1e9,
                mean_step * 1e3, self.peak_flops / 1e9, self.num_devices)
        else:
            logger.info("Epoch[%d] MFU: n/a (FLOPs/step unresolved; "
                        "%.2f ms/step)", epoch, mean_step * 1e3)
        h.gauge("goodput_pct", goodput)
        for reason, seconds in badput.items():
            if seconds <= 0:
                continue
            if reason == "compile":
                # deduped against any Speedometer that saw the same
                # registry delta mid-epoch (see record_compile_badput)
                from ..utils import compile as compile_mod

                record_compile_badput(
                    compile_mod.registry().snapshot()["compile_seconds"],
                    seconds, epoch=epoch)
            else:
                h.counter(f"badput_{reason}_seconds_total", seconds)
                h.emit("badput", reason=reason, seconds=seconds, epoch=epoch)
        logger.info(
            "Epoch[%d] Goodput: %.1f%% (badput: compile %.2fs, data-wait "
            "%.2fs, checkpoint %.2fs, resize %.2fs, profile %.2fs, wasted "
            "steps %d ≈ %.2fs)", epoch, goodput, badput["compile"],
            badput["data_wait"], badput["checkpoint"], badput["resize"],
            badput["profile"], wasted_steps, badput["wasted_steps"])
        h.emit("epoch_summary", **{k: v for k, v in report.items()
                                   if k != "badput"}, **{
            f"badput_{k}_seconds": v for k, v in badput.items()})
        return report
