"""Monitor: statistics of a bound executor's internal outputs and weights.

Counterpart of ``mxnet_tpu/monitor.py``: ``Monitor(interval, stat_func,
pattern)`` with ``install``, ``tic``, ``toc`` and ``toc_print``, and
``nonfinite_count``. As in the JAX package, ``toc`` runs the bound symbol's
``get_internals()`` graph once more (eval mode, the executor's current
arguments and auxiliary states) and applies ``stat_func`` to every internal
output and argument whose name ``pattern`` matches (``re.match``), on the
host. Every node is a head of that graph, so the fusion plan leaves each
output as its op computed it (a BatchNorm before its ReLU, say).

``track_compiles`` adds the program registry's rows
(``utils.compile``) to each ``toc``, and ``collect_compiles`` returns them:
``compile/count``, ``compile/seconds`` (capture seconds on a card),
``compile/jit_misses`` and ``compile/<label>`` for each program first seen
since the last collection, with a ``RecompileTracker``'s ``recompile/<label>``
rows. ``track_comm`` does the same for the gradient-communication
registry (``comm.registry()``): ``collect_comm`` returns ``comm/steps``,
``comm/wire_bytes`` and ``comm/fp32_wire_bytes``, each the change of the
registry's ``snapshot()`` since the last collection (or since the monitor
was made), and each ``toc`` appends them
(mxnet_tpu/monitor.py:59-62,92-95,169-170,191-209).
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

from .executor import _build_graph_fn

__all__ = ["Monitor", "nonfinite_count"]


def nonfinite_count(x) -> int:
    """Number of NaN and inf elements of an array (0 for integer types).
    A tensor is counted where it lies, and one scalar crosses to the host;
    anything else goes through numpy."""
    if isinstance(x, torch.Tensor):
        if not x.is_floating_point():
            return 0
        return int(x.numel() - torch.isfinite(x).sum())
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        return 0
    return int(x.size - np.isfinite(x).sum())


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 and float16 widen to float32, which
    holds them exactly (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


class Monitor:
    """Collect ``stat_func`` of the matched internals every ``interval``
    batches. ``track_nonfinite`` adds a ``<name>_nonfinite`` row with the
    NaN/inf count of each matched output and argument."""

    def __init__(self, interval, stat_func=None, pattern=".*",
                 track_nonfinite=False, track_compiles=False,
                 track_comm=False):
        self.track_compiles = track_compiles
        self.track_comm = track_comm
        # the first collection reports what moved since the monitor was made
        self._comm_snap = None
        if track_comm:
            from . import comm as comm_mod

            self._comm_snap = comm_mod.registry().snapshot()
        self._compile_snap = None
        self._recompile_events = []
        self.interval = interval
        self.stat_func = stat_func or (lambda x: np.abs(x).mean())
        self.pattern = re.compile(pattern)
        self.track_nonfinite = track_nonfinite
        self.step = 0
        self.activated = False
        self.queue = []
        self._exe = None
        self._graph = None  # (internals symbol, its eval graph function)

    def install(self, exe):
        """Attach to an Executor."""
        self._exe = exe
        self._graph = None

    def tic(self):
        """Start a batch: collection is armed every ``interval`` batches."""
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        self.step += 1

    def _rows(self, name, value):
        rows = [(self.step, name, self.stat_func(_host(value)))]
        if self.track_nonfinite:
            rows.append((self.step, name + "_nonfinite",
                         nonfinite_count(value)))
        return rows

    def toc(self):
        """End a batch: when armed, the rows ``(step, name, stat)`` of every
        matched internal output, then of every matched argument."""
        if not self.activated or self._exe is None:
            return []
        self.activated = False
        exe = self._exe
        if self._graph is None:
            internals = exe._symbol.get_internals()
            self._graph = (internals, _build_graph_fn(internals,
                                                      is_train=False))
        internals, fn = self._graph
        with torch.inference_mode():
            outs, _ = fn(exe.arg_dict, exe.aux_dict)
        res = []
        for name, value in zip(internals.list_outputs(), outs):
            if self.pattern.match(name):
                res.extend(self._rows(name, value))
        for name, arr in exe.arg_dict.items():
            if self.pattern.match(name):
                res.extend(self._rows(name, arr))
        if self.track_compiles:
            res.extend(self.collect_compiles())
        else:
            res.extend(self._drain_recompiles())
        if self.track_comm:
            res.extend(self.collect_comm())
        self.queue = res
        self._publish(res)
        return res

    def _publish(self, rows):
        """Mirror the collected stat rows into the telemetry hub (gauges
        labeled by stat name + one ``monitor`` event per collection), so
        Monitor output reaches the same exporters as everything else
        (mxnet_tpu/monitor.py:176-189)."""
        from . import telemetry

        published = 0
        for _, name, stat in rows:
            try:
                value = float(stat)
            except (TypeError, ValueError):
                continue  # a non-scalar stat_func output stays queue-only
            telemetry.gauge("monitor_stat", value, stat=name)
            published += 1
        telemetry.emit("monitor", rows=published, step=self.step)

    def toc_print(self):
        for step, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, stat)

    def collect_comm(self):
        """The comm registry's changes since the last collection, as rows
        ``comm/steps``, ``comm/wire_bytes`` and ``comm/fp32_wire_bytes``
        (what the same steps would have sent uncompressed)."""
        from . import comm as comm_mod

        stats = comm_mod.registry().snapshot()
        prev = self._comm_snap or {"steps": 0, "wire_bytes": 0.0,
                                   "fp32_wire_bytes": 0.0}
        res = [
            (self.step, "comm/steps", stats["steps"] - prev["steps"]),
            (self.step, "comm/wire_bytes",
             stats["wire_bytes"] - prev["wire_bytes"]),
            (self.step, "comm/fp32_wire_bytes",
             stats["fp32_wire_bytes"] - prev["fp32_wire_bytes"]),
        ]
        self._comm_snap = stats
        return res

    def _drain_recompiles(self):
        events, self._recompile_events = self._recompile_events, []
        return events

    def collect_compiles(self):
        """The program registry's deltas since the last collection, as
        rows (mxnet_tpu/monitor.py:214-240)."""
        from .utils import compile as compile_mod

        stats = compile_mod.compile_stats()
        prev = self._compile_snap or {"compiles": 0, "compile_seconds": 0.0,
                                      "misses": 0, "per_function": {}}
        res = [
            (self.step, "compile/count", stats["compiles"] - prev["compiles"]),
            (self.step, "compile/seconds",
             stats["compile_seconds"] - prev["compile_seconds"]),
            (self.step, "compile/jit_misses",
             stats["misses"] - prev["misses"]),
        ]
        for label, c in stats["per_function"].items():
            before = prev["per_function"].get(label, {}).get("compiles", 0)
            if c["compiles"] > before:
                res.append((self.step, f"compile/{label}",
                            c["compiles"] - before))
        res.extend(self._drain_recompiles())
        self._compile_snap = stats
        return res
