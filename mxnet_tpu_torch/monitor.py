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
rows. The communication rows (``track_comm``, ``collect_comm``) read a
registry of a later item: they raise naming it.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import torch

from .executor import _build_graph_fn

__all__ = ["Monitor", "nonfinite_count"]

_A6 = "ROADMAP A6 (comm/stats)"


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
        if track_comm:
            raise NotImplementedError(
                f"Monitor(track_comm) is not ported yet: {_A6}")
        self.track_compiles = track_compiles
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
        self.queue = res
        return res

    def toc_print(self):
        for step, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, stat)

    def collect_comm(self):
        raise NotImplementedError(
            f"Monitor.collect_comm is not ported yet: {_A6}")

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
