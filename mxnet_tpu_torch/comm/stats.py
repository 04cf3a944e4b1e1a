"""Wire-byte accounting: the comm plan and the process registry.

Counterpart of the part of ``mxnet_tpu/comm/stats.py`` that ``fit`` uses
(``stats.py:46-92,155-240``). The plan is exact arithmetic from shapes,
with the ring-algorithm wire factors:

    all-reduce     2·(n-1)/n · payload
    all-gather     (n-1)/n · output bytes
    all-to-all     (n-1)/n · payload

The JAX package's HLO parsers have no counterpart here (ROADMAP A6).
"""

from __future__ import annotations

import threading

from .compression import CompressionSpec, payload_nbytes, quantization_unit

__all__ = ["allreduce_plan", "fp32_allreduce_wire_bytes", "CommRegistry",
           "registry", "comm_stats", "reset_comm_stats"]


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


class CommRegistry:
    """Per-program comm plans + per-step wire counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._plans = {}
            self._steps = {}

    def register_plan(self, label: str, plan: dict):
        with self._lock:
            self._plans[label] = dict(plan)
            self._steps.setdefault(label, 0)

    def record_step(self, label: str, count: int = 1):
        """One (or ``count``) dispatches of ``label``'s per-step plan."""
        with self._lock:
            self._steps[label] = self._steps.get(label, 0) + int(count)

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
            return {
                "steps": steps,
                "wire_bytes": wire,
                "fp32_wire_bytes": fp32,
                "ratio": (fp32 / wire) if wire else None,
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
