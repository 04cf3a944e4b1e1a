"""Wire-byte accounting: the comm plan and the process registry.

Counterpart of the part of ``mxnet_tpu/comm/stats.py`` that ``fit`` and
the kvstore transports use (``stats.py:46-151,155-240``). The plan is exact
arithmetic from shapes, with the ring-algorithm wire factors:

    all-reduce     2·(n-1)/n · payload
    all-gather     (n-1)/n · output bytes
    all-to-all     (n-1)/n · payload

The JAX package's HLO parsers have no counterpart here (ROADMAP A6).
"""

from __future__ import annotations

import threading

from .compression import CompressionSpec, payload_nbytes, quantization_unit

__all__ = ["allreduce_plan", "overlap_plan", "fp32_allreduce_wire_bytes",
           "CommRegistry", "registry", "comm_stats", "reset_comm_stats"]


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
        self._lock = threading.Lock()
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
