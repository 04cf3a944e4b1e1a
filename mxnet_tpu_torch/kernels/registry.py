"""Kernel registry: every hand-written kernel declares its operation and byte
model, and from it the least time an H100 could take for the same work.

Counterpart of ``mxnet_tpu/ops/pallas/registry.py``. A cost is a pure
function of one call's full operands and results: operations counted by the
type of unit that does them, and bytes counted as every operand read once and
every result written once. The bound is the larger of bytes over the memory
rate and the sum of each type's operations over its peak rate.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["KernelCost", "KernelSpec", "register_kernel", "get_kernel",
           "H100_PEAK_OPS", "H100_HBM_BYTES_PER_S"]

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
H100_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_OPS = {
    "int8": 1979e12,  # tensor cores
    "bf16": 989e12,   # tensor cores
    "f32": 67e12,     # outside the tensor cores
}


@dataclass(frozen=True)
class KernelCost:
    """What one call costs: ``ops`` maps a unit type of
    :data:`H100_PEAK_OPS` to the operations done there; ``bytes`` is the
    device-memory traffic floor."""

    ops: dict
    bytes: float

    @property
    def flops(self) -> float:
        return float(sum(self.ops.values()))

    @staticmethod
    def io_bytes(ins, outs) -> float:
        """Every operand read once and every result written once."""
        return float(sum(t.numel() * t.element_size() for t in (*ins, *outs)))

    def bound(self):
        """``(seconds, "bytes" | "operations")``: the least time an H100
        could take for this work, and which of the two limits sets it."""
        t_ops = sum(n / H100_PEAK_OPS[kind] for kind, n in self.ops.items())
        t_bytes = self.bytes / H100_HBM_BYTES_PER_S
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: ``cost_fn(ins, outs, **static) ->
    KernelCost`` (``static``: what the call fixes besides its operands,
    such as ``causal``), the CUDA source it is built from and the TPU
    kernel it replaces."""

    name: str
    cost_fn: object
    source: str
    replaces: str

    def cost(self, ins, outs, **static) -> KernelCost:
        return self.cost_fn(ins, outs, **static)


_KERNELS: dict[str, KernelSpec] = {}


def register_kernel(name: str, cost_fn, source: str,
                    replaces: str) -> KernelSpec:
    """Register (or idempotently re-register) a kernel's cost model, its
    CUDA source and the TPU kernel (file:line) it replaces."""
    spec = _KERNELS[name] = KernelSpec(name, cost_fn, source, replaces)
    return spec


def get_kernel(name: str):
    return _KERNELS.get(name)

