"""Kernel registry: every hand-written kernel declares its operation and byte
model, and from it the least time an H100 could take for the same work.

Counterpart of ``mxnet_tpu/ops/pallas/registry.py``. A cost is a pure
function of one call's full operands and results: operations counted by the
type of unit that does them, and bytes counted as every operand read once and
every result written once. The bound is the larger of bytes over the memory
rate and the sum of each type's operations over its peak rate.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..analysis.lockwatch import named_lock

__all__ = ["KernelCost", "KernelSpec", "register_kernel", "get_kernel",
           "kernel_names", "kernel_of_symbol", "H100_PEAK_OPS",
           "H100_HBM_BYTES_PER_S"]

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
_LOCK = named_lock("ops.pallas.KernelRegistry")


def register_kernel(name: str, cost_fn, source: str,
                    replaces: str) -> KernelSpec:
    """Register (or idempotently re-register) a kernel's cost model, its
    CUDA source and the TPU kernel (file:line) it replaces."""
    spec = KernelSpec(name, cost_fn, source, replaces)
    with _LOCK:
        _KERNELS[name] = spec
    return spec


def get_kernel(name: str):
    with _LOCK:
        return _KERNELS.get(name)


def kernel_names():
    """The registered kernels' names (the profiler's kernel categories)."""
    with _LOCK:
        return sorted(_KERNELS)



# CUDA symbols of the kernels in csrc/ -> the registry name of the kernel
# they implement (the profiler names a device event by it). Checked in
# order: the dequantize names before the quantize ones they contain.
_SYMBOLS = (
    ("fused_adam", r"fused_adam_kernel"),
    ("int8_matmul", r"quantize_rows_kernel|int8_gemm_kernel"),
    ("dequant_sum_int8", r"dequant_sum_int8_kernel"),
    ("dequant_sum_twobit", r"dequant_sum_twobit(_byte)?_kernel"),
    ("dequant_int8", r"dequant_int8_kernel"),
    ("dequant_twobit", r"dequant_twobit_kernel"),
    ("quant_int8", r"(?<![a-z_])quant_int8(_chunk)?_kernel"),
    ("quant_twobit", r"(?<![a-z_])quant_twobit(_vec)?_kernel"),
    ("flash_bwd_dkv", r"flash_bwd_dkv_(kernel|hopper)"),
    ("flash_bwd_dq", r"flash_bwd_dq_(kernel|hopper)"),
    ("flash_fwd", r"flash_fwd_(kernel|hopper)"),
)
_SYMBOL_RES = tuple((name, re.compile(pat)) for name, pat in _SYMBOLS)


def kernel_of_symbol(symbol: str):
    """The registry name of the hand-written kernel a CUDA symbol (a
    device event's name in a trace) belongs to, or None."""
    for name, pattern in _SYMBOL_RES:
        if pattern.search(symbol):
            return name
    return None
