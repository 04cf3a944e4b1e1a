"""Gradient communication across ``torch.distributed`` ranks: quantized
collectives and wire-byte accounting.

Counterpart of ``mxnet_tpu/comm/``:

  compression.py  CompressionSpec (none|bf16|int8|twobit) and the codecs
  allreduce.py    the compressed allreduce (quantize -> reduce-scatter ->
                  dequantize-accumulate -> all-gather) with error-feedback
                  residuals, over a process group
  stats.py        exact wire-byte plans and the process CommRegistry
                  behind ``comm_stats()``

Entry points: ``FeedForward.fit(kvstore="dist_sync", compression=...,
comm_kernels=...)``, ``parallel.make_data_parallel_step(compression=...)``,
``kvstore.create("dist_sync").set_gradient_compression("bf16")``,
``comm.comm_stats()``. The bucketing, overlap scheduler and host codec of
the JAX package are not ported yet: their names raise
``NotImplementedError`` naming ROADMAP A4.
"""

from .compression import (CompressionSpec, decode, encode, payload_nbytes,
                          payload_bytes_of, quantization_unit)
from .allreduce import (CommKernelConfig, compressed_allreduce,
                        compressed_exchange, error_feedback_allreduce,
                        error_feedback_exchange, flat_views,
                        init_error_feedback, flat_size, padded_flat_size)
from .stats import (CommRegistry, allreduce_plan, comm_stats,
                    fp32_allreduce_wire_bytes, registry, reset_comm_stats)

__all__ = [
    "CompressionSpec", "encode", "decode", "payload_nbytes",
    "payload_bytes_of", "quantization_unit",
    "CommKernelConfig", "compressed_allreduce", "error_feedback_allreduce",
    "compressed_exchange", "error_feedback_exchange", "flat_views",
    "init_error_feedback", "flat_size", "padded_flat_size",
    "CommRegistry", "registry", "comm_stats", "reset_comm_stats",
    "allreduce_plan", "fp32_allreduce_wire_bytes",
]

# names of the JAX package's comm/ that later work brings
_LATER = ("GradBucketer", "HostCodec", "decode_payload",
          "DEFAULT_BUCKET_BYTES", "OverlapConfig", "OverlapPlan",
          "plan_overlap", "overlap_allreduce", "init_overlap_residuals",
          "residuals_match_plan", "reverse_topo_param_order",
          "fused_layout_key", "overlap_efficiency", "overlap_plan",
          "hlo_collective_rows", "hlo_collective_table",
          "hlo_collective_wire_bytes", "hlo_elementwise_table",
          "hlo_quantize_pass_count")


def __getattr__(name):
    if name in _LATER:
        item = "A6 (a torch.profiler table)" if name.startswith("hlo_") \
            else "A4 (left from slice 4: comm/bucketing.py, comm/overlap.py)"
        raise NotImplementedError(
            f"comm.{name} is not ported yet: ROADMAP {item}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
