"""Gradient communication across ``torch.distributed`` ranks: quantized
collectives and wire-byte accounting.

Counterpart of ``mxnet_tpu/comm/``:

  compression.py  CompressionSpec (none|bf16|int8|twobit) and the codecs
  allreduce.py    the compressed allreduce (quantize -> reduce-scatter ->
                  dequantize-accumulate -> all-gather) with error-feedback
                  residuals, over a process group or the replicas of
                  one process (ReplicaGroup)
  stats.py        exact wire-byte plans (fused and per-bucket), the
                  process CommRegistry behind ``comm_stats()``, the JAX
                  package's HLO collective parsers and their counterparts
                  over a ``torch.profiler`` trace
  bucketing.py    GradBucketer (size-capped fused slabs) and HostCodec
                  (the numpy codec of the kvstore transports)
  overlap.py      the overlapped schedule: per-bucket exchanges in
                  reverse-topological order, each started as backward
                  fills its bucket (OverlapSchedule)

Entry points: ``FeedForward.fit(kvstore="dist_sync", compression=...,
overlap=..., comm_kernels=...)``, ``parallel.make_data_parallel_step(
compression=..., overlap=...)``, ``kvstore.create("dist_sync")
.set_gradient_compression("bf16")`` with ``push_bucketed``, the
``dist_async`` transport's compressed pushes, ``comm.comm_stats()``,
``comm.collective_table(profiler)``.
"""

from .compression import (CompressionSpec, decode, encode, payload_nbytes,
                          payload_bytes_of, quantization_unit)
from .allreduce import (CommKernelConfig, ReplicaGroup, compressed_allreduce,
                        compressed_exchange, error_feedback_allreduce,
                        error_feedback_exchange, flat_views,
                        init_error_feedback, flat_size, padded_flat_size)
from .bucketing import (DEFAULT_BUCKET_BYTES, GradBucketer, HostCodec,
                        decode_payload)
from .overlap import (OverlapConfig, OverlapPlan, OverlapSchedule,
                      fused_layout_key, init_overlap_residuals,
                      overlap_allreduce, overlap_efficiency, plan_overlap,
                      residuals_match_plan, reverse_topo_param_order)
from .stats import (CommRegistry, allreduce_plan, collective_rows,
                    collective_table, collective_wire_bytes, comm_stats,
                    elementwise_table, fp32_allreduce_wire_bytes,
                    hlo_collective_rows, hlo_collective_table,
                    hlo_collective_wire_bytes, hlo_elementwise_table,
                    hlo_quantize_pass_count, overlap_plan,
                    quantize_pass_count, registry, reset_comm_stats)

__all__ = [
    "CompressionSpec", "encode", "decode", "payload_nbytes",
    "payload_bytes_of", "quantization_unit",
    "CommKernelConfig", "ReplicaGroup", "compressed_allreduce",
    "error_feedback_allreduce",
    "compressed_exchange", "error_feedback_exchange", "flat_views",
    "init_error_feedback", "flat_size", "padded_flat_size",
    "GradBucketer", "HostCodec", "decode_payload", "DEFAULT_BUCKET_BYTES",
    "OverlapConfig", "OverlapPlan", "OverlapSchedule", "plan_overlap",
    "overlap_allreduce", "init_overlap_residuals", "residuals_match_plan",
    "reverse_topo_param_order", "fused_layout_key", "overlap_efficiency",
    "CommRegistry", "registry", "comm_stats", "reset_comm_stats",
    "allreduce_plan", "overlap_plan", "fp32_allreduce_wire_bytes",
    "hlo_collective_rows", "hlo_collective_table",
    "hlo_collective_wire_bytes",
    "hlo_elementwise_table", "hlo_quantize_pass_count",
    "collective_rows", "collective_table", "collective_wire_bytes",
    "elementwise_table", "quantize_pass_count",
]
