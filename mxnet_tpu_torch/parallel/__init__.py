"""Parallelism over meshes of ``torch.distributed`` ranks.

Counterpart of ``mxnet_tpu/parallel``: a mesh with named axes

    dp - data parallel (batch)
    tp - tensor parallel (hidden)
    sp - sequence/context parallel (ring attention)
    pp - pipeline parallel (layers)
    ep - expert parallel (MoE)

where the JAX package's mesh is a grid of devices in one process, the port's
is a grid of ranks, each holding its own blocks (``mesh.py``).
"""

from .data_parallel import (allreduce_grads, grad_accum,
                            make_data_parallel_step, replicate_params,
                            shard_batch)
from .expert import init_moe_params, moe_ffn
from .mesh import auto_mesh, data_sharding, make_mesh, replicated
from .pipeline import spmd_pipeline
from .sequence import (attention_reference, ring_attention,
                       ring_flash_attention, ring_self_attention)
from .tensor_parallel import (column_parallel, row_parallel,
                              transformer_param_specs)

__all__ = [
    "make_mesh", "auto_mesh", "data_sharding", "replicated",
    "shard_batch", "replicate_params", "allreduce_grads",
    "column_parallel", "row_parallel", "transformer_param_specs",
    "ring_attention", "ring_flash_attention", "ring_self_attention",
    "attention_reference",
    "spmd_pipeline", "moe_ffn", "init_moe_params",
    "grad_accum", "make_data_parallel_step",
]
