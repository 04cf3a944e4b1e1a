"""Parallelism of the port: data parallelism over ``torch.distributed``
ranks (``data_parallel.py``) and the dense attention reference. The ring
attention entry points need an ``sp`` axis over several cards and raise
(``ROADMAP.md`` A5)."""

from .data_parallel import (allreduce_grads, grad_accum,
                            make_data_parallel_step)
from .sequence import (attention_reference, ring_attention,
                       ring_flash_attention, ring_self_attention)

__all__ = ["allreduce_grads", "grad_accum", "make_data_parallel_step",
           "attention_reference", "ring_attention", "ring_flash_attention",
           "ring_self_attention"]
