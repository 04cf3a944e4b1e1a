"""Parallelism of the port. Only the dense attention reference runs so far;
the ring attention entry points need an ``sp`` axis over several cards and
raise (``ROADMAP.md`` A5)."""

from .sequence import (attention_reference, ring_attention,
                       ring_flash_attention, ring_self_attention)

__all__ = ["attention_reference", "ring_attention", "ring_flash_attention",
           "ring_self_attention"]
