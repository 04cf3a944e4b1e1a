"""Device memory introspection: the allocator's statistics by device.

Counterpart of ``mxnet_tpu/utils/memory.py``, over the CUDA caching
allocator (``torch.cuda.memory_stats``). The :data:`BASE_KEYS` mean what
they mean in the JAX package: ``bytes_in_use`` is the memory of live
tensors, ``peak_bytes_in_use`` its high-water mark and ``bytes_limit`` the
most the allocator can hand out, the card's total memory
(``torch.cuda.mem_get_info``). Every other key the allocator reports
(``num_alloc_retries``, ``reserved_bytes.all.current``, ...) passes
through untouched. On the CPU every base key reads 0, as the JAX
package's CPU backend reports nothing."""

from __future__ import annotations

import torch

__all__ = ["memory_stats", "BASE_KEYS"]

# Always-present keys (zeros when the backend exposes nothing — the CPU
# contract): callers may key on these unconditionally.
BASE_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def _devices():
    if not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _cuda_stats(device) -> dict:
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    stats["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
    return stats


def memory_stats(device=None) -> dict:
    """Per-device allocator stats, keyed by the device's name
    (``"cuda:0"``, ``"cpu"``). The :data:`BASE_KEYS` are always present
    (0 on the CPU); every other key the allocator reports passes through.
    ``device``: one device (a ``torch.device``, a string or a
    ``Context``); default every local device."""
    if device is None:
        devices = _devices()
    else:
        device = getattr(device, "torch_device", device)
        devices = [torch.device(device)]
    out = {}
    for d in devices:
        stats = {}
        if d.type == "cuda":
            try:
                stats = _cuda_stats(d)
            except Exception:  # noqa: BLE001 - an allocator without stats
                stats = {}
        out[str(d)] = {**{k: 0 for k in BASE_KEYS}, **stats}
    return out
