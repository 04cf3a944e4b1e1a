"""Device context model.

Counterpart of ``mxnet_tpu/context.py``. A Context resolves to a
``torch.device``. Where the JAX package quietly falls back to a CPU device
when no accelerator is attached, :func:`gpu` here raises: a run that asked for
the card never lands on the CPU without saying so. The default context is
``gpu(0)``, where the JAX package's is ``cpu()``. ``cpu_pinned()`` is host
memory that :func:`place` pins (``pin_memory``) where a card is present,
so copies to and from the card run without a staging copy.
"""

from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "current_context",
           "num_devices", "place"]

_thread_local = threading.local()


class Context:
    """A device context, constructed via :func:`cpu` or :func:`gpu`.

    Supports ``with`` like the reference's ``mxnet.context.Context``.
    """

    def __init__(self, device_type: str, device_id: int = 0):
        if device_type not in ("cpu", "gpu", "cpu_pinned"):
            raise ValueError(f"unknown device type {device_type!r}; "
                             "expected 'cpu', 'cpu_pinned' or 'gpu'")
        self.device_type = device_type
        self.device_id = device_id
        self._old_ctx = None

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        self._old_ctx = getattr(_thread_local, "default_ctx", None)
        _thread_local.default_ctx = self
        return self

    def __exit__(self, exc_type, exc_value, traceback):
        _thread_local.default_ctx = self._old_ctx
        return False


def cpu(device_id: int = 0) -> Context:
    """Host-memory context."""
    return Context("cpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Pinned (page-locked) host memory."""
    return Context("cpu_pinned", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA card ``device_id``. Raises when CUDA or that card is absent."""
    if not torch.cuda.is_available():
        raise MXNetError("gpu(): CUDA is not available in this process")
    if device_id >= torch.cuda.device_count():
        raise MXNetError(f"gpu({device_id}): only "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return Context("gpu", device_id)


def current_context() -> Context:
    """The default context: the innermost ``with Context`` block, else
    ``gpu(0)``, which raises where there is no CUDA."""
    ctx = getattr(_thread_local, "default_ctx", None)
    return gpu(0) if ctx is None else ctx


def num_devices(device_type: str = "gpu") -> int:
    """The number of devices of ``device_type``: CUDA cards for ``"gpu"``
    (0 without CUDA; the JAX package counts its CPU devices there), one
    host for ``"cpu"`` and ``"cpu_pinned"``."""
    if device_type == "gpu":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_type in ("cpu", "cpu_pinned"):
        return 1
    raise ValueError(f"unknown device type {device_type!r}")


def place(t: torch.Tensor, ctx: Context) -> torch.Tensor:
    """``t`` on ``ctx``'s device (itself when it is already there); in
    pinned memory for ``cpu_pinned`` where a card is present."""
    t = t.to(ctx.torch_device)
    if ctx.device_type == "cpu_pinned" and torch.cuda.is_available() \
            and not t.is_pinned():
        t = t.pin_memory()
    return t
