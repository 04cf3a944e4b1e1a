"""Device context model.

Counterpart of ``mxnet_tpu/context.py``. A Context resolves to a
``torch.device``. Where the JAX package quietly falls back to a CPU device
when no accelerator is attached, :func:`gpu` here raises: a run that asked for
the card never lands on the CPU without saying so. The default context is
``gpu(0)``, where the JAX package's is ``cpu()``. ``cpu_pinned()`` is host
memory that :func:`place` pins (``pin_memory``) where a card is present,
so copies to and from the card run without a staging copy.

Device identity is the JAX package's (mxnet_tpu/context.py:76-83):
``gpu(i)`` is card ``i % n`` of the ``n`` CUDA cards, and ``cpu(i)`` is
host device ``i % n`` of the ``n`` host devices that
``--xla_force_host_platform_device_count=n`` in ``XLA_FLAGS`` declares (1
without it), the variable the JAX package's CPU backend honours. Torch
has one CPU device, so host devices differ only as replicas:
:attr:`Context.replica_key` tells them apart, and a ctx list of
``[cpu(i) for i in range(4)]`` is four replicas in one process where the
JAX package sees four devices.
"""

from __future__ import annotations

import os
import re
import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "current_context",
           "num_devices", "place", "host_device_count", "distinct_contexts"]

_thread_local = threading.local()
_HOST_COUNT = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def host_device_count() -> int:
    """The host devices a ``cpu(i)`` resolves among: the count that
    ``--xla_force_host_platform_device_count`` in ``XLA_FLAGS`` sets, else
    1, read at each call."""
    found = _HOST_COUNT.findall(os.environ.get("XLA_FLAGS", ""))
    return max(1, int(found[-1])) if found else 1


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
    def replica_key(self) -> tuple:
        """The device this context resolves to, as the JAX package resolves
        it: ``("gpu", i % cards)`` or ``("cpu", i % host devices)``. Two
        contexts with one key are aliases of one device."""
        if self.device_type == "gpu":
            return ("gpu", self.device_id % max(1, torch.cuda.device_count()))
        return ("cpu", self.device_id % host_device_count())

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "gpu":
            return torch.device("cuda", self.replica_key[1])
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
    """CUDA card ``device_id % n`` of the ``n`` cards (the JAX package's
    rule). Raises when CUDA is absent."""
    if not torch.cuda.is_available():
        raise MXNetError("gpu(): CUDA is not available in this process")
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


def distinct_contexts(ctx_list) -> list:
    """The replicas of a ctx list: its contexts with aliases of one device
    removed (by :attr:`Context.replica_key`), in list order
    (mxnet_tpu/model.py:449-460)."""
    seen, out = set(), []
    for c in ctx_list:
        if c.replica_key not in seen:
            seen.add(c.replica_key)
            out.append(c)
    return out


def place(t: torch.Tensor, ctx: Context) -> torch.Tensor:
    """``t`` on ``ctx``'s device (itself when it is already there); in
    pinned memory for ``cpu_pinned`` where a card is present."""
    t = t.to(ctx.torch_device)
    if ctx.device_type == "cpu_pinned" and torch.cuda.is_available() \
            and not t.is_pinned():
        t = t.pin_memory()
    return t
