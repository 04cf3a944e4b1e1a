"""Preemption handling: turn SIGTERM into a checkpoint, not a loss.

Counterpart of ``mxnet_tpu/resilience/preempt.py``. A scheduler preempts a
job with SIGTERM, then SIGKILL after a grace window. The handler here only
sets a flag; the slow part (flushing the final checkpoint) happens at the
next step boundary of the fit loop, on the main thread, where the device
state is consistent. ``fit`` then raises ``TrainingPreempted``, so the
caller (or the relaunch wrapper) knows the run stopped with its state on
disk, and the next ``fit`` on the same checkpoint directory resumes from
the flushed step.

The handler chains any SIGTERM handler installed before it, installs only
from the main thread (the signal module's contract), and is refcounted so
nested fits share one installation.
"""

from __future__ import annotations

import logging
import signal
import threading

from ..analysis.lockwatch import named_lock
from ..base import MXNetError

__all__ = ["TrainingPreempted", "PreemptionHandler", "preemption_requested"]


class TrainingPreempted(MXNetError):
    """Training stopped on SIGTERM after flushing a checkpoint."""

    def __init__(self, message, step=None, epoch=None):
        super().__init__(message)
        self.step = step
        self.epoch = epoch


class PreemptionHandler:
    """Process-wide SIGTERM flag (install/uninstall are refcounted)."""

    _lock = named_lock("preempt.handler")
    _refs = 0
    _prev = None
    _requested = False

    @classmethod
    def install(cls):
        """Install the handler. Returns the handler class (pass it to
        ``uninstall`` exactly once) — or None when installation is
        impossible (not the main thread): then NO reference is held and
        the caller must not uninstall, so a concurrent main-thread fit's
        live handler is never torn down by a failed installer."""
        with cls._lock:
            if cls._refs == 0:
                try:
                    cls._prev = signal.signal(signal.SIGTERM, cls._on_term)
                except ValueError:  # not the main thread
                    logging.warning(
                        "preemption handler not installed (not on the main "
                        "thread); SIGTERM will not flush a checkpoint")
                    cls._prev = None
                    return None
                cls._requested = False
            cls._refs += 1
        return cls

    @classmethod
    def uninstall(cls):
        with cls._lock:
            if cls._refs == 0:
                return
            cls._refs -= 1
            if cls._refs == 0 and cls._prev is not None:
                try:
                    signal.signal(signal.SIGTERM, cls._prev)
                except ValueError:  # pragma: no cover - non-main thread
                    pass
                cls._prev = None

    @classmethod
    def _on_term(cls, signum, frame):
        cls._requested = True
        logging.warning(
            "SIGTERM received: will flush a checkpoint at the next step "
            "boundary and stop")
        prev = cls._prev
        if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    @classmethod
    def requested(cls) -> bool:
        return cls._requested

    @classmethod
    def clear(cls):
        cls._requested = False


def preemption_requested() -> bool:
    """Has SIGTERM been seen since the handler was installed/cleared?"""
    return PreemptionHandler.requested()
