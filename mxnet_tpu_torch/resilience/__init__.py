"""Fault tolerance for the training stack.

Counterpart of ``mxnet_tpu/resilience/``:

  lost / delayed kvstore messages   -> retry.RetryingKVStore (backoff,
                                       jitter and idempotent resends)
  a server group down               -> retry.CircuitBreaker degrading to
                                       local aggregation
  non-finite loss / gradients       -> guards (a device-side skip and a
                                       dynamic loss scale, ``fit(guards=)``)
  hung steps                        -> guards.StepWatchdog
  preemption (SIGTERM)              -> preempt.PreemptionHandler and the
                                       checkpoint flush in ``fit``
  torn / corrupt checkpoints        -> utils.checkpoint's manifest (CRC)
                                       and ``latest_step`` skipping them
  work lost to coarse checkpoints   -> ckpt_async: snapshots, the peer
                                       tier and the step-granular disk tier
  proving any of it works           -> chaos (seeded fault injection)

Elastic resizing and the fleet controller (``elastic.py``,
``controller.py``) are a later item of the port: ``fit(elastic=...)`` and
``fit(controller=...)`` raise naming ROADMAP A6.
"""

from .chaos import (Chaos, ChaosConfig, TransientError, TransientStepError,
                    chaos_scope)
from . import chaos
from . import ckpt_async
from .ckpt_async import (AsyncCheckpointWriter, ReplicaStore, Snapshot,
                         capture_snapshot)
from .guards import GuardConfig, StepTimeoutError, StepWatchdog
from .preempt import PreemptionHandler, TrainingPreempted
from .retry import CircuitBreaker, CircuitOpenError, RetryingKVStore, \
    RetryPolicy, retry_call

__all__ = ["chaos", "Chaos", "ChaosConfig", "chaos_scope",
           "TransientError", "TransientStepError",
           "ckpt_async", "AsyncCheckpointWriter", "ReplicaStore",
           "Snapshot", "capture_snapshot",
           "GuardConfig", "StepTimeoutError", "StepWatchdog",
           "PreemptionHandler", "TrainingPreempted",
           "CircuitBreaker", "CircuitOpenError", "RetryingKVStore",
           "RetryPolicy", "retry_call"]
