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
  worker churn (die / rejoin)       -> elastic.ElasticCoordinator: resize
                                       the world of replicas mid-run
                                       without a process restart
                                       (``fit(elastic=)``; kvstore stalls
                                       raise MembershipTimeout, a detected
                                       membership change)
  nobody watching the dashboards    -> controller.FleetController: the
                                       policy loop from telemetry to
                                       actuation (evict blamed stragglers,
                                       backfill, retier the compression,
                                       world size by goodput per chip,
                                       checkpoint cadence) with
                                       hysteresis, cooldowns, dry run and
                                       its own circuit breaker
                                       (``fit(controller=)``)
  proving any of it works           -> chaos (seeded fault injection)
"""

from .chaos import (Chaos, ChaosConfig, TransientError, TransientStepError,
                    chaos_scope)
from . import chaos
from . import ckpt_async
from .ckpt_async import (AsyncCheckpointWriter, ReplicaStore, Snapshot,
                         capture_snapshot)
from . import controller
from . import elastic
from .controller import FleetController, FleetControllerConfig
from .elastic import (ElasticCoordinator, MembershipChanged,
                      MembershipTimeout, ResizeEvent)
from .guards import GuardConfig, StepTimeoutError, StepWatchdog
from .preempt import PreemptionHandler, TrainingPreempted
from .retry import CircuitBreaker, CircuitOpenError, RetryingKVStore, \
    RetryPolicy, retry_call

__all__ = ["chaos", "Chaos", "ChaosConfig", "chaos_scope",
           "TransientError", "TransientStepError",
           "ckpt_async", "AsyncCheckpointWriter", "ReplicaStore",
           "Snapshot", "capture_snapshot",
           "controller", "FleetController", "FleetControllerConfig",
           "elastic", "ElasticCoordinator", "MembershipChanged",
           "MembershipTimeout", "ResizeEvent",
           "GuardConfig", "StepTimeoutError", "StepWatchdog",
           "PreemptionHandler", "TrainingPreempted",
           "CircuitBreaker", "CircuitOpenError", "RetryingKVStore",
           "RetryPolicy", "retry_call"]
