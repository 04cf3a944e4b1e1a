"""Step guards: keep one bad step from killing (or silently poisoning) a run.

Counterpart of ``mxnet_tpu/resilience/guards.py``. Three mechanisms, kept
off the host in the hot path:

  non-finite guard   The train step computes one ``finite`` flag on the
                     device: isfinite(loss + the sum of the per-tensor
                     gradient sums), the reference's order; NaN and inf
                     propagate through the sums. The parameter, optimizer,
                     auxiliary and metric updates are selected between new
                     and old state with that flag, so a NaN step is a
                     no-op. The skip counter stays on the device and is
                     read once an epoch.

  dynamic loss scale The guard state holds a loss scale on the device: the
                     loss is scaled before backward and the gradients
                     unscaled before the update. A non-finite step backs
                     the scale off (x ``scale_backoff``); ``growth_interval``
                     finite steps in a row grow it (x ``scale_growth``,
                     capped). With ``dynamic_loss_scale=False`` the scale
                     stays at ``init_scale`` (1.0 by default: skip-on-NaN
                     only, the right default for f32).

  step watchdog      A host deadline on step progress. The fit loop beats
                     after every completed step; if no beat lands within
                     ``watchdog_deadline`` seconds the watchdog trips.
                     Monitoring starts at the first beat, after the first
                     step's warm-up and capture. In process a trip
                     surfaces as ``StepTimeoutError`` at the next check;
                     for a wedged device program, MXNET_TPU_WATCHDOG_ABORT=1
                     escalates to SIGTERM, which flushes the preemption
                     checkpoint.

The device functions take and give torch tensors on the step's device and
never read a value back to the host, so they run inside a captured step.
``init_guard_state`` makes the state's tensors once; the ``_`` forms of
``guard_select`` and ``update_guard_state`` write into existing tensors,
which is what a CUDA graph replays.
"""

from __future__ import annotations

import logging
import os
import signal
import threading

import torch

from ..analysis.lockwatch import named_lock
from ..base import MXNetError, env_bool

__all__ = ["GuardConfig", "StepTimeoutError", "StepWatchdog",
           "init_guard_state", "finite_flag", "guard_select",
           "guard_select_", "update_guard_state", "update_guard_state_"]


class StepTimeoutError(MXNetError):
    """A step exceeded the watchdog deadline."""


class GuardConfig:
    """Knobs for the in-step guards (see module docstring)."""

    def __init__(self, skip_nonfinite=True, init_scale=1.0,
                 dynamic_loss_scale=False, scale_backoff=0.5,
                 scale_growth=2.0, growth_interval=200, max_scale=2.0 ** 16,
                 min_scale=2.0 ** -14, max_step_retries=2,
                 watchdog_deadline=None):
        self.skip_nonfinite = skip_nonfinite
        self.init_scale = float(init_scale)
        self.dynamic_loss_scale = dynamic_loss_scale
        self.scale_backoff = float(scale_backoff)
        self.scale_growth = float(scale_growth)
        self.growth_interval = int(growth_interval)
        self.max_scale = float(max_scale)
        self.min_scale = float(min_scale)
        self.max_step_retries = int(max_step_retries)
        self.watchdog_deadline = watchdog_deadline

    @classmethod
    def resolve(cls, guards):
        """Normalize fit()'s ``guards`` argument: None -> env gate
        MXNET_TPU_GUARDS, True -> defaults, GuardConfig -> itself."""
        if guards is None:
            return cls() if env_bool("MXNET_TPU_GUARDS", False) else None
        if guards is True:
            return cls()
        if guards is False:
            return None
        if isinstance(guards, cls):
            return guards
        raise MXNetError(f"guards must be bool/None/GuardConfig, "
                         f"got {type(guards)}")

    def key(self):
        """Hashable identity: a part of a guarded step's program key, as
        ``repr(vars(guard_cfg))`` is of the JAX package's
        (mxnet_tpu/model.py:531)."""
        return ("guards", repr(vars(self)))

    def pinned_unit_scale(self, scale=None) -> bool:
        """Does the loss scale stay 1.0 for the whole run? Then scaling
        the loss and unscaling the gradients are identities, and the step
        leaves them out."""
        start = self.init_scale if scale is None else float(scale)
        return not self.dynamic_loss_scale and start == 1.0


def init_guard_state(cfg: GuardConfig, scale=None, device=None):
    """The guard state on ``device``: the loss scale (f32), the skip
    counter and the finite streak (int32), and the last step's flag
    (f32 1.0 or 0.0)."""
    def full(value, dtype):
        return torch.full((), value, dtype=dtype, device=device)

    return {
        "scale": full(cfg.init_scale if scale is None else float(scale),
                      torch.float32),
        "skipped": full(0, torch.int32),
        "streak": full(0, torch.int32),
        "last_finite": full(1.0, torch.float32),
    }


def finite_flag(loss, grads):
    """One 0-d bool tensor: the whole step is finite. Each gradient is
    summed in f32, then ``loss`` and the sums are added (the reference's
    order: per-tensor sums, then their sum), so a finite gradient whose
    sum overflows flags the step too. ``grads``: a dict (summed in sorted
    name order, as the JAX package's dict flattens) or a list."""
    if isinstance(grads, dict):
        grads = [grads[k] for k in sorted(grads)]
    total = loss.detach().float().reshape(())
    if grads:
        sums = torch.stack([g.detach().float().sum() for g in grads])
        total = total + sums.sum()
    return torch.isfinite(total)


def guard_select(finite, new_tree, old_tree):
    """Per leaf: the new value when the step was finite, else the old
    (a dict or a list of tensors; new tensors are returned)."""
    if isinstance(new_tree, dict):
        return {k: torch.where(finite, v, old_tree[k])
                for k, v in new_tree.items()}
    return [torch.where(finite, n, o) for n, o in zip(new_tree, old_tree)]


def guard_select_(finite, tensors, olds):
    """:func:`guard_select` into ``tensors`` themselves: each keeps its new
    value when the step was finite and takes its old one (``olds``, a
    snapshot taken before the step) when not."""
    for t, o in zip(tensors, olds):
        torch.where(finite, t, o, out=t)


def update_guard_state(cfg: GuardConfig, gstate, finite):
    """The guard counters and loss scale after a step with flag
    ``finite`` (a new state; :func:`update_guard_state_` writes in
    place)."""
    keep = finite
    skipped = gstate["skipped"] + torch.where(keep, 0, 1).to(torch.int32)
    streak = torch.where(keep, gstate["streak"] + 1,
                         torch.zeros_like(gstate["streak"]))
    scale = gstate["scale"]
    if cfg.dynamic_loss_scale:
        grown = torch.clamp(scale * cfg.scale_growth, max=cfg.max_scale)
        backed = torch.clamp(scale * cfg.scale_backoff, min=cfg.min_scale)
        grow_now = torch.logical_and(keep, streak >= cfg.growth_interval)
        scale = torch.where(keep, torch.where(grow_now, grown, scale),
                            backed)
        streak = torch.where(grow_now, torch.zeros_like(streak), streak)
    return {"scale": scale, "skipped": skipped, "streak": streak,
            "last_finite": keep.to(torch.float32)}


def update_guard_state_(cfg: GuardConfig, gstate, finite):
    """:func:`update_guard_state` written into ``gstate``'s tensors."""
    new = update_guard_state(cfg, gstate, finite)
    for k, v in new.items():
        gstate[k].copy_(v)
    return gstate


class StepWatchdog:
    """Deadline monitor for step progress.

    ``beat()`` after every completed step; ``check()`` raises
    StepTimeoutError once the deadline has passed without a beat. A
    background timer handles the case where the main thread never reaches
    a check(): it logs, and with MXNET_TPU_WATCHDOG_ABORT=1 escalates to
    SIGTERM (-> preemption flush) after one extra deadline of grace.
    """

    def __init__(self, deadline: float, abort=None):
        self.deadline = float(deadline)
        self.expired = False
        self._abort = env_bool("MXNET_TPU_WATCHDOG_ABORT", False) \
            if abort is None else abort
        self._lock = named_lock("guards.StepWatchdog")
        self._timer = None
        self._stopped = False
        # NOT armed at construction: monitoring starts at the first beat()
        # (i.e. after the first completed step), so first-step jit
        # compilation — minutes for big programs — never counts against a
        # per-step deadline sized for steady-state steps

    def _arm(self):
        with self._lock:
            if self._stopped:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self.deadline, self._trip)
            self._timer.daemon = True
            self._timer.start()

    def _trip(self):
        self.expired = True
        logging.error("step watchdog: no step completed within %.1fs",
                      self.deadline)
        # black box first: a wedged step is exactly the state the flight
        # recorder exists for (no-op unless MXNET_TPU_FLIGHT_DIR is set)
        from .. import telemetry

        telemetry.emit("watchdog", deadline=self.deadline)
        telemetry.flight.auto_dump("watchdog")
        if self._abort:
            logging.critical(
                "step watchdog: escalating to SIGTERM (preemption flush); "
                "hard exit in %.1fs if the flush cannot run", self.deadline)
            os.kill(os.getpid(), signal.SIGTERM)
            killer = threading.Timer(self.deadline,
                                     lambda: os._exit(124))
            killer.daemon = True
            killer.start()

    def beat(self):
        """A step completed: clear any expiry and reset the deadline (a
        late-but-finished step must not kill the run at the next check)."""
        self.expired = False
        self._arm()

    def check(self):
        """Raise if the deadline expired since the last beat."""
        if self.expired:
            raise StepTimeoutError(
                f"train step exceeded watchdog deadline of "
                f"{self.deadline:.1f}s")

    def stop(self):
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
