"""Deterministic fault injection for resilience testing.

Counterpart of ``mxnet_tpu/resilience/chaos.py``, with the same sites,
the same seeded schedules and the same ``MXNET_TPU_CHAOS`` format: the same
seed and rules fire at the same occurrences in either package. Every
failure has a *site* name and a seeded trigger, so a test (and only a
test: the hooks are no-ops unless armed) replays the same failure schedule
on every run.

Sites wired through the port:

  ``kvstore.push`` / ``kvstore.pull``   RetryingKVStore drops the op
                                        (raises TransientError before the
                                        inner store sees it)
  ``kvstore.delay``                     RetryingKVStore sleeps before the op
  ``group.push.send``                   _GroupWorkerKVStore: request lost
                                        before reaching the BSP server
  ``group.push.ack``                    _GroupWorkerKVStore: the server
                                        applied the push but the ack was
                                        lost; the retry resends a duplicate
  ``async.call``                        AsyncKVStore: the client socket dies
                                        mid-request (reconnect and resend)
  ``ckpt.corrupt``                      save_sharded: flip bytes in one
                                        written shard after the manifest
                                        (its CRC catches it)
  ``ckpt.async_write``                  AsyncCheckpointWriter: a background
                                        write fails (counted, never raised)
  ``ckpt.replica``                      fit: a cadence snapshot is lost on
                                        its way to the peer tier
  ``step.nan``                          fit: poison the batch with NaN so
                                        the loss and gradients go
                                        non-finite
  ``step.raise``                        fit: raise TransientStepError before
                                        dispatching the train step
  ``step.hang``                         fit: a hung step (host sleep until
                                        the watchdog trips)
  ``elastic.kill``                      ElasticCoordinator.chaos_poll: the
                                        highest alive rank dies
  ``elastic.rejoin``                    ElasticCoordinator.chaos_poll: every
                                        departed rank rejoins

Triggers are a probability in [0, 1) (each query of the site draws from a
per-site ``random.Random`` seeded by ``(seed, site)``) or a set of
occurrence indices (0-based per-site call counter), so a test can say
"corrupt exactly the third checkpoint".

Activation::

  with chaos_scope(seed=7, rules={"kvstore.push": 0.3, "step.nan": {2}}):
      model.fit(...)

or, for subprocess tests, ``MXNET_TPU_CHAOS="seed=7;kvstore.push=0.3;
step.nan=#2;step.nan=#5"``. Disarmed, each site costs one global read.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import threading
import time

from ..analysis.lockwatch import named_lock
from ..base import MXNetError

__all__ = ["TransientError", "TransientStepError", "ChaosConfig", "Chaos",
           "chaos_scope", "install", "uninstall", "active", "fires",
           "maybe_raise", "maybe_sleep"]


class TransientError(MXNetError):
    """A retryable transport-level failure (lost message, dead socket)."""


class TransientStepError(TransientError):
    """A retryable mid-step failure (the step can be re-dispatched)."""


def _parse_rule(value):
    """'0.3' -> probability; '#5' -> occurrence index set."""
    value = value.strip()
    if value.startswith("#"):
        return {int(value[1:])}
    return float(value)


class ChaosConfig:
    """Seeded failure schedule: site name -> probability or index set."""

    def __init__(self, seed=0, rules=None):
        self.seed = int(seed)
        self.rules: dict = {}
        for site, spec in (rules or {}).items():
            self.add(site, spec)

    def add(self, site, spec):
        if isinstance(spec, (set, frozenset, list, tuple)):
            spec = set(int(i) for i in spec)
            prev = self.rules.get(site)
            if isinstance(prev, set):
                spec |= prev
        elif isinstance(spec, dict):  # {"at": 5} convenience form
            spec = {int(spec["at"])}
        else:
            spec = float(spec)
        self.rules[site] = spec
        return self

    @classmethod
    def from_env(cls, text):
        """Parse the MXNET_TPU_CHAOS format: ';'-separated site=spec pairs,
        with an optional leading seed=N (spec '#k' = fire on occurrence k)."""
        cfg = cls()
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            key, _, value = part.partition("=")
            key = key.strip()
            if key == "seed":
                cfg.seed = int(value)
            else:
                cfg.add(key, _parse_rule(value))
        return cfg


class Chaos:
    """Armed fault injector: deterministic per-site draws and counters."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self._lock = named_lock("chaos.Chaos")
        self._counts: dict = {}
        self._rngs: dict = {}
        self.fired: dict = {}  # site -> number of injected faults

    def _rng(self, site):
        rng = self._rngs.get(site)
        if rng is None:
            rng = self._rngs[site] = random.Random(
                f"{self.config.seed}:{site}")
        return rng

    def fires(self, site) -> bool:
        """Advance the site's counter and decide whether the fault fires."""
        spec = self.config.rules.get(site)
        if spec is None:
            return False
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            if isinstance(spec, set):
                hit = n in spec
            else:
                hit = self._rng(site).random() < spec
            if hit:
                self.fired[site] = self.fired.get(site, 0) + 1
        if hit:
            logging.debug("chaos: injecting fault at %s (occurrence %d)",
                          site, n)
        return hit


_CURRENT: Chaos | None = None
_ENV_CHECKED = False


def install(config: ChaosConfig) -> Chaos:
    """Arm chaos process-wide (tests only). Returns the injector."""
    global _CURRENT
    _CURRENT = Chaos(config)
    return _CURRENT


def uninstall():
    global _CURRENT
    _CURRENT = None


def active() -> Chaos | None:
    """The armed injector, or None. Lazily arms from MXNET_TPU_CHAOS once
    (subprocess tests set the env before launch)."""
    global _ENV_CHECKED, _CURRENT
    if _CURRENT is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        text = os.environ.get("MXNET_TPU_CHAOS")
        if text:
            _CURRENT = Chaos(ChaosConfig.from_env(text))
    return _CURRENT


@contextlib.contextmanager
def chaos_scope(seed=0, rules=None, config=None):
    """Arm chaos for a with-block; restores the previous injector after."""
    global _CURRENT
    prev = _CURRENT
    injector = install(config or ChaosConfig(seed=seed, rules=rules))
    try:
        yield injector
    finally:
        _CURRENT = prev


def fires(site) -> bool:
    """True when an armed injector fires at this site (no-op cost when
    disarmed: one global read). Each firing is recorded as a ``chaos``
    incident in the telemetry hub — post-mortems (flight dumps, merged
    traces) show exactly which injected fault preceded a failure."""
    c = active()
    if c is None or not c.fires(site):
        return False
    from .. import telemetry

    span = telemetry.current_span()
    ctx = {} if span is None else {"span_id": span.span_id,
                                   "trace_id": span.trace_id}
    telemetry.emit("chaos", site=site, **ctx)
    return True


def maybe_raise(site, exc=TransientError, message=None):
    if fires(site):
        raise exc(message or f"chaos-injected fault at {site}")


def maybe_sleep(site, duration=0.05):
    if fires(site):
        time.sleep(duration)
