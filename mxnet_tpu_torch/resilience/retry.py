"""Retrying transport for parameter synchronization.

Counterpart of ``mxnet_tpu/resilience/retry.py``, over the port's
kvstores (their values are torch tensors; the local mirror is numpy, as in
the JAX package). Three pieces:

  ``RetryPolicy``     bounded retries with exponential backoff, seeded
                      jitter and a per-op deadline.
  ``CircuitBreaker``  closed -> open after N consecutive failures; open ->
                      half-open probe after ``reset_after`` seconds; a
                      successful probe closes it again.
  ``RetryingKVStore`` wraps any KVStore. push/pull retry transient
                      transport failures; while the breaker is open the
                      store *degrades to local aggregation*: pushes apply
                      to a local mirror and pulls serve it. When the
                      breaker closes again, the next successful pull
                      re-syncs the mirror from the server, whose state
                      wins.

Chaos sites ``kvstore.push`` / ``kvstore.pull`` / ``kvstore.delay`` fire
*before* the inner store sees the op, so a dropped push is retried with
the same payload; the inner stores (``_GroupServer``, the dist_async host)
keep idempotency state keyed on (worker, seq).
"""

from __future__ import annotations

import itertools
import logging
import random
import time

import numpy as np
import torch

from ..base import MXNetError
from .chaos import TransientError, maybe_raise, maybe_sleep

__all__ = ["RetryPolicy", "CircuitBreaker", "RetryingKVStore",
           "CircuitOpenError", "retry_call"]

# transport failures worth a resend; anything else propagates immediately
RETRYABLE = (TransientError, ConnectionError, TimeoutError, OSError)


class CircuitOpenError(MXNetError):
    """Raised internally when the breaker refuses an op (callers degrade)."""


class RetryPolicy:
    """Exponential backoff with seeded jitter and a total deadline.

    ``delays()`` yields ``max_retries`` sleep durations: base * 2^k,
    capped at ``max_delay``, each multiplied by a jitter draw in
    [1-jitter, 1+jitter] from a private seeded RNG (deterministic tests,
    decorrelated workers in production via per-rank seeds).
    """

    def __init__(self, max_retries=5, base_delay=0.05, max_delay=2.0,
                 jitter=0.5, deadline=30.0, seed=None):
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.deadline = deadline
        self._rng = random.Random(seed)

    def delays(self):
        for attempt in range(self.max_retries):
            d = min(self.base_delay * (2.0 ** attempt), self.max_delay)
            yield d * (1.0 + self.jitter * (2.0 * self._rng.random() - 1.0))


def retry_call(fn, policy: RetryPolicy, what="op", sleep=time.sleep,
               on_retry=None):
    """Call ``fn()`` with bounded retries on RETRYABLE failures.

    Raises the last failure once retries or the deadline are exhausted.
    ``on_retry(attempt, exc)`` observes each resend (stats hooks).
    """
    start = time.monotonic()
    last = None
    for attempt, delay in enumerate(policy.delays()):
        try:
            return fn()
        except RETRYABLE as e:
            last = e
            if policy.deadline is not None and \
                    time.monotonic() - start + delay > policy.deadline:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            from .. import telemetry

            telemetry.counter("resilience_kv_retries_total")
            # the retry incident attaches to the in-flight step span (its
            # span_id parents it in the cross-rank merge and the flight
            # recorder's incident ring)
            span = telemetry.current_span()
            ctx = {} if span is None else {"span_id": span.span_id,
                                           "trace_id": span.trace_id}
            telemetry.emit("retry", op=what, attempt=attempt,
                           error=type(e).__name__, **ctx)
            if span is not None:
                span.events.append({"name": "retry", "op": what,
                                    "attempt": attempt,
                                    "ts": time.perf_counter()})
            sleep(delay)
    try:
        return fn()  # final attempt carries the real failure out
    except RETRYABLE:
        if last is not None:
            logging.warning("%s failed after %d retries", what,
                            policy.max_retries)
        raise


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open recovery probe.

    Every state transition (closed -> open, open -> half_open probe,
    half_open -> closed/open) is observable in the flight recorder: a
    ``breaker`` event lands in the hub ring + incident ring, and three
    labeled gauges track the live state —
    ``circuit_breaker_state{breaker=}`` (0 closed,
    1 half_open, 2 open), ``circuit_breaker_failures{breaker=}``
    (consecutive failures), ``circuit_breaker_last_transition{breaker=}``
    (hub-clock seconds of the newest transition). ``name`` labels the
    series so the kvstore breaker and the fleet controller's breaker
    stay distinguishable on one scrape."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
    _STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0}

    def __init__(self, failure_threshold=3, reset_after=5.0,
                 clock=time.monotonic, name="kvstore"):
        self.failure_threshold = int(failure_threshold)
        self.reset_after = float(reset_after)
        self._clock = clock
        self.name = str(name)
        self.state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.trip_count = 0
        self.last_transition = None  # hub-clock ts of the newest change

    @property
    def failures(self) -> int:
        """Consecutive failures since the last success."""
        return self._failures

    def publish_state(self):
        """Publish the live-state gauges (also called on every
        transition). Long-lived breakers — the fleet controller's —
        call this from their owner's heartbeat so a scrape sees a
        healthy CLOSED breaker, not an absent one."""
        from .. import telemetry

        telemetry.gauge("circuit_breaker_state",
                        self._STATE_CODE[self.state], breaker=self.name)
        telemetry.gauge("circuit_breaker_failures", float(self._failures),
                        breaker=self.name)
        if self.last_transition is not None:
            telemetry.gauge("circuit_breaker_last_transition",
                            self.last_transition, breaker=self.name)

    def _transition(self, new_state):
        """Move to ``new_state`` and publish it (no-op on a non-change).
        Gauges + a ``breaker`` incident — the flight recorder's view of
        why a store degraded or a controller froze."""
        if new_state == self.state:
            return
        from .. import telemetry

        old, self.state = self.state, new_state
        self.last_transition = telemetry.hub().now()
        self.publish_state()
        telemetry.emit("breaker", breaker=self.name, state=new_state,
                       from_state=old, failures=self._failures)

    def allow(self) -> bool:
        """May the caller attempt the real op right now?"""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN and \
                self._clock() - self._opened_at >= self.reset_after:
            self._transition(self.HALF_OPEN)  # one probe goes through
            return True
        return self.state == self.HALF_OPEN
    # NOTE: single-threaded per worker handle (kvstore contract); no lock.

    def record_success(self):
        if self.state != self.CLOSED:
            logging.info("circuit breaker %s: probe succeeded, closing",
                         self.name)
        had_pressure = self._failures > 0
        self._failures = 0
        self._transition(self.CLOSED)
        if had_pressure and self.state == self.CLOSED:
            # a below-threshold failure published a nonzero pressure
            # gauge; the reset must clear it even without a transition
            self.publish_state()

    def record_failure(self):
        self._failures += 1
        if self.state == self.HALF_OPEN or \
                self._failures >= self.failure_threshold:
            if self.state != self.OPEN:
                self.trip_count += 1
                logging.warning(
                    "circuit breaker %s: OPEN after %d consecutive "
                    "failures (retry in %.1fs)", self.name,
                    self._failures, self.reset_after)
                from .. import telemetry

                telemetry.counter("resilience_circuit_open_total")
                telemetry.emit("circuit_open", op=self.name,
                               failures=self._failures)
            self._opened_at = self._clock()
            self._transition(self.OPEN)
        else:
            from .. import telemetry

            # failures below the threshold still move the gauge so a
            # scrape sees pressure building before the trip
            telemetry.gauge("circuit_breaker_failures",
                            float(self._failures), breaker=self.name)


_BREAKER_SEQ = itertools.count()  # unique default-breaker names per store


class RetryingKVStore:
    """Fault-tolerant wrapper over any KVStore handle.

    Transparent for correctness when nothing fails; under transient
    transport failures it retries with backoff+jitter; under a persistent
    outage the breaker opens and the store serves a local mirror so the
    training loop never blocks on a dead server group.
    """

    def __init__(self, inner, policy: RetryPolicy = None,
                 breaker: CircuitBreaker = None):
        self._inner = inner
        self._policy = policy or RetryPolicy()
        # per-instance breaker name: two stores' state gauges must not
        # clobber each other on one scrape (a healthy store's success
        # would overwrite a degraded store's OPEN reading)
        self._breaker = breaker or CircuitBreaker(
            name=f"kvstore{next(_BREAKER_SEQ)}")
        self._mirror: dict = {}        # key -> np.ndarray (last known value)
        self._fallback_updater = None  # applies pushes to the mirror offline
        self.stats = {"retries": 0, "degraded_ops": 0, "resyncs": 0}

    # -- passthrough surface ---------------------------------------------------
    @property
    def type(self):
        return self._inner.type

    @property
    def rank(self):
        return self._inner.rank

    @property
    def num_workers(self):
        return self._inner.num_workers

    @property
    def breaker(self):
        return self._breaker

    def __getattr__(self, name):
        return getattr(self._inner, name)

    # -- internals -------------------------------------------------------------
    def _on_retry(self, attempt, exc):
        del attempt, exc
        self.stats["retries"] += 1

    def _guarded(self, site, fn, what):
        """Run one remote op through chaos + retry + the breaker."""
        if not self._breaker.allow():
            raise CircuitOpenError(f"{what}: circuit open")

        def attempt():
            maybe_sleep("kvstore.delay")
            maybe_raise(site, message=f"chaos dropped {what}")
            return fn()

        try:
            result = retry_call(attempt, self._policy, what=what,
                                on_retry=self._on_retry)
        except RETRYABLE:
            self._breaker.record_failure()
            raise
        self._breaker.record_success()
        return result

    def _mirror_put(self, key, value):
        from ..kvstore import _to_numpy

        self._mirror[key] = np.array(_to_numpy(value), np.float32)

    def _apply_local(self, key, grad):
        """Degraded-mode push: apply to the mirror with the fallback
        updater (sum-accumulate when none was installed)."""
        stored = self._mirror.get(key)
        if stored is None:
            raise MXNetError(f"degraded push for unknown key {key!r} "
                             "(never initialized/pulled through this store)")
        grad = np.asarray(grad, np.float32)
        if self._fallback_updater is not None:
            self._fallback_updater(key, grad, stored)
        else:
            stored += grad

    # -- KVStore API -----------------------------------------------------------
    def init(self, key, value):
        for k, v in self._inner._as_pairs(key, value):
            vv = v[0] if isinstance(v, (list, tuple)) else v
            self._mirror_put(k, vv)
        # init is idempotent on every inner store (first write wins)
        self._guarded("kvstore.push", lambda: self._inner.init(key, value),
                      "kvstore.init")

    def push(self, key, value, priority=0):
        try:
            self._guarded("kvstore.push",
                          lambda: self._inner.push(key, value, priority),
                          "kvstore.push")
        except (CircuitOpenError,) + RETRYABLE:
            self.stats["degraded_ops"] += 1
            from ..kvstore import _to_numpy

            for k, vlist in self._inner._as_pairs(key, value):
                self._apply_local(k, _to_numpy(self._inner._merge(vlist)))

    def pull(self, key, out, priority=0):
        try:
            self._guarded("kvstore.pull",
                          lambda: self._inner.pull(key, out, priority),
                          "kvstore.pull")
        except (CircuitOpenError,) + RETRYABLE:
            self.stats["degraded_ops"] += 1
            for k, outs in self._inner._as_pairs(key, out):
                value = self._mirror.get(k)
                if value is None:
                    raise MXNetError(
                        f"degraded pull for unknown key {k!r}") from None
                if isinstance(outs, torch.Tensor):
                    outs = [outs]
                for o in outs:
                    with torch.no_grad():
                        o.copy_(torch.from_numpy(value).reshape(o.shape))
            return
        # server reachable: refresh the mirror from what the caller pulled
        for k, outs in self._inner._as_pairs(key, out):
            first = outs[0] if isinstance(outs, (list, tuple)) else outs
            self._mirror_put(k, first)
        self.stats["resyncs"] += 1

    # -- dist_async bulk surface (present only on AsyncKVStore) ----------------
    def push_pull(self, kvs: dict, priority=0) -> dict:
        del priority  # uniform data-plane kwarg (see kvstore.py docstring)
        try:
            result = self._guarded(
                "kvstore.push", lambda: self._inner.push_pull(kvs),
                "kvstore.push_pull")
        except (CircuitOpenError,) + RETRYABLE:
            self.stats["degraded_ops"] += 1
            for k, grad in kvs.items():
                self._apply_local(k, grad)
            return {k: self._mirror[k].copy() for k in kvs}
        for k, v in result.items():
            self._mirror_put(k, v)
        return result

    def pull_many(self, keys, priority=0) -> dict:
        del priority
        try:
            result = self._guarded(
                "kvstore.pull", lambda: self._inner.pull_many(keys),
                "kvstore.pull_many")
        except (CircuitOpenError,) + RETRYABLE:
            self.stats["degraded_ops"] += 1
            return {k: self._mirror[k].copy() for k in keys}
        for k, v in result.items():
            self._mirror_put(k, v)
        self.stats["resyncs"] += 1
        return result

    def push_many(self, kvs: dict, priority=0):
        del priority
        try:
            self._guarded("kvstore.push",
                          lambda: self._inner.push_many(kvs),
                          "kvstore.push_many")
        except (CircuitOpenError,) + RETRYABLE:
            self.stats["degraded_ops"] += 1
            for k, grad in kvs.items():
                self._apply_local(k, grad)

    def set_updater(self, updater):
        self._fallback_updater = updater
        self._inner.set_updater(updater)

    def set_optimizer(self, optimizer):
        # keep a local updater so degraded mode preserves update-on-push
        # semantics (the reference ships the optimizer to servers; we also
        # keep a copy for the local stand-in)
        from ..optimizer import get_updater
        from ..kvstore import wrap_np_updater

        self._fallback_updater = wrap_np_updater(get_updater(optimizer))
        self._inner.set_optimizer(optimizer)

    def barrier(self):
        # barriers are not idempotent (arrival counting); never retried
        self._inner.barrier()
