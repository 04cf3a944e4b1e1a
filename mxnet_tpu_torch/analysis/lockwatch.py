"""Runtime lock-order watchdog (gate MXNET_TPU_LOCKWATCH).

The port's copy of ``mxnet_tpu/analysis/lockwatch.py`` (stdlib only). A
static concurrency pass sees what the source *says*; this module watches
what the threads *do*. The
repo's Lock/RLock/Condition constructions go through a small factory
(:func:`named_lock` / :func:`named_rlock` / :func:`named_condition`) so
every synchronization primitive carries a stable name. When the watchdog
is enabled it records, per thread, the set of held locks and, globally,
the **acquisition-order graph**: an edge A->B means some thread acquired B
while holding A. A cycle in that graph is a potential deadlock — two
threads interleaving the two orders wedge forever — and is reported the
moment the closing edge first appears, long before the interleaving that
would actually deadlock. Long-held locks (stalls) are reported the same
way. Both land where every other anomaly in this repo lands: the hub
(gauges ``lockwatch_cycles_total`` / ``lockwatch_max_hold_ms``, incident
events of kind ``lockwatch``) and therefore the flight recorder's
incident ring, so a deadlock *risk* shows up in the same CRC-validated
post-mortem dump as a crash.

Costs: with the watchdog disabled (the default) a watched lock's
``acquire`` is one module-global read plus the real ``acquire`` — the
factory is safe to leave in production paths. Enabled, each acquire/
release pair pays ~2 thread-local list ops, two clock reads, and
GIL-plain counter/edge/hold updates (new dict ENTRIES — never-seen
edges, first holds, cycles, stalls — go through the watcher's private
raw lock, so readers iterating under it never see a resize; in-place
updates race benignly and may lose a count, which diagnostics tolerate).
``chip_smoke.py``'s ``telemetry`` phase prices the armed pair on the
card.

Reentrancy discipline: the watcher never emits to the hub while holding
its own bookkeeping lock, and a thread inside watcher code sets a
thread-local ``busy`` flag so the hub's own (watched) locks acquired
during incident emission are not re-observed — the watchdog cannot
deadlock or recurse through the telemetry it reports into.

This module is stdlib-only and imports telemetry lazily at incident time,
so any layer (engine, kvstore, telemetry itself) can use the factory
without import cycles.
"""

from __future__ import annotations

import os
import threading
import time

__all__ = ["named_lock", "named_rlock", "named_condition", "WatchedLock",
           "LockWatcher", "enable", "disable", "enabled", "watcher",
           "report", "publish", "reset"]

_ON_VALUES = ("1", "true", "on", "yes")

_WATCHER = None          # None = disabled; LockWatcher instance = enabled
_TLS = threading.local() # .st = [busy_flag, held_list] (one lookup per op)


def _tls_state():
    st = getattr(_TLS, "st", None)
    if st is None:
        st = _TLS.st = [False, []]   # [busy, [(lock, t0), ...]]
    return st


class WatchedLock:
    """A named Lock/RLock whose acquisition order and hold times are
    observable. Disabled watcher: ``acquire``/``release`` delegate with one
    global read of overhead. A PLAIN watched lock works as a Condition's
    underlying lock (provides ``_is_owned``); reentrant ones are rejected
    by :func:`named_condition` (see its docstring)."""

    __slots__ = ("_lock", "name", "reentrant", "_owner", "_depth")

    def __init__(self, name, reentrant=False):
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self.name = str(name)
        self.reentrant = bool(reentrant)
        self._owner = None   # ident of the tracked holder (None untracked)
        self._depth = 0

    def acquire(self, blocking=True, timeout=-1):
        if _WATCHER is None:
            return self._lock.acquire(blocking, timeout)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            me = threading.get_ident()
            if self._owner == me:
                self._depth += 1          # reentrant re-acquire: no edge
            else:
                self._owner = me
                self._depth = 1
                w = _WATCHER
                if w is not None:
                    st = _tls_state()
                    if not st[0]:
                        w._on_acquired(self, st[1])
        return ok

    def release(self):
        if self._owner == threading.get_ident():
            self._depth -= 1
            if self._depth == 0:
                self._owner = None
                st = _tls_state()
                w = _WATCHER
                if w is not None and not st[0]:
                    w._on_released(self, st[1])
                else:
                    # watchdog disabled (or busy) mid-hold: still drop the
                    # tracked entry, or a later re-enable would see a
                    # phantom "held" lock and fabricate edges from it
                    held = st[1]
                    for i in range(len(held) - 1, -1, -1):
                        if held[i][0] is self:
                            del held[i]
                            break
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._owner is not None or (
            hasattr(self._lock, "locked") and self._lock.locked())

    def _is_owned(self):
        """Condition's ownership probe. Tracked holds answer exactly; a
        hold taken while the watchdog was off delegates to the underlying
        RLock's exact probe when it has one, else falls back to the
        stdlib's try-acquire probe (same contract as threading.Condition
        over a plain Lock)."""
        if self._owner is not None:
            return self._owner == threading.get_ident()
        inner = getattr(self._lock, "_is_owned", None)
        if inner is not None:        # RLock: exact even when untracked
            return inner()
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def __repr__(self):
        return f"WatchedLock({self.name!r})"


def named_lock(name) -> WatchedLock:
    """The factory replacing bare ``threading.Lock()`` constructions."""
    return WatchedLock(name)


def named_rlock(name) -> WatchedLock:
    """The factory replacing bare ``threading.RLock()`` constructions."""
    return WatchedLock(name, reentrant=True)


def named_condition(name, lock=None) -> threading.Condition:
    """A Condition over a watched PLAIN lock (pass an existing watched
    ``lock`` to share it, the `cv = Condition(self.lock)` idiom).

    Reentrant watched locks are rejected: ``Condition.wait`` must fully
    release the lock, and the wrapper does not forward RLock's
    ``_release_save`` multi-level release — a Condition over a
    ``named_rlock`` would sleep while still holding the lock (silent
    deadlock). Every repo cv is plain-lock-based; raise loudly here
    rather than wedge at the first wait."""
    if lock is None:
        lock = named_lock(name)
    if isinstance(lock, WatchedLock) and lock.reentrant:
        raise TypeError(
            f"named_condition({name!r}): reentrant watched locks are not "
            "Condition-compatible (wait() would release only one level); "
            "use named_lock for the cv's underlying lock")
    return threading.Condition(lock)


class LockWatcher:
    """Held-lock sets per thread + the global acquisition-order graph.

    Internal state is guarded by a *raw* threading.Lock — never a watched
    one — and incident emission happens outside it under the thread-local
    ``busy`` flag (see module docstring)."""

    def __init__(self, stall_ms=None):
        if stall_ms is None:
            raw = os.environ.get("MXNET_TPU_LOCKWATCH_STALL_MS", "").strip()
            stall_ms = float(raw) if raw else 1000.0
        self.stall_ms = float(stall_ms) or None
        self._mu = threading.Lock()      # raw on purpose: see docstring
        self._edges = {}                 # (a, b) -> count
        self._edge_sites = {}            # (a, b) -> first thread name
        self._cycles = []                # [{"cycle": [...], "thread": ...}]
        self._cycle_keys = set()
        self._holds = {}                 # name -> [count, total_ms, max_ms]
        self.acquires = 0
        self.max_hold_ms = 0.0
        self.stalls = []                 # [{"lock", "hold_ms", "thread"}]

    # -- recording (called from WatchedLock with busy unset) ------------------
    # Hot-path discipline: the watchdog must cost a fraction of what the
    # locks it watches guard. Counters and per-lock hold stats are updated
    # with PLAIN dict/int ops (GIL-consistent; concurrent updates can lose
    # a count — fine for diagnostics), and the
    # internal mutex is taken only on the rare structural paths: a
    # never-seen edge (cycle check), a first hold of a lock, a stall.
    def _on_acquired(self, lock, held):
        self.acquires += 1
        if held:
            a, b = held[-1][0].name, lock.name
            if a != b:
                key = (a, b)
                cnt = self._edges.get(key)
                if cnt is None:
                    self._new_edge(key)
                else:
                    self._edges[key] = cnt + 1
        held.append((lock, time.perf_counter()))

    def _new_edge(self, key):
        a, b = key
        new_cycle = None
        with self._mu:
            if key not in self._edges:
                self._edges[key] = 0
                self._edge_sites[key] = threading.current_thread().name
                path = self._path(b, a)
                if path is not None:         # b ->* a existed: cycle
                    # path is b..a; the new a->b edge closes it, so the
                    # cycle's node set IS the path
                    cyc = self._canonical(path)
                    if cyc not in self._cycle_keys:
                        self._cycle_keys.add(cyc)
                        new_cycle = {"cycle": list(cyc),
                                     "closing_edge": [a, b],
                                     "thread":
                                         threading.current_thread().name}
                        self._cycles.append(new_cycle)
            self._edges[key] += 1
        if new_cycle is not None:
            self._incident("cycle",
                           cycle="->".join(new_cycle["cycle"]),
                           closing_edge=f"{a}->{b}",
                           thread=new_cycle["thread"])

    def _on_released(self, lock, held):
        for i in range(len(held) - 1, -1, -1):   # usually the top
            if held[i][0] is lock:
                _, t0 = held.pop(i)
                hold_ms = (time.perf_counter() - t0) * 1e3
                st = self._holds.get(lock.name)
                if st is None:
                    with self._mu:
                        st = self._holds.setdefault(lock.name,
                                                    [0, 0.0, 0.0])
                st[0] += 1
                st[1] += hold_ms
                if hold_ms > st[2]:
                    st[2] = hold_ms
                if hold_ms > self.max_hold_ms:
                    self.max_hold_ms = hold_ms
                if self.stall_ms is not None and hold_ms >= self.stall_ms:
                    stall = {"lock": lock.name,
                             "hold_ms": round(hold_ms, 3),
                             "thread": threading.current_thread().name}
                    with self._mu:
                        self.stalls.append(stall)
                    self._incident("stall", **stall)
                return

    # -- graph helpers (call with self._mu held) ------------------------------
    def _path(self, src, dst):
        """DFS path src ->* dst over the current edges, or None."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for (a, b) in self._edges:
                if a == node and b not in seen:
                    seen.add(b)
                    stack.append((b, path + [b]))
        return None

    @staticmethod
    def _canonical(nodes):
        """Rotation-normalized cycle key (min element first)."""
        i = nodes.index(min(nodes))
        return tuple(nodes[i:] + nodes[:i])

    # -- reporting ------------------------------------------------------------
    def _incident(self, what, **fields):
        """Emit one lockwatch incident + refresh the gauges, with the
        reentrancy guard up so hub locks touched here are unobserved."""
        st = _tls_state()
        st[0] = True
        try:
            from .. import telemetry

            telemetry.gauge("lockwatch_cycles_total", float(len(self._cycles)))
            telemetry.gauge("lockwatch_max_hold_ms", float(self.max_hold_ms))
            telemetry.emit("lockwatch", what=what, **fields)
        except Exception:
            pass  # the watchdog must never take down the watched program
        finally:
            st[0] = False

    def report(self):
        with self._mu:
            return {
                "acquires": self.acquires,
                "locks": sorted({n for e in self._edges for n in e}
                                | set(self._holds)),
                "edges": [{"from": a, "to": b, "count": c,
                           "first_thread": self._edge_sites.get((a, b))}
                          for (a, b), c in sorted(self._edges.items())],
                "cycles": [dict(c) for c in self._cycles],
                "stalls": [dict(s) for s in self.stalls],
                "max_hold_ms": round(self.max_hold_ms, 3),
                "holds": {n: {"count": c, "total_ms": round(t, 3),
                              "max_ms": round(m, 3)}
                          for n, (c, t, m) in sorted(self._holds.items())},
            }

    def cycles(self):
        with self._mu:
            return [dict(c) for c in self._cycles]


# -- module-level control ------------------------------------------------------

def enabled() -> bool:
    return _WATCHER is not None


def watcher() -> LockWatcher | None:
    return _WATCHER


def enable(stall_ms=None) -> LockWatcher:
    """Arm the watchdog (idempotent; also armed at import when
    MXNET_TPU_LOCKWATCH is truthy). Locks created before enabling are
    watched too — the factory wrapper is always in place."""
    global _WATCHER
    if _WATCHER is None:
        _WATCHER = LockWatcher(stall_ms=stall_ms)
    return _WATCHER


def disable():
    global _WATCHER
    _WATCHER = None


def reset(stall_ms=None):
    """Fresh watcher, preserving enablement (tests)."""
    global _WATCHER
    if _WATCHER is not None:
        _WATCHER = LockWatcher(stall_ms=stall_ms)
    return _WATCHER


def report() -> dict:
    w = _WATCHER
    return {"enabled": False} if w is None else \
        {"enabled": True, **w.report()}


def publish():
    """Refresh the hub gauges from the current watcher state (test
    hook; incidents refresh them automatically)."""
    w = _WATCHER
    if w is None:
        return
    st = _tls_state()
    st[0] = True
    try:
        from .. import telemetry

        telemetry.gauge("lockwatch_cycles_total", float(len(w._cycles)))
        telemetry.gauge("lockwatch_max_hold_ms", float(w.max_hold_ms))
        telemetry.gauge("lockwatch_acquires_total", float(w.acquires))
    finally:
        st[0] = False


if os.environ.get("MXNET_TPU_LOCKWATCH", "").strip().lower() in _ON_VALUES:
    enable()
