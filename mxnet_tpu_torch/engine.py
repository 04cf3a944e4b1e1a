"""Host-side task engine with read/write dependency ordering.

Counterpart of ``mxnet_tpu/engine.py``: variables with read and write sets,
``push`` returning a ``Future``, ``wait_for_var``, ``wait_for_all``, the
pooled engine (``MXNET_CPU_WORKER_NTHREADS`` threads, default 4) and the
naive one, which runs each task on push. Tasks that write a variable run
after every earlier task that touched it; reads since the last write run
concurrently. The data pipeline (``io.ImageRecordIter``,
``io.PrefetchingIter``) runs on it. ``MXNET_ENGINE_TYPE`` or
:func:`set_engine_type` picks ``ThreadedEnginePerDevice`` /
``ThreadedEnginePooled`` (pooled) or ``NaiveEngine``.
"""

from __future__ import annotations

import itertools
import threading
import time as _time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout

from .base import MXNetError, env_int, env_str

__all__ = ["Engine", "Var", "engine", "naive_engine", "set_engine_type"]


class Var:
    """A dependency-tracking variable: the future of its last write and the
    reads pushed since."""

    _ids = itertools.count()

    def __init__(self, name=""):
        self.vid = next(Var._ids)
        self.name = name or f"var{self.vid}"
        self._tail: Future | None = None
        self._readers: list[Future] = []

    def __repr__(self):
        return f"Var({self.name})"


class _Task:
    __slots__ = ("fn", "reads", "writes", "future")

    def __init__(self, fn, reads, writes):
        self.fn = fn
        self.reads = reads
        self.writes = writes
        self.future = Future()


class Engine:
    """``push(fn, read_vars, write_vars)`` returns a Future of ``fn()``,
    which runs on a worker thread once its dependencies completed; its
    exception comes back through the future and the waits."""

    def __init__(self, num_workers=None, synchronous=False):
        self.synchronous = synchronous
        self._lock = threading.Lock()
        self._inflight: set[Future] = set()
        self._pool = None if synchronous else ThreadPoolExecutor(
            max_workers=num_workers or env_int("MXNET_CPU_WORKER_NTHREADS", 4),
            thread_name_prefix="mxtorch-engine")

    def new_variable(self, name="") -> Var:
        return Var(name)

    def push(self, fn, read_vars=(), write_vars=(), priority=0):
        """Schedule ``fn()`` after its dependencies; ``priority`` is taken
        for the reference signature only (the pool runs FIFO)."""
        del priority
        task = _Task(fn, tuple(read_vars), tuple(write_vars))
        deps: list[Future] = []
        with self._lock:
            for v in task.reads:
                if v._tail is not None:
                    deps.append(v._tail)
                v._readers.append(task.future)
            for v in task.writes:
                if v._tail is not None:
                    deps.append(v._tail)
                deps.extend(v._readers)
                v._readers = []
                v._tail = task.future
            self._inflight.add(task.future)
            task.future.add_done_callback(
                lambda f, reads=task.reads: self._on_done(f, reads))
        if self.synchronous:
            self._run(task)
        elif not deps:
            self._pool.submit(self._run, task)
        else:
            self._chain(task, [d for d in set(deps) if d is not task.future])
        return task.future

    def push_sync(self, fn, read_vars=(), write_vars=()):
        return self.push(fn, read_vars, write_vars).result()

    def wait_for_var(self, var: Var, timeout=None):
        """Block until every task touching ``var`` completed; ``timeout``
        (seconds, for the whole wait) raises ``MXNetError`` on expiry."""
        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._lock:
            waits = list(var._readers)
            if var._tail is not None:
                waits.append(var._tail)
        for f in waits:
            self._wait(f, deadline, f"engine wait for {var}")

    def wait_for_all(self, timeout=None):
        deadline = None if timeout is None else _time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [f for f in self._inflight if not f.done()]
            if not pending:
                return
            for f in pending:
                self._wait(f, deadline, "engine wait_for_all")

    @staticmethod
    def _wait(fut, deadline, what):
        left = None
        if deadline is not None:
            left = deadline - _time.monotonic()
            if left <= 0:
                raise MXNetError(f"{what} exceeded deadline")
        try:
            fut.result(left)  # re-raises the task's error
        except _FutureTimeout:
            # a task's own TimeoutError lands here too: claim the deadline
            # only when it expired
            if deadline is not None and _time.monotonic() >= deadline:
                raise MXNetError(f"{what} exceeded deadline") from None
            raise

    def delete_variable(self, var: Var):
        del var

    def _chain(self, task, deps):
        remaining = [len(deps)]
        lock = threading.Lock()

        def _dep_done(_f):
            with lock:
                remaining[0] -= 1
                ready = remaining[0] == 0
            if ready:
                self._pool.submit(self._run, task)

        for d in deps:
            d.add_done_callback(_dep_done)

    @staticmethod
    def _run(task):
        try:
            result = task.fn()
        except BaseException as exc:  # noqa: BLE001 - through the future
            task.future.set_exception(exc)
        else:
            task.future.set_result(result)

    def _on_done(self, fut, reads):
        with self._lock:
            self._inflight.discard(fut)
            for v in reads:  # a finished read leaves its variables' lists
                try:
                    v._readers.remove(fut)
                except ValueError:
                    pass


_engine_lock = threading.Lock()
_engines: dict[str, Engine] = {}
_TYPES = ("ThreadedEnginePerDevice", "ThreadedEnginePooled", "NaiveEngine")


def set_engine_type(name: str):
    """Replace the process-wide engine (else ``MXNET_ENGINE_TYPE``, default
    the pooled engine)."""
    if name not in _TYPES:
        raise MXNetError(f"unknown engine type {name}")
    with _engine_lock:
        _engines["selected"] = Engine(synchronous=(name == "NaiveEngine"))


def engine() -> Engine:
    """The process-wide engine."""
    with _engine_lock:
        if "selected" not in _engines:
            name = env_str("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
            _engines["selected"] = Engine(synchronous=(name == "NaiveEngine"))
        return _engines["selected"]


def naive_engine() -> Engine:
    """A synchronous engine, for debugging."""
    with _engine_lock:
        if "naive" not in _engines:
            _engines["naive"] = Engine(synchronous=True)
        return _engines["naive"]
