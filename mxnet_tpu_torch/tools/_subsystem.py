"""What the subsystem acceptance benches share: the port's copy of what
``bench.py``'s thirteen ``--*-bench`` modes repeat.

- the dp-8 MLP ``FeedForward`` of ``bench.py:929-937`` (one hidden tanh
  layer and a softmax head, SGD at ``learning_rate=0.05``), over a ctx
  list of eight aliases of one device: :func:`build_mlp`. Where the JAX
  benches run eight virtual CPU devices, the port runs eight replicas that
  time-share one card (or the CPU under ``--cpu``), each its own member of
  the in-process exchange (:class:`ReplicaFeedForward`);
- the seeded rows ``X``, ``y`` (:func:`mlp_data`) and the timed fit, warm
  once and then timed (:func:`timed_fit`);
- the microbench timer of one host operation (:func:`per_op_ns`) and the
  count of the calls a fit makes to it (:func:`counted_fit`), which
  together price a subsystem's operations a step;
- each bench's correctness gates, its ``check(result)`` through
  :func:`require`, which ``chip_smoke.py`` and the tests call;
- the ``--smoke`` / ``--cpu`` / ``--out`` arguments (:func:`parser`; the
  device is ``_bench.card``'s: without ``--cpu`` and without CUDA,
  ``MXNetError`` naming CUDA, as every tool of ``_bench``);
- the single exit (:func:`publish`): the one JSON line on stdout, then
  ``telemetry.ledger.publish_bench``, which writes ``BENCH_<NAME>_torch.json``
  and the ``BENCH_LEDGER_r20.json`` trajectory under :data:`WORK_DIR` (or
  beside ``--out``) on full runs and nothing on ``--smoke`` runs.

Times on the card are of eight replicas sharing it: a step's time is the
eight replicas' work in turn, never one device's share of a mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..model import FeedForward
from . import _bench

# where full runs write their JSON and the trajectory (ignored by git)
WORK_DIR = Path(__file__).resolve().parents[2] / "build" / "bench_subsystems"
REPLICAS = 8
SEED = 0
TIME_SHARED = ("eight replicas time-share one device: a step's time is "
               "their work in turn")


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX mode's smoke shapes; writes no file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a check of the bench: nothing of "
                         "the card is measured)")
    ap.add_argument("--out", default=None,
                    help="the JSON of a full run (default: "
                         "build/bench_subsystems/BENCH_<NAME>_torch.json)")
    return ap


def contexts(device, n: int = REPLICAS) -> list:
    """``n`` aliases of ``device`` as a ctx list: ``[gpu(0)] * n`` on the
    card, ``[cpu(0)] * n`` on the CPU."""
    from ..context import cpu, gpu

    device = torch.device(device)
    one = gpu(device.index or 0) if device.type == "cuda" else cpu(0)
    return [one] * n


def synchronize(device) -> None:
    """Wait for the card's queue (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ReplicaFeedForward(FeedForward):
    """A ``FeedForward`` whose every ctx entry is a replica, aliases of one
    device included, as an elastic fit makes them: ``[gpu(0)] * 8`` trains
    eight replicas on one card through the in-process exchange
    (``comm.ReplicaGroup``), where a plain ``FeedForward`` collapses the
    aliases into one replica."""

    @property
    def _replicas(self) -> list:
        return list(self.ctx)


def mlp_symbol(hidden: int, classes: int):
    """``bench.py:929-935``: ``data -> fc1(hidden) -> tanh -> fc2(classes)
    -> softmax``."""
    from .. import symbol as sym

    data = sym.Variable("data")
    h1 = sym.Activation(sym.FullyConnected(data, name="fc1",
                                           num_hidden=hidden),
                        name="a1", act_type="tanh")
    return sym.SoftmaxOutput(sym.FullyConnected(h1, name="fc2",
                                                num_hidden=classes),
                             name="softmax")


def build_mlp(hidden: int, classes: int, epochs: int, device,
              world: int = REPLICAS) -> ReplicaFeedForward:
    """The JAX benches' ``build()``: the MLP over ``world`` replicas of
    ``device``, SGD at 0.05 for ``epochs`` epochs."""
    return ReplicaFeedForward(mlp_symbol(hidden, classes),
                              ctx=contexts(device, world), num_epoch=epochs,
                              optimizer="sgd", learning_rate=0.05)


def mlp_data(n_rows: int, dim: int, classes: int):
    """``X`` (``n_rows`` x ``dim`` normal f32) and ``y`` (class ids as
    f32) from ``np.random.RandomState(SEED)``, drawn in the JAX benches'
    order."""
    rng = np.random.RandomState(SEED)
    X = rng.randn(n_rows, dim).astype(np.float32)
    y = rng.randint(0, classes, (n_rows,)).astype(np.float32)
    return X, y


def timed_fit(build, X, y, batch: int, device, **fit_kw) -> float:
    """Seconds of the second of two fits of one model (the first warms its
    programs), to the card's last step."""
    model = build()
    model.fit(X, y, batch_size=batch, **fit_kw)
    synchronize(device)
    t0 = time.perf_counter()
    model.fit(X, y, batch_size=batch, **fit_kw)
    synchronize(device)
    return time.perf_counter() - t0


def per_op_ns(fn, reps: int) -> float:
    """Nanoseconds a call of ``fn(i)``, over ``reps`` calls in a row: a
    host operation (a hub write, a lock pair), which enqueues nothing on
    the card."""
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    # host work only: nothing to wait for before the clock is read
    return (time.perf_counter() - t0) / reps * 1e9  # mxlint: disable=MX306


@contextlib.contextmanager
def counting(targets):
    """Count the calls of each ``(owner, name)`` of ``targets``, a class's
    method or a module's function, while the block runs. Yields a dict of
    calls by ``name`` (targets of one name add up); each is restored
    after."""
    counts = {name: 0 for _, name in targets}
    saved = [(owner, name, owner.__dict__[name]) for owner, name in targets]

    def counted(name, plain):
        def call(*args, **kw):
            counts[name] += 1
            return plain(*args, **kw)
        return call

    try:
        for owner, name, _ in saved:
            setattr(owner, name, counted(name, getattr(owner, name)))
        yield counts
    finally:
        for owner, name, plain in saved:
            setattr(owner, name, plain)


def counted_fit(build, X, y, batch: int, steps: int, targets,
                **fit_kw) -> dict:
    """The calls a step of each of ``targets`` (:func:`counting`) over one
    fit of ``steps`` steps of a fresh model, untimed."""
    model = build()
    with counting(targets) as counts:
        model.fit(X, y, batch_size=batch, **fit_kw)
    return {name: n / steps for name, n in counts.items()}


def on_card(result: dict) -> bool:
    """Whether a bench's JSON was measured on a card (not ``--cpu``)."""
    return result["device"] != _bench.NO_CARD


def require(cond, what: str) -> None:
    """A bench's correctness gate: ``AssertionError`` naming ``what``."""
    if not cond:
        raise AssertionError(what)


def bound_flag(value, bound: float, below: bool = True) -> dict:
    """A JAX bound beside a figure: ``{"bound", "met"}``. A miss on the
    card is a finding, never a failed run."""
    if value is None:
        return {"bound": bound, "met": None}
    return {"bound": bound,
            "met": bool(value < bound) if below else bool(value > bound)}


def out_path(args, name: str) -> Path:
    """Where a full run of bench ``name`` writes its JSON."""
    if getattr(args, "out", None):
        return Path(args.out).resolve()
    return WORK_DIR / f"BENCH_{name.upper()}_torch.json"


def publish(result: dict, name: str, args) -> dict:
    """Print ``result`` as the run's one JSON line, then publish it through
    ``telemetry.ledger.publish_bench`` (``bench.py:_publish``): a full run
    writes ``BENCH_<NAME>_torch.json`` and the trajectory beside it, a
    ``--smoke`` run writes nothing. Returns ``result``."""
    from ..telemetry import ledger

    print(json.dumps(result, default=str), flush=True)
    path = out_path(args, name)
    smoke = bool(getattr(args, "smoke", False))
    if not smoke:
        os.makedirs(path.parent, exist_ok=True)
    out = ledger.publish_bench(result, filename=path.name,
                               bench_dir=str(path.parent), smoke=smoke)
    if out["bench_path"]:
        print(f"wrote {out['bench_path']}", file=sys.stderr)
    return result
