#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes, on the card.

    python3 chip_smoke_profile.py

from the root of a checkout. Runs ``chip_smoke.main()`` unchanged, with
every module-level function of the script timed (inclusive wall seconds
and calls) and, under the phase that called them, a few of the port's
methods where phases spend their time (``FeedForward.fit``, the
checkpoint writer and ``save_sharded``, graph captures, the profiler's
stop and ``key_averages``, ``subprocess.run``). Rank processes time their
own functions and write a file each, with the wall-clock instants at which
``rank_process`` and the rank's body started and ended, so that a rank's
start-up reads against its body. The first ``card_device_us`` of each
phase is also held to ``key_averages``' device rows. Writes
``smoke_profile.json`` (and ``smoke_profile_rank_<pid>.json``) under
``build/chip_smoke/profile``; prints what ``chip_smoke.py`` prints and
exits with its code. Every phase is timed, the last ones
(``phase_tools_examples``, 12c, ``phase_examples``, 12d,
``phase_bench_tools``, 12e, and ``phase_bench_subsystems``, 12f) too;
their background processes (the launcher's workers, ``im2rec``,
bench_compile's children) are other interpreters, timed by the phase
itself in its row.
"""
import functools
import json
import os
import sys
import time
import types

T_IMPORT = time.time()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "build", "chip_smoke", "profile")
STATS = {}
EVENTS = []
PHASE = ["main"]
# too small or too frequent to be worth a timer
SKIP = {"emit", "require", "main", "rel_fro", "bits_equal"}
MARKED = ("run_ranks", "rank_process")


def dump(name):
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{name}.json"), "w") as f:
        json.dump({"t_import": T_IMPORT, "events": EVENTS,
                   "stats": dict(sorted(STATS.items(),
                                        key=lambda kv: -kv[1][0]))}, f,
                  indent=0)


def add(key, seconds):
    s = STATS.setdefault(key, [0.0, 0])
    s[0] += seconds
    s[1] += 1


def wrap(name, fn):
    marked = name in MARKED or name.endswith("_body")

    @functools.wraps(fn)
    def inner(*a, **k):
        t = time.perf_counter()
        if marked:
            EVENTS.append((name, "start", time.time(),
                           a[-1] if name == "run_ranks" else None))
        try:
            return fn(*a, **k)
        finally:
            add(name, time.perf_counter() - t)
            if marked:
                EVENTS.append((name, "end", time.time(), None))
            if name == "rank_process":
                dump(f"smoke_profile_rank_{os.getpid()}")
    return inner


def wrap_phase(name, fn):
    inner = wrap(name, fn)

    @functools.wraps(fn)
    def outer(*a, **k):
        PHASE.append(name)
        try:
            return inner(*a, **k)
        finally:
            PHASE.pop()
    return outer


def wrap_attr(owner, attr, label):
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def inner(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            add(f"{PHASE[-1]}/{label}", time.perf_counter() - t)
    setattr(owner, attr, inner)


def instrument():
    import subprocess

    import torch
    import torch.profiler

    from mxnet_tpu_torch import model
    from mxnet_tpu_torch.resilience import ckpt_async
    from mxnet_tpu_torch.utils import checkpoint
    from mxnet_tpu_torch.utils import compile as compile_mod

    for owner, attr, label in (
            (model.FeedForward, "fit", "FeedForward.fit"),
            (model.FeedForward, "predict", "FeedForward.predict"),
            (checkpoint, "save_sharded", "save_sharded"),
            (checkpoint, "load_sharded", "load_sharded"),
            (ckpt_async.AsyncCheckpointWriter, "close", "writer.close"),
            (ckpt_async.AsyncCheckpointWriter, "flush", "writer.flush"),
            (ckpt_async.AsyncCheckpointWriter, "_write", "writer._write"),
            (compile_mod.CapturedProgram, "capture",
             "CapturedProgram.capture"),
            (torch.profiler.profile, "stop", "profile.stop"),
            (torch.profiler.profile, "key_averages", "profile.key_averages"),
            (subprocess, "run", "subprocess.run"),
            (torch.cuda, "synchronize", "cuda.synchronize")):
        wrap_attr(owner, attr, label)

    device_us, checked = cs.card_device_us, set()

    def card_device_us(torch, prof):
        got = device_us(torch, prof)
        if PHASE[-1] not in checked:
            checked.add(PHASE[-1])
            ref = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
            EVENTS.append(("device_us_check", PHASE[-1], got, ref))
        return got

    cs.card_device_us = card_device_us


# at import, so that the rank processes (forked from a server that imports
# this file as the main module) are timed too
for _name, _fn in list(vars(cs).items()):
    if isinstance(_fn, types.FunctionType) and \
            _fn.__module__ == "chip_smoke" and _name not in SKIP:
        setattr(cs, _name, (wrap_phase if _name.startswith("phase_")
                            or _name.endswith("_body") else wrap)(_name, _fn))
instrument()


if __name__ == "__main__":
    t0 = time.perf_counter()
    try:
        rc = cs.main()
    finally:
        add("TOTAL", time.perf_counter() - t0)
        dump("smoke_profile")
    sys.exit(rc)
