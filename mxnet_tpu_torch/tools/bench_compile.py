"""Cold against warm time to the first training step, each in a fresh
process: the port's counterpart of ``bench.py --compile-bench``
(``run_compile_bench`` and its child, ``run_compile_bench_child``).

In the port nothing of a step's capture outlives its process
(``utils/compile.py``): what persists is each hand-written kernel's
shared library, built by ``nvcc`` from its source once per source hash
into ``kernels._common.BUILD_DIR``. So the cold child starts with that
directory pointed at a fresh one (every kernel its step launches is
built), and the warm child with the same directory (every library is
loaded as built). Two more children run ``FeedForward.precompile`` (the
capture of the step's CUDA graph) before the fit, cold and warm. Each
child times the import, its first step, and each kernel build it paid
for. The net and the batch are the JAX bench's (a conv-BN net on
32 x 32 inputs); its optimizer is the port's fused Adam, so that the step
launches a hand-written kernel: with plain SGD no artifact of the port
would persist from one process to the next.

    python -m mxnet_tpu_torch.tools.bench_compile [--batch-size N] [--out FILE]

It runs on the card only: the children's builds need ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

METRIC = "compile_bench_time_to_first_step_sec"
CHILD_TIMEOUT_S = 1200
SEED = 0
# a child process: its clock starts before the package is imported
CHILD = """import time
t0 = time.perf_counter()
import json, sys
from mxnet_tpu_torch.tools import bench_compile
print(json.dumps(bench_compile.run_child(sys.argv[1], sys.argv[2],
                                         int(sys.argv[3]), t0)))
"""


def compile_bench_symbol():
    """``bench.py:371-389``: three conv-BN-ReLU blocks (two max-pooled),
    then two fully connected layers and a softmax."""
    from .. import symbol as sym

    net = sym.Variable("data")
    for i, ch in enumerate((32, 64, 64)):
        net = sym.Convolution(data=net, name=f"conv{i}", num_filter=ch,
                              kernel=(3, 3), pad=(1, 1))
        net = sym.BatchNorm(data=net, name=f"bn{i}")
        net = sym.Activation(data=net, name=f"relu{i}", act_type="relu")
        if i < 2:
            net = sym.Pooling(data=net, name=f"pool{i}", kernel=(2, 2),
                              stride=(2, 2), pool_type="max")
    net = sym.Flatten(data=net, name="flat")
    net = sym.FullyConnected(data=net, name="fc1", num_hidden=64)
    net = sym.Activation(data=net, name="fcrelu", act_type="relu")
    net = sym.FullyConnected(data=net, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(data=net, name="softmax")


def run_child(mode, build_dir, batch_size, t0):
    """One measured process start (``bench.py:392-438``), its clock started
    at ``t0`` before the package's import: build the model, capture the
    step ahead (``mode == "aot"``), fit to the first step. Returns the
    child's record; ``build_dir`` becomes ``kernels._common.BUILD_DIR``
    before the first launch."""
    from pathlib import Path

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.kernels import _common
    from mxnet_tpu_torch.utils import compile as compile_mod

    from . import _bench

    import_s = time.perf_counter() - t0
    dev = _bench.card(False, "bench_compile")
    _common.BUILD_DIR = Path(build_dir)
    built, loaded = [], []
    plain_build = _common._build

    def timed_build(stem):
        # which libraries this process paid nvcc for, and how long each took
        _, out = _common._library_path(stem)
        existed = out.exists()
        tb = time.perf_counter()
        path = plain_build(stem)
        if existed:
            loaded.append(stem)
        else:
            # nvcc ran in a subprocess that has returned: host time only
            built.append({"source": f"{stem}.cu",
                          "seconds": round(time.perf_counter() - tb, 3)})  # mxlint: disable=MX306
        return path

    _common._build = timed_build
    rng = np.random.RandomState(SEED)
    X = rng.randn(batch_size, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, (batch_size,)).astype(np.float32)
    model = mt.FeedForward(compile_bench_symbol(), ctx=mt.gpu(dev.index or 0),
                           num_epoch=1, learning_rate=0.1, optimizer="adam",
                           fused=True)
    marks = []

    def first_step(_param):
        if not marks:
            import torch

            torch.cuda.synchronize(dev)
        marks.append(time.perf_counter())

    precompile_s = None
    if mode == "aot":
        t_pre = time.perf_counter()
        model.precompile(data_shapes={"data": (batch_size, 3, 32, 32)},
                         label_shapes={"softmax_label": (batch_size,)},
                         batch_end_callback=first_step)
        precompile_s = time.perf_counter() - t_pre
    model.fit(X, y, batch_size=batch_size, batch_end_callback=first_step)
    stats = compile_mod.compile_stats()
    return {
        "import_s": round(import_s, 3),
        "time_to_first_step_s": round(marks[0] - t0, 3),
        "first_step_after_setup_s": round(
            marks[0] - t0 - import_s - (precompile_s or 0.0), 3),
        "precompile_s": (round(precompile_s, 3)
                         if precompile_s is not None else None),
        "compiles": stats["compiles"],
        "compile_seconds": round(stats["compile_seconds"], 3),
        "captures": stats["captures"],
        "capture_seconds": round(stats["capture_seconds"], 3),
        "kernel_builds": built,
        "kernel_build_s": round(sum(b["seconds"] for b in built), 3),
        "kernel_libraries_loaded": loaded,
    }


def child(mode, build_dir, batch_size):
    """A fresh process running :func:`run_child`; its record."""
    cmd = [sys.executable, "-c", CHILD, mode, build_dir, str(batch_size)]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT_S, cwd=root)
    if r.returncode != 0:
        print(r.stdout + r.stderr, file=sys.stderr)
        raise RuntimeError(f"bench_compile: the {mode} child failed")
    return json.loads(r.stdout.strip().splitlines()[-1])


def run(args):
    from . import _bench
    from . import _subsystem as sub

    dev = _bench.card(False, "bench_compile")
    base = tempfile.mkdtemp(prefix="mxtorch_compile_bench_")
    try:
        plain_dir = os.path.join(base, "build")
        cold = child("plain", plain_dir, args.batch_size)
        warm = child("plain", plain_dir, args.batch_size)
        aot_dir = os.path.join(base, "aot_build")
        aot = child("aot", aot_dir, args.batch_size)
        aot_warm = child("aot", aot_dir, args.batch_size)
        entries = len([f for f in os.listdir(plain_dir)
                       if f.endswith(".so")]) \
            if os.path.isdir(plain_dir) else 0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    saved = sum(b["seconds"] for b in cold["kernel_builds"]
                if b["source"][:-3] in warm["kernel_libraries_loaded"])
    result = {
        "metric": METRIC,
        "unit": "seconds",
        "batch_size": args.batch_size,
        "cold_start_s": cold["time_to_first_step_s"],
        "warm_start_s": warm["time_to_first_step_s"],
        "warm_speedup": round(cold["time_to_first_step_s"]
                              / max(warm["time_to_first_step_s"], 1e-9), 2),
        "warm_persistent_cache_hits": len(warm["kernel_libraries_loaded"]),
        "warm_compile_saved_s": round(saved, 3),
        "aot_precompile_s": aot["precompile_s"],
        "aot_first_step_after_setup_s": aot["first_step_after_setup_s"],
        "aot_warm_precompile_s": aot_warm["precompile_s"],
        "aot_warm_first_step_after_setup_s":
            aot_warm["first_step_after_setup_s"],
        "cold_first_step_after_setup_s": cold["first_step_after_setup_s"],
        "cache_entries": entries,
        "cold_kernel_builds": cold["kernel_builds"],
        "warm_kernel_builds": warm["kernel_builds"],
        "detail": {"cold": cold, "warm": warm, "aot": aot,
                   "aot_warm": aot_warm},
        "smoke": False,
        "device": _bench.card_identity(dev),
        "bounds": {"warm_speedup": sub.bound_flag(
            cold["time_to_first_step_s"]
            / max(warm["time_to_first_step_s"], 1e-9), 1.0, below=False)},
        "notes": (
            "What persists between processes in the port is each kernel's "
            "shared library (built per source hash into "
            "kernels._common.BUILD_DIR): the cold child builds what its "
            "step launches, the warm child loads it. The JAX package's "
            "persistent XLA cache and AOT-serialized executables have no "
            "counterpart here: a step's CUDA graph is captured again in "
            "every process (captures, capture_seconds), with precompile "
            "or at the fit's second step. warm_persistent_cache_hits "
            "counts the libraries the warm child loaded as built, "
            "warm_compile_saved_s the cold child's nvcc seconds for them. "
            "Each child pays its own process start and import."),
    }
    return sub.publish(result, "compile", args)


def check(result):
    """The bench's gates: the cold child paid a kernel build, the warm
    child none."""
    from . import _subsystem as sub

    sub.require(result["cold_kernel_builds"]
                and not result["warm_kernel_builds"],
                f"bench_compile: the cold child built "
                f"{result['cold_kernel_builds']}, the warm one "
                f"{result['warm_kernel_builds']} (none)")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="the JSON (default: "
                         "build/bench_subsystems/BENCH_COMPILE_torch.json)")
    ap.add_argument("--batch-size", type=int, default=256)
    return ap


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
