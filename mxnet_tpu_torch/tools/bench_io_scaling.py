"""The native input pipeline's decode scaling by thread count: the port's
counterpart of ``tools/bench_io_scaling.py``.

Runs the port's ``native.NativePipeline`` (RecordIO read, the port's JPEG
decode, resize-short 256, random crop 224, mirror, batch assembly in C++
threads, into pinned batches for the card) over ``_bench.ensure_recordio``'s
1,024 synthetic 256² JPEG records, batch 64, at 1, 2, 4 and 8 threads and at
the host's ``os.cpu_count()`` where that is larger; each figure is images/s
over a steady epoch after a warm one. The JAX tool's host had one core, so
it measured one core and projected eight. The card's host has many, so the
curve is measured, and the JAX tool's Amdahl projection is printed beside
it, from the same two stage measurements at one thread:

- ``MXTPU_NATIVE_SKIP_DECODE=1``: everything but the JPEG decode (the
  decode's share is what it takes away);
- ``MXTPU_NATIVE_SKIP_WORK=1``: zeroed batches, only the serial path (the
  batch tickets and the ordered delivery copy in ``next``); everything
  else runs on the worker threads by construction.

    python -m mxnet_tpu_torch.tools.bench_io_scaling [--out IO_SCALING_torch.json]

It runs where the card is (its batches are pinned for it) and raises
naming CUDA where there is none. Writes ``--out`` (never the JAX tool's
``IO_SCALING_r*.json``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..base import MXNetError
from . import _bench

SKIP_VARS = ("MXTPU_NATIVE_SKIP_DECODE", "MXTPU_NATIVE_SKIP_WORK")


def default_threads():
    """1, 2, 4, 8 and the host's cores where that is more."""
    cores = os.cpu_count() or 1
    return [1, 2, 4, 8] + ([cores] if cores > 8 else [])


def run_epochs(path, offsets, nthreads, batch=64, epochs=2,
               skip_decode=False, skip_work=False):
    """img/s over the steady epoch (the first warms the page cache and the
    threads)."""
    from .. import native

    prior = {v: os.environ.get(v) for v in SKIP_VARS}
    for var, on in zip(SKIP_VARS, (skip_decode, skip_work)):
        if on:
            os.environ[var] = "1"
        else:
            os.environ.pop(var, None)
    try:
        pipe = native.NativePipeline(
            path, offsets, batch, (3, 224, 224), rand_crop=True,
            rand_mirror=True, resize=256, shuffle=True, seed=3,
            num_threads=nthreads, prefetch=8, nhwc=True, out_u8=True)
    finally:
        for var, value in prior.items():
            if value is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = value
    for _ in range(max(1, epochs - 1)):  # warm epochs
        while True:
            try:
                pipe.next()
            except StopIteration:
                break
        pipe.reset()
    t0 = time.perf_counter()
    m = 0
    while True:
        try:
            pipe.next()
        except StopIteration:
            break
        m += 1
    dt = time.perf_counter() - t0
    del pipe
    return m * batch / dt


def summarize(records, serial_only, nodecode):
    """The JAX tool's projection from the one-thread figures, beside the
    measured curve: the parallel fraction ``p = 1 - t_serial / t_full``,
    Amdahl's ``1 / ((1 - p) + p / n)`` at 8 cores, and the measured
    speedup at each thread count."""
    base = records[0]["img_per_sec"]
    t_full = 1.0 / base
    t_serial = 1.0 / serial_only
    p = 1.0 - t_serial / t_full
    amdahl8 = 1.0 / ((1 - p) + p / 8)
    curve = {str(r["threads"]): r["img_per_sec"] / base for r in records}
    return {
        "single_thread_img_per_sec": base,
        "decode_share_of_worker_cost":
            1.0 - base / nodecode if nodecode > base else 0.0,
        "serial_path_img_per_sec": serial_only,
        "parallel_fraction": p,
        "amdahl_projected_speedup_8_cores": amdahl8,
        "amdahl_projected_img_per_sec_8_cores": base * amdahl8,
        "measured_speedup_by_threads": curve,
    }


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="IO_SCALING_torch.json")
    ap.add_argument("--rec", default=str(_bench.WORK_DIR
                                         / "bench_imagenet_1024.rec"),
                    help="the RecordIO shard, written from the seed when "
                         "missing")
    ap.add_argument("--threads", default=None,
                    help="comma-separated thread counts (default 1,2,4,8 "
                         "and the host's cores where more)")
    return ap


def main(argv=None):
    from .. import native

    args = parser().parse_args(argv)
    device = _bench.card(what="bench_io_scaling")
    ident = _bench.card_identity(device)
    threads = [int(t) for t in args.threads.split(",")] if args.threads \
        else default_threads()
    path = _bench.ensure_recordio(args.rec, n=1024)
    offsets = native.scan_offsets(path)
    if not offsets:
        raise MXNetError(f"bench_io_scaling: no records in {path} (the "
                         "native scanner is unavailable or the file is "
                         "not RecordIO)")
    results = {"card": ident, "host_cores": os.cpu_count(),
               "records_in_shard": len(offsets), "records": []}
    for nt in threads:
        ips = run_epochs(path, offsets, nt)
        results["records"].append(
            {"threads": nt, "decode": True, "img_per_sec": ips})
        print(json.dumps({**results["records"][-1], "card": ident}),
              flush=True)
    curve = list(results["records"])
    nodecode = run_epochs(path, offsets, 1, skip_decode=True)
    results["records"].append(
        {"threads": 1, "stage": "no_decode", "img_per_sec": nodecode})
    serial_only = run_epochs(path, offsets, 1, skip_work=True)
    results["records"].append(
        {"threads": 1, "stage": "serial_path_only",
         "img_per_sec": serial_only})
    for rec in results["records"][-2:]:
        print(json.dumps({**rec, "card": ident}), flush=True)
    results.update(summarize(curve, serial_only, nodecode))
    results["note"] = (
        "measured on the card's host at each thread count; the Amdahl "
        "projection (serial term: the ordered delivery copy and the "
        "tickets) is printed beside the measured curve")
    print(json.dumps({k: v for k, v in results.items() if k != "records"}))
    _bench.write_json(args.out, results)
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
