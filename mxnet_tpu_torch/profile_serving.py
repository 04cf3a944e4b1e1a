"""Where a served request's device time goes, by kernel, on one CUDA card.

    python3 -m mxnet_tpu_torch.profile_serving [--quantize int8|none]

It builds the seeded full-width ResNet-50 that ``chip_smoke.py`` serves
(batch 32, seed 0), serves one warm-up request through
``Predictor(ctx=gpu(0))``, then traces four requests with ``torch.profiler``
and prints one JSON object:
the card's name and power limit, the window's wall time, the device time
summed over kernels, the device's idle share of the window, and the kernels
with the most device time. f32 contractions keep f32
(``set_matmul_precision("highest")``, TF32 off), as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import Predictor, gpu, set_matmul_precision
from .convert import random_params
from .models import resnet50

BATCH = 32     # chip_smoke.py's serving batch
SEED = 0       # and its weight seed
REQUESTS = 4
TOP = 12       # kernels listed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=("int8", "none"), default="int8")
    args = ap.parse_args(argv)

    ctx = gpu(0)  # raises without CUDA
    set_matmul_precision("highest")
    net = resnet50(num_classes=1000)
    shape = (BATCH, 3, 224, 224)
    arg_params, aux_params = random_params(net, SEED, data=shape)
    image = np.random.default_rng(SEED + 1).standard_normal(
        shape, np.float32)
    pred = Predictor(net, arg_params, aux_params, ctx=ctx,
                     quantize=None if args.quantize == "none" else "int8")
    pred.forward(data=image).get_output(0)
    torch.cuda.synchronize()

    report = device_report(lambda: pred.forward(data=image).get_output(0),
                           REQUESTS, "request")
    print(json.dumps({"quantize": args.quantize, "batch": BATCH, **report}))
    return 0


def device_report(run_once, repeats: int, unit: str) -> dict:
    """Trace ``repeats`` calls of ``run_once`` with ``torch.profiler`` and
    return the card's name and power limit, wall and device time per call,
    the device's idle share of the window and the kernels with the most
    device time."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    # a command of its own, alone in its process: the report reads the
    # profile object's device rows, which a capture window does not give
    with torch.profiler.profile(activities=activities) as prof:  # mxlint: disable=MX314
        t0 = time.perf_counter()
        for _ in range(repeats):
            run_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): CPU-op rows also report the
    # device time of the kernels they launched, which would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    device_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    return {
        "nvidia_smi": smi, f"{unit}s": repeats,
        f"wall_ms_per_{unit}": wall_us / repeats / 1e3,
        f"device_ms_per_{unit}": device_us / repeats / 1e3,
        "device_idle_share": 1.0 - device_us / wall_us,
        "top_kernels": [
            {"name": e.key[:90], f"calls_per_{unit}": e.count / repeats,
             f"ms_per_{unit}": e.self_device_time_total / repeats / 1e3,
             "share": e.self_device_time_total / device_us}
            for e in events[:TOP]],
    }


if __name__ == "__main__":
    sys.exit(main())
