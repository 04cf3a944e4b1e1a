"""MNIST train-step throughput on the card, MLP and LeNet: the port's
counterpart of ``tools/bench_mnist.py``.

The reference's published MNIST anchors (``example/mnist/README.md``):
MLP 103K img/s and LeNet 22.5K img/s on one GTX 980. This measures the
same two train steps (forward, backward and SGD with momentum, f32, the
JAX tool's update: ``m = 0.9 m + g / batch``, ``w -= 0.1 m``) over the
port's ``_build_graph_fn(is_train=True)``, parameters from
``np.random.RandomState(0)`` at the JAX tool's scales. Steps this small
are launch-bound, so each is captured into a CUDA graph and timed as the
mean of ``--iters`` replays between CUDA events (the JAX tool slope-timed
an in-device ``fori_loop``).

    python -m mxnet_tpu_torch.tools.bench_mnist [--out MNIST_torch.json]

Writes ``--out`` (never the JAX tool's ``MNIST_r*.json``) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.compile import CapturedProgram
from . import _bench

BASELINES = {"mlp": 103000.0, "lenet": 22500.0}  # 1x GTX 980, BASELINE.md


def build_step(model_name, batch, device=None):
    """``(step, params, moms, data_shape)`` of the JAX tool's
    ``build_step``: ``step(params, moms, aux, data, label)`` updates
    ``params`` and ``moms`` in place and returns the softmax output."""
    from ..executor import _build_graph_fn
    from ..models import lenet, mlp

    device = torch.device(device or "cpu")
    if model_name == "mlp":
        net, data_shape = mlp(), (batch, 784)
    else:
        net, data_shape = lenet(), (batch, 1, 28, 28)
    shapes = {"data": data_shape, "softmax_label": (batch,)}
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rng = np.random.RandomState(0)
    params = {}
    for name, shp in zip(net.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("bias"):
            value = np.zeros(shp, np.float32)
        else:
            scale = float(np.sqrt(2.0 / max(1, int(np.prod(shp[1:])))))
            value = (rng.randn(*shp) * scale).astype(np.float32)
        params[name] = torch.from_numpy(value).to(device)
    moms = {k: torch.zeros_like(v) for k, v in params.items()}
    step = _bench.sgd_momentum_step(_build_graph_fn(net, is_train=True),
                                    lr=0.1, momentum=0.9, divide=batch)
    return step, params, moms, data_shape


def bench_model(model_name, batch, iters=50, device=None):
    step, params, moms, data_shape = build_step(model_name, batch, device)
    gen = torch.Generator(device=device).manual_seed(0)
    data = torch.randn(data_shape, generator=gen, device=device)
    label = torch.randint(0, 10, (batch,), generator=gen,
                          device=device).float()
    run = CapturedProgram(lambda: step(params, moms, {}, data, label),
                          device, "bench_mnist")
    run()
    run()
    per_ms = _bench.replay_ms(run, iters)
    return {"model": model_name, "batch": batch, "step_ms": per_ms,
            "images_per_sec": batch / per_ms * 1e3}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="MNIST_torch.json")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = _bench.card(what="bench_mnist")
    ident = _bench.card_identity(device)
    print(f"card={ident}", flush=True)
    records = []
    for name in ("mlp", "lenet"):
        rec = bench_model(name, args.batch, iters=args.iters, device=device)
        rec["baseline_gtx980_img_s"] = BASELINES[name]
        rec["vs_baseline"] = rec["images_per_sec"] / BASELINES[name]
        rec["card"] = ident
        print(json.dumps(rec), flush=True)
        records.append(rec)
    out = {"card": ident,
           "timing": "captured step: --iters replays between CUDA events, "
                     "median of 3 runs",
           "iters": args.iters, "records": records}
    _bench.write_json(args.out, out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
