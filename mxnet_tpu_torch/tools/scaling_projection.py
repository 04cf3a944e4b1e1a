"""Data-parallel ResNet-50 scaling from 8 to 256 cards, projected from one:
the port's counterpart of ``tools/scaling_projection.py``.

There is one card, so this is a PROJECTION, not a measurement across cards,
built as the JAX tool builds it from two inputs and a link model:

1. the all-reduce payload of one data-parallel step: the port's ResNet-50
   f32 gradient, one flat buffer (``model._GradSync``), planned by
   ``comm.stats.overlap_plan`` as one uncompressed bucket, and checked
   against ``comm.stats.collective_table`` of a profiled all-reduce of that
   buffer through the port's exchange (``comm.allreduce.all_reduce_sum``
   over a ``ReplicaGroup`` of two members on the device). The JAX tool
   reads the all-reduce operands from the compiled step's HLO, which also
   carry BatchNorm's batch statistics and the loss (``not_in_payload``
   names them and their bytes);
2. the step time of one card at batch 256: measured on the card (the f32
   step of ``bench_roofline``, captured, 8 replays between CUDA events),
   or read from ``bench_roofline``'s JSON with ``--roofline``;
3. the link model: a ring all-reduce moves ``2 (n - 1) / n`` of the payload
   through each card's links. Inside one node of 8 H100 SXM cards the ring
   runs over NVLink; from 16 cards on it crosses the nodes' network cards,
   one per GPU, and the slowest link bounds the ring. Each link's nominal
   rate, from its data sheet, is derated by an achievable fraction, and
   a share of the exchange may hide under the backward (overlap).

Efficiency is ``step / (step + exposed comm)``. ``project`` keeps the JAX
tool's rows with the port's link names; ``JAX_KEYS`` says which JAX key
each row key stands for.

    python -m mxnet_tpu_torch.tools.scaling_projection [--out SCALING_torch.json]
    python -m mxnet_tpu_torch.tools.scaling_projection --cpu \\
        --roofline ROOFLINE_torch.json

The payload count runs on the CPU with ``--cpu``, as the JAX tool's runs
there; the step time is the card's or ``--roofline``'s, never the CPU's.
Writes ``--out`` (never the JAX tool's ``SCALING_r*.json``) with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import tempfile

import numpy as np
import torch

from ..base import MXNetError
from ..utils.compile import CapturedProgram
from . import _bench

# NVIDIA H100 SXM data sheet: fourth-generation NVLink, 900 GB/s a card,
# 450 GB/s each way, to the other cards of its node
NVLINK_GBS = 450.0
# one 400 Gb/s ConnectX-7 network card a GPU (NVIDIA DGX H100 data sheet:
# 8 single-port OSFP 400 Gb/s cards for 8 GPUs): 50 GB/s each way
NIC_GBS_PER_CARD = 50.0
CARDS_PER_NODE = 8
ACHIEVABLE = 0.7       # fraction of nominal a real collective sustains
OVERLAP = 0.7          # fraction of all-reduce hidden under backward
SIZES = (8, 16, 32, 64, 128, 256)
STEP_BATCH = 256       # the step the projection scales: one card's batch
STEP_ITERS = 8         # its timed replays, when it is measured
# the port's row keys that stand for the JAX tool's
JAX_KEYS = {"cards": "chips", "allreduce_gb_per_card": "allreduce_gb_per_chip",
            "t_comm_nvlink_ms": "t_comm_ici_ms",
            "eff_nvlink_no_overlap": "eff_ici_no_overlap",
            "eff_nvlink_70pct_overlap": "eff_ici_70pct_overlap",
            "eff_nic_no_overlap": "eff_dcn_no_overlap"}
SOURCES = {
    "nvlink_gbs_nominal": "NVIDIA H100 SXM data sheet: NVLink 900 GB/s a "
                          "card, 450 GB/s each way",
    "nic_gbs_per_card_nominal": "NVIDIA DGX H100 data sheet: 8 x 400 Gb/s "
                                "ConnectX-7 for 8 GPUs, 50 GB/s each way a "
                                "card",
}


def resnet50_gradient(batch=16):
    """``({param: shape}, {aux: shape})`` of ResNet-50 at the JAX tool's
    batch (2 a device over 8)."""
    from ..models import resnet50

    sym = resnet50(num_classes=1000)
    shapes = {"data": (batch, 3, 224, 224), "softmax_label": (batch,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    params = {n: tuple(s) for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in shapes}
    aux = dict(zip(sym.list_auxiliary_states(), map(tuple, aux_shapes)))
    return params, aux


def profiled_allreduce_table(num_elements, device):
    """``comm.stats.collective_table`` of one all-reduce of a flat f32
    gradient of ``num_elements`` through ``all_reduce_sum`` over two
    members on ``device``, in a ``telemetry.profiling`` capture."""
    from ..comm.allreduce import ReplicaGroup, all_reduce_sum
    from ..comm.stats import collective_table
    from ..telemetry import profiling

    group = ReplicaGroup([device, device])
    flats = [torch.zeros(num_elements, device=device) for _ in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.capture(tmp, owner="scaling_projection"):
            summed = all_reduce_sum(flats, group)
        del summed, flats
        (name,) = [n for n in os.listdir(tmp) if n.endswith(".json.gz")]
        with gzip.open(os.path.join(tmp, name), "rt") as f:
            return collective_table(json.load(f))


def allreduce_payload(n_dev=8, device="cpu"):
    """The payload of one data-parallel step over ``n_dev`` cards:
    ``{"payload_bytes", "param_bytes_f32", "plan", "profiled",
    "not_in_payload"}``. ``plan`` is ``overlap_plan`` of the flat gradient
    as one uncompressed bucket, ``profiled`` the all-reduce row of the
    profiled table; they must agree."""
    from ..comm.stats import overlap_plan

    params, aux = resnet50_gradient(2 * n_dev)
    elems = sum(int(np.prod(s)) for s in params.values())
    plan = overlap_plan([("resnet50", elems)], n_dev, None)
    table = profiled_allreduce_table(elems, torch.device(device))
    row = next(r for r in table if r["op"] == "all-reduce")
    if row["payload_bytes"] != plan["payload_bytes"] or row["count"] != 1:
        raise MXNetError(f"scaling_projection: the profiled all-reduce "
                         f"{row} is not overlap_plan's "
                         f"{plan['collectives']}")
    stats = sum(int(np.prod(s)) for s in aux.values()) * 4
    return {"payload_bytes": plan["payload_bytes"],
            "param_bytes_f32": elems * 4,
            "plan": plan["collectives"], "profiled": row,
            "not_in_payload": {
                "batchnorm_statistics_bytes": stats,
                "loss_bytes": 4,
                "note": "the JAX tool's compiled step also all-reduces "
                        "BatchNorm's batch mean and variance of every "
                        "layer (the moving statistics' shapes, f32) and "
                        "the summed loss; the gradient payload here is "
                        "the parameters' alone"}}


def project(ar_bytes, step_ms):
    """One row a cluster size: the all-reduce bytes through each card, its
    time over NVLink and over the network card, the link the ring crosses
    at that size, and the efficiency without overlap, with 70% of the
    exchange hidden, and bound by the network card."""
    rows = []
    for n in SIZES:
        wire = 2 * (n - 1) / n * ar_bytes
        t_nvlink = wire / (NVLINK_GBS * ACHIEVABLE * 1e9) * 1e3      # ms
        t_nic = wire / (NIC_GBS_PER_CARD * ACHIEVABLE * 1e9) * 1e3
        link = "nvlink" if n <= CARDS_PER_NODE else "nic"
        t_comm = t_nvlink if link == "nvlink" else t_nic
        rows.append({
            "cards": n,
            "link": link,
            "allreduce_gb_per_card": round(wire / 1e9, 4),
            "t_comm_nvlink_ms": round(t_nvlink, 2),
            "t_comm_nic_ms": round(t_nic, 2),
            "eff_nvlink_no_overlap": round(step_ms / (step_ms + t_nvlink), 4),
            "eff_nvlink_70pct_overlap": round(
                step_ms / (step_ms + (1 - OVERLAP) * t_nvlink), 4),
            "eff_nic_no_overlap": round(step_ms / (step_ms + t_nic), 4),
            "eff_no_overlap": round(step_ms / (step_ms + t_comm), 4),
            "eff_70pct_overlap": round(
                step_ms / (step_ms + (1 - OVERLAP) * t_comm), 4),
        })
    return rows


def measured_step_ms(device):
    """The f32 ResNet-50 step of ``bench_roofline`` at batch
    ``STEP_BATCH``: ms a replay of the captured step, ``STEP_ITERS``
    replays between CUDA events."""
    from ..base import get_matmul_precision, set_matmul_precision
    from .bench_roofline import step_inputs

    prior = get_matmul_precision()
    set_matmul_precision("highest")
    try:
        step, params, moms, aux = _bench.build_resnet50_train_step(
            STEP_BATCH, device=device)
        data, label = step_inputs(STEP_BATCH, device)
        prog = CapturedProgram(lambda: step(params, moms, aux, data, label),
                               device, "scaling_projection")
        prog()
        prog()
        return _bench.replay_ms(prog, STEP_ITERS, samples=1)
    finally:
        set_matmul_precision(prior)


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="SCALING_torch.json")
    ap.add_argument("--roofline", default=None,
                    help="take the step time from this bench_roofline JSON "
                         "(its measured_step_ms) instead of measuring it")
    ap.add_argument("--cpu", action="store_true",
                    help="count the payload on the CPU (needs --roofline)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.cpu and not args.roofline:
        raise MXNetError("scaling_projection: --cpu counts the payload only;"
                         " the step time is the card's: pass --roofline")
    device = _bench.card(args.cpu, what="scaling_projection")
    payload = allreduce_payload(device=device)
    if args.roofline:
        with open(args.roofline) as f:
            roof = json.load(f)
        step_ms, step_from = roof["measured_step_ms"], {
            "file": args.roofline, "card": roof.get("card"),
            "batch_size": roof.get("batch_size")}
        ident = roof.get("card")
    else:
        step_ms = measured_step_ms(device)
        ident = _bench.card_identity(device)
        step_from = {"measured": True, "card": ident,
                     "batch_size": STEP_BATCH}
    out = {
        "model": "resnet50 dp train step (the port's f32 gradient, one "
                 "flat buffer)",
        "card": ident,
        "allreduce_payload_bytes_per_step": payload["payload_bytes"],
        "param_bytes_f32": payload["param_bytes_f32"],
        "plan_collectives": payload["plan"],
        "profiled_allreduce": payload["profiled"],
        "not_in_payload": payload["not_in_payload"],
        "assumptions": {
            "step_ms_measured_1card": step_ms,
            "step_from": step_from,
            "nvlink_gbs_nominal": NVLINK_GBS,
            "nic_gbs_per_card_nominal": NIC_GBS_PER_CARD,
            "cards_per_node": CARDS_PER_NODE,
            "achievable_fraction": ACHIEVABLE,
            "overlap_fraction": OVERLAP,
            "sources": SOURCES,
            "note": "PROJECTION from one card: the step time of one H100 "
                    "and the gradient's bytes, over nominal data-sheet link "
                    "rates; not a measurement across cards. Ring all-reduce "
                    "2(N-1)/N model; NVLink inside an 8-card node, the "
                    "network card from 16 cards on.",
        },
        "jax_keys": JAX_KEYS,
        "projection": project(payload["payload_bytes"], step_ms),
    }
    _bench.write_json(args.out, out)
    print(json.dumps({k: v for k, v in out.items() if k != "projection"},
                     indent=1))
    print(f"\nPROJECTION from one card ({ident}), not measured across cards")
    print("| cards | link | all-reduce GB/card | t_comm NVLink (ms) | "
          "t_comm NIC (ms) | eff (no overlap) | eff (70% overlap) |")
    print("|---|---|---|---|---|---|---|")
    for r in out["projection"]:
        print(f"| {r['cards']} | {r['link']} | "
              f"{r['allreduce_gb_per_card']:.3f} | "
              f"{r['t_comm_nvlink_ms']:.2f} | {r['t_comm_nic_ms']:.2f} | "
              f"{r['eff_no_overlap']:.1%} | {r['eff_70pct_overlap']:.1%} |")
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
