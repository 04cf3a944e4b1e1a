"""Gradient-sync wire bytes and step time by compression mode: the port's
counterpart of ``bench.py --comm-bench`` (``run_comm_bench``).

For each of none, bf16, int8 and twobit the same dp-8 MLP train step
(tanh hidden layer, log-softmax cross entropy, SGD at 0.1) runs over eight
replicas of one device in one process, its gradients averaged through the
in-process exchange (``comm.compressed_allreduce`` /
``error_feedback_allreduce`` over a ``comm.ReplicaGroup``). One step runs
under ``torch.profiler``: the exchange's recorded collective table
(``comm.collective_table``, the ranges each collective opens) gives the
step's wire bytes, held against the closed-form ``comm.allreduce_plan``.
Then the step is timed. The headline is int8's wire reduction against
f32.

    python -m mxnet_tpu_torch.tools.bench_comm [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import comm
from . import _bench
from . import _subsystem as sub

METRIC = "comm_bench_int8_wire_reduction_vs_fp32"
MODES = (None, "bf16", "int8", "twobit")


def shapes(smoke):
    """``bench.py:522-524``: ``(dim, hidden, classes, batch, steps)``."""
    dim, hidden, classes = (64, 64, 8) if smoke else (512, 1024, 64)
    return dim, hidden, classes, 64 if smoke else 256, 3 if smoke else 30


def mlp_params(dim, hidden, classes, rng):
    """``bench.py:525-531``, drawn from ``rng`` in its order."""
    return {
        "w1": (rng.randn(dim, hidden) * 0.05).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": (rng.randn(hidden, classes) * 0.05).astype(np.float32),
        "b2": np.zeros(classes, np.float32),
    }


def replica_batches(arrays: dict, n: int, device) -> list:
    """Each replica's contiguous block of rows (``shard_batch`` over a
    data axis of ``n``), as tensors on ``device``."""
    return [{k: torch.from_numpy(np.ascontiguousarray(
        np.array_split(v, n)[i])).to(device) for k, v in arrays.items()}
        for i in range(n)]


def replica_grads(loss_fn, params: list, batches: list):
    """``(losses, grads)``: each replica's loss and gradient dict."""
    losses, grads = [], []
    for p, b in zip(params, batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(leaves, b)
        g = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.detach())
        grads.append(dict(zip(leaves, g)))
    return losses, grads


def make_replica_step(loss_fn, lr, group, compression):
    """The dp step of ``parallel.make_data_parallel_step`` over a
    ``ReplicaGroup``: ``step(params, batches, residuals) -> (params,
    mean loss, residuals)``, one value a replica in each list; the
    gradients averaged over the replicas, each replica updated with them
    (``w - lr * g``)."""
    spec = comm.CompressionSpec.resolve(compression)
    has_ef = spec is not None and spec.error_feedback

    def step(params, batches, residuals):
        losses, grads = replica_grads(loss_fn, params, batches)
        if has_ef:
            reduced, residuals = comm.error_feedback_allreduce(
                grads, residuals, spec, group=group, average=True)
        else:
            reduced = comm.compressed_allreduce(grads, spec, group=group,
                                                average=True)
        with torch.no_grad():
            params = [{k: p[k] - lr * r[k] for k in p}
                      for p, r in zip(params, reduced)]
        return params, torch.stack(losses).mean(), residuals

    return step


def profiled_table(fn, n):
    """``fn()`` once under ``torch.profiler`` (host ranges only): the
    collective table its exchange recorded, and ``fn``'s result."""
    # the collective ranges of one step, read as a table here and priced
    # nowhere: no window of a fit, so no badput to charge
    with torch.profiler.profile(  # mxlint: disable=MX314
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return comm.collective_table(prof, default_group_size=n), out


def run(args):
    dev = _bench.card(args.cpu, "bench_comm")
    smoke = bool(args.smoke)
    ndev = sub.REPLICAS
    dim, hidden, classes, batch, steps = shapes(smoke)
    rng = np.random.RandomState(0)
    params0 = mlp_params(dim, hidden, classes, rng)
    num_elems = sum(v.size for v in params0.values())
    x = rng.randn(batch, dim).astype(np.float32)
    y = rng.randint(0, classes, (batch,)).astype(np.int64)
    batches = replica_batches({"x": x, "y": y}, ndev, dev)
    group = comm.ReplicaGroup([dev] * ndev)

    def loss_fn(p, d):
        h = torch.tanh(d["x"] @ p["w1"] + p["b1"])
        logp = torch.log_softmax(h @ p["w2"] + p["b2"], dim=-1)
        return -logp.gather(1, d["y"][:, None]).mean()

    modes = {}
    for mode in MODES:
        spec = comm.CompressionSpec.resolve(mode)
        step = make_replica_step(loss_fn, 0.1, group, mode)
        params = [{k: torch.from_numpy(v).to(dev) for k, v in
                   params0.items()} for _ in range(ndev)]
        resid = None
        if spec is not None and spec.error_feedback:
            resid = [comm.init_error_feedback(params[0], spec, ndev,
                                              device=dev)
                     for _ in range(ndev)]
        table, _ = profiled_table(lambda: step(params, batches, resid), ndev)
        wire = sum(r["wire_bytes"] for r in table)
        plan = comm.allreduce_plan(num_elems, ndev, mode)
        state = step(params, batches, resid)  # warm the path
        sub.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state[0], batches, state[2])
        sub.synchronize(dev)
        dt = (time.perf_counter() - t0) / steps
        modes[mode or "none"] = {
            "hlo_wire_bytes_per_step": round(wire, 1),
            "hlo_collectives": table,
            "plan_wire_bytes_per_step": round(plan["wire_bytes"], 1),
            "plan_ratio_vs_fp32": round(plan["ratio"], 2),
            "step_ms": round(dt * 1e3, 3),
            "final_loss": round(float(state[1]), 5),
        }
    fp32_wire = modes["none"]["hlo_wire_bytes_per_step"]
    for m in modes.values():
        wire = m["hlo_wire_bytes_per_step"]
        m["hlo_ratio_vs_fp32"] = round(fp32_wire / wire, 2) if wire else None
        m["wire_matches_plan"] = bool(
            abs(wire - m["plan_wire_bytes_per_step"])
            <= 0.02 * m["plan_wire_bytes_per_step"])
    ratio = modes["int8"]["hlo_ratio_vs_fp32"] or 0.0
    result = {
        "metric": METRIC,
        "value": ratio,
        "unit": "x",
        "vs_baseline": ratio,
        "axis_size": ndev,
        "param_elements": int(num_elems),
        "smoke": smoke,
        "modes": modes,
        "device": _bench.card_identity(dev),
        "notes": (
            "hlo_* keep the JAX bench's names: here they are the "
            "exchange's recorded collective table (one row a collective, "
            "its payload's own dtype: bf16 stays bf16), "
            "held against the closed-form plan; the eight replicas "
            "exchange in one process, so no byte crosses a link and "
            "step_ms prices the quantization arithmetic, not a wire. "
            + sub.TIME_SHARED + "."),
    }
    return sub.publish(result, "comm", args)


def check(result):
    """The bench's gates: every mode's recorded wire bytes the plan's."""
    for mode, row in result["modes"].items():
        sub.require(row["hlo_wire_bytes_per_step"]
                    == row["plan_wire_bytes_per_step"],
                    f"bench_comm: the {mode} wire bytes "
                    f"{row['hlo_wire_bytes_per_step']} are the plan's "
                    f"{row['plan_wire_bytes_per_step']}")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
