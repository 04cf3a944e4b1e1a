"""The hand-written kernels' roofline accounting: the port's counterpart of
``bench.py --kernel-bench`` (``run_kernel_bench``).

Three measurements, one JSON line:

(a) a roofline row for each of the eleven kernels of ``kernels/``: the
    registry's operation and byte model (``kernels/registry.py``) of one
    call at the JAX bench's shapes, against its time on the card (CUDA
    events around single launches, the L2 cache flushed before each); on
    the CPU the row times the kernel's plain version (``source``
    "plain");
(b) the error-feedback int8 exchange of eight replicas with the fused
    kernels (``comm.CommKernelConfig``) and with the codecs, each once
    under ``torch.profiler``: the slab-sized quantize passes that ran as
    torch operations (the passes the kernels replace; on the CPU the
    kernels' plain versions are such operations), the kernels launched,
    and the recorded wire bytes, which must not change;
(c) the whole-tree ``fused_adam`` step against the per-leaf update, its
    time and its bitwise parity on the same inputs.

    python -m mxnet_tpu_torch.tools.bench_kernels [--smoke] [--cpu] [--out FILE]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import comm, telemetry
from .. import optimizer as opt_mod
from ..kernels import comm_kernels as ck
from ..kernels import flash_attention as tfa
from ..kernels import fused_adam as kfa
from ..kernels import int8_matmul as k8
from ..kernels import registry
from . import _bench
from . import _subsystem as sub

METRIC = "kernel_bench_full_slab_quantize_passes_removed"
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "quant_int8",
           "quant_twobit", "dequant_sum_int8", "dequant_sum_twobit",
           "dequant_int8", "dequant_twobit", "fused_adam", "int8_matmul")
WRAPPERS = {"flash_fwd": tfa.flash_fwd, "flash_bwd_dq": tfa.flash_bwd_dq,
            "flash_bwd_dkv": tfa.flash_bwd_dkv,
            "quant_int8": ck.quant_int8, "quant_twobit": ck.quant_twobit,
            "dequant_sum_int8": ck.dequant_sum_int8,
            "dequant_sum_twobit": ck.dequant_sum_twobit,
            "dequant_int8": ck.dequant_int8,
            "dequant_twobit": ck.dequant_twobit,
            "fused_adam": kfa.fused_adam, "int8_matmul": k8.int8_matmul}
CHUNK = 256
THRESHOLD = 0.5
ADAM = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=1.0,
            clip_gradient=None, wd_l2=0.0, decoupled=False)
WORLD = 8


def shapes(smoke):
    """``bench.py:1970-1982``: the attention ``(b, h, s, d)``, the slab
    ``(rows, length)``, the GEMM ``(m, k, n)``, the Adam leaves and the
    exchange's length a replica."""
    return {
        "attention": (1, 2, 128, 32) if smoke else (2, 4, 512, 64),
        "slab": (8, 4096) if smoke else (8, 65536),
        "matmul": (64, 128, 64) if smoke else (512, 1024, 512),
        "adam": [(256, 64), (64,), (64, 32)] if smoke else
        [(1024, 512), (512,), (512, 256)],
        "exchange": 2048 if smoke else 16384,
        "iters": 3 if smoke else 20,
    }


def launches() -> dict:
    return {n: WRAPPERS[n].launches for n in KERNELS}


def operands(sh, dev, rng):
    """Each kernel's call at the bench shapes: ``({name: (fn, ins, outs,
    static)}, (x, w))``, ``fn()`` one call of the kernel's wrapper, ``ins``
    and ``outs`` the tensors its registry model prices, ``x`` and ``w`` the
    GEMM's float operands. Inputs the JAX bench builds outside its timed
    function (a payload to decode) and the weight's per-channel
    quantization are made here, outside the timer."""

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    b, h, s, d = sh["attention"]
    q = t(rng.randn(b, h, s, d).astype(np.float32))
    do = t(rng.randn(b, h, s, d).astype(np.float32))
    o, lse = tfa.flash_fwd(q, q, q, causal=True)
    delta = tfa.attention_delta(o, do)
    dq = tfa.flash_bwd_dq(q, q, q, do, lse, delta, causal=True)
    dk, dv = tfa.flash_bwd_dkv(q, q, q, do, lse, delta, causal=True)
    rows = t(rng.randn(*sh["slab"]).astype(np.float32))
    q8, s8, dq8, _ = ck.quant_int8(rows, CHUNK, True)
    q2, dq2, _ = ck.quant_twobit(rows, THRESHOLD, True)
    sum8 = ck.dequant_sum_int8(q8, s8, CHUNK)
    sum2 = ck.dequant_sum_twobit(q2, THRESHOLD)
    de8 = ck.dequant_int8(q8, s8, CHUNK)
    de2 = ck.dequant_twobit(q2, THRESHOLD)
    m, kk, n = sh["matmul"]
    x = t(rng.randn(m, kk).astype(np.float32))
    w = t(rng.randn(n, kk).astype(np.float32))
    wq, sw = k8.quantize_channels(w)
    y = k8.int8_matmul(x, wq, w_scale=sw)
    leaves = [t(rng.randn(*s_).astype(np.float32)) for s_ in sh["adam"]]
    grads = [t(rng.randn(*s_).astype(np.float32)) for s_ in sh["adam"]]
    ms = [torch.zeros_like(leaf) for leaf in leaves]
    vs = [torch.zeros_like(leaf) for leaf in leaves]
    ones = [1.0] * len(leaves)
    zeros = [0.0] * len(leaves)
    causal = {"causal": True}
    return ({
        "flash_fwd": (lambda: tfa.flash_fwd(q, q, q, causal=True),
                      (q, q, q), (o, lse), causal),
        "flash_bwd_dq": (lambda: tfa.flash_bwd_dq(q, q, q, do, lse, delta,
                                                  causal=True),
                         (q, q, q, do, lse, delta), (dq,), causal),
        "flash_bwd_dkv": (lambda: tfa.flash_bwd_dkv(q, q, q, do, lse, delta,
                                                    causal=True),
                          (q, q, q, do, lse, delta), (dk, dv), causal),
        "quant_int8": (lambda: ck.quant_int8(rows, CHUNK, True), (rows,),
                       (q8, s8, dq8), {}),
        "quant_twobit": (lambda: ck.quant_twobit(rows, THRESHOLD, True),
                         (rows,), (q2, dq2), {}),
        "dequant_sum_int8": (lambda: ck.dequant_sum_int8(q8, s8, CHUNK),
                             (q8, s8), (sum8,), {}),
        "dequant_sum_twobit": (lambda: ck.dequant_sum_twobit(q2, THRESHOLD),
                               (q2,), (sum2,), {}),
        "dequant_int8": (lambda: ck.dequant_int8(q8, s8, CHUNK), (q8, s8),
                         (de8,), {}),
        "dequant_twobit": (lambda: ck.dequant_twobit(q2, THRESHOLD), (q2,),
                           (de2,), {}),
        "fused_adam": (lambda: kfa.fused_adam(leaves, grads, ms, vs, ones,
                                              ones, zeros, **ADAM),
                       (leaves, grads, ms, vs), (leaves, ms, vs), {}),
        "int8_matmul": (lambda: k8.int8_matmul(x, wq, w_scale=sw),
                        (x, wq, sw), (y,), {}),
    }, (x, w))


def call_ms(fn, dev, iters):
    """Milliseconds a call: on the card the median of ``iters`` single
    launches with the L2 cache flushed before each; on the CPU the mean of
    ``iters`` calls after two."""
    if torch.device(dev).type == "cuda":
        return _bench.kernel_ms(fn, iters)
    for _ in range(2):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    # CPU tensors: each call has finished when it returns
    return (time.perf_counter() - t0) / iters * 1e3  # mxlint: disable=MX306


def roofline_row(name, fn, ins, outs, static, dev, iters, peak):
    """One kernel's row: its registry model beside its measured time."""
    cost = registry.get_kernel(name).cost(ins, outs, **static)
    bound_s, bound_by = cost.bound()
    before = WRAPPERS[name].launches
    ms = call_ms(fn, dev, iters)
    flops, bytes_ = cost.flops, cost.bytes
    return {
        "kernel": name,
        "source": "measured" if torch.device(dev).type == "cuda"
        else "plain",
        "kernels_in_program": [name],
        "model_flops": flops,
        "model_bytes": bytes_,
        "intensity_flops_per_byte": round(flops / bytes_, 3)
        if bytes_ else None,
        "ms": round(ms, 5),
        "achieved_gflops_s": round(flops / (ms * 1e-3) / 1e9, 3),
        "achieved_gbytes_s": round(bytes_ / (ms * 1e-3) / 1e9, 3),
        "pct_of_measured_peak": round(100.0 * flops / (ms * 1e-3) / peak, 3),
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "pct_of_bound": round(100.0 * bound_s * 1e3 / ms, 2),
        "timed_launches": WRAPPERS[name].launches - before,
    }


def exchange_rows(dev, length, rng):
    """(b): the int8 error-feedback exchange over eight replicas of
    ``dev``, codecs against kernels, each once under ``torch.profiler``."""
    group = comm.ReplicaGroup([dev] * WORLD)
    spec = comm.CompressionSpec("int8", chunk=CHUNK)
    L = WORLD * length
    g = torch.from_numpy(rng.randn(L).astype(np.float32)).to(dev)
    out = {}
    for label, cfg in (("codec", None), ("kernels", comm.CommKernelConfig())):
        trees = [{"g": g.clone()} for _ in range(WORLD)]
        resid = [comm.init_error_feedback(L, spec, WORLD, device=dev)
                 for _ in range(WORLD)]
        comm.error_feedback_allreduce(trees, resid, spec, group=group,
                                      kernels=cfg)  # warm
        sub.synchronize(dev)
        before = launches()
        # one exchange's ops and collective ranges, outside any fit
        with torch.profiler.profile(  # mxlint: disable=MX314
                activities=[torch.profiler.ProfilerActivity.CPU],
                record_shapes=True) as prof:
            comm.error_feedback_allreduce(trees, resid, spec, group=group,
                                          kernels=cfg)
            sub.synchronize(dev)
        after = launches()
        sub.synchronize(dev)
        t0 = time.perf_counter()
        comm.error_feedback_allreduce(trees, resid, spec, group=group,
                                      kernels=cfg)
        sub.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        out[label] = {
            "full_slab_quantize_passes": comm.quantize_pass_count(
                prof, min_elements=L),
            "collective_wire_bytes": round(sum(
                r["wire_bytes"] for r in comm.collective_table(
                    prof, default_group_size=WORLD)), 1),
            "kernel_launches": {n: after[n] - before[n] for n in KERNELS
                                if after[n] != before[n]},
            "step_ms": round(step_ms, 3),
        }
    return out


def adam_rows(sh, dev, rng, iters):
    """(c): ``Adam(fused=True).apply`` against ``Adam(fused=False)`` on the
    same leaves, gradients and states: the time of each and whether every
    parameter and state leaf is bitwise equal."""
    names = ["p0", "p1", "p2"]

    def t(a):
        return torch.from_numpy(a).to(dev)

    params = {n: t(rng.randn(*s).astype(np.float32))
              for n, s in zip(names, sh["adam"])}
    grads = {n: t(rng.randn(*s).astype(np.float32))
             for n, s in zip(names, sh["adam"])}
    adam_f = opt_mod.Adam(lr=1e-3, fused=True)
    adam_u = opt_mod.Adam(lr=1e-3, fused=False)
    states = adam_f.init_state_tree(params)

    def copies():
        # the fused step writes its parameters and moments in place
        return ({n: w.clone() for n, w in params.items()},
                {n: tuple(torch.as_tensor(x).clone() for x in s)
                 for n, s in states.items()})

    p_f, s_f = copies()
    pf, sf = adam_f.apply(p_f, grads, s_f, 1e-3)
    pu, su = adam_u.apply(params, grads, states, 1e-3)
    parity = all(torch.equal(pf[n], pu[n]) for n in names) and all(
        torch.equal(torch.as_tensor(sf[n][i]), torch.as_tensor(su[n][i]))
        for n in names for i in range(3))
    p_t, s_t = copies()
    return {
        "fused_ms": round(call_ms(
            lambda: adam_f.apply(p_t, grads, s_t, 1e-3), dev, iters), 4),
        "per_leaf_ms": round(call_ms(
            lambda: adam_u.apply(params, grads, states, 1e-3), dev,
            iters), 4),
        "bitwise_parity": bool(parity),
        "param_elements": int(sum(int(np.prod(s)) for s in sh["adam"])),
    }


def catalog():
    """Every registered kernel: its CUDA source and the TPU kernel it
    replaces."""
    return [{"kernel": n, "source": registry.get_kernel(n).source,
             "replaces": registry.get_kernel(n).replaces}
            for n in registry.kernel_names()]


def run(args):
    dev = _bench.card(args.cpu, "bench_kernels")
    smoke = bool(args.smoke)
    sh = shapes(smoke)
    rng = np.random.RandomState(0)
    peak = telemetry.measured_peak_flops(device=dev)
    calls, (x, w) = operands(sh, dev, rng)
    rows = [roofline_row(n, *calls[n], dev, sh["iters"], peak)
            for n in KERNELS]
    hlo_delta = exchange_rows(dev, sh["exchange"], rng)
    passes_cut = (hlo_delta["codec"]["full_slab_quantize_passes"]
                  - hlo_delta["kernels"]["full_slab_quantize_passes"])
    adam_row = adam_rows(sh, dev, rng, sh["iters"])

    y_ref = x @ w.T
    mm_err = float(torch.linalg.norm(calls["int8_matmul"][0]() - y_ref)
                   / torch.linalg.norm(y_ref))
    on_card = torch.device(dev).type == "cuda"
    result = {
        "metric": METRIC,
        "value": passes_cut,
        "unit": "hlo_passes",
        "vs_baseline": hlo_delta["codec"]["full_slab_quantize_passes"],
        "smoke": smoke,
        "interpret_mode": not on_card,
        "measured_peak_gflops_s": round(peak / 1e9, 2),
        "kernels": rows,
        "hlo_fused_vs_unfused": hlo_delta,
        "wire_bytes_identical": (
            hlo_delta["codec"]["collective_wire_bytes"]
            == hlo_delta["kernels"]["collective_wire_bytes"]),
        "fused_adam": adam_row,
        "int8_matmul_rel_error": round(mm_err, 6),
        "catalog": catalog(),
        "device": _bench.card_identity(dev),
        "notes": (
            "Each row prices one kernel call with its registry model "
            "(kernels/registry.py: operations by unit type, every operand "
            "read once and every result written once) against "
            + ("its time on the card (single launches, L2 flushed); "
               "pct_of_bound is the H100 data sheet's bound over that time."
               if on_card else
               "the wall time of its plain version on the CPU (source "
               "plain: nothing of a kernel is timed).")
            + " The exchange rows keep the JAX bench's names: the passes "
            "are slab-sized quantize-shaped torch operations in the "
            "profiled exchange, the wire bytes its recorded collective "
            "table; both paths must move the same bytes. The int8 GEMM's "
            "error is against the f32 x @ w.T; its row times the kernel "
            "on a weight quantized per channel outside the timer."),
    }
    return sub.publish(result, "kernels", args)


def check(result):
    """The bench's gates: a row each kernel, its time measured over the
    kernel's launches on the card (the plain version's on the CPU, where
    nothing launches); the codec path's slab-sized quantize passes and, on
    the card, none on the kernel path (on the CPU the kernels' plain
    versions are torch operations the profiler counts); the same wire
    bytes on both paths; ``fused_adam`` bitwise."""
    card = sub.on_card(result)
    rows = {r["kernel"]: (r["source"], r["timed_launches"])
            for r in result["kernels"]}
    sub.require(set(rows) == set(KERNELS) and all(
        source == ("measured" if card else "plain") and (launches or not card)
        for source, launches in rows.values()),
        f"bench_kernels: a row each kernel, timed over its launches on "
        f"the card: {rows}")
    hlo = result["hlo_fused_vs_unfused"]
    sub.require(result["wire_bytes_identical"]
                and hlo["codec"]["full_slab_quantize_passes"] > 0,
                f"bench_kernels: both paths move the same bytes, the "
                f"codec's with slab-sized quantize passes: {hlo}")
    if sub.on_card(result):
        sub.require(hlo["kernels"]["full_slab_quantize_passes"] == 0,
                    f"bench_kernels: no slab-sized quantize pass on the "
                    f"kernel path: {hlo['kernels']}")
    sub.require(result["fused_adam"]["bitwise_parity"],
                "bench_kernels: fused_adam bitwise the per-leaf update")


def main(argv=None):
    return run(sub.parser(__doc__.split("\n\n")[0]).parse_args(argv))


if __name__ == "__main__":
    main()
