"""The flash-attention kernels' rates on the card: the port's counterpart
of ``tools/bench_flash.py``.

Measures the forward and forward+backward rates of
``kernels.flash_attention`` at long sequences, and each of its three
kernels (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``,
``csrc/flash_attention.cu``) on its own, in bf16 (the tensor-core
kernels) and in f32 (the SIMT forms), against the card's measured bf16
GEMM rate. The JAX tool sweeps its Pallas kernel's ``(block_q,
block_k)``; the port's key tile is fixed at 64 (``KERNEL_BLOCK``, ROADMAP
C.2 "Flash attention's tiles"), so each record names that tile and the
sweep runs over head_dim 64 and 128, non-causal and causal, bf16 and f32,
at the JAX sweep's batch x heads 4 and sequence 16,384, plus the
transformer LM's own attention (8 x 8 heads x 2,048 x 64, causal), whose
``flash_fwd`` time compares with ``PERF.md`` §6's row 9. q, k and v are
views of one packed ``(b, s, 3, h, d)`` tensor, as the LM hands them.

FLOP accounting, the JAX tool's (non-causal): fwd = 4*B*H*Sq*Sk*D (QK^T
and PV at 2 FLOP a MAC); fwd+bwd = 14x the same MACs (the backward's 10:
dV, dP, dS->dQ, dS->dK and the recomputed QK^T). Causal halves both. A
kernel's own row adds its bound from ``kernels/registry.py`` (the exact
causal entries, each product at 2 FLOP a MAC).

Times: each kernel and the forward from single launches between CUDA
events, the L2 cache flushed before each (median of ``--iters``); the
forward+backward (``flash_attention`` and autograd's backward, which adds
``attention_delta`` and the packed gradient's copies) from replays of
that step captured into a CUDA graph. Each record counts the launches its
schedule makes (``launches``), which the run's counters equal.

    python -m mxnet_tpu_torch.tools.bench_flash [--out FLASH_torch.json]

An OOM or a kernel error is recorded for its configuration, as the JAX
tool records it, and the sweep goes on. Writes ``--out`` (never the JAX
tool's ``FLASH_r*.json``) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..base import MXNetError
from ..utils.compile import CapturedProgram
from . import _bench

FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
LM_SHAPE = (8, 8, 2048, 64)      # the transformer LM's attention, causal
FLOP_ACCOUNTING = ("fwd=4*B*H*Sq*Sk*D, fwd+bwd=14x same MACs; causal x0.5 "
                   "(the JAX tool's)")


def sweep(quick=False):
    """The configurations, ``(batch, heads, seq, head_dim, dtype,
    causal)``: the JAX sweep's B*H = 4 at 16,384 over head_dim, causal and
    dtype, then the LM's shape; ``quick``: the JAX tool's one."""
    if quick:
        return [(1, 4, 16384, 64, torch.bfloat16, False)]
    combos = [(1, 4, 16384, d, dtype, causal)
              for d in (64, 128) for causal in (False, True)
              for dtype in (torch.bfloat16, torch.float32)]
    return combos + [(*LM_SHAPE, torch.bfloat16, True)]


def flops(batch, heads, seq, d, causal):
    """``(forward, forward + backward)`` FLOPs under the JAX tool's
    accounting."""
    mac = batch * heads * seq * seq * d * (0.5 if causal else 1.0)
    return 4 * mac, 14 * mac


def derived_launches(iters):
    """Each kernel's launches in one configuration's schedule: a first
    call, ``iters`` timed ones, and the captured step's eager warm-up, its
    warm replay and ``iters`` timed replays (the capture itself counts
    nothing: its replays do)."""
    return {name: 1 + iters + 2 + iters for name in FLASH_NAMES}


def _operands(shape, dtype, device, seed=0):
    b, h, s, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=device)
    do = torch.randn((b, h, s, d), generator=gen, device=device)
    return qkv.to(dtype), do.to(dtype)


def _views(qkv):
    return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))


def bench_config(batch, heads, seq, d, dtype, causal, iters, device):
    """One configuration's record: each kernel's ms and TF/s against its
    registry bound, the forward's and the captured forward+backward's
    TF/s, and the launches its schedule made."""
    from ..kernels import flash_attention as tfa
    from ..kernels import registry

    qkv, do = _operands((batch, heads, seq, d), dtype, device)
    q, k, v = _views(qkv)
    rec = {"batch": batch, "heads": heads, "bh": batch * heads, "seq": seq,
           "d": d, "key_tile": tfa.KERNEL_BLOCK,
           "dtype": str(dtype).replace("torch.", ""), "causal": causal}
    o, lse = tfa.flash_fwd(q, k, v, causal)
    delta = tfa.attention_delta(o, do)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    calls = {
        "flash_fwd": (lambda: tfa.flash_fwd(q, k, v, causal),
                      [q, k, v], [o, lse]),
        "flash_bwd_dq": (lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                  causal),
                         [q, k, v, do, lse, delta], [dq]),
        "flash_bwd_dkv": (lambda: tfa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                    causal),
                          [q, k, v, do, lse, delta], [dk, dv]),
    }
    kernels = {}
    for name, (fn, ins, outs) in calls.items():
        ms = _bench.kernel_ms(fn, iters)
        cost = registry.get_kernel(name).cost(ins, outs, causal=causal)
        bound_s, bound_by = cost.bound()
        kernels[name] = {"ms": ms, "tflops": cost.flops / ms / 1e9,
                         "bound_ms": bound_s * 1e3, "bound_by": bound_by,
                         "share_of_bound": bound_s * 1e3 / ms}
    del o, lse, delta, dq, dk, dv

    leaf = qkv.detach().requires_grad_(True)

    def fwd_bwd():
        out = tfa.flash_attention(*_views(leaf), causal=causal)
        return torch.autograd.grad(out, leaf, do)[0]

    step = CapturedProgram(fwd_bwd, device, "bench_flash")
    step()
    step()
    t_fb = _bench.replay_ms(step, iters, samples=1)
    fl_f, fl_fb = flops(batch, heads, seq, d, causal)
    t_f = kernels["flash_fwd"]["ms"]
    rec.update({
        "fwd_ms": t_f, "fwd_tflops": fl_f / t_f / 1e9,
        "fwdbwd_ms": t_fb, "fwdbwd_tflops": fl_fb / t_fb / 1e9,
        "kernels": kernels, "launches": derived_launches(iters)})
    return rec


def _error_record(combo, exc):
    batch, heads, seq, d, dtype, causal = combo
    return {"batch": batch, "heads": heads, "bh": batch * heads, "seq": seq,
            "d": d, "dtype": str(dtype).replace("torch.", ""),
            "causal": causal,
            "oom": isinstance(exc, torch.cuda.OutOfMemoryError),
            "error": repr(exc)[:200]}


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="FLASH_torch.json")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls of each kernel and replays of the "
                         "forward+backward step")
    ap.add_argument("--quick", action="store_true",
                    help="single config smoke run")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    device = _bench.card(what="bench_flash")
    ident = _bench.card_identity(device)
    peak = _bench.measured_matmul_peak_tflops(device)
    print(f"card={ident} measured bf16 matmul peak: {peak:.1f} TF/s",
          flush=True)
    records = []
    for combo in sweep(args.quick):
        try:
            rec = bench_config(*combo, iters=args.iters, device=device)
        except (RuntimeError, MXNetError, ValueError) as e:
            # an OOM is a RuntimeError: record it and go on with the sweep
            rec = _error_record(combo, e)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        rec["pct_of_matmul_peak_fwd"] = (
            100 * rec["fwd_tflops"] / peak if "fwd_tflops" in rec else None)
        rec["card"] = ident
        records.append(rec)
        print(json.dumps(rec), flush=True)
    out = {"card": ident,
           "measured_bf16_matmul_peak_tflops": peak,
           "flop_accounting": FLOP_ACCOUNTING,
           "timing": "each kernel and the forward: single launches, L2 "
                     "flushed, CUDA events, median of --iters; "
                     "forward+backward: --iters replays of the captured "
                     "step between CUDA events",
           "iters": args.iters, "records": records}
    _bench.write_json(args.out, out)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
