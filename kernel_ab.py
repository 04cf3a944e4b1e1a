#!/usr/bin/env python3
"""Time the port's redesigned kernels against an earlier build of their
sources, in turns, on one CUDA card.

    mkdir -p build/ab
    git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/ab
    python3 kernel_ab.py build/ab/mxnet_tpu_torch/csrc [stem ...]

Each named source (``int8_matmul``, ``flash_attention``, ``comm_kernels``;
by default the first two) in the given directory is built into a library of
its own with the port's nvcc flags, and its kernels run through the
current wrappers on the earlier library and on the current one in turns
(earlier, current, current, earlier), each timed as ``chip_smoke.py``
times a kernel (CUDA events, L2 flushed, median of 25), after both builds
are held to the plain version:

* int8_matmul: the int8_matmul.cu of before split-K, whose entry point
  takes no ``per`` (the slabs a block sums), at chip_smoke's
  ``KERNEL_SHAPES``; bitwise.
* flash_attention: an earlier flash_attention.cu with the current C
  interface, ``flash_bwd_dq`` at the LM's attention; chip_smoke's row
  bound.
* comm_kernels: an earlier comm_kernels.cu behind the current interface
  (``earlier_comm``: its source says which adapters it needs);
  ``quant_int8`` (with its round trip, and as stage 2's one row and its
  error) and ``dequant_int8`` at one 4 MB bucket's two-rank shape and at
  ResNet-50's padded gradient over two ranks; ``quant_twobit`` (with its
  round trip, and as the exchange's stage 1, whose error an earlier build
  without it leaves to a torch subtraction) and ``dequant_sum_twobit``
  at chip_smoke's ``TWOBIT_SHAPES`` (the bucket, the gradient with its odd
  row of code bytes, the odd-B bucket); bitwise, NaN and inf included;
  then both twobit kernels at each distinct bucket size of dp_overlap's
  plan and at the gradient, each form of the current build (forced
  through its wrapper's picker threshold) and the earlier build's kernel
  in turns, six each. The launch floor (``torch.cuda._sleep(0)``) is
  timed beside them.

Prints the card's name and power limit, then one JSON line per case with
both builds' times (the mean of each build's two turns, and every turn).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import types
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent


def build_earlier(src: Path, common) -> ctypes.CDLL:
    out = ROOT / "build" / "kernel_ab" / f"lib{src.stem}-earlier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o", str(out),
                        str(src)], capture_output=True, text=True)
    cs.require(r.returncode == 0, f"nvcc {src}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out))


def without_per(lib: ctypes.CDLL):
    """The int8 library of before split-K, behind the current interface:
    its entry point is called without ``per``."""
    fn = lib.mxtt_int8_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def mxtt_int8_matmul(*args):
        return fn(*args[:9], args[10])

    return types.SimpleNamespace(
        mxtt_int8_matmul=mxtt_int8_matmul,
        mxtt_cuda_error_string=lib.mxtt_cuda_error_string)


def earlier_comm(lib: ctypes.CDLL, ck, source: str):
    """A comm_kernels library behind the current interface; its
    ``source`` tells which entry points take another interface:

    * without ``quant_twobit_vec_kernel`` (before twobit's vector forms),
      ``mxtt_quant_twobit`` takes a grid in place of the form and writes
      no error (a call that asks for one is refused, as the current build
      refuses a bad argument), and ``mxtt_dequant_sum_twobit`` takes a grid
      in place of the load width;
    * without ``mxtt_quant_int8_chunked``, that entry point runs the
      general kernel on the grid the wrapper then gave it, and
      ``dequant_int8`` takes that grid in place of the load width.
    """
    old_twobit = "quant_twobit_vec_kernel" not in source
    old_int8 = "mxtt_quant_int8_chunked" not in source
    if not (old_twobit or old_int8):
        return lib
    import torch

    _I64, _P, _F, _I = (ctypes.c_longlong, ctypes.c_void_p, ctypes.c_float,
                        ctypes.c_int)
    argtypes = dict(ck._ARGTYPES)
    if old_twobit:
        argtypes["mxtt_quant_twobit"] = [_P, _P, _P, _I64, _F, _I, _P]
        argtypes["mxtt_dequant_sum_twobit"] = [_P, _P, _I, _I64, _F, _I, _P]
    if old_int8:
        del argtypes["mxtt_quant_int8_chunked"]
    for name, types_ in argtypes.items():
        getattr(lib, name).argtypes = types_
        getattr(lib, name).restype = ctypes.c_int
    adapted = {name: getattr(lib, name) for name in argtypes}
    adapted["mxtt_comm_error_string"] = lib.mxtt_comm_error_string

    def grid(threads):
        return ck._grid(threads, torch.cuda.current_device())

    if old_twobit:
        def mxtt_quant_twobit(x, q, dq, err, n_bytes, threshold, vector,
                              stream):
            if err:
                return 1  # cudaErrorInvalidValue: no error output
            return lib.mxtt_quant_twobit(x, q, dq, n_bytes, threshold,
                                         grid(n_bytes), stream)

        def mxtt_dequant_sum_twobit(q, out, rows, row_bytes, threshold,
                                    load_bytes, stream):
            return lib.mxtt_dequant_sum_twobit(q, out, rows, row_bytes,
                                               threshold, grid(row_bytes),
                                               stream)

        adapted.update(mxtt_quant_twobit=mxtt_quant_twobit,
                       mxtt_dequant_sum_twobit=mxtt_dequant_sum_twobit)
    if old_int8:
        def mxtt_quant_int8_chunked(x, q, scale, dq, err, err_fma, n_chunks,
                                    chunk, stream):
            return lib.mxtt_quant_int8(x, q, scale, dq, err, err_fma,
                                       n_chunks, chunk, grid(32 * n_chunks),
                                       stream)

        def mxtt_dequant_int8(q, scale, out, n, chunk, load_bytes, stream):
            return lib.mxtt_dequant_int8(q, scale, out, n, chunk, grid(n),
                                         stream)

        adapted.update(mxtt_quant_int8_chunked=mxtt_quant_int8_chunked,
                       mxtt_dequant_int8=mxtt_dequant_int8)
    return types.SimpleNamespace(**adapted)


def in_turns(torch, common, stem, libs, fn, earlier_fn=None):
    """``fn`` timed on the earlier and the current library in turns
    (``earlier_fn`` in its place on the earlier one, where given)."""
    turns = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        common._LIBS[stem] = libs[which]
        turns[which].append(cs.time_ms(
            torch, earlier_fn if which == "earlier" and earlier_fn else fn))
    common._LIBS[stem] = libs["current"]
    return {"earlier_ms": sum(turns["earlier"]) / 2,
            "current_ms": sum(turns["current"]) / 2, "turns_ms": turns}


def ab_int8_matmul(torch, np, common, libs):
    from mxnet_tpu_torch.kernels import int8_matmul as k8

    libs["earlier"] = without_per(libs["earlier"])
    rng = np.random.default_rng(cs.SEED)
    for M, K, N in cs.KERNEL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal((N, K), np.float32)).cuda()
        wq, sw = k8.quantize_channels(w)
        plain = k8.int8_matmul_plain(x, wq, sw)
        for which in ("earlier", "current"):
            common._LIBS["int8_matmul"] = libs[which]
            cs.require(torch.equal(k8.int8_matmul(x, wq, w_scale=sw), plain),
                       f"int8_matmul ({which}) {M}x{K}x{N} is bitwise plain")
        cs.emit({"kernel": "int8_matmul", "M": M, "K": K, "N": N,
                 "split": k8._k_split(M, N, K),
                 **in_turns(torch, common, "int8_matmul", libs,
                            lambda: k8.int8_matmul(x, wq, w_scale=sw))})


def ab_flash_attention(torch, np, common, libs):
    from mxnet_tpu_torch.kernels import flash_attention as tfa

    shape, dtype_name, causal, _ = cs.FLASH_CASES[0]
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, do = cs.flash_operands(torch, shape, dtype, gen)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    delta = tfa.attention_delta(o, do)
    pdq = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)[0]
    worst = {}
    for which in ("earlier", "current"):
        common._LIBS["flash_attention"] = libs[which]
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        share, _ = cs.row_errors(torch, dq, pdq, cs.flash_row_bound(torch,
                                                                    dtype))
        worst[which] = float(share.max())
        cs.require(worst[which] <= 1.0, f"flash_bwd_dq ({which}) within its "
                   f"row bound: {worst[which]}")
    cs.emit({"kernel": "flash_bwd_dq", "shape": list(shape),
             "dtype": dtype_name, "causal": causal,
             "share_of_row_bound": worst,
             **in_turns(torch, common, "flash_attention", libs,
                        lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 causal))})


def ab_comm_kernels(torch, np, common, libs):
    from mxnet_tpu_torch import comm
    from mxnet_tpu_torch.kernels import comm_kernels as ck

    libs["earlier"] = earlier_comm(libs["earlier"], ck, libs["source"])
    cs.emit({"kernel": "launch floor", "ms": cs.time_ms(
        torch, lambda: torch.cuda._sleep(0))})
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 14)
    chunk = cs.COMM_CHUNK
    full = cs.comm_padded(comm, "int8", 2) // 2
    for label, length in (("4 MB bucket", cs.BUCKET_ELEMS // 2),
                          ("ResNet-50 gradient", full)):
        x = cs.comm_rows(torch, gen, (2, length), chunk, specials=True)
        row = x[:1]
        q, scale, _, _ = ck.quant_int8_plain(x, chunk, False)
        cases = {
            "quant_int8": (lambda: ck.quant_int8(x, chunk, True),
                           ck.quant_int8_plain(x, chunk, True), x),
            "quant_int8 stage 2": (
                lambda: ck.quant_int8(row, chunk, err="sub"),
                ck.quant_int8_plain(row, chunk, False, "sub"), row),
            "dequant_int8": (lambda: (ck.dequant_int8(q, scale, chunk),),
                             (ck.dequant_int8_plain(q, scale, chunk),), q),
        }
        for name, (fn, plain, operand) in cases.items():
            for which in ("earlier", "current"):
                common._LIBS["comm_kernels"] = libs[which]
                got = fn()
                torch.cuda.synchronize()
                cs.require(all(cs.bits_equal(torch, a, b)
                               for a, b in zip(got, plain) if a is not None),
                           f"{name} ({which}) {label} is bitwise plain")
            cs.emit({"kernel": name, "shape": list(operand.shape),
                     "at": label, "chunk": chunk,
                     "form": ck.quant_int8_form(operand, chunk)
                     if operand.dtype == torch.float32
                     else ck.dequant_int8_load_bytes(operand),
                     **in_turns(torch, common, "comm_kernels", libs, fn)})
        del x, row, q, scale, cases
    ab_twobit(torch, common, libs, ck, comm, gen)


def ab_twobit(torch, common, libs, ck, comm, gen):
    """quant_twobit (with dq; and as the exchange's stage 1, whose error
    the earlier build leaves to a torch subtraction) and
    dequant_sum_twobit at TWOBIT_SHAPES, both builds bitwise plain first."""
    t = comm.CompressionSpec("twobit").threshold

    def stage1_earlier(x):
        q, dq, _ = ck.quant_twobit(x, t, True)
        return q, None, x - dq

    for label, shape in cs.TWOBIT_SHAPES.items():
        x = cs.comm_rows(torch, gen, shape, cs.COMM_CHUNK, specials=True)
        q, dq, err = ck.quant_twobit_plain(x, t, True, True)
        cases = {
            "quant_twobit": (lambda: ck.quant_twobit(x, t, True), None,
                             (q, dq, None), x),
            "quant_twobit stage 1": (
                lambda: ck.quant_twobit(x, t, want_err=True),
                lambda: stage1_earlier(x), (q, None, err), x),
            "dequant_sum_twobit": (
                lambda: (ck.dequant_sum_twobit(q, t),), None,
                (ck.dequant_sum_twobit_plain(q, t),), q),
        }
        for name, (fn, earlier_fn, plain, operand) in cases.items():
            for which in ("earlier", "current"):
                common._LIBS["comm_kernels"] = libs[which]
                got = (earlier_fn if which == "earlier" and earlier_fn
                       else fn)()
                torch.cuda.synchronize()
                cs.require(all(cs.bits_equal(torch, a, b)
                               for a, b in zip(got, plain) if a is not None),
                           f"{name} ({which}) {label} is bitwise plain")
            cs.emit({"kernel": name, "shape": list(operand.shape),
                     "at": label,
                     **({"kernel_form": ck.quant_twobit_form(operand)}
                        if operand.dtype == torch.float32 else
                        cs.kernel_form(ck, "dequant_sum_twobit", operand)),
                     "earlier_stage1": "quant_twobit with dq, then x - dq"
                     if earlier_fn else None,
                     **in_turns(torch, common, "comm_kernels", libs, fn,
                                earlier_fn)})
        del x, q, dq, err, cases
    ab_twobit_sweep(torch, common, libs, ck, comm, gen, t)


def rotation(torch, common, libs, variants, rounds=3):
    """Each of ``variants`` (``{label: (library, {picker threshold of
    comm_kernels: value}, fn)}``) timed in turns, in their order and then
    reversed, ``rounds`` times: the median, least and most of its turns."""
    from mxnet_tpu_torch.kernels import comm_kernels as ck

    order = list(variants) + list(variants)[::-1]
    turns = {label: [] for label in variants}
    for label in order * rounds:
        which, thresholds, fn = variants[label]
        common._LIBS["comm_kernels"] = libs[which]
        kept = {k: getattr(ck, k) for k in thresholds}
        for k, v in thresholds.items():
            setattr(ck, k, v)
        try:
            turns[label].append(cs.time_ms(torch, fn))
        finally:
            for k, v in kept.items():
                setattr(ck, k, v)
    common._LIBS["comm_kernels"] = libs["current"]
    return {label: {"median_ms": statistics.median(ts), "min_ms": min(ts),
                    "max_ms": max(ts), "turns_ms": ts}
            for label, ts in turns.items()}


def ab_twobit_sweep(torch, common, libs, ck, comm, gen, t):
    """Each distinct bucket size of dp_overlap's twobit plan, and
    ResNet-50's gradient over two ranks: quant_twobit as the exchange's
    stage 1 (with its error; the earlier build with dq, then ``x - dq``)
    in each form, and dequant_sum_twobit in each load width, beside the
    earlier build's kernel, in turns (``rotation``). A form is forced by
    setting its wrapper's picker threshold (``QUANT_TWOBIT_VECTOR_MIN``,
    ``DQSUM_TWOBIT_FOUR_MIN``) to 0 or past the size."""
    from mxnet_tpu_torch.models import resnet50

    plan = comm.plan_overlap(cs.resnet50_leaf_shapes(), "twobit", cs.DP_WORLD,
                             max_bytes=cs.DP_OVERLAP_BUCKET_BYTES,
                             symbol=resnet50(num_classes=1000))
    sizes = sorted({b["padded"] for b in plan.buckets})
    sizes.append(2 * cs.TWOBIT_SHAPES["ResNet-50 gradient"][1])
    never = 1 << 62
    for n in sizes:
        x = cs.comm_rows(torch, gen, (cs.DP_WORLD, n // cs.DP_WORLD),
                         cs.COMM_CHUNK)
        q = ck.quant_twobit_plain(x, t, False)[0]

        def stage1_earlier():
            q_, dq, _ = ck.quant_twobit(x, t, True)
            return q_, x - dq

        def stage1():
            return ck.quant_twobit(x, t, want_err=True)

        def dqsum():
            return ck.dequant_sum_twobit(q, t)

        cs.emit({
            "kernel": "twobit sweep", "elems": n, "B": q.shape[1],
            "picked": {"quant_twobit": ck.quant_twobit_form(x),
                       "dequant_sum_twobit_load_bytes":
                           ck.dequant_sum_twobit_load_bytes(q)},
            "quant_twobit stage 1": rotation(torch, common, libs, {
                "earlier": ("earlier", {}, stage1_earlier),
                "vector": ("current", {"QUANT_TWOBIT_VECTOR_MIN": 0}, stage1),
                "scalar": ("current", {"QUANT_TWOBIT_VECTOR_MIN": never},
                           stage1)}),
            "dequant_sum_twobit": rotation(torch, common, libs, {
                "earlier": ("earlier", {}, dqsum),
                "one byte": ("current", {"DQSUM_TWOBIT_FOUR_MIN": never},
                             dqsum),
                "four bytes": ("current", {"DQSUM_TWOBIT_FOUR_MIN": 0},
                               dqsum)})})
        del x, q


AB = {"int8_matmul": ab_int8_matmul, "flash_attention": ab_flash_attention,
      "comm_kernels": ab_comm_kernels}


def main(argv) -> int:
    import numpy as np
    import torch

    stems = argv[1:] or ["int8_matmul", "flash_attention"]
    if not argv or any(s not in AB for s in stems) or \
            not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from mxnet_tpu_torch.kernels import _common as common

    earlier_dir = Path(argv[0])
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    for stem in stems:
        libs = {"current": common.load_library(stem),
                "earlier": build_earlier(earlier_dir / f"{stem}.cu", common),
                "source": (earlier_dir / f"{stem}.cu").read_text()}
        AB[stem](torch, np, common, libs)
        common._LIBS[stem] = libs["current"]
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
