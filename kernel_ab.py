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
* comm_kernels: a comm_kernels.cu from before ``quant_int8``'s chunked
  form and ``dequant_int8``'s redesign, behind the current interface (the
  chunked entry point runs the earlier general kernel on the grid its
  wrapper gave it; ``dequant_int8`` gets that grid in place of the load
  width); ``quant_int8`` (with its round trip, and as stage 2's one row
  and its error) and ``dequant_int8`` at one 4 MB bucket's two-rank shape
  and at ResNet-50's padded gradient over two ranks; bitwise, NaN and inf
  chunks included. The launch floor (``torch.cuda._sleep(0)``) is timed
  beside them.

Prints the card's name and power limit, then one JSON line per case with
both builds' times (the mean of each build's two turns, and every turn).
"""

from __future__ import annotations

import ctypes
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


def earlier_comm(lib: ctypes.CDLL, ck):
    """A comm_kernels library behind the current interface. One without
    ``mxtt_quant_int8_chunked`` is from before it: that entry point then
    runs the general kernel on the grid the wrapper then gave it, and
    ``dequant_int8`` takes that grid in place of the load width."""
    try:
        lib.mxtt_quant_int8_chunked
        return lib
    except AttributeError:
        pass
    names = dict(ck._ARGTYPES)
    for name, argtypes in names.items():
        if name != "mxtt_quant_int8_chunked":
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    import torch

    def grid(threads):
        return ck._grid(threads, torch.cuda.current_device())

    def mxtt_quant_int8_chunked(x, q, scale, dq, err, err_fma, n_chunks,
                                chunk, stream):
        return lib.mxtt_quant_int8(x, q, scale, dq, err, err_fma, n_chunks,
                                   chunk, grid(32 * n_chunks), stream)

    def mxtt_dequant_int8(q, scale, out, n, chunk, load_bytes, stream):
        return lib.mxtt_dequant_int8(q, scale, out, n, chunk, grid(n),
                                     stream)

    adapted = {name: getattr(lib, name) for name in names
               if name != "mxtt_quant_int8_chunked"}
    adapted.update(mxtt_quant_int8_chunked=mxtt_quant_int8_chunked,
                   mxtt_dequant_int8=mxtt_dequant_int8,
                   mxtt_comm_error_string=lib.mxtt_comm_error_string)
    return types.SimpleNamespace(**adapted)


def in_turns(torch, common, stem, libs, fn):
    """``fn`` timed on the earlier and the current library in turns."""
    turns = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        common._LIBS[stem] = libs[which]
        turns[which].append(cs.time_ms(torch, fn))
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

    libs["earlier"] = earlier_comm(libs["earlier"], ck)
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
                "earlier": build_earlier(earlier_dir / f"{stem}.cu", common)}
        AB[stem](torch, np, common, libs)
        common._LIBS[stem] = libs["current"]
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
