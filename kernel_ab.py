#!/usr/bin/env python3
"""Time the port's redesigned kernels against an earlier build of their
sources, in turns, on one CUDA card.

    mkdir -p build/ab
    git archive <commit> mxnet_tpu_torch/csrc | tar -x -C build/ab
    python3 kernel_ab.py build/ab/mxnet_tpu_torch/csrc

Each of ``int8_matmul.cu`` and ``flash_attention.cu`` in the given directory
is built into a library of its own with the port's nvcc flags: an earlier
flash_attention.cu with the current C interface, and the int8_matmul.cu of
before split-K, whose entry point takes no ``per`` (the slabs a block
sums). Then ``int8_matmul`` at chip_smoke's ``KERNEL_SHAPES`` and
``flash_bwd_dq`` at the LM's attention run through their wrappers on the
earlier library and on the current one in turns (earlier, current,
current, earlier), each timed as ``chip_smoke.py`` times a kernel (CUDA
events, L2 flushed, median of 25). Both builds are held to
the plain version first: bitwise for int8_matmul, chip_smoke's row bound
for dq. Prints the card's name and power limit, then one JSON line per
case with both builds' times (the mean of each build's two turns, and
every turn).
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


def in_turns(torch, common, stem, libs, fn):
    """``fn`` timed on the earlier and the current library in turns."""
    turns = {"earlier": [], "current": []}
    for which in ("earlier", "current", "current", "earlier"):
        common._LIBS[stem] = libs[which]
        turns[which].append(cs.time_ms(torch, fn))
    common._LIBS[stem] = libs["current"]
    return {"earlier_ms": sum(turns["earlier"]) / 2,
            "current_ms": sum(turns["current"]) / 2, "turns_ms": turns}


def main(argv) -> int:
    import numpy as np
    import torch

    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from mxnet_tpu_torch.kernels import _common as common
    from mxnet_tpu_torch.kernels import flash_attention as tfa
    from mxnet_tpu_torch.kernels import int8_matmul as k8

    earlier_dir = Path(argv[0])
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    libs = {stem: {"current": common.load_library(stem),
                   "earlier": build_earlier(earlier_dir / f"{stem}.cu",
                                            common)}
            for stem in ("int8_matmul", "flash_attention")}
    int8_libs = libs["int8_matmul"]
    int8_libs["earlier"] = without_per(int8_libs["earlier"])

    rng = np.random.default_rng(cs.SEED)
    for M, K, N in cs.KERNEL_SHAPES:
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal((N, K), np.float32)).cuda()
        wq, sw = k8.quantize_channels(w)
        plain = k8.int8_matmul_plain(x, wq, sw)
        for which in ("earlier", "current"):
            common._LIBS["int8_matmul"] = libs["int8_matmul"][which]
            cs.require(torch.equal(k8.int8_matmul(x, wq, w_scale=sw), plain),
                       f"int8_matmul ({which}) {M}x{K}x{N} is bitwise plain")
        cs.emit({"kernel": "int8_matmul", "M": M, "K": K, "N": N,
                 "split": k8._k_split(M, N, K),
                 **in_turns(torch, common, "int8_matmul", libs["int8_matmul"],
                            lambda: k8.int8_matmul(x, wq, w_scale=sw))})

    shape, dtype_name, causal, _ = cs.FLASH_CASES[0]
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q, k, v, do = cs.flash_operands(torch, shape, dtype, gen)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    delta = tfa.attention_delta(o, do)
    pdq = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)[0]
    worst = {}
    for which in ("earlier", "current"):
        common._LIBS["flash_attention"] = libs["flash_attention"][which]
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        share, _ = cs.row_errors(torch, dq, pdq, cs.flash_row_bound(torch,
                                                                    dtype))
        worst[which] = float(share.max())
        cs.require(worst[which] <= 1.0, f"flash_bwd_dq ({which}) within its "
                   f"row bound: {worst[which]}")
    cs.emit({"kernel": "flash_bwd_dq", "shape": list(shape),
             "dtype": dtype_name, "causal": causal,
             "share_of_row_bound": worst,
             **in_turns(torch, common, "flash_attention",
                        libs["flash_attention"],
                        lambda: tfa.flash_bwd_dq(q, k, v, do, lse, delta,
                                                 causal))})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
