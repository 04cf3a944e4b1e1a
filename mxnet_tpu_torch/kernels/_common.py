"""What every kernel module of the port shares: the route between a kernel and
its plain version, and the build of the CUDA sources.

Each wrapper counts its launches with :func:`count_launch`: one added to
its ``launches`` where it launches its kernel. Under a CUDA-graph capture
(:func:`capture_launches`, which ``utils.compile.CapturedProgram`` opens) a
launch executes nothing, so it goes into the capture's record instead, and
the program adds the record to the counters at every replay.

The route is chosen by the tensors' device and nothing else. CPU tensors take
the plain PyTorch version; CUDA tensors launch the kernel, or the call raises.
No environment variable sends a CUDA tensor to the plain version, unlike the
JAX package's interpret override (``mxnet_tpu/ops/pallas/_common.py``).

Sources live in ``mxnet_tpu_torch/csrc``. Each ``.cu`` file has a plain C
interface and is compiled by ``nvcc`` at first use into a shared library
under ``build/mxnet_tpu_torch/`` at the repository root, named by a hash of
the source and flags, and loaded with ``ctypes``. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import contextlib
import subprocess
import threading
from pathlib import Path

import torch

from ..base import MXNetError

__all__ = ["use_kernel", "load_library", "NVCC_FLAGS", "count_launch",
           "capture_launches", "priced", "flop_counters"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mxnet_tpu_torch"

# sm_90a for Hopper; no fast-math, so divides and float conversions are the
# IEEE-rounded ones the plain versions compute
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_STEM_LOCKS: dict[str, threading.Lock] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def use_kernel(*tensors) -> bool:
    """True when the tensors lie on one CUDA device (launch the kernel),
    False when they all lie on the CPU (take the plain version). Anything
    else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


# the launch record of the capture open in this process: autograd runs a
# captured backward's kernels on a thread of its own, so the record is the
# process's, not the capturing thread's (one capture at a time)
_CAPTURE = {"counts": None}
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def capture_launches():
    """The launch record of a capture: ``{wrapper: n}``, every launch made
    while the capture is open, from whichever thread."""
    prev = _CAPTURE["counts"]
    counts = _CAPTURE["counts"] = {}
    try:
        yield counts
    finally:
        _CAPTURE["counts"] = prev


# the FLOP counters entered in this process (telemetry.mfu.FlopCounter):
# a kernel wrapper's call is priced from its cost model, and the torch
# operations of its plain version are not counted
flop_counters: list = []


@contextlib.contextmanager
def priced(name, ins, outs, **static):
    """A call of the hand-written kernel ``name`` (either route), one unit
    for the FLOP counter entered, if any: priced from the kernel
    registry's cost model of ``(ins, outs, **static)``."""
    if not flop_counters:
        yield
        return
    counter = flop_counters[-1]
    counter.kernel(name, ins, outs, **static)
    counter._kernel_depth += 1
    try:
        yield
    finally:
        counter._kernel_depth -= 1


def count_launch(wrapper, n=1):
    """Count ``n`` launches of ``wrapper``'s kernel: on its counter when
    they run now, in the open capture's record when the current stream is
    capturing (a replay adds them)."""
    if torch.cuda.is_current_stream_capturing():
        with _CAPTURE_LOCK:
            counts = _CAPTURE["counts"]
            if counts is not None:
                counts[wrapper] = counts.get(wrapper, 0) + n
        return
    wrapper.launches += n


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise MXNetError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                         "are built from source at first use")
    return found


def _library_path(stem: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{stem}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{stem}-{digest}.so"


def _build(stem: str) -> Path:
    """The shared library of ``csrc/<stem>.cu``, compiled if not built yet;
    raises with the compiler's output if ``nvcc`` fails."""
    src, out = _library_path(stem)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise MXNetError(f"nvcc failed for {stem}.cu (exit "
                             f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or none
    return out


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, built if needed.
    Different sources build concurrently when called from several
    threads; one source is built once."""
    with _LOCK:
        stem_lock = _STEM_LOCKS.setdefault(stem, threading.Lock())
    with stem_lock:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = _LIBS[stem] = ctypes.CDLL(str(_build(stem)))
        return lib
