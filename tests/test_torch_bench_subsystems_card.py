"""The subsystem benches on the card (``-m cuda``; skipped without a card):
``bench_kernels`` at full size, its rows against ``chip_smoke.py``'s
kernel timer on the same operands, its exchange on the kernel path with no
slab-sized quantize pass, ``fused_adam`` bitwise the per-leaf update;
``bench_mem``'s captured step recording a memory plan; and
``bench_compile``'s cold child paying a kernel build that its warm child
does not.

Run on the card with
``python3 -m pytest tests/test_torch_bench_subsystems_card.py -m cuda -q``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.tools import (bench_compile, bench_kernels,  # noqa: E402
                                   bench_mem)

pytestmark = pytest.mark.cuda

# a row's time against the kernel timer's on the same operands: both are
# medians of single launches with the L2 cache flushed before each, so
# they differ by the medians' spread and, for launches of a few
# microseconds, by the launch floor
ROW_REL, ROW_ABS_MS = 0.25, 0.01


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    mt.set_matmul_precision("highest")


def _run(module, tmp_path, *argv):
    out = tmp_path / f"{module.__name__.rsplit('.', 1)[1]}.json"
    module.main([*argv, "--out", str(out)])
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def kernels_json(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    mt.set_matmul_precision("highest")
    return _run(bench_kernels, tmp_path_factory.mktemp("kernels"))


def test_kernel_rows_are_the_kernel_timers(kernels_json):
    """Each of the eleven rows against ``chip_smoke.time_ms`` of the same
    wrapper on the same operands (the timer of phase ``kernels``)."""
    calls, _ = bench_kernels.operands(bench_kernels.shapes(False),
                                      torch.device("cuda", 0),
                                      np.random.RandomState(0))
    rows = {r["kernel"]: r for r in kernels_json["kernels"]}
    assert set(rows) == set(bench_kernels.KERNELS)
    for name in bench_kernels.KERNELS:
        want = cs.time_ms(torch, calls[name][0], reps=20)
        got = rows[name]["ms"]
        assert abs(got - want) <= ROW_REL * max(got, want) + ROW_ABS_MS, \
            (name, got, want)
        assert rows[name]["source"] == "measured"
        assert rows[name]["timed_launches"] > 0
        assert rows[name]["ms"] >= rows[name]["bound_ms"], rows[name]


def test_kernel_path_exchange_and_fused_adam(kernels_json):
    """The bench's gates on the card: no slab-sized quantize pass on the
    kernel path, the codec path's bytes, fused_adam bitwise."""
    bench_kernels.check(kernels_json)
    hlo = kernels_json["hlo_fused_vs_unfused"]
    assert set(hlo["kernels"]["kernel_launches"]) >= {
        "quant_int8", "dequant_sum_int8", "dequant_int8"}
    assert kernels_json["device"] == cs.nvidia_smi("name,power.limit")


def test_mem_records_a_plan_on_the_card(tmp_path):
    got = _run(bench_mem, tmp_path)
    bench_mem.check(got)  # this bench's capture recorded a plan
    assert got["device"] == cs.nvidia_smi("name,power.limit")


def test_compile_cold_child_builds_warm_child_loads(tmp_path):
    got = _run(bench_compile, tmp_path)
    bench_compile.check(got)
    assert [b["source"] for b in got["cold_kernel_builds"]] == \
        ["fused_adam.cu"], got["cold_kernel_builds"]
    assert got["warm_kernel_builds"] == [], got["warm_kernel_builds"]
    assert got["warm_persistent_cache_hits"] >= 1
    assert got["detail"]["aot"]["kernel_builds"]
    assert not got["detail"]["aot_warm"]["kernel_builds"]
    assert got["aot_precompile_s"] > 0
    assert got["detail"]["aot"]["captures"] >= 1
