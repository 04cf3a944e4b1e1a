"""The port's measurement tools on the card (``-m cuda``; skipped without a
card): each tool's ``main`` once at a small size, its JSON naming the card
as ``nvidia-smi`` does, and the flash kernels' launches what bench_flash's
schedule derives; and the one side stream a thread's captured programs
share.

Run on the card with
``python3 -m pytest tests/test_torch_bench_tools_card.py -m cuda -q``.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.tools import (bench_flash, bench_io_scaling,  # noqa: E402
                                   bench_longctx, bench_mnist, bench_roofline,
                                   scaling_projection)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    mt.set_matmul_precision("highest")


@pytest.fixture
def smi(_card):
    return cs.nvidia_smi("name,power.limit")


def _run(module, tmp_path, *argv):
    out = tmp_path / f"{module.__name__.rsplit('.', 1)[1]}.json"
    module.main([*argv, "--out", str(out)])
    return json.loads(out.read_text())


def test_bench_flash_quick(tmp_path, smi):
    cs.reset_launches()
    got = _run(bench_flash, tmp_path, "--quick", "--iters", "2")
    launches = cs.read_launches()
    (rec,) = got["records"]
    assert got["card"] == rec["card"] == smi and "error" not in rec
    peak = got["measured_bf16_matmul_peak_tflops"]
    assert 0 < rec["fwd_tflops"] <= peak and 0 < rec["fwdbwd_tflops"] <= peak
    for name in bench_flash.FLASH_NAMES:
        assert launches[name] == rec["launches"][name] == 7, name
        assert rec["kernels"][name]["ms"] >= rec["kernels"][name]["bound_ms"]


def test_bench_longctx_one_seq(tmp_path, smi):
    got = _run(bench_longctx, tmp_path, "--seqs", "2048", "--iters", "2")
    assert got["card"] == smi
    assert [(r["seq"], r["remat"]) for r in got["records"]] == \
        [(2048, False), (2048, True)]
    assert all(r["step_ms"] > 0 and r["peak_bytes"] > 0
               for r in got["records"])


def test_bench_mnist(tmp_path, smi):
    got = _run(bench_mnist, tmp_path, "--batch", "64", "--iters", "5")
    assert got["card"] == smi
    assert [r["model"] for r in got["records"]] == ["mlp", "lenet"]
    assert all(r["images_per_sec"] > 0 for r in got["records"])


def test_bench_roofline_then_projection(tmp_path, smi):
    roof = _run(bench_roofline, tmp_path, "--batch-size", "16", "--iters",
                "2")
    assert roof["card"] == smi
    assert roof["measured_step_ms"] >= roof["memory_floor_ideal_fusion_ms"]
    assert 0 < roof["step_tflops"] <= roof["measured_matmul_peak_tflops"]
    got = _run(scaling_projection, tmp_path, "--roofline",
               str(tmp_path / "bench_roofline.json"))
    assert got["card"] == smi
    assert got["assumptions"]["step_ms_measured_1card"] == \
        roof["measured_step_ms"]
    assert got["profiled_allreduce"]["payload_bytes"] == \
        got["param_bytes_f32"]


def test_bench_io_scaling_two_threads(tmp_path, smi):
    got = _run(bench_io_scaling, tmp_path, "--threads", "1,2", "--rec",
               str(tmp_path / "shard.rec"))
    assert got["card"] == smi and got["records_in_shard"] == 1024
    assert [r["threads"] for r in got["records"]] == [1, 2, 1, 1]
    assert all(r["img_per_sec"] > 0 for r in got["records"])


def test_programs_share_one_side_stream():
    """Every captured program of a thread warms up and captures on one side
    stream a device (each stream costs a cuBLAS workspace for the process's
    life, which pins a block of that stream's cache); another thread gets
    a stream of its own, and both programs still replay what they
    computed eager."""
    import threading

    from mxnet_tpu_torch.utils.compile import CapturedProgram

    a = torch.randn(64, 64, device="cuda")
    progs = [CapturedProgram(lambda: a @ a, "cuda", "side_a"),
             CapturedProgram(lambda: a @ a.t(), "cuda", "side_b")]
    other = []
    thread = threading.Thread(target=lambda: other.append(
        CapturedProgram(lambda: a + 1, "cuda", "side_c")))
    thread.start()
    thread.join()
    assert progs[0]._side is progs[1]._side
    assert other[0]._side is not progs[0]._side
    for prog, want in zip(progs, (a @ a, a @ a.t())):
        eager = prog().clone()
        assert torch.equal(prog(), eager) and torch.equal(prog(), eager)
        torch.testing.assert_close(eager, want, rtol=1e-5, atol=1e-5)
