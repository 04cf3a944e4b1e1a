"""The source lint's witnesses on the card (``-m cuda``; skipped without a
card): what the port's lint flags misbehaves on an H100, and its clean copy
does not. The fixtures are ``chip_smoke.py``'s (phase ``mxlint``):

- MX306: 20 replays of fused_adam captured at ResNet-50's 161 leaves,
  timed with the clock read after the loop. The flagged copy reads the
  launches' enqueue, at most half what the copy that synchronizes first
  reads, and that one covers the 20 launches (PERF.md's row time x
  MXLINT_FLOOR each).
- MX202: a step that calls ``.item()``, given to
  ``utils.compile.CapturedProgram``: its capture raises; the copy that
  returns the tensor captures and replays the right sum.

Run on the card with
``python3 -m pytest tests/test_torch_mxlint_card.py -m cuda -q``.
"""

import os
import statistics
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

from mxnet_tpu_torch import optimizer as topt  # noqa: E402
from mxnet_tpu_torch.analysis import lint_source  # noqa: E402
from mxnet_tpu_torch.kernels import fused_adam as kfa  # noqa: E402
from mxnet_tpu_torch.utils import compile as compile_mod  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def test_mx306_flagged_delta_reads_the_enqueue(cuda_device):
    flagged, clean, _, _ = chip_smoke.mxlint_fixtures()
    assert [f.rule.id for f in lint_source(flagged, "fx.py")] == ["MX306"]
    assert lint_source(clean, "fx.py") == []
    prog, held = chip_smoke.mxlint_adam_program(torch, topt, compile_mod,
                                                kfa)
    timers = [chip_smoke.mxlint_load(src, name)["timed"]
              for src, name in ((flagged, "flagged"), (clean, "clean"))]
    before = kfa.fused_adam.launches
    reads = ([], [])
    for _ in range(chip_smoke.MXLINT_REPS):
        for timer, out in zip(timers, reads):
            torch.cuda.synchronize()
            out.append(timer(prog, chip_smoke.MXLINT_LAUNCHES) * 1e3)
            torch.cuda.synchronize()
    flagged_ms, clean_ms = (statistics.median(r) for r in reads)
    assert kfa.fused_adam.launches - before == \
        2 * chip_smoke.MXLINT_REPS * chip_smoke.MXLINT_LAUNCHES
    assert clean_ms >= chip_smoke.MXLINT_LAUNCHES * \
        chip_smoke.MXLINT_ROW_MS * chip_smoke.MXLINT_FLOOR, reads
    assert flagged_ms <= 0.5 * clean_ms, reads


def test_mx202_flagged_step_fails_its_capture(cuda_device):
    _, _, flagged, clean = chip_smoke.mxlint_fixtures()
    assert [f.rule.id for f in lint_source(flagged, "fx.py")] == ["MX202"]
    assert lint_source(clean, "fx.py") == []
    x = torch.arange(1024, dtype=torch.float32, device=cuda_device)
    want = float(2 * x.sum())
    bad = chip_smoke.mxlint_load(flagged, "flagged")["make"](x)
    assert bad() == want  # the eager warm-up may read the host
    with pytest.raises(Exception):
        bad()
    assert not bad.captured
    torch.cuda.synchronize()
    good = chip_smoke.mxlint_load(clean, "clean")["make"](x)
    assert [float(good()) for _ in range(3)] == [want] * 3
    assert good.captured
