"""The port's tools and launched examples on the card (``-m cuda``; skipped
without a card): phase 12c of ``chip_smoke.py`` at the smallest size that
still launches each kernel, through its helpers.

- ``tools/launch.py -n 2`` runs the dist_sync MLP example on the card: both
  workers share it over gloo (the kvstore's log line), hold their models
  there and pass the script's accuracy assertion.
- ``elastic_train`` over ``[gpu(0)] * 8`` with the exchange's kernels armed
  (``MXNET_TPU_COMM_KERNELS=1``): the JAX script's membership history, rows
  3, 5 and 7 launched and held bitwise at the example's bucket shapes.
- ``train_long_lm``'s steps with ``--flash`` on two ranks sharing the card
  (dp 1 x sp 2, 4 steps): each rank's flash launches steps x layers x (sp
  index + 1), and the kernels row by row at the example's shape.
- ``im2rec`` on the card's host writes the JAX script's bytes; the Caffe
  LeNet on gpu(0) within ``CAFFE_BOUND`` of the CPU.
- Phase 12d's single-process ``lstm_bucketing`` on the card under the
  package's gate ``MXNET_TPU_FUSED_ADAM=1``: fused_adam launched once a
  batch (``batches_per_epoch() * EPOCHS``, from the script's corpus), and
  its first launch bitwise its plain version at the example's leaves.

Run on the card with
``python3 -m pytest tests/test_torch_examples_card.py -m cuda -q``.
"""

import contextlib
import hashlib
import io
import os
import re
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from torch_ranks import run_ranks, train_long_lm_runs  # noqa: E402

pytestmark = pytest.mark.cuda
LONGLM_STEPS = 4


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    mt.set_matmul_precision("highest")


def test_launcher_runs_dist_sync_mlp_on_the_card(tmp_path):
    rc, out, err, _ = cs.finish_logged(cs.start_tools_launch(str(tmp_path)),
                                       cs.TOOLS_LAUNCH_TIMEOUT_S)
    assert rc == 0, err[-3000:]
    # the two workers share one stdout: match values, not whole lines
    accs = [float(a) for a in
            re.findall(r"dist_sync_mlp accuracy = (\d\.\d+)", out)]
    assert len(accs) == 2 and min(accs) > cs.TOOLS_MLP_ACCURACY, out
    assert err.count("with gloo (2 rank(s) on this host") == 2, err[-2000:]
    peaks = [int(p.read_text()) for p in tmp_path.glob("card_peak_bytes.*")]
    assert len(peaks) == 2 and min(peaks) > 0, peaks


def test_elastic_train_launches_the_comm_kernels(tmp_path, monkeypatch):
    from mxnet_tpu_torch.examples.distributed import elastic_train
    from mxnet_tpu_torch.kernels import comm_kernels as ck

    monkeypatch.setenv("MXNET_TPU_COMM_KERNELS", "1")
    cs.reset_launches()
    with cs.CommCalls(ck) as calls, \
            contextlib.redirect_stdout(io.StringIO()):
        co, acc = elastic_train.main([str(tmp_path)])
    launches = cs.read_launches()
    assert [(h["from"], h["to"], h["reason"]) for h in co.history] == \
        cs.ELASTIC_EXAMPLE_HISTORY
    assert acc > cs.ELASTIC_EXAMPLE_ACCURACY
    for name in ("quant_int8", "dequant_sum_int8", "dequant_int8"):
        assert launches[name] > 0, launches
    for name in ("quant_twobit", "dequant_sum_twobit", "dequant_twobit",
                 "fused_adam", "int8_matmul"):
        assert launches[name] == 0, launches
    rows = cs.comm_example_holds(torch, ck, calls)
    assert all(r["bitwise"] for r in rows.values())


def test_train_long_lm_flash_launches_on_two_ranks(tmp_path):
    from mxnet_tpu_torch.kernels import flash_attention as tfa

    argv = ["--dp", "1", "--sp", "2", "--flash", "--steps",
            str(LONGLM_STEPS)]
    ranks = run_ranks(train_long_lm_runs, 2, tmp_path, [argv], None, True,
                      join=False)
    for r in ranks:
        run = r["runs"][0]
        want = LONGLM_STEPS * cs.LONGLM_LAYERS * (r["coords"]["sp"] + 1)
        assert run["launches"] == dict.fromkeys(cs.FLASH_NAMES, want), r
        assert all(v == v for v in run["losses"])
    assert ranks[0]["runs"][0]["losses"] == ranks[1]["runs"][0]["losses"]
    worst = cs.longlm_flash_holds(torch, tfa)
    assert all(w["share_of_bound_max"] <= 1.0 for w in worst.values())


def test_tools_on_the_card_host(tmp_path):
    from mxnet_tpu_torch.tools import im2rec

    cs.write_tool_images(tmp_path / "images")
    lst, rec = str(tmp_path / "t.lst"), str(tmp_path / "t.rec")
    with contextlib.redirect_stdout(io.StringIO()):
        im2rec.make_list(str(tmp_path / "images"), lst)
        im2rec.pack(lst, str(tmp_path / "images"), rec,
                    resize=cs.TOOLS_RESIZE, center_crop=True)
    with open(rec, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cs.TOOLS_REC_SHA256
    caffe = cs.caffe_card_check(torch, mt, str(tmp_path))
    assert caffe["max_abs_err"] <= cs.CAFFE_BOUND


def test_lstm_bucketing_example_launches_fused_adam(monkeypatch):
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing
    from mxnet_tpu_torch.kernels import fused_adam as kfa

    monkeypatch.setenv("MXNET_TPU_FUSED_ADAM", "1")
    with cs.FirstAdamStep(torch, topt) as first:
        run = cs.run_example(torch, "rnn.lstm_bucketing", [])
    derived = lstm_bucketing.batches_per_epoch() * lstm_bucketing.EPOCHS
    assert run["launches"]["fused_adam"] == derived, run["launches"]
    assert run["peak_bytes"] > 0
    held = first.hold(kfa)
    assert held["bitwise"], held
    assert "Epoch[4] Train-accuracy" in run["logged"]
