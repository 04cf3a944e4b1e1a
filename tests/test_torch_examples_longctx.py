"""``mxnet_tpu_torch/examples/long_context/train_long_lm.py`` on the CPU,
against the JAX package's ``examples/long_context/train_long_lm.py``.

- Launched: ``tools/launch.py -n 4`` runs the script with ``--dp 2 --sp 2
  --cpu`` (its defaults otherwise: 600 steps of the copy task): exit 0, the
  JAX script's printed lines (a loss line every 20 steps, the summary) and
  its own assertion (the last loss below 1.5).
- Weights carried across (``convert.shard_transformer_params``): dp 1 x sp
  2 on two gloo ranks that join the world from the launcher's variables,
  against the JAX model on two virtual devices from the same initial
  parameters and batches: the first 20 losses within 1e-4 (f32 on both
  sides, contractions at full precision); the port's ``--flash`` run (the
  kernels' plain versions on the CPU) within 1e-4 of its dense run.
- Without CUDA and without ``--cpu`` the script raises and names CUDA.
"""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples.long_context import train_long_lm
from torch_ranks import run_ranks, train_long_lm_runs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "mxnet_tpu_torch.examples.long_context.train_long_lm"
STEPS = 20


def test_launched_dp2_sp2_learns_the_copy_task():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n", "4",
         sys.executable, "-m", MODULE, "--dp", "2", "--sp", "2", "--cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    steps = re.findall(r"step +(\d+)  loss ([\d.]+)  \(seq 128 over sp=2: "
                       r"64 tokens/device\)", res.stdout)
    assert [int(s) for s, _ in steps] == list(range(0, 600, 20)), res.stdout
    m = re.search(r"long-context LM: loss ([\d.]+) -> ([\d.]+) over 600 "
                  r"steps, ring attention sp=2", res.stdout)
    assert m and float(m.group(2)) < 1.5 < float(m.group(1)), res.stdout


def _jax_losses(steps):
    """The JAX script's loop at dp 1 x sp 2 on two of conftest's virtual
    devices: its initial parameters (numpy) and its first losses."""
    from mxnet_tpu.models.transformer import TransformerLM, \
        transformer_lm_config
    from mxnet_tpu.parallel import make_mesh

    mesh = make_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    cfg = transformer_lm_config(vocab_size=64, d_model=64, n_heads=4,
                                n_layers=2, max_len=128, dtype=jnp.float32,
                                attn_impl="auto")
    model = TransformerLM(cfg)
    params, moms = model.init_sharded(mesh, seed=0)
    init = {k: np.asarray(v) for k, v in params.items()}
    step = model.make_train_step(mesh, lr=0.1)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        toks = rng.randint(1, 64, (2, 128)).astype(np.int32)
        tgt = np.concatenate([toks[:, :1], toks[:, :-1]], axis=1)
        params, moms, loss = step(params, moms, toks, tgt.astype(np.int32))
        losses.append(float(loss))
    return init, losses


def test_dp1_sp2_first_losses_match_the_jax_script(tmp_path):
    init, want = _jax_losses(STEPS)
    argv = ["--dp", "1", "--sp", "2", "--cpu", "--steps", str(STEPS)]
    ranks = run_ranks(train_long_lm_runs, 2, tmp_path,
                      [argv, argv + ["--flash"]], init, join=False)
    for r in ranks:
        dense, flash = (run["losses"] for run in r["runs"])
        np.testing.assert_allclose(dense, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(flash, dense, rtol=0, atol=1e-4)
    assert ranks[0]["runs"][0]["losses"] == ranks[1]["runs"][0]["losses"]
    assert want[-1] < want[0]


def test_without_cpu_the_script_needs_cuda(monkeypatch):
    """Without ``--cpu`` and without CUDA it raises, naming CUDA, before
    it joins a world."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        train_long_lm.main(["--dp", "1", "--sp", "1"])
