"""The port's launched examples (``mxnet_tpu_torch/examples/distributed``)
on the CPU, against the JAX package's scripts under ``examples/distributed``.

- Every launched script runs under the repo's ``tools/launch.py`` with
  ``--cpu``, at 2 workers (4 for the staleness tier), all started together
  (one thread a worker process), and passes the JAX script's own assertions
  and printed lines; ``dist_sync_kvstore`` also runs standalone (4
  in-process workers). ``crash_resume_train`` runs twice: exit 137 after
  epoch 2, then a resume from epoch 2.
- ``dist_sync_mlp`` at world 1 against the JAX package's ``FeedForward`` on
  the JAX script's data, from the same weights: the final parameters within
  1e-5 (f32 contractions on both sides).
- ``elastic_train`` against the JAX script run as a subprocess: the same
  membership history, and final accuracy within 0.02.
- Without CUDA and without ``--cpu`` each script raises and names CUDA.
- ``kvstore.create("dist_sync")``'s backend: nccl only where every rank on
  the host has a card of its own, else gloo (the card count and the local
  world patched).
"""

import importlib.util
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.base import MXNetError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = os.path.join(REPO, "tools", "launch.py")
PKG = "mxnet_tpu_torch.examples.distributed"
TIMEOUT_S = 240

mt.set_matmul_precision("highest")


def _env():
    """A worker's environment: one thread a process (the workers share the
    box with the rest of the suite), no MXTPU_* left over."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _launch(script, n, *args):
    return subprocess.run(
        [sys.executable, LAUNCH, "-n", str(n), sys.executable, "-m",
         f"{PKG}.{script}", "--cpu", *args],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(),
        cwd=REPO)


LAUNCHED = {
    # script: (workers, the line each worker prints, how many)
    "dist_sync_kvstore": (2, r"worker \d/2: dist_sync semantics OK "
                             r"\(reduced value = 3\)", 2),
    "dist_sync_mlp": (2, r"worker \d/2: dist_sync_mlp accuracy = "
                         r"(1\.0000|0\.9[5-9]\d\d)", 2),
    "dist_sync_lenet": (2, r"worker \d/2: dist_sync_lenet accuracy = "
                           r"(1\.0000|0\.9\d\d\d)", 2),
    "dist_sync_module": (2, r"worker \d/2: dist_sync_module accuracy = "
                            r"(1\.0000|0\.9[5-9]\d\d) wsum = [\d.]+", 2),
    "dist_async_kvstore": (2, r"worker \d/2: dist_async semantics OK "
                              r"\(value = 5\)", 2),
    "dist_async_mlp": (2, r"worker \d/2: dist_async_mlp accuracy = "
                          r"(1\.0000|0\.9[5-9]\d\d)", 2),
    "dist_async_lenet": (2, r"worker \d/2: dist_async_lenet accuracy = "
                            r"(1\.0000|0\.9\d\d\d)", 2),
    "dist_async_staleness": (4, r"worker \d/4: completed 12 batches", 4),
}


@pytest.fixture(scope="module")
def launched():
    """Every launched tier at once: {script: CompletedProcess}."""
    with ThreadPoolExecutor(len(LAUNCHED)) as pool:
        futures = {s: pool.submit(_launch, s, n)
                   for s, (n, _, _) in LAUNCHED.items()}
        return {s: f.result() for s, f in futures.items()}


@pytest.mark.parametrize("script", sorted(LAUNCHED))
def test_launched_tier_passes_the_jax_scripts_checks(launched, script):
    res = launched[script]
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    _, line, count = LAUNCHED[script]
    got = re.findall(line, res.stdout)
    assert len(got) == count, res.stdout
    if script == "dist_sync_module":
        # identical replicas: every rank prints the same weight digest
        digests = re.findall(r"wsum = ([\d.]+)", res.stdout)
        assert len(set(digests)) == 1, res.stdout
    if script == "dist_async_staleness":
        m = re.search(r"dist_async_staleness OK: updates=48 acc=([\d.]+)",
                      res.stdout)
        assert m and float(m.group(1)) > 0.9, res.stdout


def test_dist_sync_kvstore_standalone_group():
    """No launcher: four in-process workers on threads (the JAX script's
    second mode)."""
    res = subprocess.run(
        [sys.executable, "-m", f"{PKG}.dist_sync_kvstore", "--cpu"],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=_env(),
        cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("dist_sync semantics OK (reduced value = 10)") \
        == 4, res.stdout
    assert "all workers passed" in res.stdout


def test_crash_resume_train_dies_then_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cmd = [sys.executable, "-m", f"{PKG}.crash_resume_train", ckpt, "--cpu"]
    env = _env()
    crashed = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=TIMEOUT_S,
                             env={**env, "MXTPU_CRASH_AFTER_EPOCH": "2"},
                             cwd=REPO)
    assert crashed.returncode == 137, crashed.stderr[-2000:]
    assert "simulated preemption after epoch 1" in crashed.stdout
    resumed = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=TIMEOUT_S, env=env, cwd=REPO)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    m = re.search(r"crash_resume final accuracy = ([\d.]+) \(resumed from "
                  r"epoch (\d+)\)", resumed.stdout)
    assert m and float(m.group(1)) > 0.95 and m.group(2) == "2", \
        resumed.stdout


def _jax_example(name):
    """A JAX example's module, loaded from its file (it imports the JAX
    package and pins JAX to the CPU, as conftest already has)."""
    path = os.path.join(REPO, "examples", "distributed", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_dist_sync_mlp_world_one_matches_jax_feedforward():
    """The port's script body at world 1 against the JAX package's
    FeedForward on the JAX script's data and net, from one set of
    weights and one shuffle order: the final parameters within 1e-5."""
    from mxnet_tpu_torch.examples.distributed import dist_sync_mlp as tex

    jex = _jax_example("dist_sync_mlp")
    X, y = jex.make_dataset()
    tX, ty = tex.make_dataset()
    np.testing.assert_array_equal(X, tX)
    np.testing.assert_array_equal(y, ty)
    rng = np.random.RandomState(5)
    shapes = {"fc1_weight": (32, 16), "fc1_bias": (32,),
              "fc2_weight": (2, 32), "fc2_bias": (2,)}
    args = {k: (rng.randn(*s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}

    net = mx.symbol.Variable("data")
    net = mx.symbol.FullyConnected(data=net, num_hidden=32, name="fc1")
    net = mx.symbol.Activation(data=net, act_type="relu", name="relu1")
    net = mx.symbol.FullyConnected(data=net, num_hidden=2, name="fc2")
    net = mx.symbol.SoftmaxOutput(data=net, name="softmax")
    jm = mx.model.FeedForward(
        symbol=net, ctx=mx.cpu(), num_epoch=5, learning_rate=0.1,
        momentum=0.9, initializer=mx.init.Xavier(),
        arg_params={k: mx.nd.array(v) for k, v in args.items()})
    # fit shuffles arrays with numpy's global generator in both packages:
    # one seed, one order
    np.random.seed(7)
    jm.fit(X, y, batch_size=32, kvstore=mx.kv.create("dist_sync"))

    kv = mt.kv.create("dist_sync", ctx=mt.cpu())
    assert kv.num_workers == 1
    np.random.seed(7)
    tm, _, _ = tex.train(kv, mt.cpu(), arg_params={
        k: torch.from_numpy(v.copy()) for k, v in args.items()})
    for k in args:
        np.testing.assert_allclose(tm.arg_params[k].numpy(),
                                   jm.arg_params[k].asnumpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        assert not np.allclose(tm.arg_params[k].numpy(), args[k]), k


def test_elastic_train_matches_the_jax_script(tmp_path):
    """The JAX script in a subprocess (it sets XLA_FLAGS at import) and the
    port's main over eight CPU replicas: the same resizes and reasons, and
    final accuracy within 0.02."""
    env = _env()
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    jax_run = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "distributed",
                                      "elastic_train.py"),
         str(tmp_path / "jax")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    from mxnet_tpu_torch.examples.distributed import elastic_train

    try:
        co, acc = elastic_train.main(["--cpu", str(tmp_path / "port")])
        out, err = jax_run.communicate(timeout=TIMEOUT_S)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, err[-2000:]
    jax_history = re.findall(r"  (\d+) -> (\d+)  downtime [\d.]+s  \((.*)\)",
                             out)
    port_history = [(str(h["from"]), str(h["to"]), h["reason"])
                    for h in co.history]
    assert port_history == jax_history == [
        ("8", "6", "kill:7:failure;kill:6:failure"),
        ("6", "8", "join:6:rejoin;join:7:rejoin")], (out, port_history)
    jax_acc = float(re.search(r"final accuracy: ([\d.]+)", out).group(1))
    assert abs(acc - jax_acc) <= 0.02, (acc, jax_acc)


EXAMPLES = ["dist_sync_kvstore", "dist_sync_mlp", "dist_sync_lenet",
            "dist_sync_module", "dist_async_kvstore", "dist_async_mlp",
            "dist_async_lenet", "dist_async_staleness", "crash_resume_train",
            "elastic_train"]


@pytest.mark.parametrize("script", EXAMPLES)
def test_without_cpu_an_example_needs_cuda(monkeypatch, script):
    """Without ``--cpu`` and without CUDA each script raises, naming CUDA,
    before it touches a world or a device."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"{PKG}.{script}")
    argv = ["unused_dir"] if script in ("crash_resume_train",
                                        "elastic_train") else []
    with pytest.raises(MXNetError, match="CUDA"):
        module.main(argv)


@pytest.mark.parametrize("cards,local,ctx,want", [
    (0, "2", None, "gloo"),        # no card
    (1, "2", None, "gloo"),        # two ranks share one card
    (1, "1", None, "nccl"),        # a card for the one rank
    (2, "2", None, "nccl"),        # a card each
    (4, "8", None, "gloo"),        # more ranks than cards
    (8, "8", None, "nccl"),
    (2, "2", "cpu", "gloo"),       # a cpu context asks for the host
])
def test_dist_sync_backend_choice(monkeypatch, cards, local, ctx, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv("MXTPU_NUM_WORKERS", local)
    got = tkv._dist_backend(mt.cpu() if ctx == "cpu" else None)
    assert got == want
    # torchrun's LOCAL_WORLD_SIZE takes precedence over the launcher's count
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    if ctx is None and cards:
        assert tkv._dist_backend(None) == "nccl"


def test_dist_sync_join_logs_its_backend(monkeypatch, caplog):
    """The join says which backend it chose, in one log line (a warning
    where ranks share a card and go through host buffers)."""
    import logging

    calls = []
    monkeypatch.setattr(tkv.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tkv.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv("MXTPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_WORKER_RANK", "1")
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch.kvstore"):
        tkv._maybe_init_distributed("gloo")
    assert calls and calls[0][0] == ("gloo",)
    lines = [r.getMessage() for r in caplog.records
             if "joined" in r.getMessage()]
    assert lines == ["mxnet_tpu_torch: rank 1 joined the 2-rank world "
                     "with gloo (2 rank(s) on this host, 0 card(s))"]


def test_kvstore_takes_ndarrays_as_the_jax_package_does():
    """The JAX scripts push and pull ``mx.nd`` arrays; the port's stores
    take its NDArrays as they take tensors."""
    kv = mt.kv.create("local")
    with mt.cpu():
        kv.init(3, mt.nd.ones((2, 2)))
        kv.push(3, [mt.nd.ones((2, 2)) * 2, mt.nd.ones((2, 2))])
        out = mt.nd.empty((2, 2))
        kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 3.0))
