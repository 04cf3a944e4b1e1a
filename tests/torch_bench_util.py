"""Helpers of the subsystem benches' CPU tests
(``tests/test_torch_bench_{overhead,comm,resilience}.py``): each bench runs
as ``python -m mxnet_tpu_torch.tools.bench_<name> --smoke --cpu`` in a
process of its own, the benches of one file started together, and its one
JSON line is read back. Imports no JAX."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each bench process's intra-op threads: the benches of a file run
# together beside the other test workers
THREADS = "2"
TIMEOUT_S = 420


def start(name, tmp_path):
    """Start bench ``name`` at ``--smoke --cpu``; its output goes to files
    under ``tmp_path``."""
    out = open(tmp_path / f"{name}.out", "w")
    err = open(tmp_path / f"{name}.err", "w")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, OMP_NUM_THREADS=THREADS,
               PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"mxnet_tpu_torch.tools.bench_{name}",
         "--smoke", "--cpu"], stdout=out, stderr=err, cwd=str(tmp_path),
        env=env)
    return proc, out, err, tmp_path / f"{name}.out", tmp_path / f"{name}.err"


def finish(started):
    """The bench's one JSON line, after it exits 0 having printed exactly
    one line that starts with ``{``."""
    proc, out, err, out_path, err_path = started
    try:
        rc = proc.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out.close()
    err.close()
    stdout, stderr = out_path.read_text(), err_path.read_text()
    assert rc == 0, (rc, (stdout + stderr)[-3000:])
    lines = [ln for ln in stdout.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def run_benches(tmp_path_factory):
    """``get(name)``: the JSON of bench ``name``; the names given to
    :func:`start_all` start together at the first call."""
    state = {"started": {}, "done": {}}

    def start_all(*names):
        tmp = tmp_path_factory.mktemp("benches")
        for n in names:
            state["started"][n] = start(n, tmp)

        def get(name):
            if name not in state["done"]:
                state["done"][name] = finish(state["started"][name])
            return state["done"][name]

        return get

    yield start_all
    for started in state["started"].values():
        if started[0].poll() is None:
            started[0].kill()
            started[0].wait()


def contract(blob, name, metric, keys):
    """What every bench's line holds: its metric, the contract keys, a
    smoke run that wrote nothing, and the CPU named as no card."""
    from mxnet_tpu_torch.tools import _bench

    for key in ("metric", "unit", "device", *keys):
        assert key in blob, (name, key, sorted(blob))
    assert blob["metric"] == metric
    assert blob["smoke"] is True  # smoke runs write no BENCH_*_torch.json
    assert blob["device"] == _bench.NO_CARD
