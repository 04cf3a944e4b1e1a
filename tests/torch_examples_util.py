"""Helpers of the single-process examples' CPU tests
(``tests/test_torch_examples_{vision,rnn,notebooks,misc}.py``): the JAX
scripts loaded from their files, file digests, and parameter checks."""

import hashlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
# the first losses, outputs or parameters of a run, f32 on both sides
BOUND = 1e-4


def jax_example(rel, name=None):
    """A JAX example's module, loaded from ``examples/<rel>`` (its top level
    runs; conftest has pinned JAX to the CPU)."""
    path = os.path.join(EXAMPLES, rel)
    name = name or "jax_example_" + rel.replace("/", "_")[:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def host(value):
    """An NDArray, a tensor or an array as numpy."""
    if hasattr(value, "asnumpy"):
        return value.asnumpy()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def jax_params(params):
    """numpy arrays as the JAX package's NDArrays."""
    import mxnet_tpu as mx

    return {k: mx.nd.array(v) for k, v in params.items()}


def port_params(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def assert_close(got, want, start=None, bound=BOUND):
    """Every entry of ``want`` within ``bound`` of ``got`` (absolute and
    relative), and, given ``start``, moved away from it (the run trained)."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        g, w = host(got[k]), host(want[k])
        np.testing.assert_allclose(g, w, rtol=bound, atol=bound, err_msg=k)
        if start is not None and k in start:
            assert not np.array_equal(w, start[k]), k


def cpu_env():
    """A launched worker's environment: one thread a process, no launcher
    variables left over."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


class BatchLosses:
    """A fit's metric that keeps the mean cross-entropy of each output of
    each training batch (one a batch for one head; one a time step for the
    unrolled LSTM), from that batch's forward, before its update; one
    instance a package (``metric``: its ``CustomMetric``)."""

    def __init__(self, metric):
        self.losses = []
        self.metric = metric.CustomMetric(self._ce, name="batch_ce")

    def _ce(self, label, pred):
        label, pred = host(label).astype(np.int64).ravel(), host(pred)
        p = pred[np.arange(len(label)), label].astype(np.float64)
        self.losses.append(float(-np.log(np.maximum(p, 1e-30)).mean()))
        return self.losses[-1]


def fresh_names(pkg):
    """A fresh auto-naming scope of ``pkg`` (either package): unnamed
    symbols number from 0, as in a new process running the script."""
    return pkg.name.NameManager()


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads a test, put back after it: the suite's workers
    share the box, and the examples train conv nets on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
