"""The port's random draws (mirroring ``tests/test_random.py``): moments,
seed determinism, ``get_state`` / ``set_state``, ``out=``, ``randint``.

torch and JAX draw different numbers from the same seed, so the two
packages are compared by their moments only: on 10,000 draws the mean of
U(-10, 10) has a standard error of 0.058 and that of N(10, 2) 0.02, so both
packages' means are held within 0.25 and 0.1 of the distribution's (4 and 5
standard errors) and their standard deviations within 0.1 (the standard
errors: 0.026 and 0.014).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with mt.cpu():
        yield
    mt.random.seed(0)


@pytest.mark.parametrize("kind,args,mean,std,mean_tol", [
    ("uniform", (-10, 10), 0.0, 20 / np.sqrt(12), 0.25),
    ("normal", (10.0, 2.0), 10.0, 2.0, 0.1)])
def test_moments_and_seed_match_jax(kind, args, mean, std, mean_tol):
    draws = {}
    for pkg in (mx, mt):
        pkg.random.seed(128)
        first = getattr(pkg.random, kind)(*args, shape=(100, 100)).asnumpy()
        pkg.random.seed(128)
        again = getattr(pkg.random, kind)(*args, shape=(100, 100)).asnumpy()
        np.testing.assert_array_equal(first, again)
        assert abs(first.mean() - mean) < mean_tol
        assert abs(first.std() - std) < 0.1
        draws[pkg.__name__] = first
    if kind == "uniform":
        assert draws["mxnet_tpu_torch"].min() >= -10
        assert draws["mxnet_tpu_torch"].max() < 10
    assert draws["mxnet_tpu_torch"].dtype == draws["mxnet_tpu"].dtype


def test_get_state_then_set_state_repeats_draws_bitwise():
    mt.random.seed(5)
    mt.random.uniform(0, 1, (7,))  # move the generator on
    state = mt.random.get_state()
    a = (mt.random.uniform(0, 1, (100,)).asnumpy(),
         mt.random.normal(0, 1, (5, 5)).asnumpy(),
         mt.random.randint(0, 100, (9,)).asnumpy())
    mt.random.seed(99)
    mt.random.set_state(state)
    b = (mt.random.uniform(0, 1, (100,)).asnumpy(),
         mt.random.normal(0, 1, (5, 5)).asnumpy(),
         mt.random.randint(0, 100, (9,)).asnumpy())
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    import json

    assert json.loads(json.dumps(state)) == state  # serialisable


def test_out_param_different_draws_and_randint():
    out = mt.nd.zeros((50, 50))
    res = mt.random.uniform(0, 1, out=out)
    assert res is out
    arr = out.asnumpy()
    assert arr.min() >= 0 and arr.max() < 1 and arr.std() > 0
    mt.nd.random_gaussian(0.0, 1.0, out=out)
    assert abs(out.asnumpy().mean()) < 0.1
    a = mt.random.uniform(0, 1, (10,)).asnumpy()
    b = mt.random.uniform(0, 1, (10,)).asnumpy()
    assert not np.allclose(a, b)
    r = mt.random.randint(0, 5, (1000,))
    assert r.dtype == np.int32
    assert r.asnumpy().min() == 0 and r.asnumpy().max() == 4
    h = mt.random.normal(0, 1, (4,), dtype="bfloat16")
    assert h.dtype == torch.bfloat16


def test_each_context_draws_from_its_own_generator():
    mt.random.seed(3)
    x = mt.random.uniform(0, 1, (4,), ctx=mt.cpu()).asnumpy()
    mt.random.seed(3)
    y = mt.nd.random_uniform(0, 1, (4,)).asnumpy()
    np.testing.assert_array_equal(x, y)
    assert mt.random.generator("cpu") is mt.random.generator("cpu")
