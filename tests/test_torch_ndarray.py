"""The imperative NDArray of the port against the JAX package's: the same
operations on the same seeded values (mirroring ``tests/test_ndarray.py``),
placement across contexts, pickling and ``.params`` files of NDArrays.

Everything runs inside ``with mt.cpu():`` (the port's default context is
``gpu(0)``, the JAX package's ``cpu()``). Tolerances: elementwise
arithmetic, copies, slices, selections and one-hot rows are exact (one
rounding each, the same in both), but a scalar over an array (one ulp);
``sqrt``, ``exp`` and ``log`` are each library's own math functions, 1e-6
relative; sums over many elements
(``sum``, ``norm``, ``dot``) add in another order, 1e-5 relative.
"""

import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

EXACT = dict(rtol=0, atol=0)
ULPS = dict(rtol=1e-6, atol=1e-7)
SUMS = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with mt.cpu():
        yield


def _values(shape, seed, lo=-10.0, hi=10.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _both(fn, *arrays, tol=EXACT):
    """``fn(pkg, *NDArrays)`` on each package's arrays of the same values."""
    want = fn(mx, *[mx.nd.array(a) for a in arrays])
    got = fn(mt, *[mt.nd.array(a) for a in arrays])
    assert isinstance(got, mt.nd.NDArray)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **tol)
    return got


BINARY = {
    "add": lambda p, a, b: a + b, "sub": lambda p, a, b: a - b,
    "mul": lambda p, a, b: a * b, "div": lambda p, a, b: a / b,
    "add_scalar": lambda p, a, b: a + 3.0, "rsub_scalar": lambda p, a, b: 3.0 - a,
    "mul_scalar": lambda p, a, b: a * 4.5, "div_scalar": lambda p, a, b: a / 3.3,
    "rdiv_scalar": lambda p, a, b: 2.0 / a, "neg": lambda p, a, b: -a,
    "pow": lambda p, a, b: a ** 2.0,
    "maximum": lambda p, a, b: p.nd.maximum(a, b),
    "minimum": lambda p, a, b: p.nd.minimum(a, b),
    "_plus_scalar": lambda p, a, b: p.nd._plus_scalar(a, 5.0),
    "_rminus_scalar": lambda p, a, b: p.nd._rminus_scalar(a, 5.0),
    "_rdiv_scalar": lambda p, a, b: p.nd._rdiv_scalar(a, 5.0),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_arithmetic_matches_jax(name):
    """Exact, but a scalar divided by an array: the JAX package's jitted
    ``b / a`` with ``b`` traced comes out one ulp off the correctly
    rounded quotient in about a fifth of the elements (5.0 / a; 2.0 / a is
    exact either way)."""
    a, b = _values((3, 4, 5), 0, 1.0), _values((3, 4, 5), 1, 1.0)
    tol = ULPS if name == "_rdiv_scalar" else EXACT
    _both(lambda p, x, y: BINARY[name](p, x, y), a, b, tol=tol)


@pytest.mark.parametrize("name,tol,lo", [
    ("square", EXACT, -10.0), ("abs", EXACT, -10.0), ("sqrt", ULPS, 0.5),
    ("exp", ULPS, -3.0), ("log", ULPS, 0.5), ("norm", SUMS, -10.0),
    ("sum", SUMS, -10.0), ("max", EXACT, -10.0), ("min", EXACT, -10.0)])
def test_functions_match_jax(name, tol, lo):
    a = _values((6, 7), 2, lo, 3.0 if name == "exp" else 10.0)
    got = _both(lambda p, x: getattr(p.nd, name)(x), a, tol=tol)
    if name in ("norm", "sum", "max", "min"):
        assert got.shape == (1,)


def test_inplace_rebinds_and_matches_jax():
    """``+=``, ``-=``, ``*=``, ``/=`` write the array, and only it: a tensor
    read before (an autograd input here) keeps its value."""
    def ops(p, a, b):
        a += 2.0
        a *= 3.0
        a -= b
        a /= 4.0
        return a

    a, b = _values((4, 5), 3), _values((4, 5), 4)
    _both(ops, a, b)
    arr = mt.nd.array(a)
    before = arr.data
    leaf = before.clone().requires_grad_(True)
    held = arr.data
    y = (leaf * held).sum()
    arr += 1.0
    y.backward()  # the saved ``held`` was not written
    np.testing.assert_array_equal(leaf.grad.numpy(), a)
    np.testing.assert_array_equal(held.numpy(), a)
    np.testing.assert_array_equal(arr.asnumpy(), a + 1.0)


def test_slicing_setitem_reshape_transpose_match_jax():
    def ops(p, a):
        a[3:8] = a[3:8] * 2 + 1
        a[0] = 7.5
        s = a.slice(2, 5)
        return p.nd.concatenate([s.reshape((3, 12)).T.reshape((36,)),
                                 a[9:].reshape((12,))])

    _both(ops, _values((10, 4, 3), 5))

    def fill(p, a):
        a[:] = 2.5
        b = a.copy()
        b[:] = np.arange(3, dtype=np.float32)
        return a + b

    _both(fill, _values((4, 3), 6))


def test_selection_functions_match_jax():
    x = np.arange(20, dtype=np.float32).reshape(4, 5) * 0.5
    idx = np.array([1, 3, 2, 0], np.float32)
    _both(lambda p, a, i: p.nd.choose_element_0index(a, i), x, idx)
    _both(lambda p, a: p.nd.argmax_channel(a), _values((6, 9), 7))
    _both(lambda p, a: p.nd.clip(a, -2.0, 3.0), _values((4, 4), 8))
    _both(lambda p, a, b: p.nd.dot(a, b), _values((5, 6), 9),
          _values((6, 3), 10), tol=SUMS)

    def onehot(p, i):
        out = p.nd.zeros((3, 4))
        res = p.nd.onehot_encode(i, out)
        assert res is out
        return out

    _both(onehot, np.array([1, 0, 2], np.float32))


def test_creation_matches_jax():
    for make in (lambda p: p.nd.zeros((2, 3)), lambda p: p.nd.ones((2, 3)),
                 lambda p: p.nd.empty(4), lambda p: p.nd.full((2, 2), 3.14),
                 lambda p: p.nd.arange(0, 10, 2),
                 lambda p: p.nd.arange(0.5, 3.7, 0.3),
                 lambda p: p.nd.array([[1, 2], [3, 4]], dtype=np.int32),
                 lambda p: p.nd.ones((3,), dtype=np.uint8)):
        _both(make)
        assert make(mt).dtype == make(mx).dtype


def test_copies_and_contexts():
    c = mt.nd.array(_values((10, 10), 11))
    d = c.copyto(mt.cpu(0))
    assert d is not c and np.array_equal(d.asnumpy(), c.asnumpy())
    e = mt.nd.zeros((10, 10), dtype=np.float64)
    assert c.copyto(e) is e and e.dtype == np.float64
    np.testing.assert_array_equal(e.asnumpy(), c.asnumpy())
    a = mt.nd.zeros((2, 2), ctx=mt.cpu(1))
    assert a.context == mt.cpu(1)
    b = a.as_in_context(mt.cpu(0))
    assert b.context == mt.cpu(0) and a.context == mt.cpu(1)
    assert a.as_in_context(mt.cpu(1)) is a
    pinned = c.copyto(mt.cpu_pinned())
    assert pinned.context == mt.cpu_pinned()
    np.testing.assert_array_equal(pinned.asnumpy(), c.asnumpy())
    assert mt.num_devices("cpu") == 1
    assert mt.num_devices("gpu") == torch.cuda.device_count()
    with pytest.raises(ValueError):
        mt.num_devices("tpu")


def test_astype_scalars_and_sync():
    a = mt.nd.ones((1,))
    assert float(a) == 1.0 and int(a * 3) == 3
    assert a.asscalar() == 1.0
    assert a.wait_to_read() is a
    mt.nd.waitall()
    h = mt.nd.array([1.5, 2.25]).astype("bfloat16")
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.asnumpy(), [1.5, 2.25])
    assert mt.nd.array([1.7, -2.7]).astype(np.int32).asnumpy().tolist() == \
        [1, -2]
    with pytest.raises(MXNetError, match="size-1"):
        mt.nd.ones((2,)).asscalar()
    ro = mt.nd.NDArray(np.ones(2, np.float32), writable=False)
    with pytest.raises(MXNetError, match="read-only"):
        ro += 1


def test_pickle_keeps_values_dtype_and_context():
    for arr in (mt.nd.array(_values((4, 5), 12)),
                mt.nd.array([1, 2], dtype=np.int32, ctx=mt.cpu(2)),
                mt.nd.ones((3,)).astype("bfloat16")):
        back = pickle.loads(pickle.dumps(arr))
        assert back.context == arr.context and back.dtype == arr.dtype
        assert torch.equal(back.data, arr.data)


def test_params_files_of_ndarrays_cross_both_ways(tmp_path):
    values = {"w": _values((3, 4), 13),
              "i": np.arange(5, dtype=np.int32),
              "u": np.arange(5, dtype=np.uint8)}
    port = str(tmp_path / "port.params")
    mt.nd.save(port, {k: mt.nd.array(v, dtype=v.dtype)
                      for k, v in values.items()})
    back = mx.nd.load(port)
    for k, v in values.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k].asnumpy(), v)
    jax_file = str(tmp_path / "jax.params")
    mx.nd.save(jax_file, [mx.nd.array(values["w"])])
    (loaded,) = mt.nd.load(jax_file)
    np.testing.assert_array_equal(loaded.numpy(), values["w"])
