"""The port's ``capi_support.CApi`` (the Python side of the flat C API)
against the JAX package's: tests/test_capi_support.py's nine cases, each run
through both ``CApi``s on the same inputs. Deterministic results match
exactly (or within 1e-6 where a float op runs); random fills, which the two
packages draw from different generators, are held by their moments. Then
the port's own device rules: the ``dev_type`` map (3 is ``cpu_pinned``
here, ``cpu`` in the JAX package), the device of the entry points that take
no context, and a card request without CUDA, which raises naming CUDA
instead of making a CPU array."""

import ctypes

import numpy as np
import pytest
import torch

from mxnet_tpu import capi_support as jcapi
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.ndarray import NDArray as JNDArray
from mxnet_tpu_torch import capi_support as tcapi
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.ndarray import NDArray as TNDArray

PACKAGES = ("jax", "torch")


@pytest.fixture(scope="module")
def apis():
    return {"jax": (jcapi.CApi(), lambda a: JNDArray(np.asarray(a, np.float32)),
                    JError),
            "torch": (tcapi.CApi(),
                      lambda a: TNDArray(np.asarray(a, np.float32), cpu()),
                      TError)}


def both(apis, fn):
    """``fn(api, nd, error)`` for each package: {package: result}."""
    return {p: fn(*apis[p]) for p in PACKAGES}


def same(results, atol=0.0):
    j, t = results["jax"], results["torch"]
    if isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            same({"jax": a, "torch": b}, atol)
    elif isinstance(j, np.ndarray):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=atol)
    else:
        assert j == t


def test_func_invoke_set_value_and_copyto(apis):
    def run(api, nd, _):
        a = nd(np.zeros((2, 3)))
        api.func_invoke("_set_value", [], [7.5], [a])
        b = nd(np.zeros((2, 3)))
        api.func_invoke("_copyto", [a], [], [b])
        return [a.asnumpy(), b.asnumpy()]

    got = both(apis, run)
    same(got)
    assert np.all(got["torch"][1] == 7.5)


@pytest.mark.parametrize("package", PACKAGES)
def test_func_invoke_random_fill_moments(apis, package):
    api, nd, _ = apis[package]
    api.random_seed(0)
    u = nd(np.zeros((4000,)))
    api.func_invoke("_random_uniform", [], [-1.0, 1.0], [u])
    vals = u.asnumpy()
    assert -1.0 <= vals.min() and vals.max() <= 1.0
    assert abs(vals.mean()) < 0.1
    g = nd(np.zeros((4000,)))
    api.func_invoke("_random_gaussian", [], [2.0, 0.5], [g])
    gv = g.asnumpy()
    assert abs(gv.mean() - 2.0) < 0.1 and abs(gv.std() - 0.5) < 0.1
    # reseeding replays the same fill
    api.random_seed(0)
    u2 = nd(np.zeros((4000,)))
    api.func_invoke("_random_uniform", [], [-1.0, 1.0], [u2])
    np.testing.assert_array_equal(u2.asnumpy(), vals)


def test_func_invoke_onehot_and_clip(apis):
    def run(api, nd, _):
        idx = nd([0.0, 2.0, 1.0])
        out = nd(np.zeros((3, 3)))
        api.func_invoke("_onehot_encode", [idx, out], [], [out])
        src = nd([-5.0, 0.5, 9.0])
        dst = nd(np.zeros((3,)))
        api.func_invoke("clip", [src], [-1.0, 1.0], [dst])
        return [out.asnumpy(), dst.asnumpy()]

    got = both(apis, run)
    same(got)
    np.testing.assert_array_equal(got["torch"][0], np.eye(3)[[0, 2, 1]])


@pytest.mark.parametrize("name", sorted(jcapi._FUNCTIONS))
def test_func_describe_and_info_match(apis, name):
    got = both(apis, lambda api, nd, _: (api.func_describe(name),
                                         api.func_info(name)[2:]))
    same(got)
    assert tcapi._FUNCTIONS == jcapi._FUNCTIONS
    assert apis["torch"][0].list_functions() == apis["jax"][0].list_functions()


@pytest.mark.parametrize("name", ["_plus", "_minus", "_mul", "_div", "dot",
                                  "choose_element_0index", "_plus_scalar",
                                  "_minus_scalar", "_mul_scalar",
                                  "_div_scalar", "_rminus_scalar",
                                  "_rdiv_scalar", "square", "sqrt", "exp",
                                  "log", "norm"])
def test_func_invoke_registered(apis, name):
    nuse, nscalar, _, _ = jcapi._FUNCTIONS[name]
    rng = np.random.RandomState(1)
    a = rng.uniform(0.5, 2.0, (3, 3)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (3, 3)).astype(np.float32)
    if name == "choose_element_0index":
        b = np.array([2.0, 0.0, 1.0], np.float32)
    out_shape = {"norm": (1,), "choose_element_0index": (3,)}.get(name, (3, 3))

    def run(api, nd, _):
        out = nd(np.zeros(out_shape))
        api.func_invoke(name, [nd(a), nd(b)][:nuse], [1.75][:nscalar], [out])
        return out.asnumpy()

    same(both(apis, run), atol=1e-6)


def test_iter_param_parsing(apis):
    for v in ["8", "0.5", "true", "False", "(3, 28, 28)", "(3,)",
              "path/to.rec", "()"]:
        got = both(apis, lambda api, nd, _: api._parse_iter_val(v))
        same(got)
        assert type(got["jax"]) is type(got["torch"])


def test_symbol_atomic_compose_roundtrip(apis):
    def run(api, nd, error):
        atom = api.symbol_create_atomic("FullyConnected", ["num_hidden"],
                                        ["4"])
        data = api.symbol_create_variable("data")
        sym = api.symbol_compose(atom, "fc", ["data"], [data])
        with pytest.raises(error):
            api.symbol_create_atomic("NoSuchOp", [], [])
        with pytest.raises(error):
            api.symbol_compose(sym, "again", ["data"], [data])
        return [atom[:2], api.symbol_list_arguments(sym),
                api.symbol_list_outputs(sym), api.symbol_list_aux(sym)]

    got = both(apis, run)
    same(got)
    assert got["torch"][1] == ["data", "fc_weight", "fc_bias"]


def test_infer_shape_full_and_error_paths(apis):
    def run(api, nd, error):
        atom = api.symbol_create_atomic("FullyConnected", ["num_hidden"],
                                        ["4"])
        data = api.symbol_create_variable("data")
        sym = api.symbol_compose(atom, "fc", ["data"], [data])
        result = api.symbol_infer_shape(sym, ["data"], [(5, 3)])
        with pytest.raises(error):
            api.symbol_infer_shape(("__atomic__", "FullyConnected", {}),
                                   ["data"], [(5, 3)])
        return result

    got = both(apis, run)
    same(got)
    args, outs, aux, complete = got["torch"]
    assert complete == 1 and args[1] == (4, 3) and outs[0] == (5, 4)


@pytest.mark.parametrize("package", PACKAGES)
def test_host_view_refresh_and_drop(apis, package):
    api, nd, _ = apis[package]
    a = nd(np.arange(4, dtype=np.float32))
    p1 = api.ndarray_data_ptr(a)
    a[:] = np.array([9.0, 8, 7, 6], np.float32)
    p2 = api.ndarray_data_ptr(a)
    assert p1 == p2, "repeat GetData must refresh the SAME buffer"
    view = (ctypes.c_float * 4).from_address(p1)
    assert list(view) == [9.0, 8.0, 7.0, 6.0]
    api.ndarray_drop_host_view(a)
    assert id(a) not in api._host_views


def test_ndarray_raw_roundtrip_and_save_load(apis, tmp_path):
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)

    def run(api, nd, _):
        raw = api.ndarray_save_raw(nd(a))
        back = api.ndarray_load_raw(raw)
        f = str(tmp_path / f"x-{type(api).__module__}.nd")
        api.ndarray_save(f, [nd(a)], ["w"])
        arrs, names = api.ndarray_load(f)
        return [raw, back.asnumpy(), names, arrs[0].asnumpy()]

    got = both(apis, run)
    same(got)
    np.testing.assert_array_equal(got["torch"][1], a)


def test_ndarray_files_cross_packages(apis, tmp_path):
    """A file one CApi saves, the other loads: the .params container is
    shared."""
    a = np.random.RandomState(2).randn(2, 5).astype(np.float32)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        api_w, nd_w, _ = apis[writer]
        f = str(tmp_path / f"{writer}.nd")
        api_w.ndarray_save(f, [nd_w(a)], ["arg:w"])
        arrs, names = apis[reader][0].ndarray_load(f)
        assert names == ["arg:w"]
        np.testing.assert_array_equal(arrs[0].asnumpy(), a)


# -- the port's device rules ---------------------------------------------------

@pytest.mark.parametrize("dev_type,want", [(1, ("cpu", 1)),
                                           (3, ("cpu_pinned", 3))])
def test_dev_type_map(apis, dev_type, want):
    """dev_type 1 is cpu in both packages; 3 is cpu_pinned in the port and
    cpu in the JAX package (ROADMAP C.2)."""
    t = apis["torch"][0].ndarray_create((2, 3), dev_type, 0, 0)
    assert t.context.device_type == want[0]
    assert apis["torch"][0].ndarray_context(t) == (want[1], 0)
    j = apis["jax"][0].ndarray_create((2, 3), dev_type, 0, 0)
    assert apis["jax"][0].ndarray_context(j) == (1, 0)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_dev_type_unknown_is_refused(apis):
    with pytest.raises(TError, match="dev_type 7"):
        apis["torch"][0].ndarray_create((2,), 7, 0, 0)


def test_card_request_without_cuda_raises_naming_cuda(apis):
    if torch.cuda.is_available():
        pytest.skip("needs a host without CUDA (the card's case is "
                    "tests/test_torch_bindings_card.py)")
    api = apis["torch"][0]
    with pytest.raises(TError, match="CUDA"):
        api.ndarray_create((2, 3), 2, 0, 0)
    atom = api.symbol_create_atomic("FullyConnected", ["num_hidden"], ["2"])
    sym = api.symbol_compose(atom, "fc", ["data"],
                             [api.symbol_create_variable("data")])
    args = [api.ndarray_create(s, 1, 0, 0) for s in ((4, 3), (2, 3), (2,))]
    with pytest.raises(TError, match="CUDA"):
        api.executor_bind(sym, 2, 0, args, [None] * 3, [0] * 3, [])


def test_contextless_entry_points_are_on_the_cpu(apis, tmp_path):
    """MXNDArrayCreateNone, MXNDArrayLoad, MXNDArrayLoadFromRawBytes and an
    iterator's data and label arrays are host arrays (dev_type 1)."""
    api = apis["torch"][0]
    f = str(tmp_path / "a.nd")
    pinned = api.ndarray_create((3,), 3, 0, 0)
    api.ndarray_save(f, [pinned], [])
    loaded, _ = api.ndarray_load(f)
    raw = api.ndarray_load_raw(api.ndarray_save_raw(pinned))
    from mxnet_tpu_torch import io as tio

    # NDArrayIter takes arrays, which no C string carries: built directly
    it = tio.NDArrayIter(np.ones((4, 2), np.float32), np.zeros(4, np.float32),
                         batch_size=2)
    it._capi_batch = None
    assert api.data_iter_next(it) == 1
    for array in (api.ndarray_create_none(), loaded[0], raw,
                  api.data_iter_get_data(it), api.data_iter_get_label(it)):
        assert api.ndarray_context(array) == (1, 0)
        assert array.data.device.type == "cpu"


def test_bound_executor_reads_rebound_handles(apis):
    """A bound executor sees writes made through the handles after the bind
    (each write rebinds the NDArray), as the JAX package's executor does,
    and its gradient handles read what backward wrote."""
    rng = np.random.RandomState(4)
    w = rng.randn(2, 3).astype(np.float32)
    batches = [rng.randn(4, 3).astype(np.float32) for _ in range(2)]

    def run(api, nd, _):
        atom = api.symbol_create_atomic("FullyConnected",
                                        ["num_hidden", "no_bias"],
                                        ["2", "true"])
        sym = api.symbol_compose(atom, "fc", ["data"],
                                 [api.symbol_create_variable("data")])
        data, weight, grad = nd(np.zeros((4, 3))), nd(w), nd(np.zeros((2, 3)))
        ex = api.executor_bind(sym, 1, 0, [data, weight], [None, grad],
                               [0, 1], [])
        seen = []
        for x in batches:
            data[:] = x
            api.executor_forward(ex, 1)
            api.executor_backward(ex, [])
            seen += [api.executor_outputs(ex)[0].asnumpy(), grad.asnumpy()]
            api.func_invoke("_minus", [weight, grad], [], [weight])
        return seen

    got = both(apis, run)
    same(got, atol=1e-6)
    np.testing.assert_allclose(got["torch"][0], batches[0] @ w.T, rtol=1e-6)
