"""Public names of modules both packages have, each held to the JAX
package's result: the compile cache's names, ``base``'s helpers, the op and
optimizer hooks, the metric's and the comm kernels' cache keys, and
``model.BASE_ESTIMATOR``."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu import base as jbase
from mxnet_tpu import comm as jcomm
from mxnet_tpu import metric as jmetric
from mxnet_tpu import model as jmodel
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import registry as jops
from mxnet_tpu.utils import compile as jcm
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import registry as tops
from mxnet_tpu_torch.utils import compile as tcm
from torch_ranks import small_net


def test_persistent_cache_names(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setitem(jcm._cache_state, "dir", None)
    assert tcm.DEFAULT_CACHE_DIR == jcm.DEFAULT_CACHE_DIR
    assert tcm.persistent_cache_dir() == jcm.persistent_cache_dir() is None
    assert tcm.maybe_enable_persistent_cache_from_env() == \
        jcm.maybe_enable_persistent_cache_from_env() is None


@pytest.mark.parametrize("value", [None, "", "0", "false", "OFF", "no", "1",
                                   "yes", "anything"])
@pytest.mark.parametrize("default", [True, False])
def test_env_bool(monkeypatch, value, default):
    if value is None:
        monkeypatch.delenv("MXTT_ENV_BOOL", raising=False)
    else:
        monkeypatch.setenv("MXTT_ENV_BOOL", value)
    assert tbase.env_bool("MXTT_ENV_BOOL", default) == \
        jbase.env_bool("MXTT_ENV_BOOL", default)


@pytest.mark.parametrize("name", ["float32", "float64", "float16", "uint8",
                                  "int32", "int8", "int64", "bool",
                                  "bfloat16"])
def test_dtype_codes(name):
    import ml_dtypes

    np_dtype = np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" \
        else np.dtype(name)
    code = jbase.dtype_code(np_dtype)
    assert tbase.dtype_code(getattr(torch, name)) == code
    assert tbase.dtype_code(np_dtype) == tbase.dtype_code(name) == code
    assert tbase.dtype_from_code(code) == getattr(torch, name)
    assert jbase.dtype_from_code(code).name == name
    with pytest.raises(tbase.MXNetError):
        tbase.dtype_from_code(99)


def test_error_alias_and_registry_names():
    assert tbase.MXNetTPUError is tbase.MXNetError
    assert jbase.MXNetTPUError is jbase.MXNetError
    assert topt.OPTIMIZERS.names() == jopt.OPTIMIZERS.names()
    assert tops.OPS.names() == jops.OPS.names()
    assert tmetric.METRICS.names() == jmetric.METRICS.names()


def test_op_num_inputs():
    tnodes = [n for n in small_net(mt)._topo() if not n.is_variable]
    jnodes = [n for n in small_net(mx)._topo() if not n.is_variable]
    assert [n.op.num_inputs() for n in tnodes] == \
        [n.op.num_inputs() for n in jnodes] == [3, 3, 1, 3, 2]


@pytest.mark.parametrize("mode", ["none", "bf16", "int8", "twobit"])
@pytest.mark.parametrize("devices", [1, 4])
def test_init_comm_residual(mode, devices):
    shapes = {"w": (37, 29), "b": (29,)}
    tparams = {k: torch.zeros(s) for k, s in shapes.items()}
    import jax.numpy as jnp

    jparams = {k: jnp.zeros(s) for k, s in shapes.items()}
    got = topt.create("sgd").init_comm_residual(tparams, mode, devices)
    want = jopt.create("sgd").init_comm_residual(jparams, mode, devices)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got.shape) == tuple(want.shape)
        assert not got.any() and got.dtype == torch.float32


@pytest.mark.parametrize("name,kwargs", [("accuracy", {}), ("ce", {}),
                                         ("top_k_accuracy", {"top_k": 3}),
                                         ("mse", {}), ("perplexity",
                                                       {"ignore_label": 0})])
def test_metric_device_key(name, kwargs):
    assert tmetric.create(name, **kwargs).device_key() == \
        jmetric.create(name, **kwargs).device_key()


@pytest.mark.parametrize("block", [None, 128])
def test_comm_kernel_config_key(block):
    assert tcomm.CommKernelConfig(block).key() == \
        jcomm.CommKernelConfig(block).key()


def test_base_estimator():
    assert tmodel.BASE_ESTIMATOR is jmodel.BASE_ESTIMATOR is object
    assert issubclass(mt.FeedForward, tmodel.BASE_ESTIMATOR)


# -- the analysis slice (ROADMAP C.1.8's names with A item 7) -------------------

# JAX-only names and the port's counterpart (ROADMAP C.2, "JAX-only names")
JAX_ONLY = {
    ("analysis", "audit_jaxpr"): ("analysis", "audit_program"),
    ("analysis", "audit_jaxpr_sharding"): ("analysis", "audit_step_program"),
    ("context.Context", "jax_device"): ("context.Context", "torch_device"),
    ("telemetry.mfu.MFUAccountant", "maybe_trace"):
        ("telemetry.mfu.MFUAccountant", "count_step"),
    ("utils.compile", "memory_plan_from_compiled"):
        ("utils.compile", "memory_plan_from_tensors"),
    ("telemetry.profiling", "hlo_texts_from_tracked"):
        ("telemetry.profiling", "parse_trace_dir"),
    ("telemetry.profiling", "hlo_op_metadata"):
        ("telemetry.profiling", "attribute_op_name"),
}
# the source passes' names (analysis/source_lint.py, concurrency.py and the
# command line): the JAX package's parameters
SOURCE_PASSES = ("lint_file", "lint_paths", "lint_source",
                 "concurrency_lint_paths", "concurrency_lint_source", "main")


def _resolve(pkg, dotted):
    import importlib

    obj, parts = pkg, dotted.split(".")
    for i, part in enumerate(parts):
        if not hasattr(obj, part):
            obj = importlib.import_module(
                f"{pkg.__name__}.{'.'.join(parts[:i + 1])}")
        else:
            obj = getattr(obj, part)
    return obj


def _analysis_names():
    import mxnet_tpu.analysis as jan

    return sorted(jan.__all__)


@pytest.mark.parametrize("name", _analysis_names())
def test_analysis_reexports(name):
    import mxnet_tpu_torch.analysis as tan

    if ("analysis", name) in JAX_ONLY:
        assert not hasattr(tan, name)
        where, other = JAX_ONLY[("analysis", name)]
        assert callable(getattr(_resolve(mt, where), other))
        return
    assert name in tan.__all__ and hasattr(tan, name)
    if name in SOURCE_PASSES:
        import inspect

        import mxnet_tpu.analysis as jan

        fn = getattr(tan, name)
        assert callable(fn)
        assert list(inspect.signature(fn).parameters) == \
            list(inspect.signature(getattr(jan, name)).parameters)


@pytest.mark.parametrize("where,name", sorted(
    k for k in JAX_ONLY if k[0] != "analysis"))
def test_jax_only_names_have_a_counterpart(where, name):
    assert hasattr(_resolve(mx, where), name)
    assert not hasattr(_resolve(mt, where), name)
    other_where, other = JAX_ONLY[(where, name)]
    assert hasattr(_resolve(mt, other_where), other)


def test_verify_and_dtype_inference_names():
    import inspect

    from mxnet_tpu.ops.tensor import EmbeddingOp as JEmbedding
    from mxnet_tpu_torch.ops.tensor import EmbeddingOp as TEmbedding

    for tfn, jfn in ((mt.symbol.Symbol.verify, mx.symbol.Symbol.verify),
                     (tops.OpProp.infer_dtype, jops.OpProp.infer_dtype),
                     (TEmbedding.infer_dtype, JEmbedding.infer_dtype)):
        assert list(inspect.signature(tfn).parameters) == \
            list(inspect.signature(jfn).parameters)
    # Embedding overrides the default, in both packages
    assert TEmbedding.infer_dtype is not tops.OpProp.infer_dtype
    assert JEmbedding.infer_dtype is not jops.OpProp.infer_dtype


def test_capi_methods_match():
    """The port's C API brain has exactly the JAX package's public methods
    (one per MX* entry point), so the C layer stays the same glue."""
    from mxnet_tpu import capi_support as jcapi
    from mxnet_tpu_torch import capi_support as tcapi

    def public(cls):
        return sorted(n for n in dir(cls) if not n.startswith("_"))

    assert public(tcapi.CApi) == public(jcapi.CApi)
    assert tcapi.__all__ == jcapi.__all__


@pytest.mark.parametrize("which", ["native_predict", "standalone"])
def test_predict_module_names(which):
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if which == "native_predict":
        from mxnet_tpu.native import predict as jmod
        from mxnet_tpu_torch.native import predict as tmod
    else:
        mods = []
        for path in (("predict", "python", "mxtpu_predict.py"),
                     ("mxnet_tpu_torch", "bindings", "mxtpu_predict.py")):
            spec = importlib.util.spec_from_file_location(
                f"names_{len(mods)}", os.path.join(root, *path))
            mods.append(importlib.util.module_from_spec(spec))
            spec.loader.exec_module(mods[-1])
        jmod, tmod = mods
    assert tmod.__all__ == jmod.__all__
    assert all(hasattr(tmod, n) for n in tmod.__all__)


def test_ledger_names_are_the_jax_packages():
    """``telemetry.ledger`` has the JAX module's public names, the bench
    writer's included, with the same trajectory file name and the same
    parameters."""
    import inspect

    from mxnet_tpu.telemetry import ledger as jledger
    from mxnet_tpu_torch.telemetry import ledger as tledger

    assert tledger.__all__ == jledger.__all__
    assert all(hasattr(tledger, n) for n in tledger.__all__)
    assert tledger.BENCH_LEDGER_NAME == jledger.BENCH_LEDGER_NAME
    assert list(inspect.signature(tledger.publish_bench).parameters) == \
        list(inspect.signature(jledger.publish_bench).parameters)
