"""Per-op inference forward parity: the port's OpProps against the JAX
package's, on the same seeded inputs, with the same parameters.

Tolerances: elementwise and structural ops are exact. Products, convolutions,
pooling sums and BatchNorm's rsqrt sum or round in another order or library
(XLA against oneDNN/ATen), so they are held to a few f32 ulps of the output's
scale. TF32 is off on the torch side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import OPS as JOPS
from mxnet_tpu.ops.pallas.matmul import int8_predict_scope as jax_int8_scope
from mxnet_tpu_torch.kernels.int8_matmul import int8_predict_scope
from mxnet_tpu_torch.base import set_matmul_precision
from mxnet_tpu_torch.ops import OPS as TOPS

torch.set_num_threads(2)
set_matmul_precision("highest")

EXACT = dict(rtol=0, atol=0)
CLOSE = dict(rtol=1e-5, atol=1e-6)


def _arr(shape, seed, positive=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _run_both(op, params, ins, aux=(), method="fwd"):
    jop, top = JOPS.create(op, **params), TOPS.create(op, **params)
    shapes = [tuple(a.shape) for a in ins]
    j_shapes = jop.infer_shape(list(shapes))
    t_shapes = top.infer_shape(list(shapes))
    assert [[tuple(s) for s in group] for group in t_shapes] == \
        [[tuple(s) for s in group] for group in j_shapes]
    j_outs, _ = getattr(jop, method)([jnp.asarray(a) for a in ins],
                                     [jnp.asarray(a) for a in aux], False, None)
    t_outs, _ = getattr(top, method)([torch.from_numpy(a) for a in ins],
                                     [torch.from_numpy(a) for a in aux],
                                     False, None)
    assert len(t_outs) == len(j_outs)
    return [np.asarray(o) for o in j_outs], [o.numpy() for o in t_outs]


def _check(op, params, ins, aux=(), tol=CLOSE, method="fwd"):
    j_outs, t_outs = _run_both(op, params, ins, aux, method)
    for j, t in zip(j_outs, t_outs):
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, **tol)


@pytest.mark.parametrize("op", ["_Plus", "_Minus", "_Mul", "_Div"])
def test_binary(op):
    _check(op, {}, [_arr((3, 4, 5), 0), _arr((3, 4, 5), 1, positive=True)],
           tol=EXACT)


STRUCTURAL = [
    ("ElementWiseSum", {"num_args": 3}, [(2, 3, 4)] * 3),
    ("Concat", {"num_args": 2, "dim": 1}, [(2, 3, 4), (2, 5, 4)]),
    ("Concat", {"num_args": 2, "dim": 0}, [(2, 3), (4, 3)]),
    ("SliceChannel", {"num_outputs": 2}, [(2, 6, 3)]),
    ("SliceChannel", {"num_outputs": 3, "axis": 2, "squeeze_axis": True},
     [(2, 4, 3)]),
    ("Reshape", {"target_shape": (0, -1)}, [(2, 3, 4)]),
    ("Reshape", {"target_shape": "(4, -1, 3)"}, [(2, 3, 4)]),
    ("Flatten", {}, [(2, 3, 4, 5)]),
    ("BlockGrad", {}, [(2, 3)]),
    ("Transpose", {}, [(2, 3, 4)]),
    ("Transpose", {"axes": (0, 2, 1, 3)}, [(2, 3, 4, 5)]),
    ("Dropout", {"p": 0.5}, [(4, 8)]),
]


@pytest.mark.parametrize("op,params,shapes", STRUCTURAL,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(STRUCTURAL)])
def test_structural_exact(op, params, shapes):
    _check(op, params, [_arr(s, i) for i, s in enumerate(shapes)], tol=EXACT)


@pytest.mark.parametrize("no_bias", [False, True])
def test_fully_connected(no_bias):
    ins = [_arr((5, 3, 4), 0), _arr((7, 12), 1)] + ([] if no_bias else
                                                    [_arr((7,), 2)])
    _check("FullyConnected", {"num_hidden": 7, "no_bias": no_bias}, ins)


@pytest.mark.parametrize("no_bias", [True, False])
def test_fully_connected_int8_route(no_bias):
    """Under the int8 scope both route FC through their int8 kernel. The JAX
    forward runs compiled, as its Predictor runs it (the scope is read when
    it traces). Without a bias the two agree bitwise. With one, XLA on the
    CPU contracts the kernel's last multiply and the bias add into a fused
    multiply-add, which rounds once where the port rounds twice: one ulp."""
    params = {"num_hidden": 9, "no_bias": no_bias}
    ins = [_arr((6, 40), 0), _arr((9, 40), 1)] + ([] if no_bias else
                                                  [_arr((9,), 2)])
    jop, top = JOPS.create("FullyConnected", **params), \
        TOPS.create("FullyConnected", **params)
    with jax_int8_scope():
        y_j = jax.jit(lambda *a: jop.fwd(list(a), [], False, None)[0][0])(
            *[jnp.asarray(a) for a in ins])
    with int8_predict_scope():
        y_t = top.fwd([torch.from_numpy(a) for a in ins], [], False,
                      None)[0][0]
    tol = EXACT if no_bias else dict(rtol=2.5e-7, atol=1e-7)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **tol)
    y_f32 = top.fwd([torch.from_numpy(a) for a in ins], [], False, None)[0][0]
    assert not torch.equal(y_t, y_f32)  # the scope really switched routes


CONVS = [
    ("NCHW", {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6,
              "no_bias": True}),
    ("NCHW", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "num_filter": 6}),
    ("NCHW", {"kernel": (3, 3), "dilate": (2, 2), "pad": (2, 2),
              "num_filter": 4, "no_bias": True}),
    ("NCHW", {"kernel": (3, 3), "num_filter": 6, "num_group": 2}),
    ("NCHW", {"kernel": (1, 1), "stride": (2, 2), "num_filter": 6,
              "no_bias": True}),
    ("NCHW", {"kernel": (7, 7), "stride": (2, 2), "pad": (3, 3),
              "num_filter": 5, "no_bias": True}),
    ("NHWC", {"kernel": (3, 3), "pad": (1, 1), "num_filter": 6}),
    ("NHWC", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
              "num_filter": 6, "no_bias": True}),
    # pointwise NHWC convs: the strided slice + matmul path
    ("NHWC", {"kernel": (1, 1), "stride": (2, 2), "num_filter": 6,
              "no_bias": True}),
    ("NHWC", {"kernel": (1, 1), "num_filter": 6}),
]


@pytest.mark.parametrize("layout,params", CONVS,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONVS)])
def test_convolution(layout, params):
    params = dict(params, layout=layout)
    x = (2, 4, 9, 9) if layout == "NCHW" else (2, 9, 9, 4)
    top = TOPS.create("Convolution", **params)
    w_shape, *b_shape = top.infer_shape([x])[0][1:]
    ins = [_arr(x, 0), _arr(w_shape, 1)] + [_arr(s, 2) for s in b_shape]
    _check("Convolution", params, ins, tol=dict(rtol=1e-5, atol=2e-6))


POOLS = [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg"},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum"},
    # padding above half the kernel: explicit padding in the port
    {"kernel": (3, 3), "pad": (2, 2), "pool_type": "max"},
    {"kernel": (3, 3), "pad": (2, 2), "pool_type": "avg"},
    {"kernel": (7, 7), "pool_type": "avg", "global_pool": True},
    {"kernel": (1, 1), "pool_type": "max", "global_pool": True},
]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("params", POOLS, ids=[str(i) for i in range(len(POOLS))])
def test_pooling(layout, params):
    x = (2, 3, 9, 8) if layout == "NCHW" else (2, 9, 8, 3)
    tol = EXACT if params["pool_type"] == "max" else CLOSE
    _check("Pooling", dict(params, layout=layout), [_arr(x, 0)], tol=tol)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu"])
def test_activation(act):
    x = _arr((4, 5, 6), 0) * 8  # reaches softrelu's large-|x| tails
    _check("Activation", {"act_type": act}, [x])


def _bn_case(shape, axis):
    ch = shape[1] if len(shape) == 2 else shape[axis % len(shape)]
    ins = [_arr(shape, 0), _arr((ch,), 1), _arr((ch,), 2)]
    aux = [_arr((ch,), 3), _arr((ch,), 4, positive=True)]
    return ins, aux


BN_CASES = [((2, 4, 5, 5), 1), ((2, 5, 5, 4), 3), ((2, 5, 5, 4), -1),
            ((6, 4), 1)]


@pytest.mark.parametrize("shape,axis", BN_CASES)
@pytest.mark.parametrize("method", ["fwd", "fwd_fused_relu"])
def test_batchnorm_eval(shape, axis, method):
    ins, aux = _bn_case(shape, axis)
    _check("BatchNorm", {"axis": axis, "eps": 1e-5}, ins, aux, method=method)


def test_batchnorm_fix_gamma():
    ins, aux = _bn_case((2, 4, 3, 3), 1)
    _check("BatchNorm", {"fix_gamma": True}, ins, aux)


@pytest.mark.parametrize("shape,axis", BN_CASES[:2])
def test_batchnorm_fused_add_relu(shape, axis):
    ins, aux = _bn_case(shape, axis)
    z = _arr(shape, 5)
    _check("BatchNorm", {"axis": axis, "eps": 1e-5}, ins + [z], aux,
           method="fwd_fused_add_relu")


@pytest.mark.parametrize("shape,params", [
    ((5, 7), {}), ((2, 3, 4, 4), {}), ((2, 3, 4), {"multi_output": True})])
def test_softmax_output(shape, params):
    top = TOPS.create("SoftmaxOutput", **params)
    label_shape = top.infer_shape([shape])[0][1]
    _check("SoftmaxOutput", params, [_arr(shape, 0) * 3, _arr(label_shape, 1)])


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "LogisticRegressionOutput",
                                "MAERegressionOutput"])
def test_regression_heads(op):
    _check(op, {}, [_arr((5, 3), 0), _arr((5, 3), 1)])


def test_unknown_op_params_rejected_like_jax():
    from mxnet_tpu_torch.base import MXNetError

    with pytest.raises(MXNetError, match="unknown parameter"):
        TOPS.create("Convolution", kernel=(3, 3), num_filter=2, bogus=1)
    with pytest.raises(MXNetError, match="required"):
        TOPS.create("FullyConnected")
