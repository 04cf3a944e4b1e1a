"""Training forwards and backwards of the port's ops against the JAX
package's, on the same seeded inputs and cotangents.

The JAX side differentiates its op's ``fwd(..., is_train=True)`` with
``jax.vjp`` (its hand-written ``custom_vjp`` rules where it has them); the
port runs ``torch.autograd.grad`` through its ``autograd.Function``s and
autograd. TF32 is off on the torch side.

Tolerances: the injected loss gradients are one subtract and one multiply
from the forward's output, within 1e-6 (the softmax's exp and sum round in
another order). BatchNorm's statistics and backward sum over the batch in another
order (XLA against ATen) and XLA on the CPU contracts some multiply-adds, so
they are held to 1e-5 relative (about 100 f32 ulps; the per-channel sums
over 50 elements each move a few ulps and the backward subtracts two of
them). Dropout draws other bits in torch than in JAX, so it is held by its
moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import OPS as JOPS
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import set_matmul_precision
from mxnet_tpu_torch.ops import OPS as TOPS

torch.set_num_threads(1)
set_matmul_precision("highest")

EXACT = dict(rtol=0, atol=0)
BN_TOL = dict(rtol=1e-5, atol=1e-5)


def _arr(shape, seed, positive=False):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


def _train_both(op, params, ins, aux=(), method="fwd", diff=None, cot_seed=9):
    """Outputs, new aux and input gradients of ``method`` in training mode
    in both packages, for a random cotangent on output 0. ``diff`` lists
    the input indices to differentiate (default: all)."""
    diff = list(range(len(ins))) if diff is None else diff
    jop, top = JOPS.create(op, **params), TOPS.create(op, **params)
    j_ins = [jnp.asarray(a) for a in ins]
    j_aux = [jnp.asarray(a) for a in aux]

    def f(*d):
        full = list(j_ins)
        for i, v in zip(diff, d):
            full[i] = v
        outs, new_aux = getattr(jop, method)(full, j_aux, True, None)
        return outs[0], new_aux

    (j_out, j_new_aux), vjp = jax.vjp(f, *[j_ins[i] for i in diff])
    cot = _arr(j_out.shape, cot_seed)
    j_grads = vjp((jnp.asarray(cot), jax.tree_util.tree_map(jnp.zeros_like,
                                                            j_new_aux)))
    t_ins = [torch.from_numpy(a.copy()) for a in ins]
    for i in diff:
        t_ins[i].requires_grad_(True)
    outs, t_new_aux = getattr(top, method)(
        t_ins, [torch.from_numpy(a.copy()) for a in aux], True, None)
    t_grads = [None] * len(diff)
    if outs[0].requires_grad:  # BlockGrad's output is cut from the graph
        t_grads = torch.autograd.grad(outs[0], [t_ins[i] for i in diff],
                                      torch.from_numpy(cot), allow_unused=True)
    t_grads = [np.zeros(ins[i].shape, np.float32) if g is None else g.numpy()
               for i, g in zip(diff, t_grads)]
    return ((np.asarray(j_out), [np.asarray(a) for a in j_new_aux],
             [np.asarray(g) for g in j_grads]),
            (outs[0].detach().numpy(), [a.numpy() for a in t_new_aux], t_grads))


def _check(j, t, tol):
    for a, b in zip([t[0], *t[1], *t[2]], [j[0], *j[1], *j[2]]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


def _bn_case(shape, axis):
    ch = shape[1] if len(shape) == 2 else shape[axis % len(shape)]
    ins = [_arr(shape, 0) * 2 + 0.3, _arr((ch,), 1), _arr((ch,), 2)]
    aux = [_arr((ch,), 3), _arr((ch,), 4, positive=True)]
    return ins, aux


BN_CASES = [((2, 4, 5, 5), 1), ((2, 5, 5, 4), 3), ((2, 5, 5, 4), -1),
            ((6, 4), 1)]


@pytest.mark.parametrize("shape,axis", BN_CASES)
@pytest.mark.parametrize("method", ["fwd", "fwd_fused_relu"])
def test_batchnorm_train_forward_stats_and_backward(shape, axis, method):
    """Batch statistics, the running-stat update and the backward of
    ``_bn_act_train`` (relu off: ``fwd``; on: ``fwd_fused_relu``)."""
    ins, aux = _bn_case(shape, axis)
    j, t = _train_both("BatchNorm", {"axis": axis, "eps": 1e-5}, ins, aux,
                       method=method)
    _check(j, t, BN_TOL)
    # the running stats really moved, towards the batch statistics
    assert not np.allclose(t[1][0], aux[0])


@pytest.mark.parametrize("shape,axis", [((2, 4, 5, 5), 1), ((2, 5, 5, 4), 3)])
def test_batchnorm_add_relu_train_backward(shape, axis):
    """``_bn_add_relu_train``: gradients of x, gamma, beta and the shortcut."""
    ins, aux = _bn_case(shape, axis)
    z = _arr(shape, 5)
    j, t = _train_both("BatchNorm", {"axis": axis, "eps": 1e-5}, ins + [z],
                       aux, method="fwd_fused_add_relu")
    _check(j, t, BN_TOL)


def test_batchnorm_fix_gamma_gives_gamma_no_gradient():
    ins, aux = _bn_case((2, 4, 3, 3), 1)
    j, t = _train_both("BatchNorm", {"fix_gamma": True}, ins, aux)
    _check(j, t, BN_TOL)
    assert not t[2][1].any() and not j[2][1].any()


def test_batchnorm_eval_leaves_running_stats():
    ins, aux = _bn_case((2, 4, 3, 3), 1)
    top = TOPS.create("BatchNorm")
    _, new_aux = top.fwd([torch.from_numpy(a) for a in ins],
                         [torch.from_numpy(a) for a in aux], False, None)
    for a, b in zip(new_aux, aux):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("shape,params", [
    ((5, 7), {}), ((5, 7), {"grad_scale": 0.25}), ((2, 3, 4, 4), {}),
    ((2, 3, 4), {"multi_output": True})])
def test_softmax_output_injected_gradient(shape, params):
    """``(p - onehot) * grad_scale``, whatever the cotangent; the label's
    gradient is zero."""
    top = TOPS.create("SoftmaxOutput", **params)
    label_shape = top.infer_shape([shape])[0][1]
    n_cls = shape[1] if len(shape) > 2 else shape[-1]
    label = np.random.default_rng(3).integers(0, n_cls, label_shape)
    ins = [_arr(shape, 0) * 3, label.astype(np.float32)]
    j, t = _train_both("SoftmaxOutput", params, ins, diff=[0, 1])
    _check(j, t, dict(rtol=1e-6, atol=1e-7))
    assert not t[2][1].any()


def test_softmax_output_masked_gradient():
    """Padded rows (mask 0) inject no gradient (fwd_masked)."""
    x, label = _arr((6, 5), 0), np.array([0, 1, 2, 3, 4, 0], np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    jop = JOPS.create("SoftmaxOutput")
    top = TOPS.create("SoftmaxOutput")
    _, vjp = jax.vjp(lambda d: jop.fwd_masked(
        [d, jnp.asarray(label)], [], True, None, jnp.asarray(mask))[0][0],
        jnp.asarray(x))
    want = np.asarray(vjp(jnp.ones((6, 5), jnp.float32))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    out = top.fwd_masked([xt, torch.from_numpy(label)], [], True, None,
                         torch.from_numpy(mask))[0][0]
    (got,) = torch.autograd.grad(out, xt, torch.ones(6, 5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[4:].any()


def test_softmax_loss_value_matches_jax():
    x, label = _arr((6, 5), 0), np.array([0, 1, 2, 3, 4, 0], np.float32)
    mask = np.array([1, 1, 1, 0, 1, 1], np.float32)
    jop = JOPS.create("SoftmaxOutput", grad_scale=0.5)
    top = TOPS.create("SoftmaxOutput", grad_scale=0.5)
    p = jax.nn.softmax(jnp.asarray(x), axis=-1)
    for m in (None, mask):
        want = jop.loss_value(p, jnp.asarray(label),
                              None if m is None else jnp.asarray(m))
        got = top.loss_value(torch.from_numpy(np.array(p)),
                             torch.from_numpy(label),
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "LogisticRegressionOutput",
                                "MAERegressionOutput"])
@pytest.mark.parametrize("grad_scale", [1.0, 3.0])
def test_regression_heads_injected_gradient_and_loss(op, grad_scale):
    """``pred - label`` (sign for MAE), the cotangent ignored. In the JAX
    package ``grad_scale`` scales only ``loss_value``: its gradient scaler
    feeds a backward that discards its cotangent. The port keeps that."""
    params = {"grad_scale": grad_scale}
    ins = [_arr((5, 3), 0), _arr((5, 3), 1)]
    j, t = _train_both(op, params, ins, diff=[0, 1])
    _check(j, t, dict(rtol=1e-6, atol=1e-7))
    jop, top = JOPS.create(op, **params), TOPS.create(op, **params)
    want = jop.loss_value(jnp.asarray(j[0]), jnp.asarray(ins[1]))
    got = top.loss_value(torch.from_numpy(t[0]), torch.from_numpy(ins[1]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_block_grad_stops_the_gradient():
    j, t = _train_both("BlockGrad", {}, [_arr((3, 4), 0)])
    _check(j, t, EXACT)
    assert not t[2][0].any()


AUTOGRAD_CASES = [
    ("FullyConnected", {"num_hidden": 7}, [(5, 3, 4), (7, 12), (7,)]),
    ("Convolution", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                     "num_filter": 6}, [(2, 4, 9, 9), (6, 4, 3, 3), (6,)]),
    ("Convolution", {"kernel": (1, 1), "stride": (2, 2), "num_filter": 6,
                     "no_bias": True, "layout": "NHWC"},
     [(2, 9, 9, 4), (6, 4, 1, 1)]),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pool_type": "max"}, [(2, 3, 9, 8)]),
    ("Pooling", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                 "pool_type": "avg"}, [(2, 3, 9, 8)]),
    ("Pooling", {"kernel": (7, 7), "pool_type": "avg", "global_pool": True},
     [(2, 3, 7, 7)]),
    ("Activation", {"act_type": "relu"}, [(4, 5, 6)]),
    ("Activation", {"act_type": "sigmoid"}, [(4, 5, 6)]),
    ("Activation", {"act_type": "tanh"}, [(4, 5, 6)]),
    ("Activation", {"act_type": "softrelu"}, [(4, 5, 6)]),
    ("_Plus", {}, [(3, 4), (3, 4)]),
    ("_Mul", {}, [(3, 4), (3, 4)]),
    ("Concat", {"num_args": 2, "dim": 1}, [(2, 3, 4), (2, 5, 4)]),
    ("Flatten", {}, [(2, 3, 4, 5)]),
]


@pytest.mark.parametrize("op,params,shapes", AUTOGRAD_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(AUTOGRAD_CASES)])
def test_autograd_gradients_match_jax(op, params, shapes):
    """Ops without a hand-written backward: autograd against jax.vjp."""
    ins = [_arr(s, i) for i, s in enumerate(shapes)]
    j, t = _train_both(op, params, ins)
    _check(j, t, dict(rtol=1e-5, atol=2e-6))


def test_dropout_train_mask_by_moments():
    """Inverted dropout: a fraction p of units drops, the rest scale by
    1/(1-p), the mean stays; torch and JAX draw different bits, so the
    port is held by moments and to itself under the same seed."""
    top = TOPS.create("Dropout", p=0.3)
    x = torch.ones(200, 500)
    trandom.seed(7)
    (y,), _ = top.fwd([x], [], True, trandom.generator("cpu"))
    kept = y != 0
    assert abs(1 - kept.float().mean().item() - 0.3) < 0.01  # 100k draws
    assert torch.all(y[kept] == torch.tensor(1 / 0.7, dtype=torch.float32))
    assert abs(y.mean().item() - 1.0) < 0.015
    trandom.seed(7)
    (y2,), _ = top.fwd([x], [], True, trandom.generator("cpu"))
    assert torch.equal(y, y2)
    (y_eval,), _ = top.fwd([x], [], False, None)
    assert torch.equal(y_eval, x)
    # the JAX package's mask has the same moments
    jop = JOPS.create("Dropout", p=0.3)
    (yj,), _ = jop.fwd([jnp.ones((200, 500))], [], True, jax.random.PRNGKey(0))
    assert abs(float((np.asarray(yj) != 0).mean()) - 0.7) < 0.01
