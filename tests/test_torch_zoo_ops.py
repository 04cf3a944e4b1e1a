"""The zoo's remaining ops in the port against the JAX package's: the unary
ops, Embedding, LRN, LeakyReLU and Deconvolution, forward and input
gradients, on the same seeded inputs and cotangents.

The JAX side differentiates its op's ``fwd`` with ``jax.vjp``; the port
runs ``torch.autograd.grad``. TF32 is off on the torch side.

Tolerances: ``square``, ``abs``, Embedding's gather and the ``leaky`` /
``prelu`` / ``rrelu`` selections are exact (one rounding each, the same
in both), and so are their gradients but prelu's gamma sum; ``sqrt``,
``exp``, ``log`` and ``elu`` go through each library's own math functions,
a few ulps apart: 1e-6 relative; sums over a window, the batch or a
convolution's taps add in another order (XLA against ATen): 1e-5 relative
with a floor of 1e-6 of the array's largest magnitude, for elements whose
terms cancel (LRN, norm, prelu's gamma, Deconvolution). rrelu draws
its slopes from other bits in torch than in JAX, so in training mode only
the slopes' range is held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import OPS as JOPS
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import OPS as TOPS

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

EXACT = dict(rtol=0, atol=0)
ULPS = dict(rtol=1e-6, atol=1e-7)
SUMS = dict(rtol=1e-5, atol=1e-6)


def _arr(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _both(op, params, ins, diff, is_train=False):
    """Output 0 and the gradients of inputs ``diff`` for a seeded cotangent,
    in both packages (``is_train`` as given, no rng)."""
    jop, top = JOPS.create(op, **params), TOPS.create(op, **params)
    j_ins = [jnp.asarray(a) for a in ins]

    def f(*d):
        full = list(j_ins)
        for i, v in zip(diff, d):
            full[i] = v
        return jop.fwd(full, [], is_train, None)[0][0]

    j_out, vjp = jax.vjp(f, *[j_ins[i] for i in diff])
    cot = _arr(j_out.shape, 99)
    j_grads = vjp(jnp.asarray(cot)) if diff else []
    t_ins = [torch.from_numpy(a.copy()) for a in ins]
    for i in diff:
        t_ins[i].requires_grad_(True)
    t_out = top.fwd(t_ins, [], is_train, None)[0][0]
    t_grads = torch.autograd.grad(t_out, [t_ins[i] for i in diff],
                                  torch.from_numpy(cot)) if diff else []
    return ((np.asarray(j_out), [np.asarray(g) for g in j_grads]),
            (t_out.detach().numpy(), [g.numpy() for g in t_grads]))


def _close(got, want, tol):
    assert got.shape == want.shape
    if tol is SUMS:
        tol = dict(rtol=SUMS["rtol"], atol=SUMS["atol"] * max(
            1.0, float(np.abs(want).max())))
    np.testing.assert_allclose(got, want, **tol)


def _check(j, t, tol, grad_tol=None):
    _close(t[0], j[0], tol)
    for a, b in zip(t[1], j[1]):
        _close(a, b, grad_tol or tol)


@pytest.mark.parametrize("op,tol,lo", [
    ("square", EXACT, None), ("abs", EXACT, None), ("sqrt", ULPS, 0.1),
    ("exp", ULPS, None), ("log", ULPS, 0.1), ("norm", SUMS, None)])
def test_unary_ops_match_jax(op, tol, lo):
    x = _arr((3, 4, 5), 0, lo, None if lo is None else 4.0)
    j, t = _both(op, {}, [x], [0])
    _check(j, t, tol, SUMS if op == "norm" else tol)
    if op == "norm":
        assert t[0].shape == (1,)


def test_unary_ops_infer_shape():
    for op in ("square", "sqrt", "exp", "log", "abs", "norm"):
        assert TOPS.create(op).infer_shape([(2, 3)]) == \
            JOPS.create(op).infer_shape([(2, 3)])


def test_embedding_repeated_ids_match_jax():
    """Repeated ids gather the same row and add their gradients into it;
    fractional ids truncate as ``astype(int32)``."""
    ids = np.array([[3, 1, 3], [0, 3, 6]], np.float32)
    ids[1, 2] = 6.7
    w = _arr((7, 5), 1)
    params = {"input_dim": 7, "output_dim": 5}
    j, t = _both("Embedding", params, [ids, w], [1])
    _check(j, t, EXACT, SUMS)
    assert np.count_nonzero(t[1][0][3]) == 5  # three cotangent rows summed
    assert TOPS.create("Embedding", **params).infer_shape([(2, 3), None]) == \
        JOPS.create("Embedding", **params).infer_shape([(2, 3), None])


@pytest.mark.parametrize("nsize", [3, 4, 5])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_lrn_matches_jax(nsize, dtype):
    """Odd and even windows (padding (half, nsize - 1 - half)); bf16 inputs
    sum in f32 and round once, as the JAX package does."""
    x = _arr((2, 7, 4, 3), 2) * 3
    params = {"nsize": nsize, "alpha": 1e-2, "beta": 0.75, "knorm": 2.0}
    if dtype == "bfloat16":
        jop, top = JOPS.create("LRN", **params), TOPS.create("LRN", **params)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = top.fwd([xb], [], False, None)[0][0]
        want = jop.fwd([jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)],
                       [], False, None)[0][0]
        assert got.dtype == torch.bfloat16
        # the f32 results agree within SUMS; one bf16 rounding apart at most
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=2 ** -8, atol=0)
        return
    j, t = _both("LRN", params, [x], [0])
    _check(j, t, SUMS)


@pytest.mark.parametrize("act,tol", [("leaky", EXACT), ("elu", ULPS),
                                     ("rrelu", EXACT)])
def test_leaky_relu_matches_jax(act, tol):
    """``leaky`` and ``elu`` at slope 0.1; ``rrelu`` at inference (its mean
    slope)."""
    x = _arr((3, 4, 5), 3)
    x[0, 0, 0] = 0.0  # the boundary takes the slope branch in both
    j, t = _both("LeakyReLU", {"act_type": act, "slope": 0.1}, [x], [0])
    _check(j, t, tol)


def test_prelu_matches_jax():
    x = _arr((3, 4, 5, 2), 4)
    gamma = _arr((4,), 5, 0.05, 0.5)
    j, t = _both("LeakyReLU", {"act_type": "prelu"}, [x, gamma], [0, 1])
    _check(j, t, EXACT, SUMS)
    assert TOPS.create("LeakyReLU", act_type="prelu").list_arguments() == \
        ["data", "gamma"]
    assert TOPS.create("LeakyReLU", act_type="prelu").infer_shape(
        [(3, 4, 5, 2), None]) == ([(3, 4, 5, 2), (4,)], [(3, 4, 5, 2)], [])


def test_rrelu_train_slopes_in_range_and_from_the_generator():
    op = TOPS.create("LeakyReLU", act_type="rrelu", lower_bound=0.1,
                     upper_bound=0.3)
    x = -torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    y = op.fwd([x], [], True, gen)[0][0]
    slopes = -y.numpy()
    assert slopes.min() >= 0.1 and slopes.max() < 0.3
    assert abs(slopes.mean() - 0.2) < 0.01 and slopes.std() > 0.05
    again = op.fwd([x], [], True, torch.Generator().manual_seed(0))[0][0]
    assert torch.equal(y, again)
    pos = torch.ones(5)
    assert torch.equal(op.fwd([pos], [], True, gen)[0][0], pos)


DECONV_CASES = [
    dict(kernel=(3, 3), num_filter=4),
    dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=3),
    dict(kernel=(3, 3), stride=(2, 2), num_filter=6, num_group=2,
         no_bias=False),
    dict(kernel=(3, 2), stride=(2, 1), pad=(1, 0), num_filter=4,
         layout="NHWC"),
]


@pytest.mark.parametrize("params", DECONV_CASES)
def test_deconvolution_matches_jax(params):
    """Values, data/weight/bias gradients and shape inference, with
    stride, pad, groups, a bias and NHWC."""
    nhwc = params.get("layout") == "NHWC"
    shape = (2, 5, 4, 4) if nhwc else (2, 4, 5, 4)
    top = TOPS.create("Deconvolution", **params)
    in_shapes, out_shapes, _ = top.infer_shape([shape, None, None][
        :len(top.list_arguments())])
    assert (in_shapes, out_shapes) == JOPS.create(
        "Deconvolution", **params).infer_shape(
            [shape] + [None] * (len(in_shapes) - 1))[:2]
    ins = [_arr(s, 10 + i) for i, s in enumerate(in_shapes)]
    j, t = _both("Deconvolution", params, ins, list(range(len(ins))))
    assert t[0].shape == tuple(out_shapes[0])
    _check(j, t, SUMS)


@pytest.mark.parametrize("case", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1)),
    dict(kernel=(3, 3), stride=(3, 2), pad=(2, 1), adj=(2, 1),
         num_group=2),
    dict(kernel=(4, 4), stride=(2, 2), target_shape=(10, 9)),
    dict(kernel=(5, 3), stride=(2, 2), target_shape=(12, 8), num_group=2),
])
def test_deconvolution_adj_and_target_shape(case):
    """``adj`` and ``target_shape``, which the JAX package's Deconvolution
    lacks: the output is the JAX package's unpadded output (pad 0) cut to
    rows ``[pad, full - pad + adj)``, with ``pad = ceil(total / 2)`` and
    ``adj = total % 2`` of ``total = full - target`` for a target shape;
    values and gradients against that cut, and the inferred shape."""
    x = _arr((2, 4, 5, 4), 20)
    top = TOPS.create("Deconvolution", num_filter=6, **case)
    in_shapes, out_shapes, _ = top.infer_shape([x.shape, None])
    w = _arr(in_shapes[1], 21)
    stride, kernel = case["stride"], case["kernel"]
    full = [s * (n - 1) + k for s, n, k in zip(stride, x.shape[2:], kernel)]
    if "target_shape" in case:
        totals = [f - t for f, t in zip(full, case["target_shape"])]
        pad = [(t + 1) // 2 for t in totals]
        adj = [t % 2 for t in totals]
        assert tuple(out_shapes[0][2:]) == case["target_shape"]
    else:
        pad, adj = case["pad"], case["adj"]
    cut = tuple(slice(p, f - p + a) for p, f, a in zip(pad, full, adj))
    jop = JOPS.create("Deconvolution", num_filter=6, kernel=kernel,
                      stride=stride, num_group=case.get("num_group", 1))

    def j_fwd(xx, ww):
        return jop.fwd([xx, ww], [], False, None)[0][0][(Ellipsis,) + cut]

    j_out, vjp = jax.vjp(j_fwd, jnp.asarray(x), jnp.asarray(w))
    cot = _arr(j_out.shape, 22)
    j_grads = vjp(jnp.asarray(cot))
    t_ins = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, w)]
    t_out = top.fwd(t_ins, [], False, None)[0][0]
    assert tuple(t_out.shape) == tuple(out_shapes[0]) == j_out.shape
    t_grads = torch.autograd.grad(t_out, t_ins, torch.from_numpy(cot))
    _check((np.asarray(j_out), [np.asarray(g) for g in j_grads]),
           (t_out.detach().numpy(), [g.numpy() for g in t_grads]), SUMS)


def test_deconvolution_serializes_for_the_jax_package():
    """Default ``adj``/``target_shape`` stay out of the JSON, so the JAX
    package loads the graph; set, they are kept and load in the port."""
    import mxnet_tpu as mx

    net = mt.sym.Deconvolution(data=mt.sym.Variable("data"), kernel=(3, 3),
                               stride=(2, 2), num_filter=4, name="d")
    back = mx.sym.load_json(net.tojson())
    assert back.infer_shape(data=(1, 2, 5, 5))[1] == \
        net.infer_shape(data=(1, 2, 5, 5))[1]
    adj = mt.sym.Deconvolution(data=mt.sym.Variable("data"), kernel=(3, 3),
                               stride=(2, 2), adj=(1, 1), num_filter=4)
    assert mt.sym.load_json(adj.tojson()).infer_shape(
        data=(1, 2, 5, 5))[1] == [(1, 4, 12, 12)]
    with pytest.raises(MXNetError, match="below the stride"):
        TOPS.create("Deconvolution", kernel=(3, 3), adj=(1, 1),
                    num_filter=2).infer_shape([(1, 2, 5, 5), None])
