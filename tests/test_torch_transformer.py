"""The port's transformer LM against the JAX package's.

Both packages get the same numpy-seeded parameters (every leaf random,
norm scales and biases included) and tokens, at a tiny width: vocab 64,
d_model 32, 4 heads of 8, 2 layers, sequence 48 (not a whole 64-row tile).
The JAX side runs its flash kernels in interpret mode where the test asks for
``attn_impl="flash"``, and the dense reference elsewhere; the port's CPU
tensors take the kernels' plain versions.

Tolerances. In f32 the two differ by summation order only: logits within
1e-5, losses within 1e-5 relative, and parameters after 3 steps within
1e-6 of each leaf's largest value for SGD (measured 6e-8) and 5e-5 for Adam
and AdamW, whose update divides by sqrt(v) and so scales a gradient's last
bits up to the step size (measured 6.4e-6). In bf16 XLA rounds its
elementwise ops (layernorm output, gelu, residual adds) at other points than
ATen: the logits of 2 layers agree within 0.05 (1.5% of their range;
measured 0.023).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models.transformer import TransformerLM as JaxLM
from mxnet_tpu.models.transformer import transformer_lm_config as jax_config
from mxnet_tpu_torch import cpu
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import transformer_params_from_numpy
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.lr_scheduler import FactorScheduler
from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config
from mxnet_tpu_torch.base import set_matmul_precision
from mxnet_tpu_torch.parallel.tensor_parallel import (column_parallel_f32,
                                                     split_cotangent,
                                                     wide_product)

set_matmul_precision("highest")  # f32 contractions held to f32 references

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=64)
BATCH, SEQ = 2, 48
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _params(seed=0):
    shapes = JaxLM(jax_config(**CFG)).init_shapes()
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):   # jit hands dicts back with keys sorted
        shape = shapes[name]
        if name in ("embed", "pos_embed"):
            v = rng.randn(*shape) * 0.3
        elif name.endswith("_scale"):
            v = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 1:
            v = rng.randn(*shape) * 0.1
        else:
            v = rng.randn(*shape) / np.sqrt(shape[0])
        out[name] = v.astype(np.float32)
    return out


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32),
            rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32))


def _models(dtype="f32", attn_impl="dense", **extra):
    jd, td = DTYPES[dtype]
    return (JaxLM(jax_config(**CFG, dtype=jd, attn_impl=attn_impl, **extra)),
            TransformerLM(transformer_config(td, attn_impl, **extra)))


def transformer_config(dtype, attn_impl, **extra):
    return transformer_lm_config(**CFG, dtype=dtype, attn_impl=attn_impl,
                                 **extra)


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_forward_and_loss_match_jax(attn_impl):
    jm, tm = _models(attn_impl=attn_impl)
    params = _params()
    tokens, targets = _batch()
    jp = _jax_params(params)
    want = np.asarray(jax.jit(jm.forward)(jp, jnp.asarray(tokens)))
    want_loss = float(jax.jit(jm.loss)(jp, jnp.asarray(tokens),
                                       jnp.asarray(targets)))
    tp = transformer_params_from_numpy(params, "cpu")
    before = tfa.flash_fwd.launches
    got = tm.forward(tp, torch.from_numpy(tokens))
    got_loss = float(tm.loss(tp, torch.from_numpy(tokens),
                             torch.from_numpy(targets)))
    assert tfa.flash_fwd.launches == before   # CPU tensors: plain versions
    assert got.dtype == torch.float32 and got.shape == (BATCH, SEQ, 64)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)


def test_bf16_forward_matches_jax():
    jm, tm = _models("bf16")
    params = _params()
    tokens, _ = _batch()
    want = np.asarray(jax.jit(jm.forward)(_jax_params(params),
                                          jnp.asarray(tokens)))
    got = tm.forward(transformer_params_from_numpy(params, "cpu"),
                     torch.from_numpy(tokens))
    assert got.dtype == torch.float32   # logits are never rounded to bf16
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=0.05)


def test_flash_and_dense_routes_agree_in_the_port():
    params = transformer_params_from_numpy(_params(), "cpu")
    tokens, _ = _batch()
    logits = {impl: TransformerLM(transformer_config(torch.float32, impl))
              .forward(params, torch.from_numpy(tokens)).detach()
              for impl in ("dense", "flash", "auto")}
    # "auto" on a CPU tensor is the dense route
    assert torch.equal(logits["auto"], logits["dense"])
    np.testing.assert_allclose(logits["flash"], logits["dense"], rtol=1e-5,
                               atol=1e-5)


def _optimizers(kind):
    if kind == "sgd":
        return None, None
    if kind == "adam":
        return (jopt.Adam(learning_rate=1e-2),
                topt.Adam(learning_rate=1e-2, fused=True))

    def decay(name):
        return not name.endswith(("_bias", "_scale", "_b1", "_b2"))

    return (jopt.AdamW(learning_rate=1e-2, weight_decay=0.1,
                       decay_filter=decay),
            topt.AdamW(learning_rate=1e-2, weight_decay=0.1,
                       decay_filter=decay, fused=True))


def _run_steps(step, params, state, steps, tensors):
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, *tensors)
        losses.append(float(loss))
    return params, state, losses


@pytest.mark.parametrize("kind", ["sgd", "adam", "adamw"])
def test_train_steps_track_jax(kind):
    jm, tm = _models()
    jo, to = _optimizers(kind)
    lr = 0.05 if kind == "sgd" else None
    params = _params()
    tokens, targets = _batch()
    jp = _jax_params(params)
    js = ({k: jnp.zeros_like(v) for k, v in jp.items()} if jo is None
          else jo.init_state_tree(jp))
    jp, js, jl = _run_steps(jm.make_train_step(None, lr=lr, optimizer=jo),
                            jp, js, 3, (jnp.asarray(tokens),
                                        jnp.asarray(targets)))
    tp = transformer_params_from_numpy(params, "cpu")
    ts = ({k: torch.zeros_like(v) for k, v in tp.items()} if to is None
          else to.init_state_tree(tp))
    tp, ts, tl = _run_steps(tm.make_train_step(None, lr=lr, optimizer=to),
                            tp, ts, 3, (torch.from_numpy(tokens),
                                        torch.from_numpy(targets)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    bound = 1e-6 if kind == "sgd" else 5e-5
    for k in params:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                   atol=bound * np.abs(want).max(),
                                   err_msg=k)


def test_flash_train_step_matches_jax():
    # one step through the flash kernels' gradients on both sides
    jm, tm = _models(attn_impl="flash")
    params = _params(2)
    tokens, targets = _batch(3)
    jp = _jax_params(params)
    jp, _, jl = _run_steps(jm.make_train_step(None, lr=0.05), jp,
                           {k: jnp.zeros_like(v) for k, v in jp.items()}, 1,
                           (jnp.asarray(tokens), jnp.asarray(targets)))
    tp = transformer_params_from_numpy(params, "cpu")
    tp, _, tl = _run_steps(tm.make_train_step(None, lr=0.05), tp,
                           {k: torch.zeros_like(v) for k, v in tp.items()}, 1,
                           (torch.from_numpy(tokens),
                            torch.from_numpy(targets)))
    assert tl[0] == pytest.approx(jl[0], rel=1e-5)
    for k in params:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max(), err_msg=k)


def test_fused_and_per_leaf_adam_agree_bitwise_on_the_lm():
    tokens, targets = _batch()
    results = []
    for fused in (True, False):
        tm = TransformerLM(transformer_config(torch.float32, "flash"))
        opt = topt.Adam(learning_rate=1e-2, fused=fused)
        tp, ts = tm.init_sharded(None, seed=4, optimizer=opt, ctx=cpu())
        assert len(tp) == 4 + 10 * CFG["n_layers"] + 1
        results.append(_run_steps(tm.make_train_step(optimizer=opt), tp, ts,
                                  2, (torch.from_numpy(tokens),
                                      torch.from_numpy(targets))))
    (p1, s1, l1), (p2, s2, l2) = results
    assert l1 == l2
    for k in p1:
        assert torch.equal(p1[k], p2[k]) and torch.equal(s1[k][0], s2[k][0])


def test_remat_gives_the_inline_loss_and_gradients():
    tokens, targets = _batch()
    out = []
    for remat in (False, True):
        tm = TransformerLM(transformer_config(torch.float32, "flash",
                                              remat=remat))
        tp, moms = tm.init_sharded(None, seed=5, ctx=cpu())
        out.append(_run_steps(tm.make_train_step(lr=0.05), tp, moms, 2,
                              (torch.from_numpy(tokens),
                               torch.from_numpy(targets))))
    assert out[0][2] == out[1][2]
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k


def test_step_marks_its_phases_and_keeps_its_result():
    """``step(..., mark=fn)`` calls ``fn`` once a phase, in order, and the
    step's result is bitwise the one without marks."""
    tokens, targets = (torch.from_numpy(t) for t in _batch())
    out, phases = [], []
    for mark in (None, phases.append):
        tm = TransformerLM(transformer_config(torch.float32, "dense"))
        opt = topt.Adam(learning_rate=1e-2, fused=True)
        tp, ts = tm.init_sharded(None, seed=6, optimizer=opt, ctx=cpu())
        out.append(tm.make_train_step(optimizer=opt)(tp, ts, tokens, targets,
                                                    mark=mark))
    assert phases == ["forward", "backward", "grad_sum", "update"]
    assert torch.equal(out[0][2], out[1][2])
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k


def test_gemms_round_once_whatever_the_process_flag(monkeypatch):
    # the model switches cuBLAS's reduced-precision bf16 reduction off for
    # each of its GEMMs, forward and gradient, and restores the caller's
    flags = torch.backends.cuda.matmul
    monkeypatch.setattr(flags, "allow_bf16_reduced_precision_reduction", True)
    seen, matmul = [], torch.matmul

    def spy(*args):
        seen.append(flags.allow_bf16_reduced_precision_reduction)
        return matmul(*args)

    monkeypatch.setattr(torch, "matmul", spy)
    tm = TransformerLM(transformer_config(torch.bfloat16, "dense"))
    tp = transformer_params_from_numpy(_params(), "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in tp.items()}
    tokens, targets = _batch()
    tm.loss(leaves, tokens, targets).backward()
    # 4 GEMMs a layer, forward and input gradient (the weight gradients and
    # the dense attention's f32 einsums call no torch.matmul); the logits'
    # forward, and each of their two gradients as two products of the split
    # cotangent
    assert len(seen) == 2 * 4 * CFG["n_layers"] + 1 + 2 * 2
    assert not any(seen)
    assert flags.allow_bf16_reduced_precision_reduction is True


def _head_operands(seed=7):
    """The LM head's operands cut narrow (96 tokens, d_model 32, vocab
    500): the f32 cotangent of the logits at a softmax gradient's scale,
    and the bf16 input and weight."""
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(96, 500).astype(np.float32) * 1e-3)
    x, w = (torch.from_numpy(rng.randn(*s).astype(np.float32))
            .to(torch.bfloat16) for s in ((96, 32), (32, 500)))
    return g, x, w


def _split_products(g, x, w):
    """dx and dw of the LM head as its backward forms them: the f32 sums of
    the two products of the cotangent's bf16 parts, before the rounding."""
    hi, lo = split_cotangent(g, torch.bfloat16)
    return {"dx": wide_product(hi, w.t()) + wide_product(lo, w.t()),
            "dw": wide_product(x.t(), hi) + wide_product(x.t(), lo)}


@pytest.mark.parametrize("what", ["dx", "dw"])
def test_split_cotangent_product_is_within_2_to_the_minus_16(what):
    # the f32 result before its bf16 rounding, against the f64 product;
    # the cotangent's hi part alone misses the bound
    g, x, w = _head_operands()
    got = _split_products(g, x, w)[what]
    if what == "dx":
        hi = g.to(torch.bfloat16).double() @ w.double().t()
        exact = g.double() @ w.double().t()
        scale = g.double().abs() @ w.double().abs().t()
    else:
        hi = x.double().t() @ g.to(torch.bfloat16).double()
        exact = x.double().t() @ g.double()
        scale = x.double().abs().t() @ g.double().abs()
    assert got.dtype == torch.float32
    assert ((got.double() - exact).abs() <= 2.0 ** -16 * scale).all()
    assert not ((hi - exact).abs() <= 2.0 ** -16 * scale).all()


def test_logits_product_keeps_f32_and_rounds_its_gradients_once():
    # the bf16 LM head: f32 logits from the bf16 operands, dx and dw the
    # split products rounded once to bf16 (dw back in the f32 master's type)
    g, x, w = _head_operands()
    xs, ws = x.clone().requires_grad_(True), w.float().requires_grad_(True)
    y = column_parallel_f32(xs, ws)
    dx, dw = torch.autograd.grad(y, (xs, ws), g)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.float() @ w.float())
    split = _split_products(g, x, w)
    assert torch.equal(dx, split["dx"].to(torch.bfloat16))
    assert dw.dtype == torch.float32 and torch.equal(
        dw, split["dw"].to(torch.bfloat16).float())


def test_logits_product_and_gradients_match_jax_in_bf16():
    # the JAX head: bf16 operands, f32 products and sums
    # (transformer.py:217-218); its gradients multiply the f32 cotangent by
    # the bf16 operand in f32 and round once to bf16. The port's split
    # products sit within 2^-16 of sum |g||w| of the exact ones, as do
    # JAX's f32 sums, so each gradient element is the JAX one or, where the
    # two sums straddle a bf16 rounding boundary, one bf16 step (2^-7 of
    # the value) and those errors from it
    g, x, w = _head_operands()
    jx, jw = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w))
    y, vjp = jax.vjp(lambda a, b: jnp.einsum(
        "td,dv->tv", a, b, preferred_element_type=jnp.float32), jx, jw)
    want = [np.asarray(t, np.float32) for t in (y, *vjp(jnp.asarray(
        g.numpy())))]
    xs, ws = (t.clone().requires_grad_(True) for t in (x, w))
    got_y = column_parallel_f32(xs, ws)
    got = [t.detach().float().numpy() for t in (
        got_y, *torch.autograd.grad(got_y, (xs, ws), g))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    gd, xd, wd = (t.double().abs() for t in (g, x, w))
    for a, b, scale in zip(got[1:], want[1:], (gd @ wd.t(), xd.t() @ gd)):
        bound = 2.0 ** -7 * np.abs(b) + 2.0 ** -15 * scale.numpy()
        assert np.all(np.abs(a - b) <= bound)
        assert np.mean(a == b) > 0.99


def test_init_params_scales_and_shapes():
    tm = TransformerLM(transformer_lm_config())
    assert tm.cfg["d_ff"] == 2048 and tm.cfg["dtype"] == torch.bfloat16
    shapes = tm.init_shapes()
    assert len(shapes) == 45
    assert sum(int(np.prod(s)) for s in shapes.values()) == 46_418_944
    small = TransformerLM(transformer_config(torch.float32, "dense"))
    p = small.init_params(0, ctx=cpu())
    assert {k: tuple(v.shape) for k, v in p.items()} == small.init_shapes()
    assert all(v.dtype == torch.float32 for v in p.values())
    assert torch.equal(p["layer0_ln1_scale"], torch.ones(32))
    assert torch.equal(p["layer1_b2"], torch.zeros(32))
    assert float(p["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(p["lm_head"].std()) == pytest.approx(32 ** -0.5, rel=0.1)
    again = small.init_params(0, ctx=cpu())
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_mesh_and_lr_scheduler_raise():
    # a mesh is parallel.make_mesh's (tests/test_torch_sharded_transformer.py
    # runs the sharded step); anything else raises
    tm = TransformerLM(transformer_config(torch.float32, "dense"))
    mesh = object()
    params = tm.init_params(0, ctx=cpu())
    for call in (lambda: tm.make_train_step(mesh),
                 lambda: tm.init_sharded(mesh, ctx=cpu()),
                 lambda: tm.param_shardings(mesh),
                 lambda: tm.forward(params, np.zeros((1, 4)), mesh=mesh)):
        with pytest.raises(TypeError, match="make_mesh"):
            call()
    opt = topt.Adam(lr_scheduler=FactorScheduler(step=10))
    with pytest.raises(MXNetError, match="lr_scheduler"):
        tm.make_train_step(None, optimizer=opt)
    with pytest.raises(ValueError, match="attn_impl"):
        transformer_lm_config(attn_impl="ring")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    tm = TransformerLM(transformer_config(torch.float32, "dense"))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tm.init_params(0)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tm.init_sharded()
    with cpu():
        assert tm.init_params(0)["embed"].device.type == "cpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_step_launches_every_kernel_and_matches_cpu(cuda_device):
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.kernels import fused_adam as kfa

    tokens, targets = _batch()
    runs = {}
    for ctx in (cpu(), gpu(0)):
        tm = TransformerLM(transformer_config(torch.float32, "auto"))
        opt = topt.Adam(learning_rate=1e-2, fused=True)
        tp = transformer_params_from_numpy(_params(), ctx.torch_device)
        ts = opt.init_state_tree(tp)
        counts = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
                  tfa.flash_bwd_dkv.launches, kfa.fused_adam.launches)
        tp, ts, losses = _run_steps(tm.make_train_step(optimizer=opt), tp, ts,
                                    1, (torch.from_numpy(tokens),
                                        torch.from_numpy(targets)))
        runs[ctx.device_type] = tp, losses, tuple(
            a - b for a, b in zip((tfa.flash_fwd.launches,
                                   tfa.flash_bwd_dq.launches,
                                   tfa.flash_bwd_dkv.launches,
                                   kfa.fused_adam.launches), counts))
    assert runs["cpu"][2] == (0, 0, 0, 0)
    assert runs["gpu"][2] == (2, 2, 2, 1)
    assert runs["gpu"][1][0] == pytest.approx(runs["cpu"][1][0], rel=1e-5)
    for k, v in runs["cpu"][0].items():
        np.testing.assert_allclose(runs["gpu"][0][k].cpu().numpy(), v.numpy(),
                                   rtol=0, atol=5e-5 * float(v.abs().max()))
