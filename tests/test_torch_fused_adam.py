"""The port's Adam/AdamW step (per-leaf and fused) against the JAX package's.

Inputs are numpy-seeded and reach both packages as the same numbers. The JAX
side runs its per-leaf ``Optimizer.apply`` under ``jax.jit`` and its Pallas
``fused_adam`` kernel in interpret mode, as tests/test_pallas_kernels.py
runs them on the CPU; the port runs its plain version (CPU tensors).

Tolerances. Inside the port the per-leaf path, the fused plain version and
the CUDA kernel round each operation on its own and agree bitwise. Against
JAX the bias corrections agree bitwise (f32 ``pow`` then subtract), but XLA
on the CPU contracts ``beta1*m + (1-beta1)*g`` into one fused multiply-add
(``fma(beta1, m, (1-beta1)*g)``, likewise for v), which rounds once where
the port rounds twice: moments and weights within 2 ulp after 3 steps, of
each value or, where an update cancels to near zero, of the largest value
of the leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops.pallas.adam import fused_adam_apply
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.convert import adam_state_from_numpy, adam_state_to_numpy
from mxnet_tpu_torch.kernels import fused_adam as kfa
from mxnet_tpu_torch.kernels import registry

torch.set_num_threads(1)

# tests/test_pallas_kernels.py:255-345
ODD = {"w1": (64, 33), "b1": (33,), "w2": (7, 5), "s": ()}
FILTERED = {"w1": (48, 16), "b1": (16,), "ln_scale": (16,)}

OPTS = {
    "adam": (ODD, dict(lr=0.01, wd=0.02, clip_gradient=0.5,
                       rescale_grad=1.0 / 32)),
    "adamw": (FILTERED, dict(weight_decay=0.05,
                             decay_filter=lambda n: n.startswith("w"),
                             clip_gradient=0.5, rescale_grad=1.0 / 32)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _arrays(shapes, seed):
    # drawn in name order: jit hands dicts back with their keys sorted
    rng = np.random.RandomState(seed)
    return {n: np.asarray(rng.randn(*shapes[n]), np.float32)
            for n in sorted(shapes)}


def _grads(shapes, step):
    return _arrays(shapes, 100 + step)


def _make(kind, pkg, fused):
    cls = {"adam": pkg.Adam, "adamw": pkg.AdamW}[kind]
    return cls(fused=fused, **OPTS[kind][1])


def _tensors(d, device="cpu"):
    return {k: torch.from_numpy(v.copy()).to(device) for k, v in d.items()}


def _run_port(opt, params, steps, device="cpu", states=None, first=0):
    """``steps`` optimizer steps of the port from numpy params; returns
    numpy params and the port's state."""
    p = _tensors(params, device)
    s = states if states is not None else opt.init_state_tree(p)
    shapes = {k: v.shape for k, v in params.items()}
    for i in range(first, first + steps):
        with torch.no_grad():
            p, s = opt.apply(p, _tensors(_grads(shapes, i), device), s, 0.01)
    return {k: v.cpu().numpy() for k, v in p.items()}, s


def _assert_ulp(got, want, maxulp):
    """Within ``maxulp`` f32 ulps of each value, or of the array's largest
    value where an update cancels to near zero."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    eps = np.finfo(np.float32).eps
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=maxulp * eps,
                               atol=maxulp * eps * scale)


@pytest.mark.parametrize("beta", [0.9, 0.999, 0.5])
def test_bias_correction_matches_jax_bitwise(beta):
    f = jax.jit(lambda t: 1 - beta ** (t + 1.0))
    for t in list(range(0, 40)) + [99, 999, 9999, 99999]:
        want = np.float32(f(jnp.float32(t)))
        got = topt._bias_correction(beta, torch.tensor(t + 1.0))
        assert np.float32(got) == want, (beta, t)


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_fused_plain_matches_jax_per_leaf_and_fused(kind):
    shapes = OPTS[kind][0]
    params = _arrays(shapes, 1)
    jo = _make(kind, jopt, False)

    @jax.jit
    def both(p, g, s, lr):
        return jo.apply(p, g, s, lr), fused_adam_apply(jo, p, g, s, lr, block=64)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init_state_tree(jp)
    to = _make(kind, topt, True)
    tp = _tensors(params)
    ts = to.init_state_tree(tp)
    for step in range(3):
        g = _grads(shapes, step)
        (rp, rs), (fp, fs) = both(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                  js, jnp.float32(0.01))
        with torch.no_grad():
            tp, ts = to.apply(tp, _tensors(g), ts, 0.01)
        for n in shapes:
            for want in ((rp[n], *rs[n][:2]), (fp[n], *fs[n][:2])):
                for got, w in zip((tp[n], *ts[n][:2]), want):
                    _assert_ulp(got.numpy(), w, 2)
            assert float(ts[n][2]) == float(rs[n][2]) == step + 1
        jp, js = rp, rs


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_per_leaf_matches_fused_bitwise(kind):
    shapes = OPTS[kind][0]
    params = _arrays(shapes, 2)
    got_f, s_f = _run_port(_make(kind, topt, True), params, 3)
    got_p, s_p = _run_port(_make(kind, topt, False), params, 3)
    for n in shapes:
        np.testing.assert_array_equal(got_f[n], got_p[n])
        for a, b in zip(s_f[n], s_p[n]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_nan_and_inf_pass_through_clip_like_the_plain_version():
    """torch.clamp and jnp.clip let NaN through where fminf/fmaxf would drop
    it; with wd = 0 the decay term still multiplies an infinite weight."""
    params = {"w": np.array([1.0, np.inf, 2.0, -3.0], np.float32)}
    grads = {"w": np.array([np.nan, 0.5, -np.inf, 1e-3], np.float32)}
    out = {}
    for fused in (True, False):
        opt = topt.Adam(fused=fused, clip_gradient=0.1, wd=0.0)
        p = _tensors(params)
        s = opt.init_state_tree(p)
        with torch.no_grad():
            p, s = opt.apply(p, _tensors(grads), s, 0.01)
        out[fused] = (p["w"].numpy(), s["w"][0].numpy(), s["w"][1].numpy())
    for a, b in zip(out[True], out[False]):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(out[True][0][0]) and np.isnan(out[True][0][1])
    assert out[True][1][2] == np.float32(0.1) * np.float32(-0.1)


def test_state_layout_and_cross_path_resume():
    """Fused steps then per-leaf steps equal per-leaf steps throughout,
    bitwise; the state is {name: (m, v, t)} on both paths."""
    shapes = {"a": (32, 8), "b": (8,)}
    params = _arrays(shapes, 3)
    fused, plain = topt.Adam(lr=0.01, fused=True), topt.Adam(lr=0.01, fused=False)
    pa, sa = _run_port(fused, params, 2)
    assert set(sa) == set(shapes) and all(len(v) == 3 for v in sa.values())
    assert all(v[2].shape == () and v[2].dtype == torch.float32
               for v in sa.values())
    pa, sa = _run_port(plain, pa, 2, states=sa, first=2)
    pb, sb = _run_port(plain, params, 4)
    for n in shapes:
        np.testing.assert_array_equal(pa[n], pb[n])
        for a, b in zip(sa[n], sb[n]):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_state_crosses_packages_both_ways():
    """A state made by one package continues in the other: the port's state
    after 2 steps continues under JAX, and JAX's under the port, each
    within 2 ulp of the package that ran all 3 steps."""
    shapes = ODD
    params = _arrays(shapes, 4)
    kw = OPTS["adam"][1]
    tp, ts = _run_port(topt.Adam(fused=True, **kw), params, 2)
    jo = jopt.Adam(fused=False, **kw)
    run = jax.jit(lambda p, g, s: jo.apply(p, g, s, jnp.float32(0.01)))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init_state_tree(jp)
    for i in range(2):
        jp, js = run(jp, {k: jnp.asarray(v) for k, v in _grads(shapes, i).items()}, js)
    g2 = {k: jnp.asarray(v) for k, v in _grads(shapes, 2).items()}
    # port state -> JAX
    js_from_port = {k: tuple(jnp.asarray(x) for x in v)
                    for k, v in adam_state_to_numpy(ts).items()}
    p_j, s_j = run({k: jnp.asarray(v) for k, v in tp.items()}, g2, js_from_port)
    # JAX state -> port
    ts_from_jax = adam_state_from_numpy(
        {k: tuple(np.asarray(x) for x in v) for k, v in js.items()}, "cpu")
    p_t, s_t = _run_port(topt.Adam(fused=True, **kw),
                         {k: np.asarray(v) for k, v in jp.items()}, 1,
                         states=ts_from_jax, first=2)
    p_ref, s_ref = _run_port(topt.Adam(fused=True, **kw), params, 3)
    for n in shapes:
        _assert_ulp(p_j[n], p_ref[n], 2)
        _assert_ulp(p_t[n], p_ref[n], 2)
        _assert_ulp(s_t[n][0].numpy(), s_ref[n][0].numpy(), 2)
        assert float(s_j[n][2]) == float(s_t[n][2]) == 3.0


def test_fused_gate(monkeypatch):
    """``fused=`` and the env gate as in the JAX package
    (tests/test_pallas_kernels.py:348-354)."""
    monkeypatch.delenv("MXNET_TPU_FUSED_ADAM", raising=False)
    assert not topt.Adam()._fused_active()
    assert topt.Adam(fused=True)._fused_active()
    monkeypatch.setenv("MXNET_TPU_FUSED_ADAM", "1")
    assert topt.Adam()._fused_active()
    assert not topt.Adam(fused=False)._fused_active()
    monkeypatch.setenv("MXNET_TPU_FUSED_ADAM", "maybe")
    with pytest.raises(Exception, match="not understood"):
        topt.Adam()._fused_active()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    called = []
    monkeypatch.setattr(kfa, "fused_adam_plain",
                        lambda *a, **k: called.append(1))
    before = kfa.fused_adam.launches
    p = _tensors(_arrays(ODD, 5))
    opt = topt.Adam(fused=True)
    with torch.no_grad():
        opt.apply(p, _tensors(_grads(ODD, 0)), opt.init_state_tree(p), 0.01)
    assert called == [1] and kfa.fused_adam.launches == before


@pytest.mark.parametrize("fault", ["strided", "dtype", "shape", "count"])
def test_bad_operands_raise(fault):
    w = [torch.zeros(4, 6), torch.zeros(3)]
    g = [torch.zeros(4, 6), torch.zeros(3)]
    m = [torch.zeros(4, 6), torch.zeros(3)]
    v = [torch.zeros(4, 6), torch.zeros(3)]
    scal = [1.0, 1.0]
    if fault == "strided":
        g[0] = torch.zeros(6, 4).t()
    elif fault == "dtype":
        m[1] = torch.zeros(3, dtype=torch.float64)
    elif fault == "shape":
        v[1] = torch.zeros(4)
    else:
        scal = [1.0]
    with pytest.raises(ValueError):
        kfa.fused_adam(w, g, m, v, scal, [1.0, 1.0], [0.0, 0.0], lr=0.01,
                       beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=1.0,
                       clip_gradient=None, wd_l2=0.0, decoupled=False)


def test_cost_model_at_resnet50():
    """161 leaves, 25.56 M elements, 28 bytes each: 715.6 MB, bound by
    bytes at 0.2136 ms on the H100's 3.35 TB/s."""
    net = tmodels.resnet50()
    arg_shapes, _, _ = net.infer_shape(data=(32, 3, 224, 224))
    shapes = [s for n, s in zip(net.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")]
    assert len(shapes) == 161
    leaves = [torch.empty(s, device="meta") for s in shapes]
    cost = registry.get_kernel("fused_adam").cost([leaves] * 4, [leaves] * 3)
    n = sum(t.numel() for t in leaves)
    assert 25.5e6 < n < 25.6e6
    assert cost.bytes == 28 * n and cost.ops == {"f32": 14.0 * n}
    seconds, bound_by = cost.bound()
    assert bound_by == "bytes" and abs(seconds * 1e3 - 0.2136) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_kernel_matches_plain_on_card(cuda_device, kind):
    shapes = dict(OPTS[kind][0], big=(1000, 70), ragged=(4099,))
    params = _arrays(shapes, 6)
    before = kfa.fused_adam.launches
    got, s_k = _run_port(_make(kind, topt, True), params, 3, cuda_device)
    assert kfa.fused_adam.launches == before + 3
    want, s_p = _run_port(_make(kind, topt, False), params, 3, cuda_device)
    plain_cpu, _ = _run_port(_make(kind, topt, True), params, 3)
    for n in shapes:
        np.testing.assert_array_equal(got[n], want[n])
        np.testing.assert_array_equal(got[n], plain_cpu[n])
        for a, b in zip(s_k[n][:2], s_p[n][:2]):
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_kernel_handles_misaligned_and_tiny_leaves(cuda_device):
    """Leaves whose pointers are not 16-byte aligned (views at an odd
    offset) take the element-by-element path; sizes 1, 3 and 4099 cover the
    scalar tail. Bitwise against the plain version on the card."""
    rng = np.random.RandomState(8)
    sizes = [1, 3, 4099, 20000]

    def leaves(offset):
        out = []
        for n in sizes:
            buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32))
            out.append(buf.to(cuda_device)[offset:offset + n])
        return out

    w, g = leaves(1), leaves(0)
    m = [torch.zeros_like(x) for x in w]
    v = [torch.zeros_like(x) for x in w]
    copies = [[x.clone() for x in group] for group in (w, m, v)]
    hyper = dict(lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8,
                 rescale_grad=0.5, clip_gradient=1.0, wd_l2=0.01,
                 decoupled=False)
    scal = ([0.1] * 4, [0.001] * 4, [0.0] * 4)
    kfa.fused_adam(w, g, m, v, *scal, **hyper)
    with torch.no_grad():
        kfa.fused_adam_plain(*copies[:1], g, *copies[1:], *scal, **hyper)
    for got, want in zip(w + m + v, sum(copies, [])):
        assert torch.equal(got, want)
