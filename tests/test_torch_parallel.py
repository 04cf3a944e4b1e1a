"""The port's mesh, tensor-parallel products and ring attention on 8 gloo
CPU ranks, against the JAX package's functions on its 8 emulated CPU
devices (tests/conftest.py), as tests/test_parallel.py runs them there.

One spawn of 8 ranks serves every case of the module
(``torch_ranks.parallel_cases``); each rank gathers its blocks into the
global result, and the tests compare rank 0's with the JAX function's and
hold every rank's bitwise equal to rank 0's.

Tolerances: the meshes' shapes, coordinates and error exactly; the
tensor-parallel product and its gradients within 1e-5 (f32 sums over 8
ranks in another order than XLA's); the rings within JAX's own bounds
(tests/test_parallel.py:86-189): 2e-5 for outputs, 3e-4 for the flash
ring's gradients. The JAX flash ring runs its Pallas kernels in interpret
mode, the port's its kernels' plain versions.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu.compat import shard_map
from mxnet_tpu.parallel.sequence import (ring_attention as jring,
                                         ring_flash_attention as jring_flash)
from mxnet_tpu_torch import parallel as tpar
from torch_ranks import parallel_cases, run_ranks

WORLD = 8


def _inputs():
    rng = np.random.RandomState(0)

    def randn(*shape):
        return rng.randn(*shape).astype(np.float32)

    return {"x": randn(4, 8), "w1": randn(8, 16), "w2": randn(16, 8),
            "r": randn(4, 8),
            "ring": [randn(2, 2, 32, 8) for _ in range(3)],
            "flash": [randn(2, 2, 64, 16) for _ in range(3)],
            "flash_w": randn(2, 2, 64, 16),
            "self_False": [randn(2, 2, 16, 4) for _ in range(3)],
            "self_True": [randn(2, 2, 16, 8) for _ in range(3)],
            "batch": randn(8, 3)}


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return run_ranks(parallel_cases, WORLD,
                     tmp_path_factory.mktemp("parallel"), data)


def _same_on_every_rank(ranks, key):
    def leaves(v):
        if isinstance(v, dict):
            return [x for k in sorted(v) for x in leaves(v[k])]
        if isinstance(v, (list, tuple)):
            return [x for item in v for x in leaves(item)]
        return [v]

    first = leaves(ranks[0][key])
    for res in ranks[1:]:
        for a, b in zip(leaves(res[key]), first):
            assert np.array_equal(a, b), key


def _jax_coords(mesh, rank):
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    return dict(zip(mesh.axis_names,
                    (int(c) for c in np.argwhere(ids == rank)[0])))


@pytest.mark.parametrize("name", ["mesh", "auto_mesh"])
def test_make_mesh_matches_jax(ranks, name):
    jmesh = (jpar.make_mesh(dp=2, tp=2, sp=2) if name == "mesh"
             else jpar.auto_mesh(tp=4))
    for rank, res in enumerate(ranks):
        assert res[name]["shape"] == dict(jmesh.shape)
        assert res[name]["coords"] == _jax_coords(jmesh, rank)


def test_mesh_wrong_size_raises_as_jax(ranks):
    with pytest.raises(ValueError) as err:
        jpar.make_mesh(dp=3, tp=2)
    assert all(res["mesh_error"] == str(err.value) for res in ranks)
    with pytest.raises(ValueError, match="needs 6 devices, have 1"):
        tpar.make_mesh(dp=3, tp=2)


def test_shard_batch_and_replicate_params_match_jax(ranks, data):
    # rank r holds the block JAX places on device r; parameters whole
    mesh = jpar.make_mesh(dp=2, tp=2, sp=2)
    placed = jpar.shard_batch({"x": data["batch"], "y": data["batch"][:, 0]},
                              mesh)
    for rank, res in enumerate(ranks):
        for k, arr in placed.items():
            (shard,) = [s.data for s in arr.addressable_shards
                        if s.device.id == rank]
            assert np.array_equal(res["shard_batch"][k], np.asarray(shard))
        assert np.array_equal(res["replicate_params"]["w"], data["batch"])


@pytest.mark.parametrize("what", ["y", "dx", "dw1", "dw2"])
def test_column_row_parallel_matches_jax(ranks, data, what):
    x, w1, w2, r = (jnp.asarray(data[k]) for k in ("x", "w1", "w2", "r"))

    def f(x, w1, w2):
        return jpar.row_parallel(jpar.column_parallel(x, w1), w2)

    y = f(x, w1, w2)
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * r), argnums=(0, 1, 2))(
        x, w1, w2)
    want = dict(zip(("y", "dx", "dw1", "dw2"), (y, *grads)))[what]
    np.testing.assert_allclose(ranks[0]["colrow"][what], np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    _same_on_every_rank(ranks, "colrow")


def _sp_ring(fn, causal):
    mesh = jpar.make_mesh(sp=8)
    spec = JP(None, None, "sp", None)
    return shard_map(functools.partial(fn, axis_name="sp", causal=causal),
                     mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
                     check_vma=False)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(ranks, data, causal):
    want = _sp_ring(jring, causal)(*data["ring"])
    np.testing.assert_allclose(ranks[0][f"ring_{causal}"], np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    _same_on_every_rank(ranks, f"ring_{causal}")


@functools.lru_cache(maxsize=None)
def _jax_ring_flash(causal):
    """The JAX flash ring's output and its q, k, v gradients of
    ``sum(out * w)``, compiled once for the module's cases."""
    data = _inputs()
    ring = _sp_ring(lambda q, k, v, axis_name, causal:
                    jring_flash(q, k, v, axis_name, causal), causal)

    def out_and_grads(q, k, v, w):
        out, vjp = jax.vjp(ring, q, k, v)
        return (out, *vjp(w))

    return [np.asarray(t) for t in jax.jit(out_and_grads)(
        *data["flash"], data["flash_w"])]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_ring_flash_attention_matches_jax(ranks, causal, what):
    i = ("out", "dq", "dk", "dv").index(what)
    bound = 2e-5 if what == "out" else 3e-4
    np.testing.assert_allclose(ranks[0][f"ring_flash_{causal}"][i],
                               _jax_ring_flash(causal)[i], rtol=bound,
                               atol=bound)
    _same_on_every_rank(ranks, f"ring_flash_{causal}")


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_self_attention_matches_jax(ranks, data, use_flash):
    mesh = jpar.make_mesh(dp=2, tp=2, sp=2)
    want = jpar.ring_self_attention(mesh, *data[f"self_{use_flash}"],
                                    causal=True, use_flash=use_flash)
    np.testing.assert_allclose(ranks[0][f"self_{use_flash}"],
                               np.asarray(want), rtol=2e-5, atol=2e-5)
    _same_on_every_rank(ranks, f"self_{use_flash}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_parallel_partial_is_the_upcast_product(dtype):
    """The row-parallel partial product (one process, no ranks): value and
    both gradients bitwise those of autograd through ``x.float() @
    w.float()``, which it replaces to run its GEMMs on the card's tensor
    cores with f32 outputs."""
    import torch

    from mxnet_tpu_torch.parallel.tensor_parallel import _UpcastMatmul

    rng = np.random.RandomState(3)
    dt = getattr(torch, dtype)
    x0, w0 = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt)
              for s in ((2, 5, 16), (16, 8)))
    dy = torch.from_numpy(rng.randn(2, 5, 8).astype(np.float32)).to(dt)
    got, want = [], []
    for out, fn in ((got, lambda x, w: _UpcastMatmul.apply(x, w)),
                    (want, lambda x, w: x.float() @ w.float())):
        x, w = (t.clone().requires_grad_(True) for t in (x0, w0))
        y = fn(x, w)
        out += [y, *torch.autograd.grad(y.to(dt), (x, w), dy)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
