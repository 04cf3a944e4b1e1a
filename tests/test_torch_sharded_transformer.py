"""The port's sharded transformer LM step on 8 gloo CPU ranks (a dp 2 x
tp 2 x sp 2 mesh) against the JAX package's GSPMD step on its 8 emulated CPU
devices: the configuration of ``__graft_entry__.dryrun_multichip`` at 8
devices (vocab 128, d_model 32, 4 heads, 2 layers, f32), a batch of 4 x 16
tokens.

The JAX ``init_sharded(mesh, seed=0)`` parameters are carried to the port
(``convert.shard_transformer_params``); every rank runs one step on its
blocks, the blocks are gathered, and the result is held against the JAX
step's. One spawn of 8 ranks runs every case (``torch_ranks.
sharded_transformer``).

Tolerances (those of tests/test_torch_transformer.py, which hold the
single-card step to the JAX package): SGD (lr 0.1), dense or flash
attention (the JAX package's Pallas kernels in interpret mode, the port's
plain versions): the loss within 1e-5 relative, every leaf within 1e-5 of
its largest value; Adam (lr 1e-2): every leaf and moment within 5e-5 of its
largest value, since Adam divides by sqrt(v) and scales a gradient's last
bits up to the step size. Sums over dp x sp and tp run in another order
than XLA's. Adam runs with ``epsilon=1e-3``, as the cross-package fit
tests do (ROADMAP.md C.2): with 1e-8 a gradient that cancels to rounding
noise becomes a step of about lr, and its sign and size follow the noise.
Reading: one element of ``layer0_w2`` has a gradient of 1.8e-7 (the leaf's
median is 1.1e-2) that the JAX package's own unsharded and sharded steps
compute 2% apart (1.778e-7, 1.814e-7); with epsilon 1e-8 the port's Adam
step differed there from the JAX sharded step by 2.3e-5 (6.3e-5 of the
leaf's largest value), every other leaf within 2.8e-6 of its largest. Within the port: ``remat=True`` gives the inline step's loss and
parameters bitwise, the leaves replicated over a mesh axis are bitwise equal
on every rank that holds them, a mesh of one rank is bitwise ``mesh=None``,
and shard then gather gives back every leaf bitwise.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import optimizer as jopt
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models.transformer import TransformerLM as JaxLM
from mxnet_tpu.models.transformer import transformer_lm_config as jax_config
from mxnet_tpu_torch import convert, cpu
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.models import TransformerLM, transformer_lm_config
from mxnet_tpu_torch.parallel import make_mesh
from mxnet_tpu_torch.parallel.mesh import P, Sharding
from mxnet_tpu_torch.parallel.tensor_parallel import transformer_param_specs
from torch_ranks import run_ranks, sharded_transformer

torch.set_num_threads(1)

WORLD = 8
CONFIG = dict(vocab_size=128, d_model=32, n_heads=4, n_layers=2, max_len=32)
BATCH, SEQ = 4, 16
# (name, attn_impl, optimizer, remat)
CASES = (("sgd", "dense", "sgd", False), ("flash", "flash", "sgd", False),
         ("adam", "dense", "adam", False), ("remat", "dense", "sgd", True))
BOUNDS = {"sgd": 1e-5, "flash": 1e-5, "adam": 5e-5}


def _batch():
    rng = np.random.RandomState(0)
    return tuple(rng.randint(0, CONFIG["vocab_size"], (BATCH, SEQ))
                 .astype(np.int32) for _ in range(2))


def _jax_mesh():
    return jpar.make_mesh(dp=2, tp=2, sp=2)


def _jax_params():
    model = JaxLM(jax_config(**CONFIG, dtype=jnp.float32))
    params, _ = model.init_sharded(_jax_mesh(), seed=0)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def params():
    return _jax_params()


@pytest.fixture(scope="module")
def ranks(params, tmp_path_factory):
    tokens, targets = _batch()
    return run_ranks(sharded_transformer, WORLD,
                     tmp_path_factory.mktemp("sharded_lm"), CONFIG, params,
                     tokens, targets, CASES)


def _jax_step(params, attn_impl, opt_name):
    model = JaxLM(jax_config(**CONFIG, dtype=jnp.float32,
                             attn_impl=attn_impl))
    mesh = _jax_mesh()
    opt = (jopt.Adam(learning_rate=1e-2, epsilon=1e-3) if opt_name == "adam"
           else None)
    p, state = model.init_sharded(mesh, seed=0, optimizer=opt)
    sh = model.param_shardings(mesh)
    p = {k: jax.device_put(jnp.asarray(params[k]), sh[k]) for k in p}
    step = model.make_train_step(mesh, lr=None if opt else 0.1,
                                 optimizer=opt)
    p, state, loss = step(p, state, *_batch())
    return (float(loss), {k: np.asarray(v) for k, v in p.items()},
            jax.tree_util.tree_map(np.asarray, state))


@pytest.mark.parametrize("name", ["sgd", "flash", "adam"])
def test_step_matches_jax(ranks, params, name):
    _, attn_impl, opt_name, _ = next(c for c in CASES if c[0] == name)
    loss, want, state = _jax_step(params, attn_impl, opt_name)
    bound = BOUNDS[name]
    for res in ranks:
        assert res[name]["loss"] == pytest.approx(loss, rel=1e-5)
    got = ranks[0][name]
    for k, w in want.items():
        np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                   atol=bound * np.abs(w).max(), err_msg=k)
    if opt_name == "adam":
        for k, (m, v, t) in state.items():
            gm, gv, gt = got["state"][k]
            np.testing.assert_allclose(gm, m, rtol=0,
                                       atol=bound * np.abs(m).max())
            np.testing.assert_allclose(gv, v, rtol=0,
                                       atol=bound * np.abs(v).max())
            assert float(gt) == float(t)


def test_remat_is_the_inline_step_bitwise(ranks):
    for res in ranks:
        assert res["remat"]["loss"] == res["sgd"]["loss"]
        for k, v in res["sgd"]["local"].items():
            assert np.array_equal(res["remat"]["local"][k], v), k


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_replicas_are_bitwise_equal(ranks, name):
    # a leaf split over tp is held by the ranks of one tp coordinate, any
    # other leaf by every rank
    specs = transformer_param_specs(CONFIG["n_layers"])
    for k in ranks[0][name]["local"]:
        split = "tp" in specs[k]
        first = {}
        for res in ranks:
            key = res["coords"]["tp"] if split else 0
            v = res[name]["local"][k]
            assert np.array_equal(first.setdefault(key, v), v), (k, key)


def test_shard_then_gather_is_bitwise(ranks, params):
    for res in ranks:
        for k, v in params.items():
            assert np.array_equal(res["roundtrip"][k], v), k
        state, again = res["adam"]["state"], res["adam"]["state_roundtrip"]
        for k, leaves in state.items():
            for a, b in zip(leaves, again[k]):
                assert np.array_equal(a, b), k


def test_wqkv_is_split_by_heads(params):
    # the fused (d, 3d) columns of rank t of tp = 2: q, k and v of heads
    # 2t and 2t + 1
    model = TransformerLM(transformer_lm_config(**CONFIG,
                                                dtype=torch.float32))
    sharding = model.param_shardings(make_mesh(devices=cpu()))["layer0_wqkv"]
    assert sharding.spec == P(None, "tp") and sharding.parts == 3
    w, d = params["layer0_wqkv"], CONFIG["d_model"]
    for t in range(2):
        mesh = types.SimpleNamespace(shape={"tp": 2}, coords={"tp": t},
                                     device=torch.device("cpu"))
        got = Sharding(mesh, sharding.spec, sharding.parts).shard(w).numpy()
        want = np.concatenate([w[:, j * d + t * d // 2:j * d + (t + 1) * d // 2]
                               for j in range(3)], axis=1)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_mesh_of_one_rank_is_bitwise_no_mesh(params, opt_name):
    tokens, targets = _batch()
    runs = []
    for mesh in (None, make_mesh(devices=cpu())):
        model = TransformerLM(transformer_lm_config(
            **CONFIG, dtype=torch.float32, attn_impl="flash"))
        p = convert.transformer_params_from_numpy(params, "cpu")
        if mesh is not None:
            p = convert.shard_transformer_params(params, mesh, model)
        if opt_name == "adam":
            opt = topt.Adam(learning_rate=1e-2, fused=True)
            step, state = model.make_train_step(mesh, optimizer=opt), \
                opt.init_state_tree(p)
        else:
            step = model.make_train_step(mesh, lr=0.1)
            state = {k: torch.zeros_like(v) for k, v in p.items()}
        losses = []
        for _ in range(2):
            p, state, loss = step(p, state, torch.from_numpy(tokens),
                                  torch.from_numpy(targets))
            losses.append(float(loss))
        runs.append((losses, p, model.forward(p, tokens, mesh=mesh)))
    (l0, p0, f0), (l1, p1, f1) = runs
    assert l0 == l1 and l0[1] < l0[0]
    assert torch.equal(f0, f1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
