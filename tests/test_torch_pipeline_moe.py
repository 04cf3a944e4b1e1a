"""The port's pipeline (pp) and expert (ep) parallelism and the MoE pipeline
LM on 8 gloo CPU ranks, against the JAX package's functions on its 8
emulated CPU devices under ``shard_map`` (tests/conftest.py), as
tests/test_pipeline_moe.py runs them there.

One spawn of 8 ranks serves every case of the module
(``torch_ranks.pipeline_moe``); each rank gathers its blocks into global
arrays, and the tests compare them with the JAX results.

Cases and tolerances:
- ``all_to_all`` (``lax.all_to_all(..., tiled=True)``) over ep = 4 and its
  gradient: bitwise (it moves values).
- ``spmd_pipeline`` at pp = 4, 6 microbatches (the JAX test's shapes): the
  outputs, the gradients of the stage weights and of x, and the summed aux,
  within 1e-5.
- ``moe_ffn`` at ep = 2 and 4 with distinct experts, at capacity factors
  2.0 and 0.5 (tokens dropped): the routing (expert and slot of every
  token) exactly; the output, the aux and the gradients of x, the gate, w1
  and w2 within 1e-5 (f32 sums in another order than XLA's).
- The MoE pipeline LM, 3 SGD steps on dp 2 x pp 2 x ep 2 (the config of
  tests/test_pipeline_moe.py:114-117) from the JAX ``init_sharded``
  parameters: the loss at every step within 1e-5 relative, every leaf and
  momentum within 1e-5 of its largest value (the sharded transformer's
  bounds); the blocks a mesh axis replicates bitwise equal on every rank
  that holds them; shard then gather bitwise; and a mesh of one rank
  against the JAX step on one device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu.compat import shard_map
from mxnet_tpu.models.moe_transformer import MoEPipelineLM as JaxMoE
from mxnet_tpu.models.moe_transformer import moe_pipeline_config as jax_config
from mxnet_tpu.parallel.expert import init_moe_params as jax_moe_params
from mxnet_tpu.parallel.expert import moe_ffn as jax_moe_ffn
from mxnet_tpu.parallel.pipeline import spmd_pipeline as jax_pipeline
from mxnet_tpu_torch import MXNetError, convert, cpu
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.models import MoEPipelineLM, moe_pipeline_config
from torch_ranks import pipeline_moe, run_ranks

torch.set_num_threads(1)

WORLD = 8
A2A_CASES = ((0, 1), (1, 0), (0, 0), (2, 1), (1, 2))
PP, N_MICRO, MB, DIM = 4, 6, 2, 8
MOE = dict(tokens=32, d=8, ff=16, n_experts=4)
EPS, FACTORS = (2, 4), (2.0, 0.5)
LM_CONFIG = dict(vocab_size=64, d_model=16, n_heads=2, n_experts=4,
                 max_len=16, n_micro=2)
LM_STEPS = 3


def _a2a_shape(split, concat, shape=(16, 8, 12), n=4):
    # the global output: the local block's split dimension / n and concat
    # dimension * n, blocks stacked on dimension 0
    local = [shape[0] // n, *shape[1:]]
    local[split] //= n
    local[concat] *= n
    return (local[0] * n, *local[1:])


def _lm_params():
    mesh = jpar.make_mesh(dp=2, pp=2, ep=2)
    params, _ = JaxMoE(jax_config(**LM_CONFIG)).init_sharded(mesh, seed=0)
    return {k: np.asarray(v) for k, v in params.items()}


@functools.lru_cache(maxsize=1)
def _inputs():
    # read only: the module's cases share it
    rng = np.random.RandomState(0)

    def randn(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    moe = {k: np.asarray(v) for k, v in jax_moe_params(
        jax.random.PRNGKey(0), MOE["d"], MOE["ff"], MOE["n_experts"]).items()}
    moe["x"] = randn(MOE["tokens"], MOE["d"])
    moe["r"] = randn(MOE["tokens"], MOE["d"])
    tokens = rng.randint(0, LM_CONFIG["vocab_size"], (8, 16)).astype(np.int32)
    return {"a2a_cases": A2A_CASES, "a2a_x": randn(16, 8, 12),
            "a2a_r": {c: randn(*_a2a_shape(*c)) for c in A2A_CASES},
            "n_micro": N_MICRO, "pipe_w": randn(PP, DIM, DIM, scale=0.3),
            "pipe_x": randn(N_MICRO, MB, DIM),
            "pipe_r": randn(N_MICRO, MB, DIM), "moe": moe,
            "lm_config": LM_CONFIG, "lm_params": _lm_params(),
            "lm_batch": (tokens, np.roll(tokens, -1, axis=1)),
            "lm_steps": LM_STEPS}


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    return run_ranks(pipeline_moe, WORLD, tmp_path_factory.mktemp("moe"),
                     data)


def _mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return jpar.make_mesh(**sizes, devices=jax.devices()[:n])


def _close(got, want, bound=1e-5):
    np.testing.assert_allclose(got, np.asarray(want), rtol=bound, atol=bound)


# -- all_to_all ---------------------------------------------------------------

@pytest.mark.parametrize("split,concat", A2A_CASES)
def test_all_to_all_matches_jax(ranks, data, split, concat):
    fn = shard_map(lambda t: lax.all_to_all(t, "ep", split, concat,
                                            tiled=True),
                   mesh=_mesh(ep=4), in_specs=JP("ep"), out_specs=JP("ep"),
                   check_vma=False)
    y, vjp = jax.vjp(fn, jnp.asarray(data["a2a_x"]))
    (g,) = vjp(jnp.asarray(data["a2a_r"][(split, concat)]))
    for res in ranks:
        got_y, got_g = res[f"a2a_{split}{concat}"]
        assert np.array_equal(got_y, np.asarray(y))
        assert np.array_equal(got_g, np.asarray(g))


# -- spmd_pipeline ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pipeline(with_aux):
    data = _inputs()
    r = jnp.asarray(data["pipe_r"])

    def block(w, m):
        return jnp.tanh(m @ w[0])

    def block_aux(w, m):
        y = block(w, m)
        return y, jnp.mean(y * y)

    def inner(w, x):
        res = jax_pipeline(block_aux if with_aux else block, N_MICRO, "pp",
                           with_aux=with_aux)(w, x)
        y, aux = res if with_aux else (res, jnp.float32(0.0))
        loss = lax.psum(jnp.sum(y * r) + aux, "pp")
        return loss, lax.psum(y, "pp"), lax.psum(aux, "pp")

    fn = shard_map(inner, mesh=_mesh(pp=PP), in_specs=(JP("pp"), JP()),
                   out_specs=(JP(), JP(), JP()), check_vma=False)

    def loss(w, x):
        value, y, aux = fn(w, x)
        return value, (y, aux)

    (_, (y, aux)), (dw, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(data["pipe_w"]),
                                            jnp.asarray(data["pipe_x"]))
    return {"y": np.asarray(y), "aux": np.asarray(aux), "dw": np.asarray(dw),
            "dx": np.asarray(dx)}


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("what", ["y", "dw", "dx", "aux"])
def test_pipeline_matches_jax(ranks, with_aux, what):
    want = _jax_pipeline(with_aux)[what]
    for res in ranks:
        _close(res[f"pipe_{with_aux}"][what], want)


def test_pipeline_matches_sequential_stages(ranks, data):
    # tests/test_pipeline_moe.py's own check: the stages applied in order
    ref = data["pipe_x"]
    for s in range(PP):
        ref = np.tanh(ref @ data["pipe_w"][s])
    _close(ranks[0]["pipe_False"]["y"], ref)


# -- moe_ffn ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_moe(ep, cf):
    m = {k: jnp.asarray(v) for k, v in _inputs()["moe"].items()}

    def inner(x, g, w1, w2, r):
        y, aux = jax_moe_ffn(x, g, w1, w2, axis_name="ep",
                             capacity_factor=cf, return_aux=True)
        return lax.psum(jnp.sum(y * r) + aux, "ep"), y, aux.reshape(1)

    fn = shard_map(inner, mesh=_mesh(ep=ep),
                   in_specs=(JP("ep"), JP(), JP("ep"), JP("ep"), JP("ep")),
                   out_specs=(JP(), JP("ep"), JP("ep")), check_vma=False)

    def loss(x, g, w1, w2):
        value, y, aux = fn(x, g, w1, w2, m["r"])
        return value, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(m["x"], m["gate"],
                                                  m["w1"], m["w2"])
    out = {"y": y, "aux": aux, **dict(zip(("dx", "dgate", "dw1", "dw2"),
                                          grads))}
    # the routing, as expert.py:142-153 computes it on each rank's tokens
    t_local = MOE["tokens"] // ep
    capacity = max(1, int(cf * t_local / MOE["n_experts"]))
    experts, slots = [], []
    for x in jnp.split(m["x"], ep):
        probs = jax.nn.softmax(x @ m["gate"], axis=-1)
        expert = jnp.argmax(probs, axis=-1)
        onehot = jax.nn.one_hot(expert, MOE["n_experts"])
        pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
        experts.append(expert)
        slots.append(jnp.where(pos < capacity, pos, -1))
    out["expert"] = jnp.concatenate(experts)
    out["slot"] = jnp.concatenate(slots)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("ep", EPS)
@pytest.mark.parametrize("cf", FACTORS)
def test_moe_routes_as_jax(ranks, ep, cf):
    want = _jax_moe(ep, cf)
    if cf < 1:   # the small capacity drops tokens
        assert (want["slot"] == -1).any()
    for res in ranks:
        got = res[f"moe_{ep}_{cf}"]
        assert np.array_equal(got["expert"], want["expert"])
        assert np.array_equal(got["slot"], want["slot"])


@pytest.mark.parametrize("ep", EPS)
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("what", ["y", "aux", "dx", "dgate", "dw1", "dw2"])
def test_moe_ffn_matches_jax(ranks, ep, cf, what):
    want = _jax_moe(ep, cf)[what]
    for res in ranks:
        _close(res[f"moe_{ep}_{cf}"][what], want)


# -- the MoE pipeline LM ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_lm():
    data = _inputs()
    mesh = jpar.make_mesh(dp=2, pp=2, ep=2)
    model = JaxMoE(jax_config(**LM_CONFIG))
    params, moms = model.init_sharded(mesh, seed=0)
    step = model.make_train_step(mesh, lr=0.1)
    losses = []
    for _ in range(LM_STEPS):
        params, moms, loss = step(params, moms, *data["lm_batch"])
        losses.append(float(loss))
    return (losses, {k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in moms.items()})


def test_lm_steps_match_jax(ranks):
    losses, params, moms = _jax_lm()
    for res in ranks:
        np.testing.assert_allclose(res["lm"]["losses"], losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    got = ranks[0]["lm"]
    for name, want, have in (("params", params, got["params"]),
                             ("moms", moms, got["moms"])):
        for k, w in want.items():
            np.testing.assert_allclose(have[k], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"{name} {k}")


def test_lm_replicated_blocks_are_bitwise_equal(ranks):
    # a leaf is held whole by the ranks that share its split coordinates
    specs = MoEPipelineLM(moe_pipeline_config(**LM_CONFIG))._param_specs()
    for k, spec in specs.items():
        axes = [a for a in spec if a is not None]
        first = {}
        for res in ranks:
            key = tuple(res["lm"]["coords"][a] for a in axes)
            v = res["lm"]["local"][k]
            assert np.array_equal(first.setdefault(key, v), v), (k, key)
        assert len(first) == (4 if len(axes) == 2 else 2 if axes else 1)


def test_lm_shard_then_gather_is_bitwise(ranks, data):
    for res in ranks:
        for k, v in data["lm_params"].items():
            assert np.array_equal(res["lm"]["roundtrip"][k], v), k


def test_batch_blocks_are_jax_placement(ranks, data):
    # P(("dp", "ep"), None): rank r holds the rows JAX places on device r
    mesh = jpar.make_mesh(dp=2, pp=2, ep=2)
    tokens = data["lm_batch"][0]
    placed = jax.device_put(tokens, NamedSharding(mesh, JP(("dp", "ep"),
                                                           None)))
    for rank, res in enumerate(ranks):
        (shard,) = [s.data for s in placed.addressable_shards
                    if s.device.id == rank]
        assert np.array_equal(res["lm"]["local_batch"], np.asarray(shard))
        assert np.array_equal(res["lm"]["batch"], tokens)


def test_mesh_of_one_rank_matches_jax_on_one_device():
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, LM_CONFIG["vocab_size"], (4, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    jmesh = _mesh(dp=1, pp=1, ep=1)
    jmodel = JaxMoE(jax_config(**LM_CONFIG))
    jp, jm = jmodel.init_sharded(jmesh, seed=1)
    params = convert.moe_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jstep = jmodel.make_train_step(jmesh, lr=0.1)
    model = MoEPipelineLM(moe_pipeline_config(**LM_CONFIG))
    mesh = tpar.make_mesh(devices=cpu())
    step = model.make_train_step(mesh, lr=0.1)
    moms = {k: torch.zeros_like(v) for k, v in params.items()}
    for _ in range(LM_STEPS):
        jp, jm, jloss = jstep(jp, jm, tokens, targets)
        params, moms, loss = step(params, moms, torch.from_numpy(tokens),
                                  torch.from_numpy(targets))
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for k, w in jp.items():
        w = np.asarray(w)
        np.testing.assert_allclose(params[k].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_init_params_scales_and_shapes():
    model = MoEPipelineLM(moe_pipeline_config(**LM_CONFIG))
    params = model.init_params(0, n_stages=2, ctx=cpu())
    want = {k: np.asarray(v).shape for k, v in _lm_params().items()}
    assert {k: tuple(v.shape) for k, v in params.items()} == want
    assert float(params["embed"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(params["w2"].std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert torch.equal(params["ln1_scale"], torch.ones(2, 16))
    local, moms = model.init_sharded(tpar.make_mesh(devices=cpu()), seed=0)
    one = model.init_params(0, n_stages=1, ctx=cpu())
    assert all(torch.equal(local[k], v) for k, v in one.items())
    assert torch.equal(one["embed"], params["embed"])
    assert all(not m.any() for m in moms.values())
    moe = tpar.init_moe_params(0, 8, 16, 4, ctx=cpu())
    assert {k: tuple(v.shape) for k, v in moe.items()} == {
        "gate": (8, 4), "w1": (4, 8, 16), "w2": (4, 16, 8)}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device where there is no card")
    model = MoEPipelineLM(moe_pipeline_config(**LM_CONFIG))
    for entry in (lambda: model.init_params(0), model.init_sharded,
                  lambda: tpar.init_moe_params(0, 8, 16, 4)):
        with pytest.raises(MXNetError, match="CUDA is not available"):
            entry()
    with cpu():
        params, moms = model.init_sharded(seed=0)
        assert params["embed"].device.type == "cpu"
        assert tpar.init_moe_params(0, 8, 16, 4)["w1"].device.type == "cpu"
    one = model.init_params(0, n_stages=1, ctx=cpu())
    assert all(torch.equal(params[k], v) for k, v in one.items())
    assert all(not m.any() for m in moms.values())


def test_exports_cover_the_jax_package():
    assert set(jpar.__all__) <= set(tpar.__all__)
    for name in ("spmd_pipeline", "moe_ffn", "init_moe_params"):
        assert callable(getattr(tpar, name))
    assert tmodels.MoEPipelineLM is MoEPipelineLM
    assert tmodels.moe_pipeline_config()["d_ff"] == 4 * 64
