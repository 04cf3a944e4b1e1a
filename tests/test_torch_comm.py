"""The port's compressed allreduce across gloo CPU ranks against the JAX
package's in ``shard_map`` on a dp=2 and a dp=4 CPU mesh.

The same numpy gradients and residuals reach both: rank r of the port feeds
row r, as device r of the mesh holds it. For every mode (none, bf16, int8,
twobit) with the kernels on and off, with and without error feedback:

- the port's kernel path is bitwise the JAX kernel path (payload, row sums
  in the Pallas kernel's FMA order, residuals), with the default block and
  with a cap of 128 elements; the stage-2 error is rounded once where XLA
  contracts it into a one-step kernel grid (the default block here), after
  the rounded product over a grid of several steps (the cap);
- the port's codec path sums each rank's decoded row in order, as XLA
  reduces, which is bitwise for none, bf16 and twobit. For int8 XLA fuses
  the decode into the sum as an FMA; the port rounds each product first, so
  a reduced value that lands on a stage-2 rounding boundary can move by one
  quantization step (the reduced shard's max over 127). That bound holds
  between the port's codec and kernel paths and against the JAX codec path,
  and such flips must be rare (under 1% of elements), the bound
  tests/test_pallas_kernels.py:186-198 allows between the JAX paths. XLA
  also contracts the codec path's stage-1 error ``rows - decode(payload)``
  into an FMA, so its residuals differ from the port's by rounding (a few
  ulp of the gradient): the same bound covers them;
- mode none is a per-leaf gloo ``all_reduce``. Two ranks' sum is bitwise
  (a + b = b + a); over four ranks gloo reduces in another order than XLA's
  device order, and each element is held within the reassociation bound
  2 (n - 1) u sum|x_i| (u = 2^-24).

Each multi-rank run is one spawn of all its ranks under a time limit
(``torch_ranks.run_ranks``).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

from mxnet_tpu import comm as jcomm
from mxnet_tpu.compat import shard_map
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import (residual_rows_from_numpy,
                                     residual_rows_to_numpy)
from torch_ranks import exchange, run_ranks

torch.set_num_threads(1)

SHAPES = {"w": (37, 29), "b": (29,), "a": (3,)}   # 1105 elements
CHUNK = 64
THRESHOLD = 0.5
MODES = ("none", "bf16", "int8", "twobit")
# kernels on with a block cap of 128 elements: the JAX kernels' grids take
# several steps, where XLA no longer contracts the stage-2 error (int8)
_BLOCKED = {"int8": (128,), "twobit": (128,)}


def _grads(world, seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(world, *s) * 0.6).astype(np.float32)
            for k, s in SHAPES.items()}


def _cases(world):
    cases = []
    for i, mode in enumerate(MODES):
        spec = jcomm.CompressionSpec(mode, threshold=THRESHOLD, chunk=CHUNK)
        for kernels in (False, True) + _BLOCKED.get(mode, ()):
            for ef in (True, False) if spec.error_feedback else (False,):
                resid = None
                if ef:
                    n = sum(int(np.prod(s)) for s in SHAPES.values())
                    Lp = jcomm.padded_flat_size(n, spec, world)
                    resid = (np.random.RandomState(10 + i).randn(world, Lp)
                             * 0.05).astype(np.float32)
                cases.append({"mode": mode, "kernels": kernels,
                              "threshold": THRESHOLD, "chunk": CHUNK,
                              "average": not ef, "grads": _grads(world, i),
                              "resid": resid})
    return cases


def _jax_case(case, world):
    """Device r's reduced tree and residual row, from the JAX package."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    spec = jcomm.CompressionSpec(case["mode"], threshold=case["threshold"],
                                 chunk=case["chunk"])
    kernels = case["kernels"]
    cfg = False if kernels is False else jcomm.CommKernelConfig(
        block_elems=None if kernels is True else kernels)
    grads = case["grads"]
    if case["resid"] is not None:
        def body(t, r):
            t = {k: v[0] for k, v in t.items()}
            out, new = jcomm.error_feedback_allreduce(
                t, r, spec, "dp", axis_size=world, average=case["average"],
                kernels=cfg)
            return {k: v[None] for k, v in out.items()}, new

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                              out_specs=(P("dp"), P("dp")), check_vma=False))
        out, new = f(grads, case["resid"])
        return ({k: np.asarray(v) for k, v in out.items()}, np.asarray(new))

    def body(t):
        t = {k: v[0] for k, v in t.items()}
        out = jcomm.compressed_allreduce(
            t, spec if spec.mode != "none" else None, "dp", axis_size=world,
            average=case["average"], kernels=cfg)
        return {k: v[None] for k, v in out.items()}

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"),
                          out_specs=P("dp"), check_vma=False))
    return {k: np.asarray(v) for k, v in f(grads).items()}, None


_RUNS = {}


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def run(request, tmp_path_factory):
    """Every case through the port's ranks and the JAX mesh, once per
    world size."""
    world = request.param
    if world not in _RUNS:
        cases = _cases(world)
        port = run_ranks(exchange, world, tmp_path_factory.mktemp(f"r{world}"),
                         cases)
        ref = [_jax_case(c, world) for c in cases]
        _RUNS[world] = (cases, port, ref)
    return (world,) + _RUNS[world]


def _bitwise(got, want, what):
    assert got.shape == want.shape, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        f"{what}: {(got != want).sum()} of {got.size} differ, max "
        f"{np.abs(got - want).max()}")


def _case(cases, mode, kernels, ef):
    for i, c in enumerate(cases):
        # repr tells True from a block cap of 1
        if (c["mode"], repr(c["kernels"]), c["resid"] is not None) == \
                (mode, repr(kernels), ef):
            return i
    raise KeyError((mode, kernels, ef))


CASE_KEYS = [(m, k, ef) for m in MODES
             for k in (False, True) + _BLOCKED.get(m, ())
             for ef in ((True, False) if m in ("int8", "twobit") else (False,))]


def _ids(key):
    m, k, ef = key
    path = "codec" if k is False else "kernels" if k is True \
        else f"kernels{k}"
    return f"{m}-{path}-{'ef' if ef else 'avg'}"


@pytest.mark.parametrize("key", CASE_KEYS, ids=_ids)
def test_exchange_matches_jax(run, key):
    world, cases, port, ref = run
    i = _case(cases, *key)
    mode, kernels, ef = key
    grads = cases[i]["grads"]
    step = _step(np.concatenate([ref[i][0][k].ravel() for k in SHAPES]))
    for rank in range(world):
        got, want = port[rank][i], ref[i]
        for k in SHAPES:
            g, w = got["out"][k], want[0][k][rank]
            if mode == "int8" and not kernels:
                _within_one_step(g, w, step, f"rank {rank} {k}")
            elif mode == "none" and world > 2:
                bound = 2 * (world - 1) * 2.0 ** -24 * np.abs(grads[k]).sum(0)
                if cases[i]["average"]:
                    bound = bound / world
                assert (np.abs(g - w) <= bound).all(), k
            else:
                _bitwise(g, w, f"rank {rank} {k}")
        if ef:
            g, w = got["resid"][0], want[1][rank]
            if kernels or mode != "int8":
                _bitwise(g, w, f"rank {rank} residual")
            else:
                _within_one_step(g, w, step, f"rank {rank} residual")
        else:
            assert got["resid"] is None


def _step(values):
    """One int8 quantization step of the reduced values."""
    return np.abs(values).max() / 127.0


def _within_one_step(got, want, step, what):
    diff = np.abs(got - want)
    assert diff.max() <= step * 1.01, (what, diff.max(), step)
    assert (diff > step * 1e-3).mean() < 0.01, what


@pytest.mark.parametrize("ef", [True, False], ids=["ef", "avg"])
def test_int8_codec_path_within_one_step_of_kernel_path(run, ef):
    world, cases, port, _ = run
    k, c = _case(cases, "int8", True, ef), _case(cases, "int8", False, ef)
    for rank in range(world):
        out_k, out_c = port[rank][k], port[rank][c]
        flat_k = np.concatenate([out_k["out"][n].ravel() for n in SHAPES])
        flat_c = np.concatenate([out_c["out"][n].ravel() for n in SHAPES])
        step = _step(flat_k)
        _within_one_step(flat_c, flat_k, step, f"rank {rank}")
        if ef:
            _within_one_step(out_c["resid"], out_k["resid"], step,
                             f"rank {rank}")


@pytest.mark.parametrize("key", CASE_KEYS, ids=_ids)
def test_every_rank_holds_the_same_result(run, key):
    world, cases, port, _ = run
    i = _case(cases, *key)
    for rank in range(1, world):
        for k in SHAPES:
            _bitwise(port[rank][i]["out"][k], port[0][i]["out"][k], k)


@pytest.mark.parametrize("key", CASE_KEYS, ids=_ids)
def test_wire_bytes_match_the_plan(run, key):
    """What each rank hands the collectives, against allreduce_plan: the
    all-to-all sends the stage-1 payload, the all-gather this rank's shard
    of the stage-2 payload (none: one all-reduce per leaf)."""
    world, cases, port, _ = run
    i = _case(cases, *key)
    mode = key[0]
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    spec = tcomm.CompressionSpec(mode, threshold=THRESHOLD, chunk=CHUNK)
    plan = tcomm.allreduce_plan(n, world, spec)
    sent = port[0][i]["wire"]
    by_op = {}
    for op, nbytes in sent:
        by_op[op] = by_op.get(op, 0) + nbytes
    if mode == "none":
        assert by_op == {"all_reduce": 4 * n}
        assert plan["collectives"][0]["payload_bytes"] == 4 * n
        return
    rows = {r["op"]: r for r in plan["collectives"]}
    assert by_op["all_to_all"] == rows["all-to-all"]["payload_bytes"]
    assert by_op["all_gather"] * world == rows["all-gather"]["payload_bytes"]
    wire = (world - 1) / world * (by_op["all_to_all"]
                                  + world * by_op["all_gather"])
    assert wire == plan["wire_bytes"]


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_allreduce_plan_matches_jax(world, mode):
    for n in (1105, 25_557_032, 7):
        spec = None if mode == "none" else tcomm.CompressionSpec(mode)
        jspec = None if mode == "none" else jcomm.CompressionSpec(mode)
        assert tcomm.allreduce_plan(n, world, spec) == \
            jcomm.allreduce_plan(n, world, jspec)
        assert tcomm.fp32_allreduce_wire_bytes(n, world) == \
            jcomm.fp32_allreduce_wire_bytes(n, world)


@pytest.mark.parametrize("mode,chunk", [("int8", 256), ("int8", 4),
                                        ("twobit", 256), ("bf16", 256)])
def test_padded_flat_size_matches_jax(mode, chunk):
    for n in (1, 255, 256, 1105, 25_557_032):
        for world in (1, 2, 4, 8):
            assert tcomm.padded_flat_size(
                n, tcomm.CompressionSpec(mode, chunk=chunk), world) == \
                jcomm.padded_flat_size(
                    n, jcomm.CompressionSpec(mode, chunk=chunk), world)


def test_one_rank_is_a_no_op():
    """axis_size == 1: no wire, no quantization error (allreduce.py:244-250,
    279-282); no process group is needed."""
    tree = {"w": torch.randn(5, 7), "b": torch.randn(7)}
    assert tcomm.compressed_allreduce(tree, "int8", axis_size=1) is tree
    resid = tcomm.init_error_feedback(tree, "twobit", 1)
    out, new = tcomm.error_feedback_allreduce(tree, resid, "twobit",
                                              axis_size=1)
    assert out is tree and new is resid
    assert tcomm.compressed_allreduce(tree, None, axis_size=1) is tree
    with pytest.raises(MXNetError, match="process group"):
        tcomm.compressed_allreduce(tree, "int8")


def test_residual_length_is_checked():
    tree = {"w": torch.randn(40)}
    with pytest.raises(MXNetError, match="init_error_feedback"):
        tcomm.error_feedback_allreduce(tree, torch.zeros(1, 64), "int8",
                                       axis_size=2)


@pytest.mark.parametrize("mode", ["int8", "twobit", "bf16", None])
def test_init_error_feedback_matches_jax_rows(mode):
    params = {k: np.zeros(s, np.float32) for k, s in SHAPES.items()}
    want = jcomm.init_error_feedback(params, mode, 4)
    got = tcomm.init_error_feedback(
        {k: torch.from_numpy(v) for k, v in params.items()}, mode, 4)
    if want is None:
        assert got is None
        return
    assert tuple(got.shape) == (1, want.shape[1])
    assert got.dtype == torch.float32 and not got.any()


def test_residual_rows_cross_both_ways():
    state = np.random.RandomState(0).randn(4, 512).astype(np.float32)
    rows = [residual_rows_from_numpy(state, r) for r in range(4)]
    assert all(tuple(r.shape) == (1, 512) for r in rows)
    np.testing.assert_array_equal(rows[2].numpy()[0], state[2])
    np.testing.assert_array_equal(residual_rows_to_numpy(rows), state)
    with pytest.raises(ValueError):
        residual_rows_from_numpy(state, 4)


def test_flatten_order_is_jax_tree_order():
    from mxnet_tpu_torch.comm.allreduce import _flatten, _unflatten

    tree = {"z": torch.arange(3.0), "a": [torch.ones(2, 2), torch.zeros(1)]}
    flat, meta = _flatten(tree)
    jleaves = jax.tree_util.tree_leaves(
        {"z": np.arange(3.0), "a": [np.ones((2, 2)), np.zeros(1)]})
    np.testing.assert_array_equal(
        flat.numpy(), np.concatenate([np.ravel(l) for l in jleaves]))
    back = _unflatten(flat, meta)
    assert torch.equal(back["z"], tree["z"])
    assert torch.equal(back["a"][0], tree["a"][0])


@pytest.mark.parametrize("env,block", [("", "off"), ("1", None),
                                       ("4096", 4096), ("no", "off")])
def test_comm_kernel_config_resolve_matches_jax(env, block, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COMM_KERNELS", env)
    got = tcomm.CommKernelConfig.resolve(None)
    want = jcomm.CommKernelConfig.resolve(None)
    if block == "off":
        assert got is None and want is None
    else:
        assert got.block_elems == want.block_elems == block
    assert tcomm.CommKernelConfig.resolve(False) is None
    assert tcomm.CommKernelConfig.resolve(True).block_elems is None
    assert tcomm.CommKernelConfig.resolve(512).block_elems == 512


def test_comm_kernel_env_typo_raises(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COMM_KERNELS", "yes-please")
    with pytest.raises(MXNetError, match="not understood"):
        tcomm.CommKernelConfig.resolve(None)
    with pytest.raises(MXNetError, match="positive"):
        tcomm.CommKernelConfig(0)


def test_comm_stats_registry():
    reg = tcomm.CommRegistry()
    plan = tcomm.allreduce_plan(1105, 2, "int8")
    reg.register_plan("step", plan)
    reg.record_step("step")
    reg.record_step("step", 2)
    stats = reg.stats()
    assert stats["steps"] == 3
    assert stats["wire_bytes"] == 3 * plan["wire_bytes"]
    assert stats["ratio"] == plan["fp32_wire_bytes"] / plan["wire_bytes"]
    assert stats["fp32_wire_bytes"] == 3 * plan["fp32_wire_bytes"]
    assert stats["per_program"]["step"]["steps"] == 3


@pytest.mark.parametrize("name", ["hlo_collective_rows",
                                  "hlo_collective_table",
                                  "hlo_collective_wire_bytes",
                                  "hlo_elementwise_table",
                                  "hlo_quantize_pass_count"])
def test_later_comm_names_raise(name):
    """The HLO parsers that once raised naming ROADMAP A6 are ported: the
    JAX package's functions, exported as its ``comm`` exports them
    (tests/test_torch_comm_table.py holds their rows to the JAX
    package's)."""
    fn = getattr(tcomm, name)
    assert callable(fn) and name in tcomm.__all__
    assert fn.__module__ == "mxnet_tpu_torch.comm.stats"
