"""The collective table of the port (``mxnet_tpu_torch/comm/stats.py``):
the JAX package's HLO parsers, copied, and their counterparts over a
``torch.profiler`` trace, against the JAX package's.

- The copied ``hlo_*`` parsers give the JAX package's rows, row for row, on
  HLO text that the JAX package compiles for its none, int8, twobit and
  overlapped exchanges on 8 CPU devices (as tests/test_comm.py:225-233 and
  tests/test_comm_overlap.py:259 build them), the Pallas kernel path
  included.
- The profiler table of a 2-rank gloo exchange equals ``allreduce_plan``
  and ``overlap_plan`` in payload and wire bytes per op, exactly, and the
  JAX package's ``hlo_collective_table`` of the same exchange on 2
  devices where the CPU's HLO keeps the payload's type (everything but
  twobit's bf16 all-gather, which XLA's CPU backend widens to f32). The
  port sends an int8 payload's codes and scales as two collectives, so
  its counts are the HLO's or larger.
- ``Monitor(track_comm)`` gives the JAX ``Monitor``'s rows over the same
  recorded plans and steps.
- On the card (tests/test_torch_resilience_card.py, ``-m cuda``) the
  kernel path's profiled exchange runs no slab-sized quantize pass as a
  torch operation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import mxnet_tpu as mx
from mxnet_tpu import comm as jcomm
from mxnet_tpu import parallel as jpar
from mxnet_tpu.compat import shard_map
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm as tcomm

from torch_ranks import comm_table_cases, run_ranks

HLO_NAMES = ["hlo_collective_rows", "hlo_collective_table",
             "hlo_collective_wire_bytes", "hlo_elementwise_table",
             "hlo_quantize_pass_count"]
HLO_L = 8 * 2048


def _mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return Mesh(np.array(devs[:n]), ("dp",))


def _exchange_hlo(mode, n, L, kernels=False, feedback=False):
    """The compiled HLO text of the JAX package's exchange of one ``L``
    gradient over ``n`` devices."""
    mesh = _mesh(n)
    rng = np.random.RandomState(0)
    g = rng.randn(n, L).astype(np.float32)
    spec = jcomm.CompressionSpec.resolve(mode)
    cfg = jcomm.CommKernelConfig(block_elems=512) if kernels else False
    if feedback:
        resid = np.zeros((n, jcomm.padded_flat_size(L, spec, n)), np.float32)

        def body(gs, r):
            out, new = jcomm.error_feedback_allreduce(
                {"w": gs[0]}, r, spec, axis_name="dp", axis_size=n,
                kernels=cfg)
            return out["w"][None], new

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                              out_specs=(P("dp"), P("dp")),
                              check_vma=False))
        return f.lower(g, resid).compile().as_text()

    def body(gs):
        out = jcomm.compressed_allreduce({"w": gs[0]}, mode, "dp",
                                         axis_size=n, average=True,
                                         kernels=cfg)
        return out["w"][None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"),
                          out_specs=P("dp"), check_vma=False))
    return f.lower(g).compile().as_text()


def _overlap_hlo():
    """The overlapped data-parallel step of tests/test_comm_overlap.py:259
    (three 256 x 256 layers, int8, three buckets) on 8 devices."""
    mesh = _mesh(8)
    rng = np.random.RandomState(0)
    params0 = {f"w{i}": (rng.randn(256, 256) * 0.05).astype(np.float32)
               for i in range(3)}
    num = sum(v.size for v in params0.values())

    def loss_fn(params, data):
        h = data["x"]
        for k in sorted(params):
            h = jnp.tanh(h @ params[k])
        return jnp.mean((h - data["y"]) ** 2)

    def update(params, s, grads):
        return {k: params[k] - 0.01 * grads[k] for k in params}, s

    x = rng.randn(64, 256).astype(np.float32)
    data = jpar.shard_batch({"x": x, "y": x}, mesh)
    spec = jcomm.CompressionSpec.resolve("int8")
    params = jpar.replicate_params(
        {k: jnp.asarray(v) for k, v in params0.items()}, mesh)
    cap = num * 4 // 3 + 4
    step = jpar.make_data_parallel_step(loss_fn, update, mesh, donate=False,
                                        compression="int8", overlap=cap)
    plan = jcomm.plan_overlap({k: v.shape for k, v in params0.items()},
                              spec, 8, max_bytes=cap)
    resid = {k: jax.device_put(v, NamedSharding(mesh, P("dp")))
             for k, v in jcomm.init_overlap_residuals(plan).items()}
    return step.lower(params, {}, data, resid).compile().as_text()


HLO_CASES = ["none", "int8", "twobit", "int8_feedback", "int8_kernels",
             "overlap"]


@pytest.fixture(scope="module")
def hlo_texts():
    texts = {}
    for case in HLO_CASES:
        if case == "overlap":
            texts[case] = _overlap_hlo()
        elif case == "int8_feedback":
            texts[case] = _exchange_hlo("int8", 8, HLO_L, feedback=True)
        elif case == "int8_kernels":
            texts[case] = _exchange_hlo("int8", 8, HLO_L, kernels=True,
                                        feedback=True)
        else:
            texts[case] = _exchange_hlo(None if case == "none" else case, 8,
                                        HLO_L)
    return texts


@pytest.mark.parametrize("name", HLO_NAMES)
@pytest.mark.parametrize("case", HLO_CASES)
def test_hlo_parsers_match_jax(hlo_texts, case, name):
    text = hlo_texts[case]
    if name in ("hlo_elementwise_table", "hlo_quantize_pass_count"):
        args = (text, HLO_L)
    else:
        args = (text, 8)
    got = getattr(tcomm, name)(*args)
    want = getattr(jcomm, name)(*args)
    assert got == want
    if name == "hlo_collective_table" and case != "none":
        assert {r["op"] for r in got} >= {"all-to-all", "all-gather"}
    if name == "hlo_quantize_pass_count" and case in ("int8_feedback",
                                                     "int8_kernels"):
        assert (got == 0) == (case == "int8_kernels")


def test_hlo_parsers_on_handwritten_text():
    """The forms the compiled CPU text may not show: async ``-start``
    halves, iota replica groups, tuple results."""
    text = "\n".join([
        "  %a = (f32[1024]{0}, f32[1024]{0}) all-reduce-start(f32[1024] %x),"
        " replica_groups={{0,1},{2,3}}",
        "  %b = f32[1024]{0} all-reduce-done((f32[1024], f32[1024]) %a)",
        "  %c = (s8[4,256]{1,0}, f32[4,1]{1,0}) all-to-all(s8[4,256] %q, "
        "f32[4,1] %s), replica_groups=[1,4]<=[4]",
        "  %d = (bf16[4,512]{1,0}, bf16[512]{0}) all-gather-start(bf16[512] "
        "%h), replica_groups={{0,1,2,3}}",
        "  %e = f32[256]{0} reduce-scatter(f32[1024] %y), "
        "replica_groups={{0,1,2,3}}",
        "  %f = u8[64]{0} collective-permute(u8[64] %z), "
        "source_target_pairs={{0,1}}",
        "  %g = f32[16384]{0} multiply(f32[16384] %p, f32[16384] %q)",
        "  %h = f32[16384]{0} round-nearest-even(f32[16384] %g)",
    ])
    for name in HLO_NAMES:
        args = (text, 16384) if "elementwise" in name or "pass" in name \
            else (text, 4)
        assert getattr(tcomm, name)(*args) == getattr(jcomm, name)(*args)
    assert tcomm.hlo_quantize_pass_count(text, 16384) == 2


# -- the profiled exchange -------------------------------------------------------

def _grads(world, shapes, seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(world, *s).astype(np.float32)
            for k, s in shapes.items()}


PROFILE_L = 2 * 4096 + 37
PROFILE_CASES = [
    dict(mode=None, feedback=False, cap=None),
    dict(mode="int8", feedback=False, cap=None),
    dict(mode="twobit", feedback=False, cap=None),
    dict(mode="int8", feedback=True, cap=None),
    dict(mode="twobit", feedback=True, cap=None),
    dict(mode="bf16", feedback=False, cap=None),
    dict(mode="int8", feedback=True, cap=3 * 64 * 64 * 4 // 2),
    dict(mode="twobit", feedback=True, cap=3 * 64 * 64 * 4 // 2),
]
OVERLAP_SHAPES = {"w0": (64, 64), "w1": (64, 64), "w2": (64, 64),
                  "b": (37,)}


def _case_id(c):
    return (f"{c['mode']}" + ("_ef" if c["feedback"] else "")
            + ("_overlap" if c["cap"] else ""))


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    cases = []
    for c in PROFILE_CASES:
        shapes = OVERLAP_SHAPES if c["cap"] else {"w": (PROFILE_L,)}
        cases.append({**c, "grads": _grads(2, shapes)})
    out = run_ranks(comm_table_cases, 2, tmp_path_factory.mktemp("table"),
                    cases)
    return cases, out


def _plan_of(case):
    spec = tcomm.CompressionSpec.resolve(case["mode"])
    shapes = {k: v.shape[1:] for k, v in case["grads"].items()}
    if case["cap"]:
        plan = tcomm.plan_overlap(shapes, spec, 2, max_bytes=case["cap"])
        return tcomm.overlap_plan(plan.bucket_elems(), 2, spec)
    return tcomm.allreduce_plan(tcomm.flat_size(
        {k: torch.zeros(s) for k, s in shapes.items()}), 2, spec)


def _by_op(rows):
    return {r["op"]: (r["payload_bytes"], r["wire_bytes"]) for r in rows}


@pytest.mark.parametrize("i", range(len(PROFILE_CASES)),
                         ids=[_case_id(c) for c in PROFILE_CASES])
def test_profiled_table_equals_the_plan(profiled, i):
    cases, out = profiled
    case = cases[i]
    plan = _plan_of(case)
    for rank in range(2):
        got = out[rank][i]
        assert _by_op(got["table"]) == _by_op(plan["collectives"])
        assert got["trace_table"] == got["table"]
        assert tcomm.collective_wire_bytes is not None
        assert sum(r["wire_bytes"] for r in got["table"]) == \
            plan["wire_bytes"]
        counts = {r["op"]: r["count"] for r in got["table"]}
        for r in plan["collectives"]:
            assert counts[r["op"]] >= r["count"]
        for row in got["rows"]:
            assert row["group_size"] == 2 and row["replica_groups"] == (1, 2)
        # the codec's full-slab passes run as torch operations here (the
        # overlapped buckets are each smaller than the whole gradient)
        assert got["passes"] == got["trace_passes"]
        if case["mode"] in ("int8", "twobit") and not case["cap"]:
            assert got["passes"] > 0


@pytest.mark.parametrize("mode", [None, "int8", "twobit"])
def test_profiled_table_equals_jax_hlo_table(profiled, mode):
    """Per op, the port's profiled exchange moves the bytes the JAX
    package's compiled exchange moves on 2 devices. Twobit's stage-2
    all-gather is bf16 in both, but XLA's CPU backend widens it to f32 in
    the HLO: there the HLO holds twice the plan's bytes."""
    cases, out = profiled
    i = next(j for j, c in enumerate(cases)
             if c["mode"] == mode and not c["feedback"] and not c["cap"])
    hlo = _exchange_hlo(mode, 2, PROFILE_L)
    want = _by_op(jcomm.hlo_collective_table(hlo, 2))
    got = _by_op(out[0][i]["table"])
    assert set(got) == set(want)
    for op, (payload, wire) in got.items():
        if mode == "twobit" and op == "all-gather":
            assert want[op] == (2 * payload, 2 * wire)
        else:
            assert want[op] == (payload, wire), op
    jrows = {r["op"]: r for r in jcomm.hlo_collective_table(hlo, 2)}
    for r in out[0][i]["table"]:
        assert r["replica_groups"] == jrows[r["op"]]["replica_groups"]
        if not (mode == "twobit" and r["op"] == "all-gather"):
            assert r["elements"] == jrows[r["op"]]["elements"]
            assert r["dtypes"] == jrows[r["op"]]["dtypes"]


def test_collective_ranges_cost_nothing_unprofiled():
    assert not torch.autograd.profiler._is_profiler_enabled
    ctx = tcomm.stats.collective_range("all-to-all", torch.int8, 10, 2)
    assert type(ctx).__name__ == "nullcontext"


def test_replica_group_exchange_is_profiled():
    """The in-process exchange of a ``ReplicaGroup`` records one row a
    collective, as one SPMD program holds one instruction."""
    from torch.profiler import ProfilerActivity, profile

    group = tcomm.ReplicaGroup(["cpu", "cpu"])
    rng = np.random.RandomState(0)
    L = 4096
    flats = [torch.from_numpy(rng.randn(L).astype(np.float32))
             for _ in range(2)]
    spec = tcomm.CompressionSpec.resolve("int8")
    Lp = tcomm.padded_flat_size(L, spec, 2)
    flats = [torch.cat([f, f.new_zeros(Lp - L)]) for f in flats]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tcomm.compressed_exchange(flats, spec, group=group)
    plan = tcomm.allreduce_plan(Lp, 2, spec)
    assert _by_op(tcomm.collective_table(prof)) == \
        _by_op(plan["collectives"])


# -- Monitor(track_comm) ------------------------------------------------------------

def test_monitor_track_comm_matches_jax():
    """The same plans and steps recorded in both registries give the JAX
    Monitor's rows, collection after collection."""
    tcomm.reset_comm_stats()
    jcomm.reset_comm_stats()
    mons = (mt.Monitor(1, track_comm=True), mx.Monitor(1, track_comm=True))
    plans = [("a", 8192, 2, "int8"), ("b", 1000, 4, "twobit"),
             ("c", 5000, 2, None)]
    for reg, pkg in ((tcomm.registry(), tcomm), (jcomm.registry(), jcomm)):
        for label, L, n, mode in plans:
            reg.register_plan(label, pkg.allreduce_plan(L, n, mode))
    collected = ([], [])
    for steps in ({"a": 3}, {"b": 1, "c": 2}, {}, {"a": 1, "b": 1}):
        for reg in (tcomm.registry(), jcomm.registry()):
            for label, k in steps.items():
                reg.record_step(label, k)
        for j, m in enumerate(mons):
            collected[j].append(m.collect_comm())
        tcomm.registry().record_host_bytes(sent=100, received=28)
        jcomm.registry().record_host_bytes(sent=100, received=28)
    assert collected[0] == collected[1]
    assert collected[0][2][0][2] == 0  # no steps in that window
    tcomm.reset_comm_stats()
    jcomm.reset_comm_stats()
