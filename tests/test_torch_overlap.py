"""The port's overlapped per-bucket gradient exchange (``comm/bucketing.py``,
``comm/overlap.py``, ``comm.stats.overlap_plan``, ``fit(overlap=...)``)
against the JAX package's (tests/test_comm_overlap.py).

- The config, the reverse-topological order, the plans (bucket names,
  keys, shapes, sizes, padding), the layout keys and ``overlap_plan`` equal
  the reference's exactly, over a (37, 29) / (29,) / (3,) tree, three
  1000-element leaves and a small MLP symbol, at several caps, modes and
  axis sizes; the per-bucket plans sum exactly to the fused plan.
- ``overlap_allreduce`` on 2 and 4 gloo CPU ranks equals the reference's
  in ``shard_map`` on a dp=2 / dp=4 CPU mesh, with the bounds
  tests/test_torch_comm.py states for each mode: bitwise for bf16 and
  twobit and for every kernel path; the int8 codec path within one
  quantization step of the reduced values (XLA fuses the decode into the
  sum as an FMA; the port rounds each product first).
- The hook schedule (``OverlapSchedule``: each bucket exchanged on the
  comm thread as soon as backward filled it, a bucket with a parameter
  that gets no gradient started after backward) gives the same gradients
  and residuals as ``overlap_allreduce`` after backward, bitwise.
- ``fit(kvstore="dist_sync", compression=int8|twobit, overlap=2048)`` over
  3 steps on 2 ranks tracks the JAX package's fit on a dp=2 mesh within
  the bounds of tests/test_torch_data_parallel.py (cross-entropy 1e-5
  relative, parameters 2e-4 absolute, running stats 1e-5 relative), its
  ranks bitwise equal, its plan the reference's and its wire bytes the
  plan's.
"""

import logging

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

import mxnet_tpu as mx
from mxnet_tpu import comm as jcomm
from mxnet_tpu.compat import shard_map
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params
from torch_ranks import fit_dist_sync, overlap_cases, run_ranks, small_net

torch.set_num_threads(1)

SHAPES = {"w": (37, 29), "b": (29,), "a": (3,)}   # 1105 elements
CHUNK = 64
CAP = 1200  # bytes: w alone, then b and a


def _mlp(pkg, hidden=64):
    s = pkg.symbol
    net = s.FullyConnected(data=s.Variable("data"), name="fc1",
                           num_hidden=hidden)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=2)
    return s.SoftmaxOutput(data=net, name="softmax")


# -- config, order, plans --------------------------------------------------------

@pytest.mark.parametrize("pkg", [jcomm, tcomm], ids=["jax", "port"])
def test_overlap_config_resolve(pkg, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_COMM_OVERLAP", raising=False)
    assert pkg.OverlapConfig.resolve(None) is None
    assert pkg.OverlapConfig.resolve(False) is None
    cfg = pkg.OverlapConfig.resolve(True)
    assert cfg.bucket_bytes == pkg.DEFAULT_BUCKET_BYTES == 4 << 20
    assert pkg.OverlapConfig.resolve(1 << 20).bucket_bytes == 1 << 20
    assert pkg.OverlapConfig.resolve(cfg) is cfg
    assert cfg.key() == ("overlap", 4 << 20)
    monkeypatch.setenv("MXNET_TPU_COMM_OVERLAP", "1")
    assert pkg.OverlapConfig.resolve(None).bucket_bytes == 4 << 20
    monkeypatch.setenv("MXNET_TPU_COMM_OVERLAP", "65536")
    assert pkg.OverlapConfig.resolve(None).bucket_bytes == 65536
    monkeypatch.setenv("MXNET_TPU_COMM_OVERLAP", "off")
    assert pkg.OverlapConfig.resolve(None) is None
    with pytest.raises(Exception, match="overlap="):
        pkg.OverlapConfig.resolve("garbage")
    with pytest.raises(Exception, match="positive"):
        pkg.OverlapConfig(0)


def test_reverse_topo_param_order_matches_reference():
    names = ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
    for extra in ([], ["orphan"]):
        want = jcomm.reverse_topo_param_order(_mlp(mx), names + extra)
        got = tcomm.reverse_topo_param_order(_mlp(mt), names + extra)
        assert got == want
    assert got[:2] == ["fc2_weight", "fc2_bias"] and got[-1] == "orphan"
    net = small_net(mt)
    args = [n for n in net.list_arguments()
            if n not in ("data", "softmax_label")]
    assert tcomm.reverse_topo_param_order(net, args) == \
        jcomm.reverse_topo_param_order(small_net(mx), args)


def _plan_sets():
    mlp = {"fc1_weight": (64, 10), "fc1_bias": (64,), "fc2_weight": (2, 64),
           "fc2_bias": (2,)}
    return [("tree", SHAPES, None), ("abc", {"a": (1000,), "b": (1000,),
                                             "c": (1000,)}, None),
            ("mlp", mlp, "mlp"), ("scalar", {"s": (), "v": (5,)}, None)]


def _same_plan(got, want):
    assert got.axis_size == want.axis_size
    assert got.num_buckets == want.num_buckets
    for g, w in zip(got.buckets, want.buckets):
        assert g["name"] == w["name"] and g["keys"] == w["keys"]
        assert [tuple(s) for s in g["shapes"]] == \
            [tuple(s) for s in w["shapes"]]
        assert g["size"] == w["size"] and g["padded"] == w["padded"]
    assert got.layout_key() == want.layout_key()
    assert got.bucket_elems() == want.bucket_elems()
    assert got.padded_sizes() == want.padded_sizes()
    assert got.param_keys() == want.param_keys()
    assert got.wire_plan() == want.wire_plan()


@pytest.mark.parametrize("mode", ["bf16", "int8", "twobit"])
@pytest.mark.parametrize("axis", [1, 2, 4, 8])
def test_plan_overlap_matches_reference(mode, axis):
    """Bucket names, order, keys, sizes, padding, layout keys and wire
    plans equal the JAX package's exactly, at caps from one element per
    bucket to one bucket for all; ``replan`` too."""
    for _, shapes, sym_kind in _plan_sets():
        for cap in (4, 600, 4096, 1 << 30):
            jsym = _mlp(mx) if sym_kind else None
            tsym = _mlp(mt) if sym_kind else None
            want = jcomm.plan_overlap(shapes, mode, axis, max_bytes=cap,
                                      symbol=jsym)
            got = tcomm.plan_overlap(shapes, mode, axis, max_bytes=cap,
                                     symbol=tsym)
            _same_plan(got, want)
            _same_plan(got.replan(3), want.replan(3))
            assert got.layout_key() != got.replan(axis + 1).layout_key()
    with pytest.raises(MXNetError, match="compression"):
        tcomm.plan_overlap(SHAPES, None, 2)


def test_overlap_plan_matches_reference_and_sums_to_fused():
    for mode in (None, "bf16", "int8", "twobit"):
        for axis in (1, 2, 4, 8):
            for elems in ([("b0", 4096)], [("b0", 1000), ("b1", 517)],
                          [("b0", 100), ("b1", 33), ("b2", 7),
                           ("b3", 70000)]):
                got = tcomm.overlap_plan(elems, axis, mode)
                assert got == jcomm.overlap_plan(elems, axis, mode)
                assert got["num_buckets"] == len(elems)
                if mode is not None:
                    assert got["matches_fused"], (mode, axis, elems)
                if axis == 1:
                    assert got["wire_bytes"] == 0.0


def test_layout_keys_efficiency_and_residual_ledgers():
    spec_t, spec_j = tcomm.CompressionSpec("int8"), jcomm.CompressionSpec(
        "int8")
    for n, axis in ((1600, 8), (1601, 8), (1600, 4)):
        assert tcomm.fused_layout_key(n, spec_t, axis) == \
            jcomm.fused_layout_key(n, spec_j, axis)
    for step, comp, comm_s in ((1.0, 0.8, 0.5), (1.3, 0.8, 0.5),
                               (0.8, 0.8, 0.5), (2.0, 0.8, 0.5),
                               (1.0, 0.0, 0.5), (0.1, 0.8, 0.5)):
        assert tcomm.overlap_efficiency(step, comp, comm_s) == \
            jcomm.overlap_efficiency(step, comp, comm_s)
    shapes = {"a": (1000,), "b": (600,)}
    plan = tcomm.plan_overlap(shapes, "int8", 8, max_bytes=4096)
    res = tcomm.init_overlap_residuals(plan)
    # this rank's rows of the reference's (axis_size, Lp_b) ledgers
    jres = jcomm.init_overlap_residuals(jcomm.plan_overlap(
        shapes, "int8", 8, max_bytes=4096))
    assert {k: (1,) + tuple(v.shape[1:]) for k, v in jres.items()} == \
        {k: tuple(v.shape) for k, v in res.items()}
    assert tcomm.residuals_match_plan(res, plan)
    assert not tcomm.residuals_match_plan(
        res, tcomm.plan_overlap(shapes, "int8", 8, max_bytes=1 << 30))
    assert not tcomm.residuals_match_plan(None, plan)
    assert not tcomm.residuals_match_plan({"bucket0": res["bucket0"]}, plan)
    bplan = tcomm.plan_overlap(shapes, "bf16", 8)
    assert tcomm.init_overlap_residuals(bplan) is None
    assert tcomm.residuals_match_plan(None, bplan)
    with pytest.raises(MXNetError, match="do not match the plan"):
        tcomm.overlap_allreduce({"zz": torch.zeros(8)}, None, bplan)


# -- the exchange on gloo ranks against shard_map --------------------------------

MODES = ("bf16", "int8", "twobit")


def _cases(world):
    cases = []
    for i, mode in enumerate(MODES):
        spec = jcomm.CompressionSpec(mode, chunk=CHUNK)
        plan = jcomm.plan_overlap(SHAPES, spec, world, max_bytes=CAP)
        rng = np.random.RandomState(i)
        grads = {k: (rng.randn(world, *s) * 0.6).astype(np.float32)
                 for k, s in SHAPES.items()}
        for kernels in (False, True):
            resid = None
            if spec.error_feedback:
                resid = {b["name"]: (rng.randn(world, b["padded"]) * 0.05)
                         .astype(np.float32) for b in plan.buckets}
            cases.append({"mode": mode, "kernels": kernels, "chunk": CHUNK,
                          "cap": CAP, "grads": grads, "resid": resid,
                          "unused": "a" if kernels else None})
    return cases


def _jax_case(case, world):
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    spec = jcomm.CompressionSpec(case["mode"], chunk=case["chunk"])
    plan = jcomm.plan_overlap(SHAPES, spec, world, max_bytes=case["cap"])
    cfg = jcomm.CommKernelConfig() if case["kernels"] else False
    grads = dict(case["grads"])
    if case["unused"] is not None:
        grads[case["unused"]] = np.zeros_like(grads[case["unused"]])
    if case["resid"] is not None:
        def body(t, r):
            t = {k: v[0] for k, v in t.items()}
            out, new = jcomm.overlap_allreduce(t, r, plan, kernels=cfg)
            return {k: v[None] for k, v in out.items()}, new

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                              out_specs=(P("dp"), P("dp")), check_vma=False))
        out, new = f(grads, case["resid"])
        return ({k: np.asarray(v) for k, v in out.items()},
                {k: np.asarray(v) for k, v in new.items()}, plan)

    def body(t):
        t = {k: v[0] for k, v in t.items()}
        out, _ = jcomm.overlap_allreduce(t, None, plan, kernels=cfg)
        return {k: v[None] for k, v in out.items()}

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"),
                          out_specs=P("dp"), check_vma=False))
    return {k: np.asarray(v) for k, v in f(grads).items()}, None, plan


_RUNS = {}


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def run(request, tmp_path_factory):
    world = request.param
    if world not in _RUNS:
        cases = _cases(world)
        port = run_ranks(overlap_cases, world,
                         tmp_path_factory.mktemp(f"o{world}"), cases)
        ref = [_jax_case(c, world) for c in cases]
        _RUNS[world] = (cases, port, ref)
    return (world,) + _RUNS[world]


def _bitwise(got, want, what):
    assert got.shape == want.shape, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        f"{what}: {(got != want).sum()} of {got.size} differ, max "
        f"{np.abs(got - want).max()}")


CASE_KEYS = [(m, k) for m in MODES for k in (False, True)]


def _index(cases, mode, kernels):
    return next(i for i, c in enumerate(cases)
                if (c["mode"], c["kernels"]) == (mode, kernels))


@pytest.mark.parametrize("key", CASE_KEYS,
                         ids=[f"{m}-{'kernels' if k else 'codec'}"
                              for m, k in CASE_KEYS])
def test_overlap_allreduce_matches_jax(run, key):
    world, cases, port, ref = run
    i = _index(cases, *key)
    mode, kernels = key
    want_out, want_res, plan = ref[i]
    step = np.abs(np.concatenate(
        [want_out[k].ravel() for k in SHAPES])).max() / 127.0
    for rank in range(world):
        got = port[rank][i]
        assert got["plan"] == plan.layout_key()
        for k in SHAPES:
            g, w = got["after"][k], want_out[k][rank]
            if mode == "int8" and not kernels:
                assert np.abs(g - w).max() <= step * 1.01, (rank, k)
            else:
                _bitwise(g, w, f"rank {rank} {k}")
        if want_res is None:
            assert got["resid_after"] is None
            continue
        for b, w in want_res.items():
            g = got["resid_after"][b][0]
            if kernels or mode != "int8":
                _bitwise(g, w[rank], f"rank {rank} residual {b}")
            else:
                assert np.abs(g - w[rank]).max() <= step * 1.01


@pytest.mark.parametrize("key", CASE_KEYS,
                         ids=[f"{m}-{'kernels' if k else 'codec'}"
                              for m, k in CASE_KEYS])
def test_hook_schedule_equals_exchange_after_backward(run, key):
    """Buckets exchanged on the comm thread while backward runs (with a
    parameter left out of the loss in the kernel cases) equal the
    exchange after backward, gradients and residuals, bitwise."""
    world, cases, port, _ = run
    i = _index(cases, *key)
    for rank in range(world):
        got = port[rank][i]
        for k in SHAPES:
            _bitwise(got["during"][k], got["after"][k], f"rank {rank} {k}")
        if got["resid_after"] is None:
            assert got["resid_during"] is None
            continue
        for b, r in got["resid_after"].items():
            _bitwise(got["resid_during"][b], r, f"rank {rank} {b}")


# -- fit(overlap=...) on two ranks against the JAX mesh fit ----------------------

WORLD, BATCH, EPOCHS = 2, 16, 3
FIT_KW = dict(optimizer="adam", fused=True, learning_rate=0.01, epsilon=1e-3)
OVERLAP_CAP = 2048  # small_net's 938 parameters in 3 buckets


def _data(seed=4):
    net = small_net(mt)
    args, aux = random_params(net, seed, data=(BATCH, 16))
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((BATCH, 16)).astype(np.float32)
    Y = rng.integers(0, 10, BATCH).astype(np.float32)
    return args, aux, X, Y


def _jax_fit(args, aux, X, Y, fit_kw):
    epochs, sums = [], []
    jm = mx.FeedForward(
        small_net(mx), ctx=[mx.cpu(0), mx.cpu(1)], num_epoch=EPOCHS,
        arg_params={k: mx.nd.array(v) for k, v in args.items()},
        aux_params={k: mx.nd.array(v) for k, v in aux.items()}, **FIT_KW)
    jm.fit(mx.io.NDArrayIter(X, Y, batch_size=BATCH, shuffle=False),
           eval_metric="ce",
           epoch_end_callback=lambda e, s, a, x: epochs.append(
               ({k: v.asnumpy() for k, v in a.items()},
                {k: v.asnumpy() for k, v in x.items()})),
           batch_end_callback=lambda p: sums.append(p.eval_metric.sum_metric),
           **fit_kw)
    return epochs, sums


_FITS = {}


@pytest.fixture(scope="module", params=["int8", "twobit"])
def fits(request, tmp_path_factory):
    mode = request.param
    if mode not in _FITS:
        args, aux, X, Y = _data()
        fit_kw = dict(compression=mode, comm_kernels=True,
                      overlap=OVERLAP_CAP)
        port = run_ranks(fit_dist_sync, WORLD,
                         tmp_path_factory.mktemp(f"ofit_{mode}"), args, aux,
                         X, Y, EPOCHS, fit_kw, FIT_KW)
        _FITS[mode] = (args, aux, port, _jax_fit(args, aux, X, Y, fit_kw))
    return (mode,) + _FITS[mode]


def test_fit_overlap_loss_and_params_track_jax(fits):
    mode, args, aux, port, (jepochs, jsums) = fits
    ce_port = np.sum([r["ce_sums"] for r in port], axis=0) / BATCH
    np.testing.assert_allclose(ce_port, np.asarray(jsums) / BATCH, rtol=1e-5)
    assert ce_port[-1] < ce_port[0]
    for step, (jargs, jaux) in enumerate(jepochs):
        targs, taux = port[0]["epochs"][step]
        for k in args:
            np.testing.assert_allclose(targs[k], jargs[k], rtol=0, atol=2e-4,
                                       err_msg=f"{mode} step {step} {k}")
        for k in aux:
            np.testing.assert_allclose(taux[k], jaux[k], rtol=1e-5,
                                       atol=1e-6,
                                       err_msg=f"{mode} step {step} {k}")


def test_fit_overlap_ranks_bitwise_plan_and_wire(fits):
    mode, args, aux, port, _ = fits
    for step in range(EPOCHS):
        for part in (0, 1):
            a, b = port[0]["epochs"][step][part], port[1]["epochs"][step][part]
            for k in a:
                assert np.array_equal(a[k].view(np.uint32),
                                      b[k].view(np.uint32)), (step, k)
    shapes = {k: v.shape for k, v in args.items()}
    want = jcomm.plan_overlap(shapes, mode, WORLD, max_bytes=OVERLAP_CAP,
                              symbol=small_net(mx))
    assert want.num_buckets == 3
    wire = want.wire_plan()
    for res in port:
        assert res["plan"]["layout_key"] == want.layout_key()
        assert [b["keys"] for b in res["plan"]["buckets"]] == \
            [b["keys"] for b in want.buckets]
        per = res["stats"]["per_program"]["train_step:dist_sync"]
        assert per["num_buckets"] == 3 and per["matches_fused"]
        assert res["stats"]["wire_bytes"] == EPOCHS * wire["wire_bytes"]
        assert res["residual"] is None
        assert {k: v.shape for k, v in res["residuals"].items()} == \
            {b["name"]: (1, b["padded"]) for b in want.buckets}
        assert all(np.isfinite(v).all() for v in res["residuals"].values())
    assert not all(np.array_equal(port[0]["residuals"][b],
                                  port[1]["residuals"][b])
                   for b in port[0]["residuals"])


def test_fit_overlap_needs_compression_and_is_ignored_alone(caplog):
    """One rank: compression and overlap are ignored (nothing crosses a
    wire); the logs say which."""
    args, aux, X, Y = _data()
    model = mt.FeedForward(small_net(mt), ctx=mt.cpu(), num_epoch=1,
                           arg_params=args, aux_params=aux, **FIT_KW)
    with caplog.at_level(logging.INFO):
        model.fit(X, Y, batch_size=8, kvstore="dist_sync",
                  compression="int8", overlap=True)
    assert "compression=int8 ignored" in caplog.text
    assert model._train_state.grad_sync is None


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_hook_schedule_on_card_equals_cpu_exchange(cuda_device, tmp_path):
    """Two gloo ranks sharing the card: the schedule on the card (side
    stream, events, the comm kernels) gives the CPU exchange's gradients
    and residuals (the kernels' plain versions) bitwise."""
    cases = [c for c in _cases(WORLD) if c["kernels"]]
    port = run_ranks(overlap_cases, WORLD, tmp_path, cases, "cuda")
    for case, res in zip(cases, zip(*port)):
        for rank, got in enumerate(res):
            for k in SHAPES:
                _bitwise(got["during"][k], got["after"][k],
                         f"{case['mode']} rank {rank} {k}")
            for b, r in (got["resid_after"] or {}).items():
                _bitwise(got["resid_during"][b], r, f"rank {rank} {b}")
