"""The port's program accounting and shape padding
(``mxnet_tpu_torch/utils/compile.py``) against the JAX package's
``utils/compile.py``: ``PadPolicy`` over a grid, ``graph_fingerprint``, the
programs a fit needs (tail batches with and without a pad policy, and a
bucketed fit), an armed ``RecompileTracker``, a padded fit's parameters,
``bucket_shapes``, ``precompile`` and the Monitor's compile rows.

The JAX package's ``compile_stats()["compiles"]`` also counts XLA compiles
of untracked operations (label ``<untracked>``: the metric's and the host's
small jnp programs); the port has none, so the comparison is of the tracked
programs: the compiles of every label but ``<untracked>``. On the CPU the
port captures nothing and counts each program key's first sight as one
compile, as the JAX package compiles once per program.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.utils import compile as jcm
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import compile as tcm

torch.set_num_threads(1)
mt.set_matmul_precision("highest")


def _mlp(pkg, hidden=16):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data=data, name="fc1", num_hidden=hidden)
    net = pkg.sym.Activation(data=net, name="relu1", act_type="relu")
    net = pkg.sym.FullyConnected(data=net, name="fc2", num_hidden=2)
    return pkg.sym.SoftmaxOutput(data=net, name="softmax")


def _blobs(n=100, dim=10, seed=0):
    rng = np.random.RandomState(seed)
    X = np.concatenate([rng.randn(n // 2, dim) + 1,
                        rng.randn(n - n // 2, dim) - 1]).astype(np.float32)
    y = np.concatenate([np.zeros(n // 2), np.ones(n - n // 2)]).astype(
        np.float32)
    order = rng.permutation(n)
    return X[order], y[order]


def _short_tail_iter(pkg, X, y, batch_size):
    """Full batches, then one genuinely short tail batch."""
    wrap = (lambda a: mx.nd.array(a)) if pkg is mx else torch.from_numpy

    class ShortTail(pkg.io.DataIter):
        def __init__(self):
            super().__init__()
            self.batch_size = batch_size
            self._i = 0

        def reset(self):
            self._i = 0

        @property
        def provide_data(self):
            return [("data", (batch_size,) + X.shape[1:])]

        @property
        def provide_label(self):
            return [("softmax_label", (batch_size,))]

        def next(self):
            s = self._i * batch_size
            if s >= len(X):
                raise StopIteration
            e = min(s + batch_size, len(X))
            self._i += 1
            return pkg.io.DataBatch([wrap(X[s:e])], [wrap(y[s:e])], pad=0)

    return ShortTail()


def _tracked_compiles(stats):
    return sum(c["compiles"] for label, c in stats["per_function"].items()
               if label != "<untracked>")


@pytest.mark.parametrize("rows", [1, 2, 3, 7, 8, 9, 31, 32, 33, 100])
@pytest.mark.parametrize("target", [1, 8, 32, 40, 64])
def test_pad_policy_rows_match_jax(rows, target):
    for mode in ("bucket", "pow2"):
        assert tcm.PadPolicy(mode).round_rows(rows, target) == \
            jcm.PadPolicy(mode).round_rows(rows, target)


def test_pad_policy_lengths_arrays_and_resolve(monkeypatch):
    for buckets in (None, [4, 16], [3, 5, 9, 17], [10, 20, 30, 40, 50, 60]):
        for length in range(1, 70):
            for mode in ("bucket", "pow2"):
                if mode == "bucket" and not buckets:
                    with pytest.raises(MXNetError):
                        tcm.PadPolicy(mode).round_length(length, buckets)
                    continue
                assert tcm.PadPolicy(mode).round_length(length, buckets) == \
                    jcm.PadPolicy(mode).round_length(length, buckets)
    arrays = {"data": np.arange(12, dtype=np.float32).reshape(3, 4),
              "label": np.arange(3, dtype=np.float32),
              "scalar": np.float32(2.0)}
    for target, pad in ((3, 0), (5, 0), (8, 1)):
        got, nv = tcm.PadPolicy().pad_arrays(arrays, target, pad=pad)
        want, nv_j = jcm.PadPolicy().pad_arrays(arrays, target, pad=pad)
        assert nv == nv_j
        for k in arrays:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
        tgot, _ = tcm.PadPolicy().pad_arrays(
            {k: torch.as_tensor(v) for k, v in arrays.items()}, target, pad)
        for k in arrays:
            np.testing.assert_array_equal(tgot[k].numpy(), np.asarray(want[k]))
    for value in (None, False, True, "bucket", "pow2"):
        a, b = tcm.PadPolicy.resolve(value), jcm.PadPolicy.resolve(value)
        assert (a is None and b is None) or a.key() == b.key()
    monkeypatch.setenv("MXNET_TPU_PAD_POLICY", "pow2")
    assert tcm.PadPolicy.resolve(None).key() == \
        jcm.PadPolicy.resolve(None).key() == ("pad_policy", "pow2")
    with pytest.raises(MXNetError):
        tcm.PadPolicy("nope")


@pytest.mark.parametrize("name", ["mlp", "lenet", "alexnet", "resnet50",
                                  "inception_bn"])
def test_graph_fingerprint_matches_jax(name, monkeypatch):
    from mxnet_tpu import name as jname
    from mxnet_tpu_torch import name as tname

    # fresh name managers: auto-named nodes count from zero in both
    with jname.NameManager():
        j = getattr(jmodels, name)()
    with tname.NameManager():
        t = getattr(tmodels, name)()
    assert tcm.graph_fingerprint(t) == jcm.graph_fingerprint(j)
    monkeypatch.setenv("MXNET_TPU_REMAT", r"unit\d+_out$")
    monkeypatch.setenv("MXNET_TPU_FUSE", "0")
    assert tcm.graph_fingerprint(t) == jcm.graph_fingerprint(j)


def _fit_programs(pkg, cm, pad_policy, epochs=2):
    X, y = _blobs(100)
    cm.reset_compile_stats()
    model = pkg.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=epochs,
                            learning_rate=0.5)
    model.fit(_short_tail_iter(pkg, X, y, 40), batch_size=40,
              pad_policy=pad_policy)
    return model, cm.compile_stats()


@pytest.mark.parametrize("pad_policy", [None, "bucket", "pow2"])
def test_tail_batch_programs_match_jax(pad_policy):
    _, j = _fit_programs(mx, jcm, pad_policy)
    _, t = _fit_programs(mt, tcm, pad_policy)
    assert t["compiles"] == _tracked_compiles(j) == \
        {None: 2, "bucket": 1, "pow2": 2}[pad_policy]
    jt = {k: v for k, v in j["per_function"].items()
          if k.startswith("train_step:")}
    tt = {k: v for k, v in t["per_function"].items()
          if k.startswith("train_step:")}
    assert list(tt) == list(jt)  # the same label: the graph's fingerprint
    assert [v["programs"] for v in tt.values()] == \
        [v["programs"] for v in jt.values()]
    assert t["eager"] == {"cpu context": 1}


def _sentences(n=48):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        length = int(rng.choice([3, 4, 6, 7]))
        s = [int(rng.randint(1, 8))]
        for _ in range(length - 1):
            s.append(s[-1] % 7 + 1)
        out.append(s)
    return out


def _bucketed(pkg, epochs=2, **kw):
    def sym_gen(seq_len):
        return pkg.models.lstm_unroll(num_layers=1, seq_len=seq_len,
                                      input_size=8, num_hidden=8,
                                      num_embed=4, num_label=8)

    init_states = [("l0_init_c", (8, 8)), ("l0_init_h", (8, 8))]
    it = pkg.BucketSentenceIter(_sentences(), buckets=[4, 8], batch_size=8,
                                init_states=init_states, shuffle=True)
    model = pkg.BucketingFeedForward(sym_gen, default_bucket_key=8,
                                     ctx=pkg.cpu(), num_epoch=epochs,
                                     optimizer="adam",
                                     learning_rate=0.02,
                                     initializer=pkg.init.Xavier(), **kw)
    return model, it


def test_bucketed_fit_programs_match_jax():
    counts = {}
    for names, cm in ((mx, jcm), (_TorchBucketing, tcm)):
        cm.reset_compile_stats()
        model, it = _bucketed(names)
        model.fit(it, batch_size=8)
        stats = cm.compile_stats()
        counts[cm.__name__] = (
            _tracked_compiles(stats) if cm is jcm else stats["compiles"],
            sorted(k for k in stats["per_function"]
                   if k.startswith("train_step:")))
    (jn, jl), (tn, tl) = counts[jcm.__name__], counts[tcm.__name__]
    assert tn == jn == 2
    assert tl == jl  # one label a bucket, as the JAX package names them


class _TorchBucketing:
    """The port's names as the JAX package's top level has them."""

    models = tmodels
    init = mt.init
    cpu = mt.cpu
    BucketSentenceIter = mt.bucketing.BucketSentenceIter
    BucketingFeedForward = mt.bucketing.BucketingFeedForward


def test_bucket_shapes_match_jax():
    sents = [[1, 2, 3], [2, 3, 4, 5, 6, 7], [3, 4], [1] * 7, [1] * 12] * 4
    init_states = [("l0_init_c", (4, 8)), ("l0_init_h", (4, 8))]
    for buckets, policy in (([4, 8], None), ([4, 8, 16], None),
                            (None, "pow2")):
        kw = dict(buckets=buckets, batch_size=4, init_states=init_states,
                  shuffle=False, pad_policy=policy)
        j = mx.BucketSentenceIter(sents, **kw).bucket_shapes()
        t = mt.bucketing.BucketSentenceIter(sents, **kw).bucket_shapes()
        assert [(b, d, lab) for b, d, lab in t] == \
            [(b, d, lab) for b, d, lab in j]


def test_armed_tracker_raises_at_the_same_step():
    steps = {}
    for pkg, cm in ((mx, jcm), (mt, tcm)):
        X, y = _blobs(100)
        model = pkg.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=2,
                                learning_rate=0.5)
        seen = []
        tracker = cm.RecompileTracker(raise_on_recompile=True)

        def count(_p, seen=seen, tracker=tracker):
            seen.append(1)
            if len(seen) == 1:
                tracker.arm()  # the 40-row program is warm; the tail is not

        try:
            with pytest.raises(cm.RecompileError):
                model.fit(_short_tail_iter(pkg, X, y, 40), batch_size=40,
                          batch_end_callback=count)
        finally:
            tracker.disarm()
        steps[pkg.__name__] = (len(seen), len(tracker.recompiles))
    assert steps["mxnet_tpu"] == steps["mxnet_tpu_torch"] == (2, 1)


def test_tracker_quiet_with_pad_policy():
    X, y = _blobs(100)
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=3,
                           learning_rate=0.5)
    tracker = tcm.RecompileTracker(raise_on_recompile=True)

    def arm_after_first(epoch, *_):
        if epoch == 0:
            tracker.arm()

    try:
        model.fit(_short_tail_iter(mt, X, y, 40), batch_size=40,
                  pad_policy="bucket", epoch_end_callback=arm_after_first)
    finally:
        tracker.disarm()
    assert tracker.recompiles == []
    acc = (model.predict(X, batch_size=40).argmax(axis=1) == y).mean()
    assert acc > 0.9, acc


@pytest.mark.parametrize("pad_policy", ["bucket", "pow2"])
def test_padded_fit_matches_jax_and_the_unpadded_fit(pad_policy):
    X, y = _blobs(100, seed=3)
    from mxnet_tpu_torch.convert import random_params

    init = random_params(_mlp(mt), 5, data=(40, 10))[0]

    def train(pkg, policy):
        arg = {k: (mx.nd.array(v) if pkg is mx else v)
               for k, v in init.items()}
        model = pkg.FeedForward(_mlp(pkg), ctx=pkg.cpu(), num_epoch=2,
                                learning_rate=0.5, arg_params=arg)
        model.fit(_short_tail_iter(pkg, X, y, 40), batch_size=40,
                  pad_policy=policy)
        return {k: (v.asnumpy() if pkg is mx else v.numpy())
                for k, v in model.arg_params.items()}

    j, t, t_plain = train(mx, pad_policy), train(mt, pad_policy), \
        train(mt, None)
    for k in j:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=3e-4, err_msg=k)
        np.testing.assert_allclose(t[k], t_plain[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_precompile_moves_no_state_and_fit_compiles_nothing():
    X, y = _blobs(80)
    from mxnet_tpu_torch.convert import random_params

    init = random_params(_mlp(mt), 6, data=(40, 10))[0]
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=2,
                           optimizer="adam", learning_rate=0.05,
                           arg_params=dict(init))
    mt.random.generator("cpu")
    rng_before = mt.random.get_state()
    out = model.precompile(data_shapes={"data": (40, 10)},
                           label_shapes={"softmax_label": (40,)})
    assert out["programs"] == 1 and out["labels"][0].startswith("train_step:")
    assert mt.random.get_state() == rng_before
    for k, v in init.items():
        assert np.array_equal(model.arg_params[k], v)
    state = model._train_state
    assert all(float(t) == 0.0 for _, _, t in state.opt_state.values())
    np.random.seed(0)  # the shuffle of fit's NDArrayIter
    with tcm.RecompileTracker(raise_on_recompile=True):
        model.fit(X, y, batch_size=40)
    assert model._train_state is state
    plain = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=2,
                           optimizer="adam", learning_rate=0.05,
                           arg_params=dict(init))
    np.random.seed(0)
    plain.fit(X, y, batch_size=40)
    for k in init:
        assert torch.equal(model.arg_params[k], plain.arg_params[k]), k


def test_bucketing_precompile_from_iterator():
    model, it = _bucketed(_TorchBucketing, epochs=1)
    out = model.precompile(data=it)
    assert out["programs"] == 2
    with tcm.RecompileTracker(raise_on_recompile=True):
        model.fit(it, batch_size=8)


def test_executor_precompile_counts_the_program():
    tcm.reset_compile_stats()
    exe = _mlp(mt).simple_bind(mt.cpu(), data=(4, 10), softmax_label=(4,))
    assert exe.precompile(is_train=False) == 0.0
    with tcm.RecompileTracker(raise_on_recompile=True):
        exe.forward()
    label = next(k for k in tcm.compile_stats()["per_function"]
                 if k.startswith("fwd_eval:"))
    stats = tcm.compile_stats()["per_function"][label]
    assert stats["precompiles"] == 1 and stats["compiles"] == 1
    assert stats["hits"] == 1
    # the training pair: nothing to capture on the CPU, the reason counted
    assert exe.precompile(is_train=True) == 0.0
    assert tcm.compile_stats()["eager"]["cpu context"] >= 1


def _train_pair_counts(pkg, cm):
    """precompile(is_train=True), then two forward/backward steps and one
    backward more: the per-kind counts of the training programs."""
    cm.reset_compile_stats()
    exe = _mlp(pkg).simple_bind(pkg.cpu(), data=(4, 10), softmax_label=(4,))
    seconds = exe.precompile(is_train=True)
    for _ in range(2):
        exe.forward(is_train=True)
        exe.backward()
    exe.backward()
    out = {}
    for label, c in cm.compile_stats()["per_function"].items():
        kind = next((k for k in ("fwd_train_res", "bwd_apply", "bwd_fused")
                     if k in label), None)
        if kind is not None:
            out[kind] = {f: c[f] for f in ("precompiles", "compiles",
                                          "misses", "hits")}
    return seconds, out


def test_executor_train_precompile_counts_as_jax():
    """The forward/backward pair's programs counted as the JAX package
    counts its ``fwd_train_res`` and ``bwd_apply`` programs; a second
    backward after one forward is one more sight of the backward (the JAX
    package recomputes it as ``bwd_fused``, a program of its own)."""
    seconds, port = _train_pair_counts(mt, tcm)
    _, ref = _train_pair_counts(mx, jcm)
    assert seconds == 0.0
    assert port["fwd_train_res"] == ref["fwd_train_res"]
    assert ref["fwd_train_res"]["precompiles"] == 1
    # the port's one backward program serves both of the JAX package's:
    # the JAX package's sights of bwd_fused are hits of bwd_apply here
    want = dict(ref["bwd_apply"])
    want["hits"] += ref["bwd_fused"]["misses"] + ref["bwd_fused"]["hits"]
    assert port["bwd_apply"] == want


def test_executor_train_after_precompile_matches_eager():
    """On the CPU ``precompile(is_train=True)`` moves nothing: the
    gradients and running statistics of the steps after it are bitwise
    those of an executor that never precompiled."""
    net = _mlp(mt)
    rng = np.random.default_rng(2)
    feed = {"data": torch.from_numpy(rng.standard_normal((4, 10)).astype(
        np.float32)), "softmax_label": torch.tensor([0.0, 1, 1, 0])}
    grads = []
    for pre in (True, False):
        exe = net.simple_bind(mt.cpu(), data=(4, 10), softmax_label=(4,))
        for k, v in exe.arg_dict.items():
            if k not in feed:
                v.copy_(torch.from_numpy(rng.standard_normal(
                    tuple(v.shape)).astype(np.float32)) if pre else
                    grads[0][1][k])
        if pre:
            assert exe.precompile(is_train=True) == 0.0
        exe.forward(is_train=True, **feed)
        exe.backward()
        grads.append(({k: v.clone() for k, v in exe.grad_dict.items()},
                      {k: v.clone() for k, v in exe.arg_dict.items()}))
    for k, g in grads[0][0].items():
        assert torch.equal(g, grads[1][0][k]), k


def test_monitor_compile_rows_named_as_jax():
    import jax.numpy as jnp

    rows = {}
    for pkg, cm in ((mx, jcm), (mt, tcm)):
        mon = pkg.Monitor(interval=1, track_compiles=True)
        mon.collect_compiles()  # the baseline
        if pkg is mx:
            f = cm.tracked_jit(lambda x: x * 3, label="unit:mon")
            f(jnp.ones((6,)))
            tr = cm.RecompileTracker(monitor=mon).arm()
            f(jnp.ones((9,)))
        else:
            seen = set()
            cm.registry().see("unit:mon", ("shape", 6), seen)
            tr = cm.RecompileTracker(monitor=mon).arm()
            cm.registry().see("unit:mon", ("shape", 9), seen)
        tr.disarm()
        # the JAX package also reports XLA compiles of untracked jnp
        # operations (here its ones(...)); the port has no such programs
        got = [r for r in mon.collect_compiles()
               if r[1] != "compile/<untracked>"]
        rows[pkg.__name__] = sorted(name for _, name, _ in got)
        assert mon._recompile_events == []
        by_name = {name: v for _, name, v in got}
        assert by_name["compile/jit_misses"] >= 1
    assert rows["mxnet_tpu"] == rows["mxnet_tpu_torch"] == sorted(
        ["compile/count", "compile/seconds", "compile/jit_misses",
         "compile/unit:mon", "recompile/unit:mon"])


def test_monitor_toc_carries_compile_rows():
    exe = _mlp(mt).simple_bind(mt.cpu(), data=(4, 10), softmax_label=(4,))
    mon = mt.Monitor(interval=1, pattern="fc1_output", track_compiles=True)
    mon.install(exe)
    mon.tic()
    exe.forward()
    names = [name for _, name, _ in mon.toc()]
    assert names[0] == "fc1_output"
    assert "compile/count" in names and "compile/jit_misses" in names


def test_stats_keys_and_persistent_cache(monkeypatch):
    stats = tcm.compile_stats()
    assert {"compiles", "compile_seconds", "misses", "hits",
            "per_function"} <= set(stats)
    assert {"captures", "capture_seconds", "pool_bytes", "eager"} <= \
        set(stats)
    monkeypatch.setenv("MXNET_TPU_COMPILE_CACHE", "1")
    assert tcm.configure_persistent_cache() is None
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "0")
    assert not tcm.graphs_enabled()
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    assert tcm.graphs_enabled()


def test_eager_reasons_in_order(monkeypatch):
    """The reasons every captured entry point shares, for a card device
    (nothing touches it) and the CPU, in the order they are checked."""
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    assert tcm.eager_reason(card) is None
    assert tcm.eager_reason(card, native=True).startswith("a _Native")
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "0")
    assert tcm.eager_reason(card) == "MXTPU_CUDA_GRAPHS=0"
    assert tcm.eager_reason(card, native=True).startswith("a _Native")
    assert tcm.eager_reason(cpu) == tcm.eager_reason(cpu, True) == \
        "cpu context"
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu())
    monkeypatch.setattr(mt.FeedForward, "_device",
                        property(lambda self: card))
    assert model._eager_reason() == "MXTPU_CUDA_GRAPHS=0"
    assert model._eager_reason(dist_sync=True).startswith("kvstore")


def test_remat_steps_are_captured(monkeypatch):
    """A fit under ``MXNET_TPU_REMAT`` has no eager reason of its own on a
    card device (nothing touches it): its steps are captured."""
    card = torch.device("cuda", 0)
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    monkeypatch.setenv("MXNET_TPU_REMAT", r"fc1$")
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu())
    monkeypatch.setattr(mt.FeedForward, "_device",
                        property(lambda self: card))
    assert model._eager_reason() is None


def _dropout_step(monkeypatch, remat):
    """Gradients of one training step of a net with two Dropouts, and the
    draws the step made."""
    if remat:
        monkeypatch.setenv("MXNET_TPU_REMAT", r"drop\d$")
    else:
        monkeypatch.delenv("MXNET_TPU_REMAT", raising=False)
    s = mt.sym
    net = s.Variable("data")
    for i in (1, 2):
        net = s.FullyConnected(data=net, name=f"fc{i}", num_hidden=16)
        net = s.Dropout(data=net, name=f"drop{i}", p=0.5)
    net = s.SoftmaxOutput(data=s.FullyConnected(data=net, name="fc3",
                                                num_hidden=3), name="softmax")
    exe = net.simple_bind(mt.cpu(), data=(4, 10), softmax_label=(4,))
    rng = np.random.RandomState(0)
    for name, arr in sorted(exe.arg_dict.items()):
        arr.copy_(torch.from_numpy(
            rng.standard_normal(tuple(arr.shape)).astype(np.float32)))
    exe.arg_dict["softmax_label"].copy_(torch.tensor([0.0, 1.0, 2.0, 1.0]))
    mt.random.seed(3)
    draws, real = [], torch.rand
    monkeypatch.setattr(torch, "rand",
                        lambda *a, **k: draws.append(a) or real(*a, **k))
    exe.forward(is_train=True)
    exe.backward()
    monkeypatch.setattr(torch, "rand", real)
    return {k: v.detach().clone() for k, v in exe.grad_dict.items()
            if v is not None}, draws


def test_remat_recompute_reads_back_the_forwards_draws(monkeypatch):
    """Each Dropout draws once a remat step (its recompute reads the
    forward's draws back from the tape: no generator state is read or
    restored, which a CUDA graph could not hold), and the gradients are
    bitwise the plain step's."""
    plain, plain_draws = _dropout_step(monkeypatch, remat=False)
    remat, remat_draws = _dropout_step(monkeypatch, remat=True)
    assert len(plain_draws) == len(remat_draws) == 2
    assert sorted(remat) == sorted(plain) and "fc1_weight" in plain
    for k in plain:
        assert torch.equal(remat[k], plain[k]), k


def test_remat_tape_keeps_what_the_plain_step_keeps(monkeypatch):
    """A remat block's tape holds what each node keeps from its draw, as
    the plain step's autograd does: Dropout's bool mask (1 byte an
    element, not the f32 uniforms) and rrelu's slopes in the input's
    dtype; the recompute reads them back bitwise."""
    from mxnet_tpu_torch.ops import OPS
    from mxnet_tpu_torch.ops.registry import DrawTape

    tapes, real_init = [], DrawTape.__init__
    monkeypatch.setattr(DrawTape, "__init__",
                        lambda self: tapes.append(self) or real_init(self))
    _dropout_step(monkeypatch, remat=True)
    kept = [t for tape in tapes for t in tape.kept]
    assert [(t.dtype, tuple(t.shape)) for t in kept] == \
        [(torch.bool, (4, 16))] * 2
    rrelu = OPS.create("LeakyReLU", act_type="rrelu")
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (3, 5)).astype(np.float32)).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    plain = rrelu.fwd([x], [], True, gen)[0][0]
    tape = DrawTape()
    gen.manual_seed(2)
    with tape.active(replay=False):
        fwd = rrelu.fwd([x], [], True, gen)[0][0]
    with tape.active(replay=True):
        again = rrelu.fwd([x], [], True, gen)[0][0]
    assert [t.dtype for t in tape.kept] == [torch.bfloat16]
    assert torch.equal(fwd, plain) and torch.equal(again, plain)


def test_eager_entry_points_count_their_reason(monkeypatch):
    """predict and score count one eager run a call, a Predictor one a
    program (at its first request), Executor.precompile one a call; on
    the CPU the reason is the device, whatever MXTPU_CUDA_GRAPHS says."""
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "0")
    X, y = _blobs(100)
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.5)
    model.fit(X, y, batch_size=50)
    tcm.reset_compile_stats()
    model.predict(X, batch_size=50)
    model.score(X, y=y, batch_size=50)
    assert tcm.compile_stats()["eager"] == {"cpu context": 2}
    pred = mt.Predictor(_mlp(mt), model.arg_params, ctx=mt.cpu())
    for rows in (4, 4, 8, 4):
        pred.forward(data=X[:rows])
    assert tcm.compile_stats()["eager"] == {"cpu context": 4}
    exe = _mlp(mt).simple_bind(mt.cpu(), data=(4, 10), softmax_label=(4,))
    assert exe.precompile() == 0.0
    assert tcm.compile_stats()["eager"] == {"cpu context": 5}


def test_predict_and_score_count_eval_programs():
    X, y = _blobs(100)
    model = mt.FeedForward(_mlp(mt), ctx=mt.cpu(), num_epoch=1,
                           learning_rate=0.5)
    model.fit(X, y, batch_size=50)
    tcm.reset_compile_stats()
    model.predict(X, batch_size=50)
    model.score(X, y=y, batch_size=50)
    evals = {k: v for k, v in tcm.compile_stats()["per_function"].items()
             if k.startswith("eval_step:")}
    # one eval program (the label heads zero-filled for predict, given
    # for score: the same shapes), seen four times
    assert len(evals) == 1
    (c,) = evals.values()
    assert c["compiles"] == 1 and c["hits"] == 3
