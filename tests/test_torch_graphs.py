"""Captured steps (``utils.compile.CapturedProgram``) on the card: each
captured run held bit for bit to the eager run of the same steps where the
step is deterministic (cuBLAS GEMMs, the hand-written kernels), launches
counted by replay, the per-step values (lr, Adam's bias corrections) read at
every replay, Dropout's masks drawn anew at each replay as the eager steps
draw them, and ``precompile`` capturing ahead of ``fit``. All need the card
(``-m cuda``); ``chip_smoke.py``'s ``graphs`` phase holds the same at full
width."""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.kernels import fused_adam as kfa
from mxnet_tpu_torch.kernels import int8_matmul as k8
from mxnet_tpu_torch.utils import compile as tcm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    mt.set_matmul_precision("highest")
    return torch.device("cuda", 0)


def _mlp(hidden=64, dropout=False):
    net = mt.sym.FullyConnected(data=mt.sym.Variable("data"), name="fc1",
                                num_hidden=hidden)
    net = mt.sym.Activation(data=net, name="relu1", act_type="relu")
    if dropout:
        net = mt.sym.Dropout(data=net, name="drop1", p=0.5)
    net = mt.sym.FullyConnected(data=net, name="fc2", num_hidden=4)
    return mt.sym.SoftmaxOutput(data=net, name="softmax")


def _fit(net, X, y, monkeypatch, graphs, **kw):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1" if graphs else "0")
    mt.random.seed(0)
    from mxnet_tpu_torch.convert import random_params

    args = random_params(net, 2, data=(32,) + X.shape[1:])[0]
    model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1,
                           arg_params=args, **kw)
    model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False))
    return model


def _data(n=256, dim=20):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    return X, (X[:, :4].argmax(axis=1)).astype(np.float32)


@pytest.mark.parametrize("opt", [dict(optimizer="adam", fused=True),
                                 dict(optimizer="adam", fused=False),
                                 dict(optimizer="sgd", momentum=0.9)])
def test_captured_fit_is_bitwise_the_eager_fit(cuda_device, monkeypatch, opt):
    X, y = _data()
    sched = mt.lr_scheduler.FactorScheduler(step=3, factor=0.5, base_lr=0.05)
    kw = dict(opt, lr_scheduler=sched)
    before = kfa.fused_adam.launches
    tcm.reset_compile_stats()
    cap = _fit(_mlp(), X, y, monkeypatch, True, **kw)
    stats = tcm.compile_stats()
    assert stats["captures"] == 1 and stats["replays"] == 7
    if opt.get("fused"):
        assert kfa.fused_adam.launches - before == 8  # replays counted
    eager = _fit(_mlp(), X, y, monkeypatch, False, **kw)
    assert tcm.compile_stats()["eager"].get("MXTPU_CUDA_GRAPHS=0") == 1
    for k, v in cap.arg_params.items():
        assert torch.equal(v, eager.arg_params[k]), k


def test_fresh_gradients_upload_only_their_pointers(cuda_device):
    """The eager wrapper with new gradient tensors each step (the LM's
    autograd gradients) builds the leaf table once and uploads only the
    gradients' pointers again; the result stays bitwise the plain
    version's."""
    shapes = [(300,), (17, 5), (4096,)]
    w = [torch.randn(s, device=cuda_device) for s in shapes]
    m = [torch.zeros_like(t) for t in w]
    v = [torch.zeros_like(t) for t in w]
    ref = [[t.clone() for t in group] for group in (w, m, v)]
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=1.0,
                 clip_gradient=None, wd_l2=0.0, decoupled=False)
    table = kfa.LeafTable()
    for t in range(1, 5):
        g = [torch.randn(s, device=cuda_device) for s in shapes]
        c1 = [1 - 0.9 ** t] * 3
        c2 = [1 - 0.999 ** t] * 3
        kfa.fused_adam(w, g, m, v, c1, c2, [0.0] * 3, lr=0.01, table=table,
                       **hyper)
        kfa.fused_adam_plain(ref[0], g, ref[1], ref[2], c1, c2, [0.0] * 3,
                             lr=0.01, **hyper)
    torch.cuda.synchronize()
    assert table.builds == 1 and 1 <= table.grad_uploads <= 4
    for got, want in zip((w, m, v), ref):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_eager_entry_points_count_their_reason_on_the_card(cuda_device,
                                                           monkeypatch):
    """Under ``MXTPU_CUDA_GRAPHS=0``, predict, score, a Predictor's program
    and Executor.precompile each count one eager run with that reason."""
    X, y = _data(64)
    model = _fit(_mlp(), X, y, monkeypatch, False, optimizer="sgd")
    tcm.reset_compile_stats()
    model.predict(X, batch_size=32)
    model.score(X, y=y, batch_size=32)
    pred = mt.Predictor(_mlp(), model.arg_params, ctx=mt.gpu(0))
    for _ in range(3):
        pred.forward(data=X[:8])
    exe = _mlp().simple_bind(mt.gpu(0), data=(8, 20), softmax_label=(8,))
    assert exe.precompile() == 0.0
    assert tcm.compile_stats()["eager"] == {"MXTPU_CUDA_GRAPHS=0": 4}


def test_baked_step_values_are_caught(cuda_device):
    """A graph that bakes lr and Adam's c1, c2 in at its capture (the
    public eager form's host upload, captured) differs from the replays of
    the device-vector form after a few steps."""
    w = [torch.randn(300, device=cuda_device)]
    g = [torch.randn(300, device=cuda_device)]
    state = [[torch.zeros(300, device=cuda_device) for _ in range(2)]
             for _ in range(2)]
    hyper = dict(beta1=0.9, beta2=0.999, eps=1e-8, rescale_grad=1.0,
                 clip_gradient=None, wd_l2=0.0, decoupled=False)
    scal = torch.zeros(kfa.HEADER + kfa.PER_LEAF, device=cuda_device)
    ws = [w[0].clone(), w[0].clone()]
    ref = w[0].clone()
    ref_m, ref_v = torch.zeros(300, device=cuda_device), \
        torch.zeros(300, device=cuda_device)

    tables = [kfa.LeafTable(), kfa.LeafTable()]

    def good():
        kfa.fused_adam_step([ws[0]], g, [state[0][0]], [state[0][1]], scal,
                            table=tables[0], **hyper)

    prog = tcm.CapturedProgram(good, cuda_device, "unit:adam", warmup=1)
    for t in range(1, 6):
        lr = 0.1 / t
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        scal.copy_(torch.from_numpy(kfa.step_vector(lr, [c1], [c2], [0.0])))
        prog()
        kfa.fused_adam([ref], g, [ref_m], [ref_v], [c1], [c2], [0.0], lr=lr,
                       **hyper)
    torch.cuda.synchronize()
    assert torch.equal(ws[0], ref) and torch.equal(state[0][0], ref_m)
    # the planted fault: the values of the capture step, frozen
    frozen = torch.from_numpy(kfa.step_vector(0.1, [0.1], [0.001], [0.0]))
    baked = frozen.to(cuda_device)
    prog2 = tcm.CapturedProgram(
        lambda: kfa.fused_adam_step([ws[1]], g, [state[1][0]], [state[1][1]],
                                    baked, table=tables[1], **hyper),
        cuda_device, "unit:baked", warmup=1)
    for _ in range(5):
        prog2()
    torch.cuda.synchronize()
    assert float((ws[1] - ref).abs().max()) > 1e-3


def test_dropout_masks_follow_the_eager_sequence(cuda_device, monkeypatch):
    X, y = _data()
    net = _mlp(dropout=True)
    kw = dict(optimizer="sgd", learning_rate=0.0)  # lr 0: masks only
    outs = {}
    for graphs in (True, False):
        monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1" if graphs else "0")
        mt.random.seed(0)
        model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1,
                               initializer=mt.init.Xavier(), **kw)
        seen = []
        metric = mt.metric.CustomMetric(
            lambda lab, pred: seen.append(pred.copy()) or 0.0)
        model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
                  eval_metric=metric)
        outs[graphs] = seen
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs[True][2], outs[True][3])


def test_remat_fit_captures_bitwise_the_eager_remat_fit(cuda_device,
                                                       monkeypatch):
    """A fit under ``MXNET_TPU_REMAT`` captures (no remat reason among the
    eager ones: the recompute reads its forward's draws back) and gives
    the eager remat fit's Dropout outputs and parameters bit for bit."""
    monkeypatch.setenv("MXNET_TPU_REMAT", r"drop1$")
    X, y = _data()
    net = _mlp(dropout=True)
    outs = {}
    for graphs in (True, False):
        monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1" if graphs else "0")
        tcm.reset_compile_stats()
        mt.random.seed(0)
        model = mt.FeedForward(net, ctx=mt.gpu(0), num_epoch=1,
                               optimizer="sgd", learning_rate=0.1,
                               initializer=mt.init.Xavier())
        seen = []
        metric = mt.metric.CustomMetric(
            lambda lab, pred: seen.append(pred.copy()) or 0.0)
        model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
                  eval_metric=metric)
        outs[graphs] = (seen, model.arg_params, tcm.compile_stats())
    (cap, cap_args, stats), (eager, eager_args, _) = outs[True], outs[False]
    assert stats["captures"] == 1 and stats["replays"] == 7
    assert stats["eager"] == {}
    for a, b in zip(cap, eager):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(cap[2], cap[3])
    for k, v in cap_args.items():
        assert torch.equal(v, eager_args[k]), k


def test_precompile_then_fit_captures_nothing(cuda_device, monkeypatch):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    X, y = _data()
    from mxnet_tpu_torch.convert import random_params

    args = random_params(_mlp(), 2, data=(32, 20))[0]
    results = []
    for pre in (True, False):
        mt.random.seed(0)
        model = mt.FeedForward(_mlp(), ctx=mt.gpu(0), num_epoch=1,
                               optimizer="adam", fused=True,
                               learning_rate=0.01, arg_params=dict(args))
        if pre:
            model.precompile(data_shapes={"data": (32, 20)},
                             label_shapes={"softmax_label": (32,)})
            for k, v in args.items():
                assert np.array_equal(model.arg_params[k], v)
        tcm.reset_compile_stats()
        model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False))
        stats = tcm.compile_stats()
        assert stats["captures"] == (0 if pre else 1)
        results.append(model.arg_params)
    for k in args:
        assert torch.equal(results[0][k], results[1][k]), k


def test_int8_predictor_replays_bitwise(cuda_device, monkeypatch):
    net = tmodels.mlp()
    from mxnet_tpu_torch.convert import random_params

    args, aux = random_params(net, 0, data=(8, 784))
    x = np.random.default_rng(1).standard_normal((8, 784), np.float32)
    outs = {}
    for graphs in ("1", "0"):
        monkeypatch.setenv("MXTPU_CUDA_GRAPHS", graphs)
        pred = mt.Predictor(net, args, aux, ctx=mt.gpu(0), quantize="int8")
        got = []
        before = k8.int8_matmul.launches
        for _ in range(4):
            got.append(pred.forward(data=x).get_output(0))
        assert k8.int8_matmul.launches - before == 4 * 3  # 3 FC layers
        outs[graphs] = got
    for a, b in zip(outs["1"], outs["0"]):
        np.testing.assert_array_equal(a, b)


def test_bucketed_lstm_captured_is_bitwise_eager(cuda_device, monkeypatch):
    def sym_gen(seq_len):
        return tmodels.lstm_unroll(num_layers=1, seq_len=seq_len,
                                   input_size=30, num_hidden=16, num_embed=8,
                                   num_label=30)

    rng = np.random.default_rng(0)
    sents = [list(rng.integers(1, 30, int(rng.integers(3, 12))))
             for _ in range(96)]
    init_states = [("l0_init_c", (8, 16)), ("l0_init_h", (8, 16))]
    params = {}
    for graphs in ("1", "0"):
        monkeypatch.setenv("MXTPU_CUDA_GRAPHS", graphs)
        mt.random.seed(0)
        it = mt.bucketing.BucketSentenceIter(
            sents, buckets=[4, 8, 12], batch_size=8,
            init_states=init_states, shuffle=True, seed=3)
        model = mt.bucketing.BucketingFeedForward(
            sym_gen, default_bucket_key=12, ctx=mt.gpu(0), num_epoch=2,
            optimizer="sgd", learning_rate=0.1, momentum=0.9,
            initializer=mt.init.Xavier())
        if graphs == "1":
            assert model.precompile(data=it)["programs"] == 3
        model.fit(it, batch_size=8)
        params[graphs] = model.arg_params
    for k, v in params["1"].items():
        assert torch.equal(v, params["0"][k]), k


def _probe_fit(monkeypatch, stale):
    """An 8-step MLP fit whose in-step probe digests, exactly, the batch the
    step read (the static input of a captured step); with ``stale`` the
    feed's copies go to new buffers after the capture while the graph keeps
    reading the old ones."""
    from mxnet_tpu_torch import model as model_mod
    from mxnet_tpu_torch.convert import to_tensor

    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    X, y = _data()
    weights = torch.arange(1, X[:32].size + 1, dtype=torch.int64)
    dev_w = weights.cuda()
    model = mt.FeedForward(_mlp(), ctx=mt.gpu(0), num_epoch=1,
                           learning_rate=0.01, initializer=mt.init.Xavier())
    model._step_probe = lambda b: (
        b["data"].reshape(-1).view(torch.int32).long() * dev_w).sum()
    real = model_mod._Program.run

    def stale_run(self, arrays):
        out = real(self, arrays)
        if self.captured.captured and not hasattr(self, "planted"):
            self.planted = self.static  # the graph's buffers stay alive
            self.static = {k: v.clone() for k, v in self.static.items()}
        return out

    if stale:
        monkeypatch.setattr(model_mod._Program, "run", stale_run)
    model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False))
    monkeypatch.setattr(model_mod._Program, "run", real)
    return [i for i, (batch, dev) in enumerate(model.step_probes)
            if int((to_tensor(batch.data[0], "cpu").reshape(-1)
                    .view(torch.int32).long() * weights).sum()) != int(dev)]


def test_stale_static_buffer_is_caught(cuda_device, monkeypatch):
    assert _probe_fit(monkeypatch, stale=False) == []
    # the warm-up step and the capture step read their own batches; every
    # replay after the capture reads the capture step's
    assert _probe_fit(monkeypatch, stale=True) == [2, 3, 4, 5, 6, 7]


def test_killed_fit_resumes_bitwise_on_the_card(cuda_device, monkeypatch,
                                               tmp_path):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    X, y = _data()
    from mxnet_tpu_torch.convert import random_params

    args = random_params(_mlp(), 2, data=(32, 20))[0]

    class Killed(Exception):
        pass

    def run(model, d, kill=None):
        seen = [0]

        def cb(_p):
            seen[0] += 1
            if seen[0] == kill:
                raise Killed()

        try:
            model.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
                      sharded_checkpoint_dir=d, checkpoint_every_n_steps=2,
                      batch_end_callback=cb)
        except Killed:
            return False
        return True

    def model():
        return mt.FeedForward(_mlp(), ctx=mt.gpu(0), num_epoch=1,
                              optimizer="adam", fused=True,
                              learning_rate=0.01, arg_params=dict(args))

    whole = model()
    assert run(whole, str(tmp_path / "whole"))
    victim = model()
    assert not run(victim, str(tmp_path / "killed"), kill=5)
    tcm.reset_compile_stats()
    assert run(victim, str(tmp_path / "killed"))
    assert tcm.compile_stats()["captures"] == 0  # the same captured steps
    for k, v in whole.arg_params.items():
        assert torch.equal(victim.arg_params[k], v), k


def test_int8_replay_after_nan_filled_allocator(cuda_device):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    wq, sw = k8.quantize_channels(torch.randn(1000, 2048, generator=gen,
                                              device="cuda"))
    x = torch.empty(32, 2048, device="cuda")
    poison = torch.full((1 << 26,), float("nan"), device="cuda")
    del poison  # its blocks go back to the allocator full of NaN
    prog = tcm.CapturedProgram(lambda: k8.int8_matmul(x, wq, w_scale=sw),
                               cuda_device, "unit:int8_nan", warmup=1)
    for _ in range(5):
        x.copy_(torch.randn(32, 2048, generator=gen, device="cuda"))
        assert torch.equal(prog().clone(), k8.int8_matmul_plain(x, wq, sw))


# -- training captured through Executor, Module and the LM's step -----------

def _head_net(hidden=64):
    """An MLP without a loss head: backward's head gradients matter."""
    net = mt.sym.FullyConnected(data=mt.sym.Variable("data"), name="fc1",
                                num_hidden=hidden)
    net = mt.sym.Activation(data=net, name="relu1", act_type="relu")
    net = mt.sym.BatchNorm(data=net, name="bn1")
    return mt.sym.FullyConnected(data=net, name="fc2", num_hidden=8)


def _executor_steps(monkeypatch, graphs, steps=4):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1" if graphs else "0")
    from mxnet_tpu_torch.convert import random_params

    net = _head_net()
    args, aux = random_params(net, 3, data=(32, 20))
    exe = net.simple_bind(mt.gpu(0), data=(32, 20))
    exe.copy_params_from({k: torch.from_numpy(v) for k, v in args.items()},
                         {k: torch.from_numpy(v) for k, v in aux.items()})
    seconds = exe.precompile(is_train=True)
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        x = rng.standard_normal((32, 20)).astype(np.float32)
        head = torch.from_numpy(rng.standard_normal((32, 8)).astype(
            np.float32)).cuda()
        outs = exe.forward(is_train=True, data=x)
        exe.backward(head)
        out.append(([o.clone() for o in outs],
                    {k: v.clone() for k, v in exe.grad_dict.items()},
                    {k: v.clone() for k, v in exe.aux_dict.items()}))
    return seconds, exe, out


def test_executor_train_pair_replays_bitwise_eager(cuda_device, monkeypatch):
    tcm.reset_compile_stats()
    seconds, exe, captured = _executor_steps(monkeypatch, True)
    stats = tcm.compile_stats()
    assert seconds > 0.0 and exe._pair is not None and exe._pair.captured
    assert stats["captures"] == 2 and stats["replays"] == 2 * 4
    _, eager_exe, eager = _executor_steps(monkeypatch, False)
    assert eager_exe._pair is None
    for (o1, g1, a1), (o2, g2, a2) in zip(captured, eager):
        for a, b in zip(o1, o2):
            assert torch.equal(a, b)
        for k in g1:
            assert torch.equal(g1[k], g2[k]), k
        for k in a1:
            assert torch.equal(a1[k], a2[k]), k


def test_executor_precompile_moves_no_state(cuda_device, monkeypatch):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    exe = _head_net().simple_bind(mt.gpu(0), data=(32, 20))
    for v in exe.grad_dict.values():
        v.fill_(3.0)
    before = {k: v.clone() for d in (exe.aux_dict, exe.grad_dict)
              for k, v in d.items()}
    state = mt.random.get_state()
    assert exe.precompile(is_train=True) > 0.0
    for d in (exe.aux_dict, exe.grad_dict):
        for k, v in d.items():
            assert torch.equal(v, before[k]), k
    assert mt.random.get_state() == state


def _module_fit(monkeypatch, graphs, buckets=False):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1" if graphs else "0")
    X, y = _data()
    mt.random.seed(0)
    mod = mt.mod.Module(_mlp(), context=mt.gpu(0))
    from mxnet_tpu_torch.convert import random_params

    args = random_params(_mlp(), 2, data=(32, 20))[0]
    mod.bind([("data", (32, 20))], [("softmax_label", (32,))])
    mod.init_params(arg_params={k: torch.from_numpy(v)
                                for k, v in args.items()})
    mod.fit(mt.io.NDArrayIter(X, y, batch_size=32, shuffle=False),
            num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    return mod


def test_module_fit_captured_is_bitwise_eager(cuda_device, monkeypatch):
    tcm.reset_compile_stats()
    captured = _module_fit(monkeypatch, True)
    stats = tcm.compile_stats()
    assert captured._exec._pair is not None
    assert stats["captures"] == 2 and stats["replays"] == 2 * 16
    eager = _module_fit(monkeypatch, False)
    assert eager._exec._pair is None
    a, b = captured.get_params()[0], eager.get_params()[0]
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _lm_steps(monkeypatch, captured, steps=3, fresh=False):
    monkeypatch.setenv("MXTPU_CUDA_GRAPHS", "1")
    cfg = tmodels.transformer_lm_config(
        vocab_size=256, d_model=64, n_heads=2, n_layers=2, d_ff=128,
        max_len=128, dtype=torch.bfloat16, attn_impl="flash")
    model = tmodels.TransformerLM(cfg)
    opt = mt.optimizer.create("adam", learning_rate=1e-3, fused=True)
    params, state = model.init_sharded(None, seed=1, optimizer=opt,
                                       ctx=mt.gpu(0))
    step = model.make_train_step(None, optimizer=opt)
    rng = np.random.default_rng(2)
    losses = []
    for _ in range(steps):
        tok, tgt = (torch.from_numpy(rng.integers(0, 256, (2, 128))).cuda()
                    for _ in range(2))
        kw = {} if captured else {"mark": lambda phase: None}
        params, state, loss = step(params, state, tok, tgt, **kw)
        losses.append(loss)
    if fresh:
        # other tensors: a capture of their own
        params2 = {k: v.clone() for k, v in params.items()}
        state2 = opt.init_state_tree(params2)
        step(params2, state2, tok, tgt)
        step(params2, state2, tok, tgt)
    return step, params, losses


def test_lm_train_step_captured_is_bitwise_eager(cuda_device, monkeypatch):
    from mxnet_tpu_torch.kernels import flash_attention as tfa

    tcm.reset_compile_stats()
    counted = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv,
               kfa.fused_adam)
    before = [k.launches for k in counted]
    step, p1, l1 = _lm_steps(monkeypatch, True, fresh=True)
    stats = tcm.compile_stats()
    label = stats["per_function"]["lm_train_step"]
    assert label["compiles"] == 2 and label["captures"] == 2
    assert len(step.programs) == 2
    # 2 layers: 2 of each flash kernel a step (the backward's launched from
    # autograd's thread, counted by replay too); one fused_adam; 5 steps
    assert [k.launches - b for k, b in zip(counted, before)] == \
        [2 * 5, 2 * 5, 2 * 5, 5]
    _, p2, l2 = _lm_steps(monkeypatch, False)
    for a, b in zip(l1, l2):
        assert torch.equal(a, b)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k
