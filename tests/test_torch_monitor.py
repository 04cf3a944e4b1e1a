"""Symbol internals and ``Monitor`` in the port against the JAX package's:
``get_internals``, ``infer_shape_partial``, ``debug_str``, pickling,
``Executor.debug_str``, the Monitor's statistics (mirroring the
``tests/test_symbol.py`` and ``tests/test_model.py`` Monitor cases), and
the metrics and callback of this slice (``Perplexity(ignore_label=)``,
``np_metric``, ``ProgressBar``).

Tolerances: names, shapes and strings are equal; a Monitor statistic
(mean |x| of an internal output) within 1e-5 relative (the forwards add in
another order, XLA against ATen); Perplexity within 1e-6 relative (a log
and an exp of a sum of the same terms).
"""

import io as pyio
import pickle
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.monitor import nonfinite_count

torch.set_num_threads(1)
mt.set_matmul_precision("highest")


def _mlp(pkg, num_classes=2):
    s = pkg.sym
    net = s.FullyConnected(data=s.Variable("data"), name="fc1", num_hidden=16)
    net = s.Activation(data=net, name="relu1", act_type="relu")
    net = s.FullyConnected(data=net, name="fc2", num_hidden=num_classes)
    return s.SoftmaxOutput(data=net, name="softmax")


def _bn_relu(pkg):
    s = pkg.sym
    bn = s.BatchNorm(data=s.Variable("data"), name="bn")
    return s.Activation(data=bn, act_type="relu", name="relu")


@pytest.mark.parametrize("make", [_mlp, _bn_relu,
                                  lambda p: p.models.lenet()],
                         ids=["mlp", "bn_relu", "lenet"])
def test_internals_debug_str_and_pickle_match_jax(make):
    jnet, tnet = make(mx), make(mt)
    ji, ti = jnet.get_internals(), tnet.get_internals()
    assert ti.list_outputs() == ji.list_outputs()
    assert ti.list_arguments() == ji.list_arguments()
    assert ti.list_auxiliary_states() == ji.list_auxiliary_states()
    assert tnet.debug_str() == jnet.debug_str()
    assert ti.tojson() == ji.tojson()
    first = ti.list_outputs()[-1]
    assert ti[first].list_outputs() == [first]
    back = pickle.loads(pickle.dumps(tnet))
    assert back.tojson() == tnet.tojson()
    assert mx.sym.load_json(back.tojson()).tojson() == jnet.tojson()


def test_infer_shape_partial_matches_jax():
    jnet, tnet = _mlp(mx), _mlp(mt)
    assert tnet.infer_shape_partial(data=(4, 10)) == \
        jnet.infer_shape_partial(data=(4, 10))
    assert tnet.infer_shape_partial() == jnet.infer_shape_partial() == \
        (None, None, None)
    fc1 = tnet.get_internals()["fc1_output"]
    assert fc1.infer_shape_partial(data=(4, 10))[1] == [(4, 16)]


def test_executor_debug_str():
    net = _mlp(mt)
    ex = net.simple_bind(mt.cpu(), data=(4, 10))
    text = ex.debug_str()
    assert text.startswith(net.debug_str())
    mb = float(re.search(r"Total ([0-9.]+) MB allocated", text).group(1))
    held = sum(t.numel() * 4 for d in (ex.arg_dict, ex.grad_dict)
               for t in d.values())
    assert mb == pytest.approx(held / 2 ** 20, abs=1e-4)


def _monitor_rows(pkg, make, shape, pattern, stat_func=None, seed=0, **kw):
    net = make(pkg)
    ex = net.simple_bind(pkg.cpu(), data=shape)
    rng = np.random.default_rng(seed)
    values = {"data": rng.standard_normal(shape).astype(np.float32)}
    for name, arr in ex.arg_dict.items():
        if name not in ("data", "softmax_label"):
            values[name] = rng.uniform(-1, 1, tuple(arr.shape)).astype(
                np.float32)
    for name, v in values.items():
        if pkg is mt:
            ex.arg_dict[name].copy_(torch.from_numpy(v))
        else:
            ex.arg_dict[name][:] = v
    mon = pkg.Monitor(interval=1, pattern=pattern, stat_func=stat_func, **kw)
    mon.install(ex)
    rows = []
    for _ in range(2):
        mon.tic()
        ex.forward()
        rows.append(mon.toc())
    return rows


@pytest.mark.parametrize("make,shape,pattern,stat", [
    (_mlp, (4, 10), ".*fc1.*", None),
    (_mlp, (4, 10), ".*", None),
    # the executor fuses BatchNorm->relu, the internals graph does not: the
    # BatchNorm output is the true pre-relu value (its minimum is negative)
    (_bn_relu, (4, 3, 5, 5), ".*bn.*", lambda x: x.min()),
], ids=["fc1", "all", "bn_under_fusion"])
def test_monitor_matches_jax(make, shape, pattern, stat):
    want = _monitor_rows(mx, make, shape, pattern, stat)
    got = _monitor_rows(mt, make, shape, pattern, stat)
    assert [[r[:2] for r in step] for step in got] == \
        [[r[:2] for r in step] for step in want]
    assert got[0] and all(re.match(pattern, r[1]) for r in got[0])
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(float(g[2]), float(w[2]), rtol=1e-5)
    if make is _bn_relu:
        assert [r[2] for r in got[0] if r[1] == "bn_output"][0] < 0


def test_monitor_interval_nonfinite_and_later_parts():
    net = _mlp(mt)
    ex = net.simple_bind(mt.cpu(), data=(4, 10))
    ex.arg_dict["fc1_weight"][0, 0] = float("nan")
    mon = mt.Monitor(interval=2, pattern="fc1_output", track_nonfinite=True)
    mon.install(ex)
    collected = []
    for _ in range(4):
        mon.tic()
        ex.forward()
        collected.append(mon.toc())
    assert [len(c) for c in collected] == [2, 0, 2, 0]
    assert collected[0][1][1] == "fc1_output_nonfinite"
    assert collected[0][1][2] == 4  # the NaN weight reaches every row
    assert nonfinite_count(torch.tensor([1.0, float("inf"), float("nan")])) \
        == 2
    assert nonfinite_count(np.array([1, 2])) == 0
    assert nonfinite_count([0.5, float("nan")]) == 1
    # track_comm: the comm registry's changes since the last collection
    reg = mt.comm.registry()
    reg.register_plan("monitor_test", mt.comm.allreduce_plan(1000, 2,
                                                             "int8"))
    comm_mon = mt.Monitor(1, track_comm=True)
    reg.record_step("monitor_test", 3)
    rows = dict((name, v) for _s, name, v in comm_mon.collect_comm())
    plan = reg.stats()["per_program"]["monitor_test"]
    assert rows == {"comm/steps": 3,
                    "comm/wire_bytes": 3 * plan["wire_bytes"],
                    "comm/fp32_wire_bytes": 3 * plan["fp32_wire_bytes"]}
    assert dict((n, v) for _s, n, v in comm_mon.collect_comm()) == {
        "comm/steps": 0, "comm/wire_bytes": 0.0,
        "comm/fp32_wire_bytes": 0.0}


def test_monitor_on_a_bf16_executor():
    """bf16 outputs are read in f32; one finite statistic a matched name,
    named as ``get_internals().list_outputs()`` names them."""
    net = tmodels.resnet(units=(1, 1, 1, 1), filter_list=(16, 32, 64, 128),
                         num_classes=10)
    from mxnet_tpu_torch.convert import random_params

    args, aux = random_params(net, 0, data=(2, 3, 32, 32))
    values = {k: torch.from_numpy(v).bfloat16() for k, v in args.items()}
    values["data"] = torch.randn(2, 3, 32, 32).bfloat16()
    values["softmax_label"] = torch.zeros(2)
    ex = net.bind(mt.cpu(), values, aux_states=aux)
    mon = mt.Monitor(interval=1, pattern=r".*unit\d+_out_output$")
    mon.install(ex)
    mon.tic()
    ex.forward(is_train=True)
    rows = mon.toc()
    names = [n for n in net.get_internals().list_outputs()
             if re.match(r".*unit\d+_out_output$", n)]
    assert [r[1] for r in rows] == names and len(names) == 4
    assert all(np.isfinite(r[2]) for r in rows)


@pytest.mark.parametrize("ignore", [None, 0])
def test_perplexity_matches_jax(ignore):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((12, 7))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(
        np.float32)
    labels = rng.integers(0, 7, 12).astype(np.float32)
    labels[:3] = 0
    want = mx.metric.Perplexity(ignore_label=ignore)
    got = mt.metric.Perplexity(ignore_label=ignore)
    for m in (want, got):
        m.update([labels[:6]], [probs[:6]])
        m.update([labels[6:]], [probs[6:]])
    assert got.num_inst == want.num_inst == \
        (12 if ignore is None else int((labels != ignore).sum())) < 13
    np.testing.assert_allclose(got.get()[1], want.get()[1], rtol=1e-6)
    dev = mt.metric.Perplexity(ignore_label=ignore)
    state = dev.device_init("cpu")
    state = dev.device_update(state, [torch.from_numpy(labels)],
                              [torch.from_numpy(probs)])
    dev.absorb_device_state(state)
    assert dev.num_inst == got.num_inst
    np.testing.assert_allclose(dev.get()[1], got.get()[1], rtol=1e-6)
    assert isinstance(mt.metric.create("perplexity"), mt.metric.Perplexity)


def test_np_metric_and_progress_bar():
    def mean_abs(label, pred):
        return float(np.abs(label - pred.argmax(1)).mean())

    got, want = mt.metric.np_metric(mean_abs), mx.metric.np_metric(mean_abs)
    y = np.array([0, 1, 1], np.float32)
    p = np.eye(3, dtype=np.float32)[[0, 0, 1]]
    for m in (got, want):
        m.update([y], [p])
    assert got.get() == want.get() == ("mean_abs", 1.0 / 3.0)
    bar = mt.callback.ProgressBar(total=4, length=8)
    buf = pyio.StringIO()
    with redirect_stdout(buf):
        bar(mt.callback.BatchEndParam(epoch=0, nbatch=1, eval_metric=None))
        bar(mt.callback.BatchEndParam(epoch=0, nbatch=4, eval_metric=None))
    assert buf.getvalue() == "[==------] 25%\r[========] 100%\r"
