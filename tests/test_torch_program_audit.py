"""The program audit (``analysis/program_audit.py``) against the JAX
package's jaxpr audit (``mxnet_tpu/analysis/jaxpr_audit.py``) on the same
small nets bound in each package.

- MX501: a ``_Native`` node is a host round trip in both packages (the
  JAX package's ``pure_callback``; the port's node range); a tensor read
  as a number inside the step (``aten::_local_scalar_dense``) is one too.
- MX502 on a bf16 net: both packages flag the global average pool's
  upcast, which is no rounding point. The JAX audit also flags the casts
  of BatchNorm's statistics and of the softmax, which the port exempts as
  the reference's rounding points (ROADMAP C.2, "the ATen-level MX502"):
  adding the pool adds exactly one MX502 finding in each package, and the
  port's other findings are none.
- Cost rows: the audit is a ``FlopCounter`` (the MFU count's dispatch
  mode), so its rows are the counter's; contraction FLOPs equal the JAX
  audit's ``dot_general`` + ``conv_general_dilated`` FLOPs exactly, and a
  hand-written kernel's call is one ``kernel::<name>`` row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.analysis import audit_executor as jaudit_executor
from mxnet_tpu.analysis import cost_rows as jcost_rows
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch.analysis import program_audit as pa
from mxnet_tpu_torch.telemetry.mfu import FlopCounter

torch.set_num_threads(1)
mt.set_matmul_precision("highest")

SHAPE = (2, 3, 8, 8)


def _net(m, pool="max"):
    x = m.sym.Variable("data")
    x = m.symbol.Convolution(data=x, num_filter=4, kernel=(3, 3),
                             pad=(1, 1), name="c1")
    x = m.symbol.BatchNorm(data=x, name="bn1")
    x = m.symbol.Activation(data=x, act_type="relu", name="r1")
    if pool == "avg":
        x = m.symbol.Pooling(data=x, kernel=(1, 1), global_pool=True,
                             pool_type="avg", name="gp")
    else:
        x = m.symbol.Pooling(data=x, kernel=(2, 2), stride=(2, 2),
                             pool_type="max", name="p1")
    x = m.symbol.Flatten(data=x, name="flat")
    x = m.symbol.FullyConnected(data=x, num_hidden=3, name="fc")
    return m.symbol.SoftmaxOutput(data=x, name="softmax")


def _bound(pool, dtype="bfloat16", seed=0):
    ts, js = _net(mt, pool), _net(mx, pool)
    arg_shapes, _, aux_shapes = ts.infer_shape(data=SHAPE)
    rng = np.random.default_rng(seed)
    args = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in zip(ts.list_arguments(), arg_shapes)}
    aux = {n: np.ones(s, np.float32)
           for n, s in zip(ts.list_auxiliary_states(), aux_shapes)}
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    te = ts.bind(mt.cpu(), {k: torch.from_numpy(v).to(tdt)
                            for k, v in args.items()},
                 aux_states={k: torch.from_numpy(v).to(tdt)
                             for k, v in aux.items()})
    je = js.bind(mx.cpu(), {k: mx.nd.array(v).astype(jdt)
                            for k, v in args.items()},
                 aux_states={k: mx.nd.array(v).astype(jdt)
                             for k, v in aux.items()})
    return te, je


def _rule_count(findings, rule):
    return sum(f.rule.id == rule for f in findings)


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_mx502_on_a_bf16_net_against_jax(is_train):
    counts = {}
    for pool in ("max", "avg"):
        te, je = _bound(pool)
        t = tanalysis.audit_executor(te, is_train=is_train,
                                     intended_dtype=torch.bfloat16)
        j = jaudit_executor(je, is_train=is_train,
                            intended_dtype=jnp.bfloat16)
        assert {f.rule.id for f in t.findings} <= {"MX502"}
        assert {f.rule.id for f in j.findings} == {"MX502"}
        counts[pool] = (_rule_count(t.findings, "MX502"),
                        _rule_count(j.findings, "MX502"))
    # the rounding points: flagged by the JAX audit, exempt in the port
    assert counts["max"][0] == 0 and counts["max"][1] > 0
    # the global average pool's upcast is one finding in each package
    assert counts["avg"][0] == 1
    assert counts["avg"][1] - counts["max"][1] == 1
    te, _ = _bound("avg")
    (f,) = tanalysis.audit_executor(te, is_train=is_train,
                                    intended_dtype=torch.bfloat16).findings
    assert f.node == "_to_copy" and "'gp/Pooling'" in f.message
    assert "promotes torch.bfloat16" in f.message


def test_no_intended_dtype_no_mx502():
    te, _ = _bound("avg")
    assert tanalysis.audit_executor(te, is_train=True).findings == []
    te, _ = _bound("avg", dtype="float32")
    assert tanalysis.audit_executor(
        te, intended_dtype=np.float32).findings == []


def test_a_bn_fused_into_an_add_is_a_rounding_point():
    """ResNet's tail: BatchNorm -> add -> relu runs inside the add's range
    (the fusion plan), and its f32 statistics stay exempt there."""
    x = mt.sym.Variable("data")
    c = mt.symbol.Convolution(data=x, num_filter=3, kernel=(1, 1),
                              name="c1")
    b = mt.symbol.BatchNorm(data=c, name="bn1")
    s = mt.symbol.Activation(data=b + x, act_type="relu", name="relu")
    net = mt.symbol.SoftmaxOutput(data=mt.symbol.FullyConnected(
        data=mt.symbol.Flatten(data=s), num_hidden=2, name="fc"),
        name="softmax")
    assert pa.rounding_ranges(net)
    ex = net.simple_bind(mt.cpu(), data=(2, 3, 4, 4))
    for d in (ex.arg_dict, ex.aux_dict):
        for k in d:
            d[k] = d[k].bfloat16()
    rep = tanalysis.audit_executor(ex, is_train=True,
                                   intended_dtype=torch.bfloat16)
    assert rep.findings == []


def _native_net(m):
    import test_torch_native as tn

    base = mt.operator.NumpyOp if m is mt else mx.operator.NumpyOp
    return tn._net(m, base)


def test_mx501_for_a_native_node_as_jax():
    ts, js = _native_net(mt), _native_net(mx)
    rng = np.random.default_rng(0)
    shapes = dict(zip(ts.list_arguments(),
                      ts.infer_shape(data=(4, 6))[0]))
    vals = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    te = ts.bind(mt.cpu(), {k: torch.from_numpy(v) for k, v in vals.items()})
    je = js.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()})
    t = tanalysis.audit_executor(te)
    j = jaudit_executor(je)
    assert [f.rule.id for f in t.findings] == \
        [f.rule.id for f in j.findings] == ["MX501"]
    assert t.findings[0].node == "nps"
    # the audit leaves the executor as it was
    assert torch.equal(te.arg_dict["data"], torch.from_numpy(vals["data"]))


def test_mx501_for_a_host_read_inside_the_step():
    def step(x):
        y = x * 2.0
        if float(y.sum()) > 0:  # a host read of a tensor's value
            return y
        return -y

    rows, totals = tanalysis.cost_rows(step, torch.ones(3))
    rep = pa.audit_program(step, torch.ones(3))
    assert [f.rule.id for f in rep.findings] == ["MX501"]
    assert rep.findings[0].node == "_local_scalar_dense"
    assert totals["flops"] == rep.totals["flops"]
    assert {r["primitive"] for r in rows} >= {"mul", "sum"}


def test_seeded_mx502_outside_a_rounding_point():
    rep = pa.audit_program(lambda x: (x.float() * 2.0).sum(),
                           torch.ones(4, dtype=torch.bfloat16),
                           intended_dtype=torch.bfloat16)
    assert [(f.rule.id, f.node) for f in rep.findings] == \
        [("MX502", "_to_copy")]

    # the same cast inside a node that is a rounding point is no finding
    def in_node(label, x):
        with torch.profiler.record_function(label):
            return x.float() * 2.0

    x = torch.ones(4, dtype=torch.bfloat16)
    for label, found in (("bn1/BatchNorm", []), ("softmax/SoftmaxOutput", []),
                         ("gp/Pooling", ["MX502"])):
        rep = pa.audit_program(in_node, label, x,
                               intended_dtype=torch.bfloat16)
        assert [f.rule.id for f in rep.findings] == found, label


@pytest.mark.parametrize("is_train", [False, True], ids=["eval", "train"])
def test_cost_rows_are_the_flop_counter_and_contractions_match_jax(is_train):
    te, je = _bound("avg", dtype="float32")
    rep = tanalysis.audit_executor(te, is_train=is_train)
    from mxnet_tpu_torch.executor import _build_graph_fn

    fn = _build_graph_fn(te._symbol, is_train)
    gen = torch.Generator().manual_seed(0)
    args = dict(te.arg_dict)
    aux = {k: v.clone() for k, v in te.aux_dict.items()}
    counter = FlopCounter()
    with counter, torch.no_grad():
        fn(args, aux, gen)
    assert rep.totals["contraction_flops"] == counter.contraction_flops
    assert rep.totals["flops"] == counter.flops
    assert rep.totals["bytes"] == counter.bytes
    assert sorted(map(str, rep.rows)) == sorted(map(str, counter.rows))
    j = jaudit_executor(je, is_train=is_train)
    jc = sum(r["flops"] for r in j.rows
             if r["primitive"] in ("dot_general", "conv_general_dilated"))
    assert rep.totals["contraction_flops"] == jc > 0


def test_jax_cost_rows_and_port_cost_rows_on_one_matmul():
    a = np.random.default_rng(0).standard_normal((8, 16)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((16, 4)).astype(np.float32)
    trows, ttot = tanalysis.cost_rows(lambda x, y: x @ y,
                                      torch.from_numpy(a), torch.from_numpy(b))
    jrows, jtot = jcost_rows(lambda x, y: x @ y, jnp.asarray(a),
                             jnp.asarray(b))
    assert ttot["flops"] == jtot["flops"] == 2 * 8 * 16 * 4
    assert [r["primitive"] for r in trows] == ["mm"]
    assert [r["primitive"] for r in jrows] == ["dot_general"]


def test_a_kernel_call_is_one_priced_row():
    from mxnet_tpu_torch.kernels import fused_adam as kfa
    from mxnet_tpu_torch.kernels import registry as kreg

    ps = [torch.randn(100), torch.randn(7, 3)]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]

    def step():
        kfa.fused_adam(ps, gs, ms, vs, [0.1, 0.1], [0.01, 0.01], [0.0, 0.0],
                       lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8,
                       rescale_grad=1.0, clip_gradient=None, wd_l2=0.0,
                       decoupled=False)

    rows, _ = tanalysis.cost_rows(step)
    cost = kreg.get_kernel("fused_adam").cost((ps, gs, ms, vs), (ps, ms, vs))
    assert [r["primitive"] for r in rows] == ["kernel::fused_adam"]
    assert rows[0]["flops"] == int(cost.flops)
    # unattributed, the plain version's operations are counted instead
    rows, _ = tanalysis.cost_rows(step, attribute_kernels=False)
    assert "kernel::fused_adam" not in {r["primitive"] for r in rows}
    assert rows


def test_audit_restores_the_range_switch():
    from mxnet_tpu_torch.telemetry import profiling

    assert not profiling.ranges_on()
    pa.audit_program(lambda: torch.ones(2) + 1)
    assert not profiling.ranges_on()
