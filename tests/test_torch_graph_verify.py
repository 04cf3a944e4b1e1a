"""Graph verification (``Symbol.verify``, ``analysis/graph.py``) and the
rule registry of the port against the JAX package's.

The registry holds the JAX package's 41 ids with the same severities and
summaries (four summaries leave out the JAX text's references to its own
change history). MX401-MX406 are held on the JAX package's fixtures
(``tests/test_mxlint.py``'s Pass 2 section), each graph built in both
packages: both give the same ``(rule id, node)`` list, and ``verify_json``
the same findings on the same JSON. Every bind runs the verification with
the bound tensors' shapes and dtypes (bfloat16 as ``torch.bfloat16``)
unless ``MXNET_TPU_VERIFY=0``, and every zoo graph and the unrolled LSTM
LM verify clean in f32 and bf16, as in the JAX package.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.analysis import rules as jrules
from mxnet_tpu.analysis.graph import verify_json as jverify_json
from mxnet_tpu.analysis.graph import verify_symbol as jverify_symbol
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.analysis import rules as trules
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import OpProp, as_dtype

# the JAX summaries' references to the JAX package's own change history:
# an upper-case label and a number, e.g. "(LABEL 10)"
_HISTORY = re.compile(
    r" \([A-Z]+ \d+\)|, [A-Z]+ \d+|(?<=from the )[A-Z]+ \d+ ")


def _ids(findings):
    return [(f.rule.id, f.node) for f in findings]


@pytest.mark.parametrize("rule_id", sorted(jrules.RULES))
def test_registry_matches_jax(rule_id):
    j, t = jrules.RULES[rule_id], trules.RULES[rule_id]
    assert t.id == j.id and t.severity == j.severity
    assert t.summary == _HISTORY.sub("", j.summary)
    assert t.fixit == j.fixit


def test_registry_ids_and_finding_text():
    assert sorted(trules.RULES) == sorted(jrules.RULES)
    assert len(trules.RULES) == 41
    assert trules.SEVERITIES == jrules.SEVERITIES
    jf = jrules.Finding(jrules.get_rule("MX402"), "msg", node="fc1")
    tf = trules.Finding(trules.get_rule("MX402"), "msg", node="fc1")
    assert tf.format() == jf.format() and str(tf) == str(jf)
    assert tf.is_error and not trules.Finding(
        trules.get_rule("MX404"), "m").is_error
    # re-registration must be identical, as in the JAX package
    trules.register_rule("MX402", "error", trules.RULES["MX402"].summary,
                         trules.RULES["MX402"].fixit)
    with pytest.raises(ValueError, match="conflicting"):
        trules.register_rule("MX402", "warning", "other")
    with pytest.raises(ValueError, match="bad severity"):
        trules.Rule("MX999", "fatal", "x")


# -- MX401-MX406 on the JAX package's fixtures --------------------------------

def _dup(m):
    return m.sym.Variable("x") + m.sym.Variable("x"), {"x": (2, 2)}, None


def _shape_conflict(m):
    data = m.sym.Variable("data")
    fc = m.symbol.FullyConnected(data=data, num_hidden=3, name="fc1")
    return fc + data, {"data": (4, 5)}, None


def _dtype_conflict(m):
    lhs = m.sym.Variable("l", shape=(2, 2), dtype=np.float32)
    rhs = m.sym.Variable("r", shape=(2, 2), dtype=np.float16)
    return lhs + rhs, None, None


def _bf16_conflict(m):
    bf16 = torch.bfloat16 if m is mt else jnp.bfloat16
    lhs = m.sym.Variable("l", shape=(2, 2), dtype=bf16)
    rhs = m.sym.Variable("r", shape=(2, 2), dtype=np.float32)
    return lhs + rhs, None, None


def _embedding(m):
    emb = m.symbol.Embedding(data=m.sym.Variable("tokens"), input_dim=16,
                             output_dim=4, name="emb")
    return emb, {"tokens": (2, 8)}, {"tokens": np.int32,
                                     "emb_weight": np.float32}


def _unused_output(m):
    split = m.symbol.SliceChannel(m.sym.Variable("data"), num_outputs=2,
                                  name="split")
    return split[0], {"data": (4, 6)}, None


def _underdetermined(m):
    fc = m.symbol.FullyConnected(data=m.sym.Variable("data"), num_hidden=3,
                                 name="fc1")
    return m.symbol.SoftmaxOutput(data=fc, name="softmax"), None, None


def _loss_label_dtype(m):
    fc = m.symbol.FullyConnected(data=m.sym.Variable("data"), num_hidden=3,
                                 name="fc1")
    out = m.symbol.SoftmaxOutput(data=fc, name="softmax")
    return out, {"data": (4, 5)}, {"data": np.float32,
                                   "softmax_label": np.int32}


FIXTURES = {"MX401": _dup, "MX402": _shape_conflict, "MX403": _dtype_conflict,
            "MX403_bf16": _bf16_conflict, "embedding": _embedding,
            "MX404": _unused_output, "MX406": _underdetermined,
            "loss_label": _loss_label_dtype}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_match_jax(name):
    tsym, shapes, dtypes = FIXTURES[name](mt)
    jsym, _, _ = FIXTURES[name](mx)
    got = tanalysis.verify_symbol(tsym, shapes, dtypes)
    want = jverify_symbol(jsym, shapes, dtypes)
    assert _ids(got) == _ids(want)
    assert [f.rule.severity for f in got] == [f.rule.severity for f in want]
    rule = name.split("_")[0]
    if rule.startswith("MX"):
        assert rule in {f.rule.id for f in got}
    errors = [f for f in got if f.is_error]
    if errors:
        with pytest.raises(MXNetError, match=errors[0].rule.id):
            tsym.verify(arg_shapes=shapes, arg_dtypes=dtypes)
    else:
        tsym.verify(arg_shapes=shapes, arg_dtypes=dtypes)


def test_shape_conflict_names_the_op_and_chain():
    tsym, shapes, _ = _shape_conflict(mt)
    (f,) = [f for f in tanalysis.verify_symbol(tsym, shapes) if f.is_error]
    jsym, _, _ = _shape_conflict(mx)
    (g,) = [g for g in jverify_symbol(jsym, shapes) if g.is_error]
    assert f.message == g.message
    assert "_Plus" in f.message and "input chain" in f.message


def _unreachable_json():
    net = mx.symbol.FullyConnected(data=mx.sym.Variable("data"),
                                   num_hidden=3, name="fc1")
    graph = json.loads(net.tojson())
    graph["nodes"].append({"op": "null", "name": "orphan", "inputs": []})
    return json.dumps(graph)


def _broken_json():
    net = mx.symbol.FullyConnected(data=mx.sym.Variable("data", shape=(4, 5)),
                                   num_hidden=3, name="fc1")
    graph = json.loads(net.tojson())
    graph["nodes"][-1]["op"] = "NoSuchOp"  # an op neither package has
    return json.dumps(graph)


@pytest.mark.parametrize("make", [_unreachable_json, _broken_json],
                         ids=["unreachable", "does_not_load"])
def test_verify_json_matches_jax(make, tmp_path):
    text = make()
    got = tanalysis.verify_json(text)
    want = jverify_json(text)
    assert [(f.rule.id, f.node, f.path) for f in got] == \
        [(f.rule.id, f.node, f.path) for f in want]
    assert got
    path = tmp_path / "graph.json"
    path.write_text(text)
    assert _ids(tanalysis.verify_json_file(str(path))) == _ids(got)
    assert {f.path for f in tanalysis.verify_json_file(str(path))} == \
        {str(path)}


# -- bind runs it -------------------------------------------------------------

def _fc_args():
    return {"data": torch.zeros(4, 5), "fc1_weight": torch.zeros(3, 9),
            "fc1_bias": torch.zeros(3)}


def test_bind_runs_verify_and_env_turns_it_off(monkeypatch):
    net = mt.symbol.FullyConnected(data=mt.sym.Variable("data"),
                                   num_hidden=3, name="fc1")
    monkeypatch.delenv("MXNET_TPU_VERIFY", raising=False)
    with pytest.raises(MXNetError) as ei:
        net.bind(mt.cpu(), _fc_args())
    assert "fc1" in str(ei.value) and "MX402" in str(ei.value)
    monkeypatch.setenv("MXNET_TPU_VERIFY", "0")
    ex = net.bind(mt.cpu(), _fc_args())  # the bind itself goes through
    assert ex.arg_dict["fc1_weight"].shape == (3, 9)


def test_bind_hands_bf16_to_verify_as_torch_bfloat16(monkeypatch):
    seen = []
    real = mt.symbol.Symbol.verify

    def spy(self, *a, **k):
        seen.append(k)
        return real(self, *a, **k)

    monkeypatch.delenv("MXNET_TPU_VERIFY", raising=False)
    monkeypatch.setattr(mt.symbol.Symbol, "verify", spy)
    net = mt.symbol.FullyConnected(data=mt.sym.Variable("data"),
                                   num_hidden=3, name="fc1")
    args = {k: v.bfloat16() for k, v in _fc_args().items()}
    args["fc1_weight"] = torch.zeros(3, 5, dtype=torch.bfloat16)
    net.bind(mt.cpu(), args)
    (kw,) = seen
    assert kw["arg_shapes"] == {"data": (4, 5), "fc1_weight": (3, 5),
                                "fc1_bias": (3,)}
    assert set(kw["arg_dtypes"].values()) == {torch.bfloat16}
    # a mixed bf16/f32 bind is the MX403 the JAX package raises
    args["fc1_bias"] = torch.zeros(3)
    with pytest.raises(MXNetError, match="MX403"):
        net.bind(mt.cpu(), args)


@pytest.mark.parametrize("value,want", [
    (np.float32, np.dtype(np.float32)), ("float16", np.dtype(np.float16)),
    (torch.int32, np.dtype(np.int32)), (torch.bfloat16, torch.bfloat16),
    ("bfloat16", torch.bfloat16)])
def test_as_dtype(value, want):
    assert as_dtype(value) == want
    import ml_dtypes

    assert as_dtype(np.dtype(ml_dtypes.bfloat16)) is torch.bfloat16


OP_KWARGS = {"FullyConnected": {"num_hidden": 3},
             "Convolution": {"num_filter": 2, "kernel": (3, 3)},
             "BatchNorm": {}, "SoftmaxOutput": {}, "_Plus": {},
             "Embedding": {"input_dim": 5, "output_dim": 2}}


@pytest.mark.parametrize("name", sorted(OP_KWARGS))
def test_infer_dtype_matches_jax(name):
    from mxnet_tpu.ops import registry as jreg

    top = mt.ops.OPS.create(name, **OP_KWARGS[name])
    jop = jreg.OPS.create(name, **OP_KWARGS[name])
    assert isinstance(top, OpProp)
    n = top.num_inputs()
    for dts in ([np.float32] + [None] * (n - 1),
                [np.float16] + [None] * (n - 1), [None] * n):
        try:
            want = jop.infer_dtype(dts)
        except Exception as e:  # noqa: BLE001 - both must refuse alike
            with pytest.raises(MXNetError, match=str(e).split(":")[0]):
                top.infer_dtype(dts)
            continue
        got = top.infer_dtype(dts)
        assert [[as_dtype(d) for d in part] for part in got] == \
            [[np.dtype(d) for d in part] for part in want]


# -- the zoo and the LSTM LM verify clean -------------------------------------

ZOO = [("mlp", {}, (2, 64)), ("lenet", {}, (2, 1, 28, 28)),
       ("alexnet", {"num_classes": 10}, (2, 3, 224, 224)),
       ("inception_bn_cifar", {}, (2, 3, 28, 28)),
       ("inception_bn", {"num_classes": 10}, (2, 3, 224, 224)),
       ("resnet50", {}, (2, 3, 224, 224))]


def _lstm_shapes(seq, layers=2, batch=4, hidden=16):
    shapes = {f"t{t}_data": (batch,) for t in range(seq)}
    shapes.update({f"t{t}_label": (batch,) for t in range(seq)})
    for i in range(layers):
        shapes[f"l{i}_init_c"] = (batch, hidden)
        shapes[f"l{i}_init_h"] = (batch, hidden)
    return shapes


def _zoo_cases():
    for name, kw, shape in ZOO:
        yield name, (lambda m, n=name, k=kw: getattr(
            tmodels if m is mt else jmodels, n)(**k)), {"data": shape}
    for seq in (3, 6):
        yield f"lstm_unroll_{seq}", (lambda m, s=seq: (
            tmodels if m is mt else jmodels).lstm_unroll(
                2, s, 20, 16, 12, 20)), _lstm_shapes(seq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,build,shapes", list(_zoo_cases()),
                         ids=[c[0] for c in _zoo_cases()])
def test_zoo_verifies_clean_as_jax(name, build, shapes, dtype):
    tsym, jsym = build(mt), build(mx)
    arg_shapes, _, _ = tsym.infer_shape(**shapes)
    names = tsym.list_arguments()
    tdt = torch.bfloat16 if dtype == "bfloat16" else np.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    full = dict(zip(names, arg_shapes))
    got = tsym.verify(arg_shapes=full, arg_dtypes={n: tdt for n in names})
    want = jsym.verify(arg_shapes=full, arg_dtypes={n: jdt for n in names})
    assert not [f for f in got if f.is_error]
    assert _ids(got) == _ids(want)


def test_small_zoo_binds_clean(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_VERIFY", raising=False)
    for name, kw, shape in ZOO[:2]:
        sym = getattr(tmodels, name)(**kw)
        ex = sym.simple_bind(mt.cpu(), data=shape)
        assert set(ex.arg_dict) == set(sym.list_arguments())
    sym = tmodels.lstm_unroll(2, 3, 20, 16, 12, 20)
    sym.simple_bind(mt.cpu(), **_lstm_shapes(3))
