"""The port's Symbol layer against the JAX package's: the same graphs, names,
shapes and JSON, and JSON that crosses between the packages both ways. Also
that the port stands alone: it imports neither JAX nor the JAX package."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mxnet_tpu import models as jmodels
from mxnet_tpu import name as jname
from mxnet_tpu import symbol as jsym
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.base import MXNetError

torch.set_num_threads(2)

PORT_DIR = Path(mt.__file__).resolve().parent

BUILDERS = {
    "resnet50": lambda m: m.resnet50(),
    "resnet50_nhwc": lambda m: m.resnet50(layout="NHWC"),
    "narrow_resnet": lambda m: m.resnet(units=(1, 1, 1, 1),
                                        filter_list=(16, 32, 64, 128)),
    "mlp": lambda m: m.mlp(),
}


@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_json_identical_and_crosses_both_ways(model):
    # fresh name counters: the residual adds are auto-named, and symbols that
    # other tests built earlier in this process advance each package's counter
    with jname.NameManager():
        j = BUILDERS[model](jmodels)
    with tname.NameManager():
        t = BUILDERS[model](tmodels)
    assert t.tojson() == j.tojson()
    assert tsym.load_json(j.tojson()).tojson() == j.tojson()
    assert jsym.load_json(t.tojson()).tojson() == t.tojson()


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet50_metadata_at_full_width(layout):
    j, t = jmodels.resnet50(layout=layout), tmodels.resnet50(layout=layout)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs() == ["softmax_output"]
    data = (1, 3, 224, 224) if layout == "NCHW" else (1, 224, 224, 3)
    t_shapes = t.infer_shape(data=data)
    j_shapes = j.infer_shape(data=data)
    assert [[tuple(s) for s in g] for g in t_shapes] == \
        [[tuple(s) for s in g] for g in j_shapes]
    assert t_shapes[1] == [(1, 1000)]
    shapes = dict(zip(t.list_arguments(), t_shapes[0]))
    assert shapes["fc1_weight"] == (1000, 2048)
    assert shapes["stem_conv_weight"] == (64, 3, 7, 7)


def test_auto_names_and_composition_match():
    def build(m):
        data = m.Variable("data")
        a = m.FullyConnected(data=data, num_hidden=8)
        b = m.FullyConnected(data=data, num_hidden=8)
        c = m.Concat(a, b, dim=1)
        return m.Group([m.Activation(data=a + b * a - a / b, act_type="tanh"),
                        m.SliceChannel(data=c, num_outputs=2)[1]])

    with jname.NameManager():
        j = build(jsym)
    with tname.NameManager():
        t = build(tsym)
    assert t.tojson() == j.tojson()
    assert t.list_outputs() == j.list_outputs()
    assert t.infer_shape(data=(4, 5))[1] == [(4, 8), (4, 8)]


def test_save_load_file(tmp_path):
    t = tmodels.mlp()
    path = str(tmp_path / "mlp-symbol.json")
    t.save(path)
    assert tsym.load(path).tojson() == t.tojson()
    assert jsym.load(path).tojson() == t.tojson()


def test_infer_shape_errors():
    t = tmodels.mlp()
    with pytest.raises(MXNetError, match="unknown"):
        t.infer_shape()
    with pytest.raises(MXNetError, match="unknown argument"):
        t.infer_shape(bogus=(1, 2))
    with pytest.raises(MXNetError, match="mismatch"):
        t.infer_shape(data=(4, 64), fc1_weight=(128, 65))


def test_contexts(monkeypatch):
    assert mt.cpu().torch_device == torch.device("cpu")
    with mt.Context("cpu", 1) as ctx:
        assert mt.current_context() is ctx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        mt.current_context()  # the default is the card, never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mt.current_context() == mt.gpu(0)
    assert mt.gpu(0).torch_device == torch.device("cuda", 0)
    # gpu(i) is card i % n, as the JAX package resolves it: on one card,
    # gpu(1) aliases gpu(0)
    assert mt.gpu(1).torch_device == torch.device("cuda", 0)
    assert mt.gpu(1).replica_key == mt.gpu(0).replica_key == ("gpu", 0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, importing the port adds no module of JAX or
    of the JAX package (measured against what the interpreter's start-up
    already loaded)."""
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import mxnet_tpu_torch, mxnet_tpu_torch.predictor, "
        "mxnet_tpu_torch.convert, mxnet_tpu_torch.profile_serving, "
        "mxnet_tpu_torch.profile_training\n"
        "from mxnet_tpu_torch.kernels import int8_matmul, fused_adam, "
        "_common, registry\n"
        "from mxnet_tpu_torch import models, executor, model, optimizer, "
        "metric, io, initializer, lr_scheduler, callback, ndarray, random\n"
        "print(json.dumps(sorted(m for m in set(sys.modules) - before\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=str(PORT_DIR.parent), timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_have_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|mxnet_tpu)(\s|\.|$)",
                         re.MULTILINE)
    offenders = [str(p) for p in PORT_DIR.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
