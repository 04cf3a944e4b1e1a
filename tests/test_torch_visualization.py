"""``visualization.plot_network`` and ``print_summary`` of the port give the
JAX package's text, string for string, for the zoo's models."""

import pytest

from mxnet_tpu import models as jmodels
from mxnet_tpu import name as jname
from mxnet_tpu import visualization as jviz
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.base import MXNetError

CASES = {
    "mlp": ({}, {"data": (1, 784)}),
    "lenet": ({}, {"data": (1, 1, 28, 28)}),
    "alexnet": ({}, {"data": (1, 3, 224, 224)}),
    "inception_bn": ({}, {"data": (1, 3, 224, 224)}),
    "resnet50": ({}, {"data": (1, 3, 224, 224)}),
    "lstm_unroll": ({"num_layers": 1, "seq_len": 3, "input_size": 10,
                     "num_hidden": 8, "num_embed": 4, "num_label": 10},
                    {"t0_data": (2,), "t1_data": (2,), "t2_data": (2,),
                     "l0_init_c": (2, 8), "l0_init_h": (2, 8)}),
}


def _pair(name, kw):
    """The zoo model in both packages, each under a fresh name manager so
    that auto-named nodes (``plus0``...) count from zero in both."""
    with jname.NameManager():
        j = getattr(jmodels, name)(**kw)
    with tname.NameManager():
        t = getattr(tmodels, name)(**kw)
    return j, t


@pytest.mark.parametrize("name", sorted(CASES))
def test_plot_network_matches_jax(name, tmp_path):
    kw, _ = CASES[name]
    j, t = _pair(name, kw)
    assert mt.viz.plot_network(t, title=name) == \
        jviz.plot_network(j, title=name)
    path = tmp_path / "net.dot"
    dot = mt.visualization.plot_network(t, save_path=str(path))
    assert path.read_text() == dot and dot.startswith('digraph "plot" {')


@pytest.mark.parametrize("name", sorted(CASES))
def test_print_summary_matches_jax(name, capsys):
    kw, shape = CASES[name]
    jsym, tsym = _pair(name, kw)
    j = jviz.print_summary(jsym, shape=shape)
    t = mt.visualization.print_summary(tsym, shape=shape)
    assert t == j
    assert t in capsys.readouterr().out
    assert t.splitlines()[-1].startswith("Total params: ")


def test_print_summary_needs_shapes():
    with pytest.raises(MXNetError, match="input shapes"):
        mt.visualization.print_summary(tmodels.mlp())
