"""The port's remaining single-process examples (``mxnet_tpu_torch/examples/
{numpy_ops,python_howto,adversary,memcost}``) on the CPU, against the JAX
package's scripts, and what all fifteen share.

- The digits the port carries (``examples/_digits.py``) are scikit-learn's
  ``load_digits()``, element for element.
- ``numpy_softmax``: the numpy head's fit from one set of weights, every
  parameter within 1e-4 of the JAX package's after an epoch.
- ``basics``: the walkthrough's numbers (NDArray math, shapes, the softmax
  and its gradient from the script's seeded weights) within 1e-5.
- ``fgsm``: the classifier's fit from one set of weights within 1e-4, and
  the input gradient of the first batch.
- ``memcost``: the no_optimization line equal to the JAX script's number;
  the train count above the remat count above the forward count.
- Every script's ``main`` without CUDA and without ``--cpu`` raises and
  names CUDA; none is imported by ``import mxnet_tpu_torch``; none imports
  JAX or the JAX package.
"""

import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import random_params
from torch_examples_util import (two_threads,  # noqa: F401
                                 BOUND, REPO, assert_close, fresh_names,
                                 jax_example, jax_params, port_params)

mt.set_matmul_precision("highest")
PKG = "mxnet_tpu_torch.examples"

# the fifteen scripts, in examples/README.md's order
SCRIPTS = ["mnist.train_mnist", "cifar10.train_cifar10",
           "imagenet.train_imagenet", "rnn.lstm_ptb", "rnn.lstm_scan",
           "rnn.lstm_bucketing", "notebooks.composite_symbol",
           "notebooks.simple_bind", "notebooks.module_api",
           "notebooks.cifar_recipe", "notebooks.cifar100_advanced",
           "numpy_ops.numpy_softmax", "python_howto.basics",
           "adversary.fgsm", "memcost.memcost"]


def test_digits_are_scikit_learns():
    from sklearn.datasets import load_digits

    from mxnet_tpu_torch.examples._digits import load_digits as port_digits

    got, want = port_digits(), load_digits()
    for field in ("data", "target", "images", "target_names"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


# -- numpy_softmax -------------------------------------------------------------

def test_numpy_softmax_matches_jax():
    from mxnet_tpu_torch.examples.numpy_ops import numpy_softmax as tex

    jex = jax_example("numpy_ops/numpy_softmax.py")
    X, y, classes = tex.dataset()
    rng = np.random.RandomState(0)   # the JAX script's draws, in its order
    centers = rng.randn(classes, 20) * 2.0
    jy = rng.randint(0, classes, 600).astype(np.float32)
    jX = (centers[jy.astype(int)] + 0.5 * rng.randn(600, 20)).astype(
        np.float32)
    assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()
    with fresh_names(mt):
        params, _ = random_params(tex.build_net(classes), 41, data=(50, 20))

    np.random.seed(8)   # fit(X, y) shuffles with numpy's global generator
    tmodel, _, _ = tex.train(mt.cpu(), num_epoch=1,
                             arg_params=port_params(params))
    data = mx.symbol.Variable("data")
    net = mx.symbol.FullyConnected(data=data, name="fc1", num_hidden=64)
    net = mx.symbol.Activation(data=net, name="relu1", act_type="relu")
    net = mx.symbol.FullyConnected(data=net, name="fc2", num_hidden=classes)
    net = jex.NumpySoftmax()(data=net, name="softmax")
    jmodel = mx.FeedForward(net, ctx=mx.cpu(), num_epoch=1,
                            learning_rate=0.2, momentum=0.9,
                            initializer=mx.init.Xavier(),
                            arg_params=jax_params(params))
    np.random.seed(8)
    jmodel.fit(jX, jy, batch_size=50)
    assert_close(tmodel.arg_params, jmodel.arg_params, start=params)


def test_numpy_softmax_main(capsys):
    from mxnet_tpu_torch.examples.numpy_ops import numpy_softmax as tex

    assert tex.main(["--cpu"]) > 0.9
    assert "train accuracy with numpy softmax head:" in \
        capsys.readouterr().out


# -- python_howto/basics -------------------------------------------------------

def test_basics_matches_jax(capsys):
    """The walkthrough's values against the JAX package's on the script's
    inputs and seeded weights (examples/python_howto/basics.py:16-54)."""
    from mxnet_tpu import ndarray as jnd
    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch.examples.python_howto import basics as tex

    got = tex.main(["--cpu"])
    printed = capsys.readouterr().out
    a = jnd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(got["c"], (a * 2 + jnd.ones((2, 3)))
                                  .asnumpy())
    data = jsym.Variable("data")
    net = jsym.FullyConnected(data=data, name="fc1", num_hidden=8)
    net = jsym.Activation(data=net, name="relu1", act_type="relu")
    net = jsym.FullyConnected(data=net, name="fc2", num_hidden=3)
    out = jsym.SoftmaxOutput(data=net, name="softmax")
    assert got["json"] == out.tojson()
    assert (got["arg_shapes"], got["out_shapes"]) == \
        out.infer_shape(data=(4, 10))[:2]
    exe = out.simple_bind(ctx=mx.cpu(), data=(4, 10), softmax_label=(4,))
    rng = np.random.RandomState(0)
    for name, arr in exe.arg_dict.items():
        if name not in ("data", "softmax_label"):
            jnd.array(rng.randn(*arr.shape).astype(np.float32)
                      * 0.1).copyto(arr)
    x = rng.randn(4, 10).astype(np.float32)
    y = np.array([0, 1, 2, 0], np.float32)
    probs = exe.forward(is_train=True, data=x, softmax_label=y)[0]
    exe.backward()
    np.testing.assert_allclose(got["probs"], probs.asnumpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["fc1_weight_grad"],
                               exe.grad_dict["fc1_weight"].asnumpy(),
                               rtol=1e-5, atol=1e-6)
    assert "symbol JSON roundtrip ok:" in printed
    assert out.debug_str().splitlines()[0] in printed


# -- adversary/fgsm ------------------------------------------------------------

def test_fgsm_matches_jax():
    """The classifier's fit (one epoch) from one set of weights, then the
    first batch's input gradient through the input-gradient executor."""
    from mxnet_tpu_torch.examples.adversary import fgsm as tex

    jex = jax_example("adversary/fgsm.py")
    X, y = tex.digits()
    with fresh_names(mt):
        params, _ = random_params(tex.build_mlp(10), 42, data=(50, 64))
    np.random.seed(9)
    got = tex.attack(mt.cpu(), num_epoch=1, arg_params=port_params(params))

    jnet = jex.build_mlp(10)
    jmodel = mx.FeedForward(jnet, ctx=mx.cpu(), num_epoch=1,
                            learning_rate=0.1, momentum=0.9,
                            initializer=mx.init.Xavier(),
                            arg_params=jax_params(params))
    np.random.seed(9)
    jmodel.fit(X, y, batch_size=50)
    assert_close(got["model"].arg_params, jmodel.arg_params, start=params)
    exe = jnet.simple_bind(ctx=mx.cpu(), grad_req={"data": "write"},
                           data=(50, 64), softmax_label=(50,))
    exe.copy_params_from(jmodel.arg_params, jmodel.aux_params)
    exe.forward(is_train=True, data=X[:50], softmax_label=y[:50])
    exe.backward()
    np.testing.assert_allclose(got["first_grad"],
                               exe.grad_dict["data"].asnumpy(), rtol=BOUND,
                               atol=BOUND)


def test_fgsm_main_breaks_the_classifier(capsys):
    from mxnet_tpu_torch.examples.adversary import fgsm as tex

    out = tex.main(["--cpu"])
    assert out["clean_acc"] > 0.95
    assert out["adv_acc"] < out["clean_acc"] - 0.3
    assert "adversarial (eps=0.15)" in capsys.readouterr().out


# -- memcost -------------------------------------------------------------------

def test_memcost_no_optimization_is_the_jax_scripts(capsys):
    """The JAX script's upper bound (examples/memcost/memcost.py:44-49: the
    internals' shapes through ``jax.eval_shape``, 4 bytes an element), equal
    to the byte; the port's train count above its remat count above its
    forward count."""
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.executor import _build_graph_fn
    from mxnet_tpu_torch.examples.memcost import memcost as tex

    sym = mx.models.inception_bn_cifar()
    shapes = {"data": (32, 3, 28, 28), "softmax_label": (32,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: jnp.zeros(s, jnp.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: jnp.zeros(s, jnp.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    key = jnp.zeros((2,), jnp.uint32)
    fn_all = _build_graph_fn(sym.get_internals(), is_train=False)
    outs = jax.eval_shape(lambda a, x: fn_all(a, x, key)[0], args, aux)
    naive = sum(int(np.prod(o.shape)) * 4 for o in outs)

    got, card = tex.main(["--cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert got["no_optimization"] == naive
    assert printed[0] == ("no_optimization (sum of all intermediates): "
                          f"{naive / (1 << 20):8.2f} MB")
    assert got["train"] > got["remat"] > got["forward_only"] > 0
    assert card == {"forward_only": None, "train": None, "remat": None}
    assert len(printed) == 4 and "unavailable" not in "".join(printed)


def test_memcost_live_bytes_follow_frees():
    """LiveBytes counts a storage from its first tensor to the death of its
    last view."""
    from mxnet_tpu_torch.examples.memcost.memcost import LiveBytes

    with LiveBytes() as live:
        a = torch.ones(256)          # 1 KiB
        b = a.view(16, 16)
        del a
        c = torch.ones(512)          # 2 KiB, a still held through b
        del b, c
        d = torch.ones(128)
    assert live.peak == 3 * 1024 and live.live == 512
    del d


# -- what every script shares --------------------------------------------------

@pytest.mark.parametrize("script", SCRIPTS)
def test_without_cpu_a_script_needs_cuda(monkeypatch, script):
    """Without ``--cpu`` and without CUDA each script raises, naming CUDA,
    before it touches a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"{PKG}.{script}")
    with pytest.raises(MXNetError, match="CUDA"):
        module.main([])


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_imports_no_jax(script):
    """No import of jax, jaxlib or the JAX package, at any depth of the
    file; and the module names its counterpart under ``examples/``."""
    path = os.path.join(REPO, "mxnet_tpu_torch", "examples",
                        *script.split(".")) + ".py"
    with open(path) as f:
        source = f.read()
    for node in ast.walk(ast.parse(source)):
        names = [a.name for a in node.names] \
            if isinstance(node, ast.Import) else \
            [node.module or ""] if isinstance(node, ast.ImportFrom) else []
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "mxnet_tpu"), \
                (script, name)
    counterpart = "examples/" + script.replace(".", "/") + ".py"
    assert counterpart in source and os.path.exists(
        os.path.join(REPO, counterpart))


def test_package_import_loads_no_example():
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, mxnet_tpu_torch; "
         "print(sorted(m for m in sys.modules if m.startswith("
         "'mxnet_tpu_torch.examples')))"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_forward_holds_its_working_set():
    """The graph function drops each intermediate after its last reader: a
    forward of Inception-BN (CIFAR) at batch 32 holds under a tenth of the
    sum of its intermediates at its peak."""
    from mxnet_tpu_torch.examples.memcost import memcost as tex

    sym = mt.models.inception_bn_cifar()
    shapes = {"data": (32, 3, 28, 28), "softmax_label": (32,)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: torch.zeros(s) for n, s in zip(sym.list_arguments(),
                                              arg_shapes)}
    aux = {n: torch.zeros(s) for n, s in zip(sym.list_auxiliary_states(),
                                             aux_shapes)}
    peak, card = tex.forward_only(sym, args, aux)
    assert card is None
    assert 0 < peak < tex.no_optimization_bytes(sym, shapes) / 10


def _inception_tensors(batch):
    sym = mt.models.inception_bn_cifar()
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(batch, 3, 28, 28), softmax_label=(batch,))
    args = {n: torch.zeros(s) for n, s in zip(sym.list_arguments(),
                                              arg_shapes)}
    aux = {n: torch.zeros(s) for n, s in zip(sym.list_auxiliary_states(),
                                             aux_shapes)}
    return sym, args, aux


def test_replica_pass_holds_its_working_set():
    """The lockstep replica pass (a ctx list's BatchNorm step) drops each
    replica's intermediates after their last reader too: a training
    forward of Inception-BN (CIFAR) over two replicas of batch 16 holds
    under a tenth of the sum of the intermediates of batch 32 at its
    peak."""
    from mxnet_tpu_torch.examples.memcost import memcost as tex
    from mxnet_tpu_torch.executor import _build_replica_graph_fn

    reps = [_inception_tensors(16) for _ in range(2)]
    sym = reps[0][0]
    fn = _build_replica_graph_fn(sym, is_train=True)
    held = tex.storages([t for _, a, x in reps
                         for t in (*a.values(), *x.values())])
    with torch.no_grad(), tex.LiveBytes(held) as live:
        outs, _ = fn([a for _, a, _ in reps], [x for _, _, x in reps],
                     [None, None], [None, None])
        assert len(outs) == 2 and outs[0][0].shape == (16, 10)
        del outs
    total = tex.no_optimization_bytes(
        sym, {"data": (32, 3, 28, 28), "softmax_label": (32,)})
    assert 0 < live.peak < total / 10


@pytest.mark.parametrize("is_train", [False, True])
def test_remat_pass_holds_its_working_set(is_train, monkeypatch):
    """Under ``MXNET_TPU_REMAT`` the outer env drops each inline node's
    output and each block's export after its last reader, and a block drops
    its members' outputs that it does not export: a forward of
    Inception-BN (CIFAR) at batch 32 with a block a ``concat`` holds under
    a tenth of the sum of its intermediates at its peak."""
    from mxnet_tpu_torch.examples.memcost import memcost as tex
    from mxnet_tpu_torch.executor import _build_graph_fn

    monkeypatch.setenv("MXNET_TPU_REMAT", r"concat$")
    sym, args, aux = _inception_tensors(32)
    fn = _build_graph_fn(sym, is_train=is_train)
    with torch.no_grad(), tex.LiveBytes(tex.storages(
            [*args.values(), *aux.values()])) as live:
        outs, _ = fn(args, aux, torch.Generator())
        del outs
    total = tex.no_optimization_bytes(
        sym, {"data": (32, 3, 28, 28), "softmax_label": (32,)})
    assert 0 < live.peak < total / 10
