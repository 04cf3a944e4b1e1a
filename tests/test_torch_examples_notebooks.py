"""The port's notebook walkthroughs (``mxnet_tpu_torch/examples/notebooks``)
on the CPU, against the JAX package's scripts under
``examples/notebooks``.

- ``composite_symbol``: the JAX script run whole (its ``.dot`` redirected
  under the test's directory): the same network JSON, arguments, output
  shape and graphviz source; the port writes its ``.dot`` under TMPDIR.
- ``simple_bind``: the digits (the port's copy, held to scikit-learn's in
  ``test_torch_examples_misc.py``), the bound executor's every training
  output of an epoch from one set of weights, within 1e-4 of the JAX
  package's executor under the notebook's hand-written SGD.
- ``module_api``: ``Module.fit`` and the explicit lifecycle from one set of
  weights, every parameter within 1e-4 of the JAX package's.
- ``cifar_recipe``, ``cifar100_advanced``: the networks' JSON, the shards'
  bytes, and the first batch's loss from one set of weights within 1e-4
  (BatchNorm nets: see ``test_torch_examples_vision.py``'s last test).
- Each script's own ``main(["--cpu", ...])``, its assertions held.
"""

import os
import runpy

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import random_params
from torch_examples_util import (two_threads,  # noqa: F401
                                 BOUND, EXAMPLES, BatchLosses, assert_close,
                                 fresh_names, host, jax_example, jax_params,
                                 port_params, sha256)

mt.set_matmul_precision("highest")


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# -- composite_symbol ----------------------------------------------------------

def test_composite_symbol_matches_jax(tmp_path, monkeypatch, capsys):
    from mxnet_tpu import visualization as jviz
    from mxnet_tpu_torch.examples.notebooks import composite_symbol as tex

    plot = jviz.plot_network

    def redirected(symbol, title="plot", shape=None, save_path=None):
        return plot(symbol, title=title, shape=shape,
                    save_path=str(tmp_path / "jax.dot"))

    monkeypatch.setattr(mx.viz, "plot_network", redirected)
    jax_globals = runpy.run_path(
        os.path.join(EXAMPLES, "notebooks", "composite_symbol.py"))
    jax_out = capsys.readouterr().out

    got = tex.main(["--cpu"])
    port_out = capsys.readouterr().out
    want = jax_globals["softmax"]
    assert got["json"] == jax_globals["js"] == want.tojson()
    assert got["softmax"].list_arguments() == want.list_arguments()
    assert got["out_shape"] == jax_globals["out_shapes"][0] == (2, 1000)
    assert got["dot"] == jax_globals["dot"]
    with open(tmp_path / "composite_symbol.dot") as f:
        assert f.read() == got["dot"]
    assert tex.component().list_arguments() == \
        jax_globals["conv_comp"].list_arguments()
    # the printed cells, but for the .dot's path
    assert port_out.replace(str(tmp_path / "composite_symbol.dot"),
                            "/tmp/composite_symbol.dot") == jax_out


# -- simple_bind ---------------------------------------------------------------

def jax_simple_bind(init, num_round):
    """The JAX script's executor and loop (examples/notebooks/
    simple_bind.py:50-115) from given weights: every training output."""
    from sklearn.datasets import load_digits

    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data=data, name="fc1", num_hidden=128)
    bn1 = mx.sym.BatchNorm(data=fc1, name="bn1")
    act1 = mx.sym.Activation(data=bn1, name="relu1", act_type="relu")
    fc2 = mx.sym.FullyConnected(data=act1, name="fc2", num_hidden=10)
    softmax = mx.sym.SoftmaxOutput(data=fc2, name="softmax")
    executor = softmax.simple_bind(ctx=mx.cpu(), data=(100, 64),
                                   softmax_label=(100,))
    args = dict(zip(softmax.list_arguments(), executor.arg_arrays))
    grads = dict(zip(softmax.list_arguments(), executor.grad_arrays))
    for key, arr in args.items():
        if key in init:
            arr[:] = init[key]
    digits = load_digits()
    X = (digits.data / 16.0).astype(np.float32)[:1500]
    y = digits.target.astype(np.float32)[:1500]
    probs = []
    for _ in range(num_round):
        for i in range(0, len(X) - 100 + 1, 100):
            args["data"][:] = X[i:i + 100]
            args["softmax_label"][:] = y[i:i + 100]
            executor.forward(is_train=True)
            probs.append(executor.outputs[0].asnumpy())
            executor.backward()
            for key in softmax.list_arguments():
                if key.startswith("data") or key.startswith("softmax"):
                    continue
                args[key][:] = args[key] - 0.1 * (grads[key] / 100)
    return probs


def test_simple_bind_matches_jax():
    from mxnet_tpu_torch.examples.notebooks import simple_bind as tex

    with fresh_names(mt):
        net = tex.build_net()
    init, _ = random_params(net, 31, data=(100, 64))
    got = tex.train(mt.cpu(), num_round=1, init=init)
    want = jax_simple_bind(init, 1)
    assert len(got["probs"]) == len(want) == 15
    for g, w in zip(got["probs"], want):
        np.testing.assert_allclose(g, w, rtol=BOUND, atol=BOUND)


def test_simple_bind_main_converges(capsys):
    from mxnet_tpu_torch.examples.notebooks import simple_bind as tex

    out = tex.main(["--cpu"])
    assert len(out["val_acc"]) == tex.NUM_ROUND and out["val_acc"][-1] > 0.85
    assert "simple_bind training converged." in capsys.readouterr().out


# -- module_api ----------------------------------------------------------------

def test_module_api_matches_jax():
    """Level 1 (``fit``, 4 epochs) and level 2 (the explicit lifecycle, one
    epoch) from one set of weights on the same shuffled batches: every
    parameter within 1e-4 of the JAX package's Module."""
    from mxnet_tpu_torch.examples.notebooks import module_api as tex

    jex = jax_example("notebooks/module_api.py")
    X, y = tex.dataset()
    jX, jy = jex.dataset()
    assert X.tobytes() == jX.tobytes() and y.tobytes() == jy.tobytes()
    assert tex.net().tojson() == jex.net().tojson()
    params, _ = random_params(tex.net(), 32, data=(32, 16))

    np.random.seed(5)
    ttrain = mt.io.NDArrayIter(X, y, batch_size=32, shuffle=True)
    tval = mt.io.NDArrayIter(X, y, batch_size=32)
    tmod = tex.level1(mt.cpu(), ttrain, tval, arg_params=port_params(params))
    np.random.seed(5)
    jtrain = mx.io.NDArrayIter(X, y, batch_size=32, shuffle=True)
    jval = mx.io.NDArrayIter(X, y, batch_size=32)
    jmod = mx.mod.Module(jex.net())
    jmod.bind(data_shapes=jtrain.provide_data,
              label_shapes=jtrain.provide_label)
    jmod.init_params(arg_params=jax_params(params))
    jmod.fit(jtrain, eval_data=jval, num_epoch=4,
             initializer=mx.init.Xavier(),
             optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                               "rescale_grad": 1 / 32.0})
    assert_close(tmod.get_params()[0], jmod.get_params()[0], start=params)
    assert tmod.score(tval)[1] == jmod.score(jval)[1]

    np.random.seed(6)
    ttrain = mt.io.NDArrayIter(X, y, batch_size=32, shuffle=True)
    tmod2, _ = tex.level2(mt.cpu(), ttrain, arg_params=port_params(params),
                          num_epoch=1)
    np.random.seed(6)
    jtrain = mx.io.NDArrayIter(X, y, batch_size=32, shuffle=True)
    jmod2 = mx.mod.Module(jex.net())
    jmod2.bind(data_shapes=jtrain.provide_data,
               label_shapes=jtrain.provide_label)
    jmod2.init_params(mx.init.Xavier(), arg_params=jax_params(params))
    jmod2.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 32.0})
    jtrain.reset()
    for batch in jtrain:
        jmod2.forward(batch, is_train=True)
        jmod2.backward()
        jmod2.update()
    assert_close(tmod2.get_params()[0], jmod2.get_params()[0], start=params)


def test_module_api_main(capsys):
    from mxnet_tpu_torch.examples.notebooks import module_api as tex

    out = tex.main(["--cpu"])
    assert out["fit_accuracy"] > 0.95 and out["lifecycle_accuracy"] > 0.95
    assert out["agree"] > 0.99
    assert "FeedForward.load on the Module checkpoint agrees" in \
        capsys.readouterr().out


# -- cifar_recipe, cifar100_advanced -------------------------------------------

RECIPES = {
    # notebook: (JAX file, the shard writer's name, the shards' sizes)
    "cifar_recipe": ("notebooks/cifar_recipe.py", "make_synthetic_rec",
                     (1536, 512)),
    "cifar100_advanced": ("notebooks/cifar100_advanced.py", "make_rec",
                          (1500, 500)),
}


def _recipe(name):
    import importlib

    return importlib.import_module(
        f"mxnet_tpu_torch.examples.notebooks.{name}")


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_net_and_shards_are_the_jax_scripts(name, tmp_path):
    tex = _recipe(name)
    rel, writer, sizes = RECIPES[name]
    jex = jax_example(rel)
    with fresh_names(mt):
        tnet = tex.build_net()
    with fresh_names(mx):
        jnet = jex.build_net()
    assert tnet.tojson() == jnet.tojson()
    shape = (4, 3, 28, 28)
    assert tnet.infer_shape(data=shape) == jnet.infer_shape(data=shape)
    for seed, n in enumerate(sizes):
        got = getattr(tex, writer)(str(tmp_path / f"t{seed}.rec"), n,
                                   seed=seed)
        want = getattr(jex, writer)(str(tmp_path / f"j{seed}.rec"), n,
                                    seed=seed)
        assert sha256(got) == sha256(want)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_fit_matches_jax(name, tmp_path):
    """The notebook's FeedForward (its optimizer, schedule and
    ``grad_scale``) on 40 records of its shard, batch 8, one epoch, from
    one set of weights, augmentation and shuffle off in both: the first
    batch's loss within 1e-4, both runs' losses falling."""
    tex = _recipe(name)
    rel, writer, _ = RECIPES[name]
    jex = jax_example(rel)
    rec = getattr(jex, writer)(str(tmp_path / "small.rec"), 40, seed=0)
    with fresh_names(mt):
        args, aux = random_params(tex.build_net(), 33, data=(8, 3, 28, 28))
    off = dict(rand_crop=False, rand_mirror=False, shuffle=False)
    tl, jl = BatchLosses(mt.metric), BatchLosses(mx.metric)
    kw = dict(arg_params=port_params(args), aux_params=port_params(aux),
              eval_metric=tl.metric)
    with fresh_names(mt):
        tit, tval = tex.iters(rec, rec, 8, **off)
        if name == "cifar_recipe":
            tex.fit(mt.cpu(), tit, tval, 1, 8, **kw)
        else:
            tex.fit(mt.cpu(), tit, tval, 1, 8, n_train=40, **kw)

    common = dict(path_imgrec=rec, data_shape=(3, 28, 28), batch_size=8,
                  mean_r=128, mean_g=128, mean_b=128, scale=1.0 / 128)
    jit = mx.io.ImageRecordIter(
        **common, **off, **({"round_batch": True}
                            if name == "cifar100_advanced" else {}))
    jval = mx.io.ImageRecordIter(**common)
    with fresh_names(mx):
        if name == "cifar_recipe":
            jmodel = mx.model.FeedForward(
                symbol=jex.build_net(), ctx=mx.cpu(), num_epoch=1,
                learning_rate=0.05, momentum=0.9, wd=0.0001,
                initializer=mx.init.Uniform(0.07),
                arg_params=jax_params(args), aux_params=jax_params(aux))
        else:
            jmodel = mx.model.FeedForward(
                symbol=jex.build_net(grad_scale=1.0), ctx=mx.cpu(),
                num_epoch=1, learning_rate=0.1, momentum=0.9, wd=0.0001,
                initializer=mx.init.Xavier(),
                lr_scheduler=mx.lr_scheduler.FactorScheduler(step=5,
                                                             factor=0.9),
                arg_params=jax_params(args), aux_params=jax_params(aux))
    jmodel.fit(X=jit, eval_data=jval, eval_metric=jl.metric,
               batch_end_callback=mx.callback.Speedometer(8, 10))
    # the 5 training batches, then the 5 of the epoch's validation
    assert len(tl.losses) == len(jl.losses) == 10
    assert abs(tl.losses[0] - jl.losses[0]) <= BOUND, (tl.losses, jl.losses)
    assert min(tl.losses[1:5]) < tl.losses[0]
    assert min(jl.losses[1:5]) < jl.losses[0]


def test_cifar_recipe_main(capsys):
    """Pickle, save/load, the restored models' predictions and the feature
    extraction, as the JAX script checks them (one epoch)."""
    from mxnet_tpu_torch.examples.notebooks import cifar_recipe as tex

    out = tex.main(["--cpu", "--num-epochs", "1"])
    assert out["features"] == (512, 64, 1, 1)
    assert out["probs"].shape == (512, 10)
    printed = capsys.readouterr().out
    assert "restored-model val accuracy" in printed
    assert "cifar recipe complete." in printed


def test_cifar_recipe_model_pickles_after_fit():
    """A fitted FeedForward pickles (its programs and hooks dropped, rebuilt
    on first use) and predicts as before, as the JAX package's does."""
    import pickle

    from mxnet_tpu_torch.examples.notebooks import module_api as tex

    X, y = tex.dataset()
    with mt.cpu():
        model = mt.FeedForward(tex.net(), ctx=mt.cpu(), num_epoch=1,
                               learning_rate=0.1,
                               initializer=mt.init.Xavier())
        model.fit(X, y, batch_size=32)
        back = pickle.loads(pickle.dumps(model))
        np.testing.assert_array_equal(back.predict(X), model.predict(X))
    assert back._train_state is None and back._eval_progs == {}
    for k, v in model.arg_params.items():
        assert torch.equal(back.arg_params[k], v), k


def test_cifar100_advanced_main(capsys):
    from mxnet_tpu_torch.examples.notebooks import cifar100_advanced as tex

    prob = tex.main(["--cpu", "--num-epochs", "1"])
    assert prob.shape == (500, 100)
    assert np.allclose(host(prob).sum(1), 1.0, atol=1e-4)
    assert "cifar100 advanced walkthrough complete; predicted (500, 100)" \
        in capsys.readouterr().out
