"""The port's vision examples (``mxnet_tpu_torch/examples/{mnist,cifar10,
imagenet}``) on the CPU, against the JAX package's scripts under
``examples/``.

- The same data: ``synthetic_mnist``'s arrays and the synthetic shards
  (``cifar_synth.rec``, ``imagenet_synth_{n}.rec``) byte for byte.
- The same symbols: ``tojson()``, ``list_arguments()`` and ``infer_shape``
  of LeNet, the MLP, Inception-BN (CIFAR) and the three ImageNet networks.
- The same training: each script's fit from one set of weights, on the same
  batches in the same order (the iterators' augmentation and shuffle off
  where the packages draw differently), against the JAX package's fit with
  the JAX script's arguments (f32, TF32 off; the JAX side at "highest"
  precision): the MLP's and LeNet's parameters within 1e-4 after an epoch
  of 14 batches; Inception-BN's first batch loss within 1e-4 (its f32
  gradients are ill-conditioned in both packages, see the last test);
  AlexNet's forward within 1e-4 (its Dropout draws are each package's).
- Each script's own ``main(["--cpu", ...])`` at reduced arguments, and
  ``imagenet``'s ``dist_sync`` tier on two workers under the repo's
  ``tools/launch.py``, as ``tests/test_multiprocess_dist.py`` runs the JAX
  script.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.convert import random_params
from torch_examples_util import (two_threads,  # noqa: F401
                                 BOUND, REPO, BatchLosses, assert_close,
                                 cpu_env, fresh_names, host, jax_example,
                                 jax_params, port_params, sha256)

mt.set_matmul_precision("highest")
PKG = "mxnet_tpu_torch.examples"


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    """Each test writes its shards and checkpoints under its own TMPDIR."""
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# -- mnist ---------------------------------------------------------------------

def test_synthetic_mnist_is_the_jax_scripts():
    from mxnet_tpu_torch.examples.mnist import train_mnist as tex

    jex = jax_example("mnist/train_mnist.py")
    for got, want in zip(tex.synthetic_mnist(), jex.synthetic_mnist()):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("network,api", [("mlp", "feedforward"),
                                         ("lenet", "feedforward"),
                                         ("mlp", "module")])
def test_mnist_fit_matches_jax(network, api):
    """One epoch (14 batches of 128) from one set of weights: the port's
    ``train`` against the JAX package's FeedForward or Module with the JAX
    script's arguments, on the same shuffled batches."""
    from mxnet_tpu_torch.examples.mnist import train_mnist as tex

    jex = jax_example("mnist/train_mnist.py")
    flat = network == "mlp"
    with fresh_names(mx):
        jnet = mx.models.mlp() if flat else mx.models.lenet()
    with fresh_names(mt):
        tnet = mt.models.mlp() if flat else mt.models.lenet()
    assert tnet.tojson() == jnet.tojson()
    assert tnet.list_arguments() == jnet.list_arguments()
    shape = (128, 784) if flat else (128, 1, 28, 28)
    assert tnet.infer_shape(data=shape) == jnet.infer_shape(data=shape)
    args, _ = random_params(tnet, 11, data=shape)

    argv = ["--cpu", "--network", network, "--num-epochs", "1", "--api", api]
    np.random.seed(3)
    tmodel, _ = tex.train(tex.parser().parse_args(argv),
                          arg_params=port_params(args))

    X, y = jex.synthetic_mnist()
    X = X.reshape(len(X), -1) if flat else X[:, None]
    split = int(0.9 * len(X))
    np.random.seed(3)
    train = mx.io.NDArrayIter(X[:split], y[:split], batch_size=128,
                              shuffle=True)
    val = mx.io.NDArrayIter(X[split:], y[split:], batch_size=128)
    if api == "module":
        jmod = mx.mod.Module(jnet, context=mx.cpu())
        jmod.bind(data_shapes=train.provide_data,
                  label_shapes=train.provide_label)
        jmod.init_params(arg_params=jax_params(args))
        jmod.fit(train, eval_data=val, num_epoch=1,
                 initializer=mx.init.Xavier(),
                 optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                   "rescale_grad": 1.0 / 128})
        want, got = jmod.get_params()[0], tmodel.get_params()[0]
    else:
        jmodel = mx.FeedForward(jnet, ctx=[mx.cpu()], num_epoch=1,
                                initializer=mx.init.Xavier(),
                                arg_params=jax_params(args), lr=0.1,
                                momentum=0.9)
        jmodel.fit(train, eval_data=val, kvstore="local",
                   batch_end_callback=mx.callback.Speedometer(128, 50))
        want, got = jmodel.arg_params, tmodel.arg_params
    assert_close(got, want, start=args)


def test_mnist_main_module_api(capsys):
    """The JAX package's test of this entry point asserts the line
    "final val accuracy: 1.0" (tests/test_examples.py:33-47)."""
    from mxnet_tpu_torch.examples.mnist import train_mnist as tex

    acc = tex.main(["--cpu", "--network", "mlp", "--api", "module",
                    "--num-epochs", "4"])
    assert acc == 1.0
    assert "final val accuracy: 1.0" in capsys.readouterr().out


def test_mnist_main_feedforward_two_contexts(capsys):
    """``--num-devices 2`` trains on ``[cpu(0), cpu(1)]``: two replicas of
    conftest's host devices."""
    from mxnet_tpu_torch.examples.mnist import train_mnist as tex

    acc = tex.main(["--cpu", "--network", "mlp", "--num-epochs", "2",
                    "--num-devices", "2"])
    assert acc > 0.95
    assert "final val accuracy:" in capsys.readouterr().out


# -- cifar10 -------------------------------------------------------------------

def test_cifar_synth_rec_is_the_jax_scripts(tmp_path):
    """The whole default shard (2,048 JPEG records), byte for byte."""
    from mxnet_tpu_torch.examples.cifar10 import train_cifar10 as tex

    jex = jax_example("cifar10/train_cifar10.py")
    got = tex.make_synthetic_rec(str(tmp_path / "port.rec"))
    want = jex.make_synthetic_rec(str(tmp_path / "jax.rec"))
    assert sha256(got) == sha256(want)


# the iterators' draws are each package's own: compare them without
AUGMENT_OFF = dict(rand_crop=False, rand_mirror=False, shuffle=False)


def test_cifar10_fit_matches_jax(tmp_path):
    """Inception-BN (CIFAR) on a 40-record shard the JAX function wrote,
    batch 8, one epoch, from one set of weights: the port's ``train``
    against the JAX package's FeedForward with the JAX script's arguments
    and iterator (augmentation and shuffle off in both). The first batch's
    loss within 1e-4; the later batches' are the JAX side's f32 rounding
    amplified by 60 BatchNorms
    (``test_bn_stack_gradient_is_ill_conditioned_in_f32``),
    and are held to trend alike."""
    from mxnet_tpu_torch.examples.cifar10 import train_cifar10 as tex

    jex = jax_example("cifar10/train_cifar10.py")
    rec = jex.make_synthetic_rec(str(tmp_path / "small.rec"), n=40)
    with fresh_names(mx):
        jnet = mx.models.inception_bn_cifar()
    with fresh_names(mt):
        tnet = mt.models.inception_bn_cifar()
    assert tnet.tojson() == jnet.tojson()
    shape = (8, 3, 28, 28)
    assert tnet.infer_shape(data=shape) == jnet.infer_shape(data=shape)
    args, aux = random_params(tnet, 12, data=shape)

    tl, jl = BatchLosses(mt.metric), BatchLosses(mx.metric)
    argv = ["--cpu", "--data-rec", rec, "--batch-size", "8",
            "--num-epochs", "1"]
    tmodel = tex.train(tex.parser().parse_args(argv),
                       arg_params=port_params(args),
                       aux_params=port_params(aux), eval_metric=tl.metric,
                       **AUGMENT_OFF)

    train = mx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=(3, 28, 28), batch_size=8,
        mean_r=128, mean_g=128, mean_b=128, scale=1 / 128.0, **AUGMENT_OFF)
    jmodel = mx.FeedForward(
        jnet, ctx=[mx.cpu()], num_epoch=1,
        initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2),
        compute_dtype=None, arg_params=jax_params(args),
        aux_params=jax_params(aux), lr=0.05, momentum=0.9, wd=1e-4)
    jmodel.fit(train, kvstore="local", eval_metric=jl.metric,
               batch_end_callback=mx.callback.Speedometer(8, 10))
    assert len(tl.losses) == len(jl.losses) == 5
    assert abs(tl.losses[0] - jl.losses[0]) <= BOUND, (tl.losses, jl.losses)
    assert tl.losses[-1] < tl.losses[0] and jl.losses[-1] < jl.losses[0]
    assert set(tmodel.arg_params) == set(jmodel.arg_params)


def test_cifar10_main_bf16(tmp_path):
    """``--bf16`` trains in bfloat16 over f32 masters, from the default
    shard path under TMPDIR (written first by the JAX function: either
    package's shard serves both)."""
    import torch

    from mxnet_tpu_torch.examples.cifar10 import train_cifar10 as tex

    jex = jax_example("cifar10/train_cifar10.py")
    jex.make_synthetic_rec(str(tmp_path / "cifar_synth.rec"), n=64)
    model = tex.main(["--cpu", "--bf16", "--batch-size", "16",
                      "--num-epochs", "1"])
    assert model.compute_dtype == torch.bfloat16
    for k, v in model.arg_params.items():
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), k


# -- imagenet ------------------------------------------------------------------

def test_imagenet_synth_rec_is_the_jax_scripts(tmp_path):
    from mxnet_tpu_torch.examples.imagenet import train_imagenet as tex

    jex = jax_example("imagenet/train_imagenet.py")
    got = tex.make_synthetic_rec(str(tmp_path / "port.rec"), n=8)
    want = jex.make_synthetic_rec(str(tmp_path / "jax.rec"), n=8)
    assert sha256(got) == sha256(want)
    assert tex.synthetic_rec_path() == (
        str(tmp_path / "imagenet_synth_512.rec"), 512)


@pytest.mark.parametrize("network", ["alexnet", "inception-bn", "resnet-50"])
def test_imagenet_networks_are_the_jax_scripts(network):
    from mxnet_tpu_torch.examples.imagenet import train_imagenet as tex

    jex = jax_example("imagenet/train_imagenet.py")
    assert sorted(tex.NETWORKS) == sorted(jex.NETWORKS)
    with fresh_names(mt):
        tnet = tex.NETWORKS[network](100)
    with fresh_names(mx):
        jnet = jex.NETWORKS[network](100)
    assert tnet.tojson() == jnet.tojson()
    assert tnet.list_arguments() == jnet.list_arguments()
    shape = (2, 3, 224, 224)
    assert tnet.infer_shape(data=shape) == jnet.infer_shape(data=shape)


def test_imagenet_alexnet_matches_jax(tmp_path):
    """AlexNet on 4 records of the JAX script's shard (resized to 256,
    cropped to 224), batch 2, from one set of weights: the forward of the
    JAX script's iterator within 1e-4 of the JAX package's (its Dropout
    draws are each package's own, so the fit is compared before it), then
    the port's ``train`` for one epoch, rank 0's checkpoint written."""
    from mxnet_tpu_torch.examples.imagenet import train_imagenet as tex

    jex = jax_example("imagenet/train_imagenet.py")
    rec = jex.make_synthetic_rec(str(tmp_path / "small.rec"), n=4)
    tnet, jnet = tex.NETWORKS["alexnet"](100), jex.NETWORKS["alexnet"](100)
    args, _ = random_params(tnet, 13, data=(2, 3, 224, 224))
    kw = dict(path_imgrec=rec, data_shape=(3, 224, 224), batch_size=2,
              resize=256, mean_r=123.68, mean_g=116.78, mean_b=103.94,
              scale=1 / 58.8, num_parts=1, part_index=0, **AUGMENT_OFF)
    want = mx.FeedForward(jnet, ctx=[mx.cpu()],
                          arg_params=jax_params(args)).predict(
        mx.io.ImageRecordIter(**kw))
    with mt.cpu():
        got = mt.FeedForward(tnet, ctx=[mt.cpu()],
                             arg_params=port_params(args)).predict(
            mt.io.ImageRecordIter(**kw))
    assert got.shape == want.shape == (4, 100)
    np.testing.assert_allclose(got, want, rtol=BOUND, atol=BOUND)

    argv = ["--cpu", "--network", "alexnet", "--data-rec", rec,
            "--num-classes", "100", "--batch-size", "2", "--lr", "0.01"]
    tmodel = tex.train(tex.parser().parse_args(argv),
                       arg_params=port_params(args), **AUGMENT_OFF)
    assert (tmp_path / "alexnet-0001.params").exists()
    assert any(not np.array_equal(host(tmodel.arg_params[k]), args[k])
               for k in args)


def test_imagenet_dist_sync_two_launched_workers(tmp_path):
    """``tools/launch.py -n 2`` runs the AlexNet tier with ``--kv-store
    dist_sync --cpu`` (tests/test_multiprocess_dist.py:101-128 for the JAX
    script): rank 0 writes the shard, rank 1 waits for its publish, each
    reads its half; both ranks log their epoch (4 or more ``Epoch[0]``
    lines) in a real two-rank world, and rank 0 alone checkpoints."""
    env = cpu_env()
    env.update(TMPDIR=str(tmp_path), MXTPU_SYNTH_IMAGES="16")
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
         "2", sys.executable, "-m", f"{PKG}.imagenet.train_imagenet",
         "--network", "alexnet", "--kv-store", "dist_sync", "--cpu",
         "--batch-size", "4", "--num-epochs", "1"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-3000:]
    assert out.count("Epoch[0]") >= 4, out[-3000:]
    assert "continuing single-process" not in out, out[-3000:]
    assert len(re.findall(r"joined the 2-rank world with gloo", out)) == 2, \
        out[-3000:]
    assert (tmp_path / "imagenet_synth_16.rec").exists()
    assert sorted(p.name for p in tmp_path.glob("alexnet-*.params")) == \
        ["alexnet-0001.params"]


def test_bn_stack_gradient_is_ill_conditioned_in_f32():
    """Why Inception-BN's later losses are not held to 1e-4 across the
    packages: from these weights at batch 8, the f32 gradient of the net's
    stack of BatchNorms (one-pass statistics ``E[x²] - mean²`` in both
    packages) lands more than 1e-3 (relative to each leaf's largest entry)
    from the f64 gradient of the same graph in either package: the port's
    own f32 run about 2e-2, the JAX package's about 7e-2. Neither f32
    trajectory is fixed to 1e-4 past the first update, so the fit is held
    on its first batch (``test_cifar10_fit_matches_jax``)."""
    import torch

    from mxnet_tpu_torch.executor import _build_graph_fn

    shape = (8, 3, 28, 28)
    tnet, jnet = mt.models.inception_bn_cifar(), mx.models.inception_bn_cifar()
    args, aux = random_params(tnet, 12, data=shape)
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.float32)

    def port(dtype):
        fn = _build_graph_fn(tnet, is_train=True)
        leaves = {k: torch.tensor(v, dtype=dtype, requires_grad=True)
                  for k, v in args.items()}
        values = dict(leaves, data=torch.tensor(x, dtype=dtype),
                      softmax_label=torch.tensor(y, dtype=dtype))
        outs, _ = fn(values, {k: torch.tensor(v, dtype=dtype)
                              for k, v in aux.items()})
        outs[0].backward(torch.ones_like(outs[0]))  # the head injects p - 1
        return {k: v.grad.double().numpy() for k, v in leaves.items()}

    exact, got = port(torch.float64), port(torch.float32)
    exe = jnet.simple_bind(mx.cpu(), data=shape, softmax_label=(8,))
    exe.copy_params_from(jax_params(args), jax_params(aux))
    exe.forward(is_train=True, data=x, softmax_label=y)
    exe.backward()
    weights = [k for k in args if k.endswith("_weight")]

    def worst(grads):
        return max(np.abs(grads[k] - exact[k]).max()
                   / np.abs(exact[k]).max() for k in weights)

    assert worst(got) > 1e-3
    assert worst({k: host(exe.grad_dict[k]) for k in weights}) > 1e-3
