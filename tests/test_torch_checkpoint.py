"""The port's sharded checkpoints (``mxnet_tpu_torch/utils/checkpoint.py``)
against the JAX package's: the round trip, the manifest and metadata, the
answers of ``validate_step``, ``latest_step`` and ``prune_steps`` on the
same planted directories in both packages' layouts, the verify modes, and
a checkpoint carried across the two packages and back, bit for bit."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from mxnet_tpu import models as jmodels
from mxnet_tpu.utils import checkpoint as jck
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import checkpoint as tck


def _state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"fc1_weight": rng.standard_normal((16, 8), np.float32),
              "fc1_bias": rng.standard_normal(16, np.float32),
              "fc2_weight": rng.standard_normal((2, 16), np.float32)}
    aux = {"bn_moving_mean": rng.standard_normal(16, np.float32)}
    opt = [rng.standard_normal((16, 8), np.float32),
           rng.standard_normal((16, 8), np.float32),
           np.asarray(3.0, np.float32)]
    return params, aux, opt


def _save(pkg, directory, step, seed=None, meta=None):
    params, aux, opt = _state(step if seed is None else seed)
    sym = (jmodels if pkg is jck else tmodels).mlp()
    pkg.save_sharded(directory, step, params, aux=aux, symbol=sym,
                     extra_meta=meta or {"epoch": 1, "num_update": step},
                     opt_state=opt)


def test_round_trip(tmp_path):
    params, aux, opt = _state(1)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    path = tck.save_sharded(tmp_path, 7, tparams, aux=aux,
                            symbol=tmodels.mlp(), opt_state=opt,
                            comm_state={"resid": np.arange(6, dtype=np.float32)},
                            extra_meta={"epoch": 2, "rng_state": {"seed": 3}})
    assert path == os.path.join(tmp_path, "7")
    assert tck.latest_step(tmp_path) == 7
    p, a, sym, meta, leaves, comm = tck.load_sharded(tmp_path, with_comm=True)
    for k in params:
        np.testing.assert_array_equal(p[k], params[k])
    np.testing.assert_array_equal(a["bn_moving_mean"], aux["bn_moving_mean"])
    for got, want in zip(leaves, opt):
        np.testing.assert_array_equal(got, want)
        assert got.shape == want.shape
    np.testing.assert_array_equal(comm["resid"], np.arange(6))
    assert meta == {"step": 7, "epoch": 2, "rng_state": {"seed": 3}}
    assert sym.tojson() == tmodels.mlp().tojson()
    assert not any(d.startswith(".tmp.") for d in os.listdir(tmp_path))


def test_manifest_and_metadata_match_jax(tmp_path):
    for pkg, name in ((jck, "jax"), (tck, "torch")):
        _save(pkg, tmp_path / name, 5, meta={"epoch": 1, "num_update": 5,
                                             "batches_done": 2})
    docs = {}
    for name in ("jax", "torch"):
        step_dir = tmp_path / name / "5"
        with open(step_dir / "manifest.json") as f:
            manifest = json.load(f)
        with open(step_dir / "metadata.json") as f:
            docs[name] = (manifest, json.load(f))
        # every file of the step but the manifest and the metadata
        on_disk = {os.path.relpath(os.path.join(d, n), step_dir)
                   for d, _, files in os.walk(step_dir) for n in files}
        assert set(manifest["files"]) == on_disk - {"manifest.json",
                                                    "metadata.json"}
        assert "symbol.json" in manifest["files"]
    (jm, jmeta), (tm, tmeta) = docs["jax"], docs["torch"]
    assert jmeta == tmeta == {"step": 5, "epoch": 1, "num_update": 5,
                              "batches_done": 2}
    assert set(jm) == set(tm) == {"format", "step", "files"}
    assert jm["format"] == tm["format"] == 1 and jm["step"] == tm["step"] == 5
    for entry in list(jm["files"].values()) + list(tm["files"].values()):
        assert set(entry) == {"size", "crc32"}
    assert jm["files"]["symbol.json"] == tm["files"]["symbol.json"]
    assert all(k.startswith("state/params/") or k.startswith("state/aux/")
               or k.startswith("state/opt/") or k == "symbol.json"
               for k in tm["files"])


def _flip(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


def _first_state_file(step_dir):
    found = []
    for d, _, files in os.walk(os.path.join(step_dir, "state")):
        found += [os.path.join(d, n) for n in files
                  if os.path.getsize(os.path.join(d, n)) > 0]
    return sorted(found)[0]


def _plant(root, pkg):
    """Steps 1-9 under ``root`` written by ``pkg``, then damaged: 9 lacks its
    metadata, 8 has a torn manifest, 7 a flipped byte in a state file (its
    size holds), 6 a truncated state file, 5 a legacy step (no manifest),
    4 torn metadata JSON; 1-3 are valid; plus a stray .tmp and .gc dir."""
    for step in range(1, 10):
        _save(pkg, root, step)
    d = lambda s: os.path.join(root, str(s))  # noqa: E731
    os.remove(os.path.join(d(9), "metadata.json"))
    with open(os.path.join(d(8), "manifest.json"), "r+b") as f:
        f.truncate(8)
    _flip(_first_state_file(d(7)))
    victim = _first_state_file(d(6))
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) - 1)
    os.remove(os.path.join(d(5), "manifest.json"))
    with open(os.path.join(d(4), "metadata.json"), "w") as f:
        f.write('{"step": 4')
    shutil.copytree(d(3), os.path.join(root, ".tmp.10"))
    shutil.copytree(d(2), os.path.join(root, ".gc.0"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("verify", ["crc", "size", "off"])
def test_validation_agrees_with_jax(tmp_path, writer, verify):
    root = str(tmp_path / "ck")
    _plant(root, jck if writer == "jax" else tck)
    for step in range(1, 10):
        assert tck.validate_step(root, step, verify=verify) == \
            jck.validate_step(root, step, verify=verify), step
    assert tck.latest_step(root, verify=verify) == \
        jck.latest_step(root, verify=verify)
    want = {"crc": 5, "size": 7, "off": 8}[verify]
    assert tck.latest_step(root, verify=verify) == want
    for k in (1, 2, 3):
        a, b = str(tmp_path / f"a{k}"), str(tmp_path / f"b{k}")
        shutil.copytree(root, a)
        shutil.copytree(root, b)
        assert tck.prune_steps(a, k, verify=verify) == \
            jck.prune_steps(b, k, verify=verify)
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def test_verify_mode_from_environment(tmp_path, monkeypatch):
    root = str(tmp_path)
    _save(tck, root, 1)
    _flip(_first_state_file(os.path.join(root, "1")))
    for mode, ok in (("crc", False), ("size", True), ("off", True)):
        monkeypatch.setenv("MXNET_TPU_CKPT_VERIFY", mode)
        assert tck.validate_step(root, 1) is ok
        assert jck.validate_step(root, 1) is ok
    monkeypatch.delenv("MXNET_TPU_CKPT_VERIFY")
    assert tck.validate_step(root, 1) is False  # crc by default
    assert tck.latest_step(root) is None


def test_jax_layout_load_raises_naming_it(tmp_path):
    _save(jck, tmp_path, 3)
    assert tck.latest_step(tmp_path) == 3  # manifests read the same
    with pytest.raises(MXNetError, match="OCDBT"):
        tck.load_sharded(tmp_path, 3)
    with pytest.raises(FileNotFoundError):
        tck.load_sharded(tmp_path / "empty")


def _carry_jax_to_torch(src, dst):
    params, aux, sym, meta, opt = jck.load_sharded(src)
    tck.save_sharded(dst, meta["step"], params, aux=aux,
                     symbol=mt.symbol.load_json(sym.tojson()),
                     extra_meta={k: v for k, v in meta.items()
                                 if k != "step"}, opt_state=opt)


def _carry_torch_to_jax(src, dst):
    params, aux, sym, meta, opt = tck.load_sharded(src)
    from mxnet_tpu import symbol as jsym

    jck.save_sharded(dst, meta["step"], params, aux=aux,
                     symbol=jsym.load_json(sym.tojson()),
                     extra_meta={k: v for k, v in meta.items()
                                 if k != "step"}, opt_state=opt)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_checkpoint_carried_across_bitwise(tmp_path, first):
    a, b, c = (str(tmp_path / n) for n in "abc")
    params, aux, opt = _state(4)
    if first == "jax":
        _save(jck, a, 4, seed=4)
        _carry_jax_to_torch(a, b)
        _carry_torch_to_jax(b, c)
        loaders = (tck.load_sharded(b), jck.load_sharded(c))
    else:
        _save(tck, a, 4, seed=4)
        _carry_torch_to_jax(a, b)
        _carry_jax_to_torch(b, c)
        loaders = (jck.load_sharded(b), tck.load_sharded(c))
    for p, a_, sym, meta, leaves in loaders:
        for k, v in params.items():
            np.testing.assert_array_equal(np.asarray(p[k]), v)
            assert np.asarray(p[k]).dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(a_["bn_moving_mean"]),
                                      aux["bn_moving_mean"])
        for got, want in zip(leaves, opt):
            np.testing.assert_array_equal(np.asarray(got), want)
        assert meta["step"] == 4 and meta["num_update"] == 4
        assert sym.tojson() == tmodels.mlp().tojson()


def test_atomic_write_and_sidecar_match_jax(tmp_path):
    payload = os.urandom(5000)

    def writer(tmp):
        with open(tmp, "wb") as f:
            f.write(payload)

    for pkg, name in ((jck, "j.bin"), (tck, "t.bin")):
        out = pkg.atomic_write(tmp_path / name, writer)
        assert out == os.path.abspath(tmp_path / name)
    with open(tmp_path / "j.bin.crc32") as f:
        j = json.load(f)
    with open(tmp_path / "t.bin.crc32") as f:
        t = json.load(f)
    assert j == t
    for name in ("j.bin", "t.bin"):
        assert tck.check_sidecar(tmp_path / name) is True
        assert jck.check_sidecar(tmp_path / name) is True
    _flip(tmp_path / "t.bin")
    assert tck.check_sidecar(tmp_path / "t.bin") is False
    assert jck.check_sidecar(tmp_path / "t.bin") is False
    (tmp_path / "bare").write_bytes(b"x")
    assert tck.check_sidecar(tmp_path / "bare") is None
    # model.py keeps one copy: its checkpoint pair goes through these
    from mxnet_tpu_torch import model as tmodel

    assert tmodel.atomic_write is tck.atomic_write
    assert tmodel.check_sidecar is tck.check_sidecar
