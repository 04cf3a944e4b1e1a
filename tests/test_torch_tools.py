"""The port's tools (``mxnet_tpu_torch/tools``) against the JAX package's
scripts under ``tools/``, on the CPU.

- ``caffe_converter``: each case of ``tests/test_caffe_converter.py`` on the
  same prototxt and blobs through both converters: the parsed messages
  equal, the symbol JSON graph-equal (equal as parsed JSON), the converted
  LeNet's forward within 1e-5 (f32 contractions on both sides) with the
  weights carried across, the missing-layer error alike; the checkpoint
  pair each converter's CLI writes loads in the other package.
- ``im2rec``: records byte-equal to the JAX script's on seeded PNG and JPEG
  sources, with and without ``--resize`` / ``--center-crop``, and once
  with PIL hidden, so that the native encoder writes; the sha256 that
  ``chip_smoke.py``'s phase tools_examples asserts; ``--make-list`` writes
  the same list; a BMP source through PIL, and without it an error naming
  PIL and the file.
- ``gen_op_docs`` and ``gen_r_ops``: regen-exact against the checked-in
  files; the same operator, alias and parameter rows as the JAX package's
  page apart from Deconvolution's ``adj`` and ``target_shape``; the same R
  function names and argument lists as ``R-package/R/mxtpu_generated.R``.
- ``run_mxlint``: exit 0 on the port's tree, exit 1 on a seeded file and 2
  on a missing path, as the JAX wrapper gives.
- The package data in ``pyproject.toml`` covers every source the port
  builds at first use.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tomllib

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import _imaging
from mxnet_tpu_torch.tools import gen_op_docs, gen_r_ops, im2rec, run_mxlint
from mxnet_tpu_torch.tools import caffe_converter as tcc
from mxnet_tpu_torch.tools.caffe_converter import convert_model as tcm
from mxnet_tpu_torch.tools.caffe_converter import prototxt as tproto

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
import chip_smoke as cs  # noqa: E402
import caffe_converter as jcc  # noqa: E402
from caffe_converter import convert_model as jcm  # noqa: E402
from caffe_converter import prototxt as jproto  # noqa: E402

mt.set_matmul_precision("highest")

V1_PROTOTXT = """
input: "data"
input_shape { dim: 1 dim: 4 dim: 8 dim: 8 }
layers { name: "sp" type: 22 bottom: "data" top: "a" top: "b" }
layers { name: "c1" type: 4 bottom: "a" top: "c1"
         convolution_param { num_output: 4 kernel_size: 1 } }
layers { name: "cat" type: 3 bottom: "c1" bottom: "b" top: "cat" }
layers { name: "loss" type: 21 bottom: "cat" top: "loss" }
"""


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- caffe_converter ----------------------------------------------------------

@pytest.mark.parametrize("text", [cs.CAFFE_LENET, V1_PROTOTXT])
def test_prototxt_parser_matches_jax(text):
    assert tproto.parse(text) == jproto.parse(text)
    msg = tproto.parse(cs.CAFFE_LENET)
    assert tproto.first(msg, "name") == "LeNet"
    assert msg["input_dim"] == [2, 1, 28, 28]


@pytest.mark.parametrize("text,shape", [(cs.CAFFE_LENET, (2, 1, 28, 28)),
                                        (V1_PROTOTXT, (1, 4, 8, 8))])
def test_proto_to_symbol_graph_equal(text, shape):
    """The LeNet case and the V1 layer types with Split and Concat: one
    graph, the same declared inputs and inferred shapes."""
    jsym, jshapes = jcc.proto_to_symbol(text)
    tsym, tshapes = tcc.proto_to_symbol(text)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert tshapes == jshapes == {"data": shape}
    assert tsym.infer_shape(data=shape) == jsym.infer_shape(data=shape)


def _blobs_npz(path):
    np.savez(path, **{f"{layer}/{i}": a
                      for layer, arrs in cs.caffe_blobs().items()
                      for i, a in enumerate(arrs)})
    return str(path)


def test_weight_conversion_and_forward_match_jax(tmp_path):
    npz = _blobs_npz(tmp_path / "blobs.npz")
    jsym, _ = jcc.proto_to_symbol(cs.CAFFE_LENET)
    tsym, _ = tcc.proto_to_symbol(cs.CAFFE_LENET)
    jargs = jcc.convert_weights(jcc.load_npz_blobs(npz), jsym)
    targs = tcc.convert_weights(tcc.load_npz_blobs(npz), tsym)
    assert set(targs) == set(jargs) == {"conv1_weight", "conv1_bias",
                                        "ip1_weight", "ip1_bias"}
    for k in jargs:
        assert targs[k].context == mt.cpu()
        np.testing.assert_array_equal(targs[k].asnumpy(), jargs[k].asnumpy())
    x = np.random.RandomState(1).rand(2, 1, 28, 28).astype(np.float32)
    jout = mx.FeedForward(jsym, ctx=mx.cpu(), arg_params=jargs).predict(x)
    tout = mt.FeedForward(tsym, ctx=mt.cpu(), arg_params=targs).predict(x)
    np.testing.assert_allclose(np.asarray(tout), np.asarray(jout), rtol=0,
                               atol=1e-5)


def test_convert_weights_missing_layer_raises_alike():
    missing = {"conv1": [np.zeros((8, 1, 5, 5), np.float32),
                         np.zeros(8, np.float32)]}
    for pkg in (jcc, tcc):
        symbol, _ = pkg.proto_to_symbol(cs.CAFFE_LENET)
        with pytest.raises(ValueError, match="ip1"):
            pkg.convert_weights(missing, symbol)


def test_caffemodel_reader_keeps_its_gated_import(tmp_path):
    """``load_caffemodel_blobs`` needs the caffe package in both: where it
    is absent, the import fails alike."""
    for load in (jcm.load_caffemodel_blobs, tcc.load_caffemodel_blobs):
        with pytest.raises(ImportError):
            load(str(tmp_path / "net.caffemodel"))


def test_checkpoint_pairs_load_in_the_other_package(tmp_path):
    """The port's CLI writes a pair the JAX package's FeedForward.load
    reads, and the JAX CLI's pair loads in the port: the same outputs."""
    proto = tmp_path / "lenet.prototxt"
    proto.write_text(cs.CAFFE_LENET)
    npz = _blobs_npz(tmp_path / "blobs.npz")
    tprefix, jprefix = str(tmp_path / "port"), str(tmp_path / "jax")
    with contextlib.redirect_stdout(io.StringIO()):
        tcm.main([str(proto), npz, tprefix])
        argv = sys.argv
        sys.argv = ["convert_model.py", str(proto), npz, jprefix]
        try:
            jcm.main()
        finally:
            sys.argv = argv
    x = np.random.RandomState(2).rand(2, 1, 28, 28).astype(np.float32)
    outs = [np.asarray(mx.FeedForward.load(tprefix, 0, ctx=mx.cpu())
                       .predict(x)),
            np.asarray(mt.FeedForward.load(jprefix, 0, ctx=mt.cpu())
                       .predict(x)),
            np.asarray(mt.FeedForward.load(tprefix, 0, ctx=mt.cpu())
                       .predict(x))]
    for out in outs[1:]:
        np.testing.assert_allclose(out, outs[0], rtol=0, atol=1e-5)
    assert outs[0].shape == (2, 10)


# -- im2rec -------------------------------------------------------------------

@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """The phase's 64 PNG sources and 12 JPEG ones (PIL's encoder), each
    under its own root with class folders."""
    from PIL import Image

    root = tmp_path_factory.mktemp("im2rec")
    cs.write_tool_images(root / "png")
    rng = np.random.default_rng(7)
    for i in range(12):
        h, w = (int(v) for v in rng.integers(30, 90, 2))
        path = root / "jpg" / f"c{i % 3}" / f"p{i:02d}.jpg"
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(cs.io_image(rng, h, w)).save(path, quality=90)
    return root


def _pack_both(jim, root, out, resize, crop):
    lst = str(out / "list.lst")
    jlst = str(out / "jax.lst")
    with contextlib.redirect_stdout(io.StringIO()):
        jim.make_list(str(root), jlst)
        im2rec.make_list(str(root), lst)
        jim.pack(jlst, str(root), str(out / "jax.rec"), resize=resize,
                 center_crop=crop)
        im2rec.pack(lst, str(root), str(out / "port.rec"), resize=resize,
                    center_crop=crop)
    return lst


@pytest.mark.parametrize("kind", ["png", "jpg"])
@pytest.mark.parametrize("resize,crop", [(0, False), (40, True), (40, False),
                                         (0, True)])
def test_im2rec_records_byte_equal_to_jax(sources, tmp_path, kind, resize,
                                          crop):
    jim = _jax_tool("im2rec")
    _pack_both(jim, sources / kind, tmp_path, resize, crop)
    assert (tmp_path / "list.lst").read_text() == \
        (tmp_path / "jax.lst").read_text()
    for suffix in (".rec", ".rec.idx"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"jax{suffix}").read_bytes(), suffix
    if kind == "png" and (resize, crop) == (cs.TOOLS_RESIZE, True):
        digest = hashlib.sha256((tmp_path / "jax.rec").read_bytes())
        assert digest.hexdigest() == cs.TOOLS_REC_SHA256


def test_im2rec_without_pil_writes_the_same_bytes(sources, tmp_path):
    """PIL hidden in a fresh process: the PNG sources through the port's
    codec, the JPEG records through the native encoder (PIL's bytes), the
    JPEG sources through the native decoder."""
    for kind, digest in (("png", cs.TOOLS_REC_SHA256), ("jpg", None)):
        out = tmp_path / kind
        out.mkdir()
        jim = _jax_tool("im2rec")
        lst = _pack_both(jim, sources / kind, out, cs.TOOLS_RESIZE, True)
        code = ("import sys, runpy\n"
                "sys.modules['PIL'] = None\n"
                f"sys.argv = ['im2rec', {lst!r}, {str(sources / kind)!r}, "
                f"{str(out / 'nopil.rec')!r}, '--resize', "
                f"'{cs.TOOLS_RESIZE}', '--center-crop']\n"
                "runpy.run_module('mxnet_tpu_torch.tools.im2rec', "
                "run_name='__main__')\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr[-2000:]
        got = (out / "nopil.rec").read_bytes()
        assert got == (out / "jax.rec").read_bytes(), kind
        if digest:
            assert hashlib.sha256(got).hexdigest() == digest


def test_im2rec_bmp_needs_pil(tmp_path, monkeypatch):
    from PIL import Image

    img = cs.io_image(np.random.default_rng(3), 20, 30)
    path = tmp_path / "a.bmp"
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(im2rec.read_image(str(path)), img)
    monkeypatch.setattr(_imaging, "_pil_image", lambda: None)
    with pytest.raises(MXNetError, match=r"a\.bmp.*PIL"):
        im2rec.read_image(str(path))


def test_im2rec_records_read_back(sources, tmp_path):
    """The packed shard through the port's ImageRecordIter: every record,
    every class."""
    jim = _jax_tool("im2rec")
    _pack_both(jim, sources / "png", tmp_path, cs.TOOLS_RESIZE, True)
    it = mt.io.ImageRecordIter(
        path_imgrec=str(tmp_path / "port.rec"),
        data_shape=(3, cs.TOOLS_RESIZE, cs.TOOLS_RESIZE), batch_size=16)
    n, labels = 0, set()
    for batch in it:
        n += batch.data[0].shape[0] - batch.pad
        labels |= set(np.asarray(batch.label[0]).ravel().tolist())
    assert n == cs.TOOLS_IMAGES and labels == {0.0, 1.0, 2.0, 3.0}


# -- the generators -----------------------------------------------------------

def test_op_docs_regen_exact():
    text, count = gen_op_docs.render()
    with open(gen_op_docs.OUT) as f:
        assert f.read() == text, \
            "stale: run python -m mxnet_tpu_torch.tools.gen_op_docs"
    assert count == 32


def _doc_rows(path):
    """{op: (aliases line, [(param, type, default), ...])} of an ops page."""
    out, cur = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r"## (\S+)$", line.strip())
            if m:
                cur = out[m.group(1)] = [None, []]
            elif line.startswith("Aliases:"):
                cur[0] = line.strip()
            elif line.startswith("| `"):
                cells = [c.strip() for c in
                         line.strip().strip("|").split(" | ")]
                cur[1].append(tuple(cells[:3]))
    return out


def test_op_docs_rows_match_the_jax_page():
    """Every operator, alias and parameter row (name, type, default) of
    doc/python/ops.md, apart from Deconvolution's two parameters beyond the
    JAX package's (ROADMAP C.2)."""
    jrows = _doc_rows(os.path.join(REPO, "doc", "python", "ops.md"))
    trows = _doc_rows(gen_op_docs.OUT)
    assert set(trows) == set(jrows)
    extra = {("`adj`", "`tuple of int`", "`(0, 0)`"),
             ("`target_shape`", "`tuple of int`", "`(0, 0)`")}
    for op in jrows:
        aliases, params = trows[op]
        if op == "Deconvolution":
            assert set(params) - set(jrows[op][1]) == extra
            params = [p for p in params if p not in extra]
        assert (aliases, params) == tuple(jrows[op]), op


def test_r_ops_regen_exact():
    body, n_ops, n_funcs = gen_r_ops.render()
    with open(gen_r_ops.OUT) as f:
        assert f.read() == body
    with contextlib.redirect_stdout(io.StringIO()) as out:
        gen_r_ops.main(["--check"])
    assert "current" in out.getvalue()
    assert (n_ops, n_funcs) == (27, 23)


def _r_functions(path):
    with open(path) as f:
        return re.findall(r"^(mx\.[\w.]+) <- function\(([^)]*)\)", f.read(),
                          re.M)


def test_r_ops_functions_match_the_jax_file():
    assert _r_functions(gen_r_ops.OUT) == _r_functions(
        os.path.join(REPO, "R-package", "R", "mxtpu_generated.R"))


# -- run_mxlint ---------------------------------------------------------------

def test_run_mxlint_exit_codes_match_the_jax_wrapper(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    missing = str(tmp_path / "nowhere")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for label, cmd in (
            ("port_tree", [sys.executable, "-m",
                           "mxnet_tpu_torch.tools.run_mxlint"]),
            ("port_bad", [sys.executable, "-m",
                          "mxnet_tpu_torch.tools.run_mxlint", str(bad)]),
            ("jax_bad", [sys.executable, os.path.join(REPO, "tools",
                                                       "run_mxlint.py"),
                         str(bad)])):
        runs[label] = subprocess.Popen(cmd, cwd=REPO, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    codes = {}
    for label, proc in runs.items():
        out, err = proc.communicate(timeout=180)
        codes[label] = (proc.returncode, out + err)
    assert codes["port_tree"][0] == 0, codes["port_tree"][1][-2000:]
    assert "0 error(s), 0 warning(s)" in codes["port_tree"][1]
    assert codes["port_bad"][0] == codes["jax_bad"][0] == 1, codes
    assert "MX100" in codes["port_bad"][1]
    with contextlib.redirect_stderr(io.StringIO()):
        assert run_mxlint.run([missing]) == 2


# -- packaging ----------------------------------------------------------------

def test_package_data_covers_every_source_built_at_first_use():
    """A wheel of the port holds what ``native`` and ``native.capi``
    compile (sources and the headers they include), the R binding's C
    side, the operator page and the generated R wrappers."""
    from pathlib import Path

    from mxnet_tpu_torch import native
    from mxnet_tpu_torch.native import capi
    from mxnet_tpu_torch.native import predict as tpredict

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "mxnet_tpu_torch"]
    pkg = Path(mt.__file__).resolve().parent
    built = {native.SOURCE, capi.SOURCE, capi.HEADER, tpredict.SOURCE}
    for src in list(built):
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            built.add((src.parent / inc).resolve())
    built |= set((pkg / "bindings" / "r").glob("*.cc"))
    built |= set((pkg / "bindings" / "r").glob("*.R"))
    built |= set((pkg / "csrc").glob("*.cu")) | {Path(gen_op_docs.OUT)}
    for path in sorted(built):
        rel = path.resolve().relative_to(pkg)
        assert any(rel.match(g) for g in globs), (str(rel), globs)


def test_the_tools_and_examples_import_no_jax_and_stay_out_of_the_package():
    """``import mxnet_tpu_torch`` imports none of the new modules, and
    importing every one of them brings in neither JAX nor the JAX
    package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import mxnet_tpu_torch as mt\n"
        "assert not [m for m in sys.modules if m.startswith(("
        "'mxnet_tpu_torch.tools', 'mxnet_tpu_torch.examples'))]\n"
        "for pkg in ('mxnet_tpu_torch.tools', 'mxnet_tpu_torch.examples'):\n"
        "    root = importlib.import_module(pkg)\n"
        "    for info in pkgutil.walk_packages(root.__path__, pkg + '.'):\n"
        "        importlib.import_module(info.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mxnet_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith("
        "'mxnet_tpu_torch.')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), \
        res.stderr[-2000:]
