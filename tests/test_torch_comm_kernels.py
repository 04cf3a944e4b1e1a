"""The port's gradient-compression codecs and comm kernels against the JAX
package's.

The JAX side runs compiled (``jax.jit``), its Pallas kernels in interpret
mode, as tests/test_pallas_kernels.py runs them on the CPU: the compiled
form is the reference (XLA turns ``/ 127.0`` into a multiply by the f32
reciprocal, fuses the int8 dequantize into the row sum as an FMA, and casts
a NaN to int8 as 0). The port runs on CPU tensors: the codecs of
``comm/compression.py`` and the plain version of each kernel.

Tolerance: none. Payloads, scales, round trips and sums are bitwise equal,
NaNs by position (the sign and payload of a NaN are the backend's), every
other value by its bits, the sign of zero included.
"""

import os
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import comm as jcomm
from mxnet_tpu.ops.pallas import comm_kernels as jck
from mxnet_tpu.ops.pallas import registry as jreg
from mxnet_tpu_torch import comm as tcomm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import comm_kernels as tck
from mxnet_tpu_torch.kernels import registry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_NAMES = ("quant_int8", "quant_twobit", "dequant_sum_int8",
                "dequant_sum_twobit", "dequant_int8", "dequant_twobit")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _specs(mode, chunk=256, threshold=0.5):
    return (jcomm.CompressionSpec(mode, threshold=threshold, chunk=chunk),
            tcomm.CompressionSpec(mode, threshold=threshold, chunk=chunk))


def _rows(shape, chunk, seed, specials=True, threshold=0.5):
    """Gaussian rows whose chunks differ in scale by up to e^±6, with a NaN
    chunk, an inf chunk, a -inf, an all-zero chunk, a -0.0 and values at
    exactly ±threshold."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    x = rng.randn(n).astype(np.float32)
    scales = np.exp(rng.uniform(-6, 6, -(-n // chunk))).astype(np.float32)
    x = (x * np.repeat(scales, chunk)[:n]).astype(np.float32)
    if specials and n >= 5 * chunk:
        x[1] = np.nan
        x[chunk + 2] = np.inf
        x[2 * chunk + 3] = -np.inf
        x[3 * chunk:4 * chunk] = 0.0
        x[4 * chunk + 1] = -0.0
        x[4 * chunk + 2] = np.float32(threshold)
        x[4 * chunk + 3] = -np.float32(threshold)
    return x.reshape(shape)


def _same(got, want, what=""):
    """Bitwise: NaN where the other has NaN, equal bits elsewhere."""
    got, want = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v) for v in (got, want))
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        nan_g, nan_w = np.isnan(got), np.isnan(want)
        assert (nan_g == nan_w).all(), f"{what}: NaN positions differ"
        ints = {2: np.uint16, 4: np.uint32, 8: np.uint64}[
            got.dtype.itemsize]
        bits_g = got.view(ints)[~nan_g]
        bits_w = want.view(ints)[~nan_w]
        bad = np.flatnonzero(bits_g != bits_w)
        assert bad.size == 0, (f"{what}: {bad.size} values differ, first "
                               f"{got[~nan_g][bad[:3]]} vs "
                               f"{want[~nan_w][bad[:3]]}")
    else:
        assert np.array_equal(got, want), what


# --------------------------------------------------------------------------
# the codecs against the jitted JAX codecs
# --------------------------------------------------------------------------

CODEC_CASES = [
    ("int8", (8, 2048), 256), ("int8", (3, 96), 4), ("int8", (64,), 4),
    ("int8", (2, 1200), 12), ("int8", (4, 2560), 512),
    ("twobit", (8, 2048), 256), ("twobit", (64,), 4), ("twobit", (5, 36), 4),
    ("bf16", (4, 1024), 256), ("none", (4, 1024), 256),
]


@pytest.mark.parametrize("mode,shape,chunk", CODEC_CASES)
def test_codec_matches_jax_jitted(mode, shape, chunk):
    js, ts = _specs(mode, chunk, threshold=0.75)
    x = _rows(shape, chunk, seed=len(shape) + shape[-1], threshold=0.75)

    @jax.jit
    def ref(v):
        p = jcomm.encode(js, v)
        return p, jcomm.decode(js, p)

    jp, jdq = ref(x)
    tp = tcomm.encode(ts, torch.from_numpy(x))
    tdq = tcomm.decode(ts, tp)
    assert set(tp) == set(jp)
    for k in jp:
        if mode == "bf16":
            # numpy has no bfloat16 of its own: compare the exact f32 values
            # (a NaN's bits are the backend's: torch writes 0xffff)
            assert tp[k].dtype == torch.bfloat16
            _same(tp[k].float(), np.asarray(jp[k]).astype(np.float32),
                  "bf16 payload")
        else:
            _same(tp[k], jp[k], f"{mode} payload {k}")
    _same(tdq, jdq, f"{mode} decode")
    assert tcomm.payload_bytes_of(tp) == jcomm.payload_bytes_of(jp)


def test_int8_scale_is_the_reciprocal_multiply():
    """The compiled reference multiplies max|x| by fl(1/127); a true divide
    differs in about 6% of chunks (the port would then be off by an ulp)."""
    rng = np.random.RandomState(3)
    x = rng.randn(256 * 512).astype(np.float32)
    js, ts = _specs("int8", 256)
    scale = tcomm.encode(ts, torch.from_numpy(x))["scale"].numpy()
    _same(scale, jax.jit(lambda v: jcomm.encode(js, v)["scale"])(x))
    amax = np.abs(x.reshape(-1, 256)).max(1)
    assert (scale == amax * np.float32(1 / 127)).all()
    assert (scale != amax / np.float32(127)).any()


def test_nan_and_inf_chunks_stay_visible():
    """A NaN chunk keeps a NaN scale and decodes to NaN; an inf chunk has
    an inf scale and decodes to NaN (inf/inf and 0*inf): non-finite
    gradients stay visible to a guard downstream, on both packages."""
    js, ts = _specs("int8", 4)
    x = np.array([1, np.nan, 2, 3, np.inf, 1, -2, .5, 1, 2, 3, 4], np.float32)
    tp = tcomm.encode(ts, torch.from_numpy(x))
    jp = jax.jit(lambda v: jcomm.encode(js, v))(x)
    _same(tp["scale"], jp["scale"])
    _same(tp["q"], jp["q"])
    assert np.isnan(tp["scale"][0].item()) and np.isinf(tp["scale"][1].item())
    assert (tp["q"][:8] == 0).all()   # NaN quotients cast to 0, as XLA does
    dq = tcomm.decode(ts, tp).numpy()
    assert np.isnan(dq[:8]).all() and np.isfinite(dq[8:]).all()


def test_twobit_code_3_decodes_to_zero():
    """Code 3 never comes out of encode; a payload that holds it decodes to
    0 (neither +t nor -t), in the codec, the plain kernels and JAX."""
    js, ts = _specs("twobit", threshold=0.25)
    q = np.array([[0b11100100, 0b11111111, 0b00011011],
                  [0b01010101, 0b10101010, 0b11001001]], np.uint8)

    @jax.jit
    def ref(p):
        return (jcomm.decode(js, {"q": p}),
                jck.fused_dequant(js, {"q": p}),
                jck.fused_dequant_sum(js, {"q": p}))

    dec, kdec, ksum = ref(q)
    tq = torch.from_numpy(q)
    _same(tcomm.decode(ts, {"q": tq}), dec)
    _same(tck.fused_dequant(ts, {"q": tq}), kdec)
    _same(tck.fused_dequant_sum(ts, {"q": tq}), ksum)
    assert tcomm.decode(ts, {"q": tq})[0, 3].item() == 0.0


@pytest.mark.parametrize("value,mode", [
    (None, None), ("int8", "int8"), ("2bit", "twobit"), (True, "int8"),
    (False, None), ("fp32", None), ({"type": "2bit", "threshold": 0.3},
                                    "twobit")])
def test_compression_spec_resolve_matches_jax(value, mode, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_GRAD_COMPRESSION", raising=False)
    got = tcomm.CompressionSpec.resolve(value)
    want = jcomm.CompressionSpec.resolve(value)
    assert (got is None) == (want is None) == (mode is None)
    if mode is not None:
        assert got.key() == want.key() and got.mode == mode
        assert got.error_feedback == want.error_feedback


@pytest.mark.parametrize("env,mode", [("", None), ("1", "int8"),
                                      ("bf16", "bf16"), ("off", None)])
def test_compression_env_gate(env, mode, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESSION", env)
    got = tcomm.CompressionSpec.resolve(None)
    assert (got.mode if got else None) == mode
    want = jcomm.CompressionSpec.resolve(None)
    assert (want.mode if want else None) == mode


def test_compression_spec_rejects_what_jax_rejects():
    for kw in (dict(mode="int4"), dict(mode="int8", chunk=6),
               dict(mode="twobit", threshold=0.0)):
        with pytest.raises(MXNetError):
            tcomm.CompressionSpec(**kw)
    _, ts = _specs("int8", 8)
    with pytest.raises(MXNetError, match="multiple of chunk"):
        tcomm.encode(ts, torch.zeros(12))


@pytest.mark.parametrize("mode,n,chunk", [
    ("none", 1000, 256), ("bf16", 1000, 256), ("int8", 2048, 256),
    ("int8", 64, 4), ("twobit", 2048, 256)])
def test_payload_nbytes_matches_jax_and_the_payload(mode, n, chunk):
    js, ts = _specs(mode, chunk)
    assert tcomm.payload_nbytes(ts, n) == jcomm.payload_nbytes(js, n)
    assert tcomm.quantization_unit(ts) == jcomm.quantization_unit(js)
    payload = tcomm.encode(ts, torch.zeros(n))
    assert tcomm.payload_bytes_of(payload) == tcomm.payload_nbytes(ts, n)


# --------------------------------------------------------------------------
# the plain kernels against the JAX Pallas kernels (interpret, jitted)
# --------------------------------------------------------------------------

QUANT_CASES = [
    # (mode, shape, chunk, block_elems): the JAX test's (8, 2048) in 512
    # blocks, the default block, a 1-D row with chunk 4, odd chunks
    ("int8", (8, 2048), 256, 512), ("int8", (2, 4096), 256, None),
    ("int8", (64,), 4, None), ("int8", (3, 1200), 12, 120),
    ("twobit", (8, 2048), 256, 512), ("twobit", (2, 4096), 256, None),
    ("twobit", (64,), 4, None), ("twobit", (3, 36), 4, 8),
]


@pytest.mark.parametrize("want_dq", [True, False])
@pytest.mark.parametrize("mode,shape,chunk,block", QUANT_CASES)
def test_plain_quantize_matches_jax_kernel(mode, shape, chunk, block,
                                           want_dq):
    js, ts = _specs(mode, chunk)
    x = _rows(shape, chunk, seed=7 + shape[-1])
    jp, jdq = jax.jit(lambda v: jck.fused_quantize(
        js, v, want_dequant=want_dq, block_elems=block))(x)
    tp, tdq = tck.fused_quantize(ts, torch.from_numpy(x),
                                 want_dequant=want_dq, block_elems=block)
    assert set(tp) == set(jp)
    for k in jp:
        _same(tp[k], jp[k], f"{mode} {k}")
    if want_dq:
        _same(tdq, jdq, f"{mode} dq")
    else:
        assert tdq is None and jdq is None
    # the kernel payload is the codec's, as in the JAX package
    codec = tcomm.encode(ts, torch.from_numpy(x))
    for k in codec:
        _same(tp[k], codec[k].numpy(), f"{mode} {k} vs codec")


@pytest.mark.parametrize("shape,chunk,block,rounding", [
    ((8192,), 256, None, "fma"), ((64,), 4, None, "fma"),
    ((4096,), 256, 512, "sub"), ((1200,), 12, 120, "sub"),
    ((2, 4096), 256, None, "sub")])
def test_plain_error_matches_jax_compiled(shape, chunk, block, rounding):
    """``want_error``: ``rows - dq`` as the jitted JAX kernel path computes
    its stage-2 error ``shard - dq2``, bitwise, NaN and inf chunks included.
    XLA contracts the interpreted kernel's product into the subtraction (one
    rounding) only when the kernel's grid is one step: one row in one block.
    Over more steps the product is rounded first. The two forms differ in
    most values, so each case tells them apart."""
    js, ts = _specs("int8", chunk)
    x = _rows(shape, chunk, seed=shape[-1] + chunk)

    @jax.jit
    def ref(v):
        p, dq = jck.fused_quantize(js, v, want_dequant=True,
                                   block_elems=block)
        return p, v - dq

    jp, jerr = ref(x)
    tp, tdq, terr = tck.fused_quantize(ts, torch.from_numpy(x),
                                       want_error=True, block_elems=block)
    assert tdq is None and terr.shape == shape
    for k in jp:
        _same(tp[k], jp[k], k)
    _same(terr, jerr, "error")
    rows = torch.from_numpy(x.reshape(-1, shape[-1]))
    other = tck.quant_int8_plain(
        rows, chunk, False, {"fma": "sub", "sub": "fma"}[rounding])[3]
    finite = torch.isfinite(other)
    assert (other[finite] != terr.reshape(other.shape)[finite]).float() \
        .mean() > 0.1


@pytest.mark.parametrize("mode", ["int8", "twobit"])
def test_want_error_is_int8s(mode):
    """``want_error`` of each codec (the name is from when it was int8's
    alone): the error beside the round trip is ``x - dq``; an unknown int8
    rounding raises, and twobit, whose error has one rounding, refuses any
    ``error_rounding``."""
    chunk = 4
    _, ts = _specs(mode, chunk)
    x = torch.from_numpy(_rows((2, 16), chunk, seed=3, specials=False))
    p, dq, err = tck.fused_quantize(ts, x, want_dequant=True, want_error=True)
    assert err.shape == dq.shape == x.shape
    _same(err, (x - dq).numpy(), "two rows: the rounded product")
    if mode == "int8":
        with pytest.raises(ValueError, match="err must be"):
            tck.quant_int8(x, chunk, err="exact")
    else:
        for rounding in ("sub", "fma"):
            with pytest.raises(MXNetError, match="error_rounding"):
                tck.fused_quantize(ts, x, want_error=True,
                                   error_rounding=rounding)
        # the error alone, without the round trip
        _, none, alone = tck.fused_quantize(ts, x, want_error=True)
        assert none is None
        _same(alone, err.numpy(), "without want_dequant")


def _twobit_rows(shape, seed, threshold):
    """Gaussian rows of scale ``threshold`` with, from element 0 on, NaN,
    +-inf, +-0, exactly +-t, and the floats just inside and outside +-t."""
    rng = np.random.RandomState(seed)
    n = int(np.prod(shape))
    x = (rng.randn(n) * threshold).astype(np.float32)
    t = np.float32(threshold)
    specials = [np.nan, np.inf, -np.inf, 0.0, -0.0, t, -t,
                np.nextafter(t, np.float32(0)), np.nextafter(t, np.float32(9)),
                np.nextafter(-t, np.float32(0)),
                np.nextafter(-t, np.float32(-9))]
    for i, v in enumerate(specials[:n]):
        x[(5 * i) % n] = v
    return x.reshape(shape)


@pytest.mark.parametrize("shape", [(2, 4096), (8, 2048), (64,), (5, 36)])
def test_plain_twobit_error_matches_jax(shape):
    """The twobit stage-1 error (``want_error``, and ``quant_twobit_plain``)
    is bitwise the JAX package's jitted ``rows - dq1``, with ``dq1`` from
    its Pallas kernel in interpret mode, at exactly +-t, +-0, NaN and
    +-inf too."""
    js, ts = _specs("twobit", threshold=0.75)
    x = _twobit_rows(shape, seed=shape[-1], threshold=0.75)

    @jax.jit
    def ref(v):
        p, dq1 = jck.fused_quantize(js, v, want_dequant=True)
        return p, v - dq1

    jp, jerr = ref(x)
    tp, tdq, terr = tck.fused_quantize(ts, torch.from_numpy(x),
                                       want_error=True)
    assert tdq is None
    _same(tp["q"], jp["q"], "q")
    _same(terr, jerr, "error")
    rows = torch.from_numpy(x.reshape(-1, shape[-1]))
    q, dq, err = tck.quant_twobit_plain(rows, 0.75, True, True)
    _same(err, np.asarray(jerr).reshape(rows.shape), "plain error")
    assert np.isnan(err.numpy().reshape(-1)[0])
    assert np.isinf(err.numpy().reshape(-1)[5])


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("mode,chunk", [("int8", 256), ("int8", 4),
                                        ("twobit", 256)])
def test_plain_dequant_sum_matches_jax_kernel(mode, chunk, rows):
    """The FMA sums, rows in order: bitwise at R = 1, 2, 4 and 8."""
    js, ts = _specs(mode, chunk)
    # one scale range for all rows, so the rows' products overlap and the
    # order and rounding of the sum matter
    x = _rows((rows, 64 * chunk), chunk, seed=rows, specials=False)
    jp = jax.jit(lambda v: jcomm.encode(js, v))(x)
    jsum = jax.jit(lambda p: jck.fused_dequant_sum(js, p,
                                                   block_elems=512))(jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    _same(tck.fused_dequant_sum(ts, tp, block_elems=512), jsum)


def test_plain_dequant_sum_rounds_once():
    """The int8 sum is fma(q, scale, acc), not a rounded product added: on
    these rows the two forms differ in most columns, and the port takes the
    kernel's."""
    js, ts = _specs("int8", 256)
    x = _rows((4, 256 * 32), 256, seed=11, specials=False)
    tp = tcomm.encode(ts, torch.from_numpy(x))
    fused = tck.fused_dequant_sum(ts, tp)
    rounded = tcomm.decode(ts, tp)
    seq = torch.zeros_like(fused)
    for r in range(4):
        seq = seq + rounded[r]
    assert (fused != seq).float().mean() > 0.1
    jsum = jax.jit(lambda v: jck.fused_dequant_sum(js, jcomm.encode(js, v)))(x)
    _same(fused, jsum)


@pytest.mark.parametrize("mode,shape,chunk", [
    ("int8", (8, 2048), 256), ("int8", (64,), 4), ("twobit", (8, 2048), 256),
    ("twobit", (64,), 4)])
def test_plain_dequant_matches_jax_kernel(mode, shape, chunk):
    js, ts = _specs(mode, chunk)
    x = _rows(shape, chunk, seed=5)
    jp = jax.jit(lambda v: jcomm.encode(js, v))(x)
    jdq = jax.jit(lambda p: jck.fused_dequant(js, p, block_elems=512))(jp)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    tdq = tck.fused_dequant(ts, tp, block_elems=512)
    _same(tdq, jdq)
    _same(tdq, tcomm.decode(ts, tp).numpy(), "vs codec decode")


def _nearest_f32(exact: Fraction) -> np.float32:
    """The float32 nearest to ``exact``, ties to even."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - exact),
                                     int(c.view(np.uint32)) & 1))


def test_fma_f32_is_correctly_rounded():
    """fma_f32 against exact rational arithmetic, on products and sums far
    apart in scale, where a float64 sum rounded again to float32 would
    round twice."""
    rng = np.random.RandomState(0)
    q = rng.randint(-127, 128, 4000).astype(np.int8)
    scale = np.exp(rng.uniform(-40, 40, 4000)).astype(np.float32)
    acc = (rng.randn(4000) * np.exp(rng.uniform(-40, 40, 4000))).astype(
        np.float32)
    # products that are exact f32 ties plus a tiny accumulator
    scale[:50] = np.float32(1 + 2 ** -23)
    q[:50] = 3
    acc[:50] = np.float32(2 ** -60)
    got = tck.fma_f32(torch.from_numpy(q).double()
                      * torch.from_numpy(scale).double(),
                      torch.from_numpy(acc)).numpy()
    for i in range(4000):
        want = _nearest_f32(Fraction(int(q[i])) * Fraction(float(scale[i]))
                            + Fraction(float(acc[i])))
        assert got[i] == want, (i, q[i], scale[i], acc[i], got[i], want)


def test_pick_block_matches_jax():
    assert tck.pick_block(2048, 256, 512) == 512
    assert tck.pick_block(2048, 256, 700) == 512
    assert tck.pick_block(1280, 256, 512) == 256
    assert tck.pick_block(12, 4, 8) == 4
    for length, unit, cap in ((2048, 4, None), (4096 * 3, 12, 1000),
                              (1 << 20, 256, 65536), (96, 4, 7)):
        assert tck.pick_block(length, unit, cap) == \
            jck.pick_block(length, unit, cap)
    with pytest.raises(MXNetError):
        tck.pick_block(10, 4)
    _, ts = _specs("int8", 8)
    with pytest.raises(MXNetError, match="not a multiple"):
        tck.fused_quantize(ts, torch.zeros(2, 12))


def test_block_elems_changes_no_result():
    _, ts = _specs("int8", 4)
    x = torch.from_numpy(_rows((4, 96), 4, seed=2))
    base = tck.fused_quantize(ts, x, want_dequant=True)
    for block in (4, 8, 24, 96, None):
        p, dq = tck.fused_quantize(ts, x, want_dequant=True,
                                   block_elems=block)
        assert torch.equal(p["q"], base[0]["q"])
        _same(dq, base[1].numpy())


def test_none_and_bf16_have_no_kernel():
    for mode in ("none", "bf16"):
        _, ts = _specs(mode)
        for fn in (lambda: tck.fused_quantize(ts, torch.zeros(2, 8)),
                   lambda: tck.fused_dequant_sum(ts, {"q": torch.zeros(2, 8)}),
                   lambda: tck.fused_dequant(ts, {"q": torch.zeros(2, 8)})):
            with pytest.raises(MXNetError, match="no kernel"):
                fn()


def test_wrappers_check_their_operands():
    with pytest.raises(ValueError, match="float32"):
        tck.quant_int8(torch.zeros(2, 8, dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tck.quant_int8(torch.zeros(2, 10), 4)
    with pytest.raises(ValueError, match="contiguous"):
        tck.dequant_int8(torch.zeros(8, 2, dtype=torch.int8).t(),
                         torch.zeros(2, 2), 4)
    with pytest.raises(ValueError, match="scale is"):
        tck.dequant_sum_int8(torch.zeros(2, 8, dtype=torch.int8),
                             torch.zeros(2, 3), 4)
    with pytest.raises(ValueError, match="uint8"):
        tck.dequant_twobit(torch.zeros(2, 8, dtype=torch.int8), 0.5)


def test_cpu_tensors_take_the_plain_version():
    before = [k.launches for k in tck.KERNELS]
    _, ts = _specs("int8", 4)
    p, _ = tck.fused_quantize(ts, torch.ones(2, 8), want_dequant=True)
    tck.fused_dequant_sum(ts, p)
    tck.fused_dequant(ts, p)
    assert [k.launches for k in tck.KERNELS] == before


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

def _jax_cost(name, ins, outs):
    spec = jreg.get_kernel(name)
    avals = lambda ts: [jax.ShapeDtypeStruct(tuple(t.shape),  # noqa: E731
                                             {torch.float32: jnp.float32,
                                              torch.int8: jnp.int8,
                                              torch.uint8: jnp.uint8}[t.dtype])
                        for t in ts]
    return spec.cost_fn(avals(ins), avals(outs))


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_registry_entries_match_jax(name):
    spec = registry.get_kernel(name)
    assert spec.source == "mxnet_tpu_torch/csrc/comm_kernels.cu"
    path, line = spec.replaces.rsplit(":", 1)
    assert path == "mxnet_tpu/ops/pallas/comm_kernels.py"
    with open(os.path.join(REPO, path)) as f:
        src = f.read().splitlines()
    assert "pl.pallas_call" in src[int(line) - 1]
    assert f'name="{name}"' in "\n".join(src[int(line):int(line) + 20])
    R, L, chunk = 2, 4096, 256
    x = torch.zeros(R, L)
    q8, s8 = torch.zeros(R, L, dtype=torch.int8), torch.zeros(R, L // chunk)
    q2 = torch.zeros(R, L // 4, dtype=torch.uint8)
    ins, outs = {
        "quant_int8": ([x], [q8, s8, x]),
        "quant_twobit": ([x], [q2, x]),
        "dequant_sum_int8": ([q8, s8], [torch.zeros(L)]),
        "dequant_sum_twobit": ([q2], [torch.zeros(L)]),
        "dequant_int8": ([q8, s8], [x]),
        "dequant_twobit": ([q2], [x]),
    }[name]
    cost = spec.cost(ins, outs)
    want = _jax_cost(name, ins, outs)
    assert cost.flops == want.flops
    assert cost.bytes == want.bytes == registry.KernelCost.io_bytes(ins, outs)
    seconds, bound_by = cost.bound()
    assert bound_by == "bytes" and seconds == cost.bytes / 3.35e12


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version, bitwise
# --------------------------------------------------------------------------

# (2, 1 << 19): one 4 MB bucket of the overlapped exchange over two ranks
CARD_CASES = [((2, 1 << 20), 256), ((2, 1 << 19), 256), ((4, 1 << 16), 256),
              ((8, 2048), 256), ((3, 1200), 12), ((64,), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", CARD_CASES)
def test_kernels_match_plain_on_card(cuda_device, shape, chunk):
    for mode in ("int8", "twobit"):
        _, ts = _specs(mode, chunk)
        x = torch.from_numpy(_rows(shape, chunk, seed=1)).to(cuda_device)
        counts = [k.launches for k in tck.KERNELS]
        kp, kdq = tck.fused_quantize(ts, x, want_dequant=True)
        torch.cuda.synchronize()
        assert [k.launches for k in tck.KERNELS] != counts
        pp, pdq = tck.fused_quantize(ts, x.cpu(), want_dequant=True)
        for k in pp:
            _same(kp[k].cpu(), pp[k].numpy(), f"{mode} {k}")
        _same(kdq.cpu(), pdq.numpy(), f"{mode} dq")
        if mode == "twobit":
            # the stage-1 error the exchange takes from the kernel
            rows = x if x.dim() == 2 else x[None]
            kerr = tck.quant_twobit(rows, ts.threshold, want_err=True)[2]
            perr = tck.quant_twobit(rows.cpu(), ts.threshold,
                                    want_err=True)[2]
            _same(kerr.cpu(), perr.numpy(), "twobit err")
        if mode == "int8":
            # the error in both roundings
            rows = x if x.dim() == 2 else x[None]
            for rounding in ("fma", "sub"):
                kerr = tck.quant_int8(rows, chunk, err=rounding)[3]
                perr = tck.quant_int8(rows.cpu(), chunk, err=rounding)[3]
                _same(kerr.cpu(), perr.numpy(), f"int8 err {rounding}")
        payload = {k: (v if v.dim() == 2 else v[None]) for k, v in kp.items()}
        ksum = tck.fused_dequant_sum(ts, payload)
        kdec = tck.fused_dequant(ts, payload)
        cpu_payload = {k: v.cpu() for k, v in payload.items()}
        _same(ksum.cpu(), tck.fused_dequant_sum(ts, cpu_payload).numpy())
        _same(kdec.cpu(), tck.fused_dequant(ts, cpu_payload).numpy())


@pytest.mark.cuda
def test_kernels_repeat_bitwise_on_card(cuda_device):
    _, ts = _specs("int8")
    x = torch.from_numpy(_rows((4, 1 << 16), 256, seed=2)).to(cuda_device)
    a = tck.fused_quantize(ts, x, want_dequant=True)
    b = tck.fused_quantize(ts, x, want_dequant=True)
    for k in a[0]:
        _same(a[0][k], b[0][k], k)
    _same(a[1], b[1], "dq")
    for rounding in ("fma", "sub"):
        _same(tck.quant_int8(x, 256, err=rounding)[3],
              tck.quant_int8(x, 256, err=rounding)[3], rounding)
    _same(tck.fused_dequant_sum(ts, a[0]), tck.fused_dequant_sum(ts, b[0]),
          "sum")


# --------------------------------------------------------------------------
# dequant_sum_int8's load paths: 16 bytes a row, one char4, or four bytes
# --------------------------------------------------------------------------

def _offset_codes(rows, length, offset, seed, device="cpu"):
    """(rows, length) int8 codes starting ``offset`` bytes past a 16-byte
    boundary of a fresh buffer on ``device``."""
    rng = np.random.RandomState(seed)
    buf = torch.empty(rows * length + 48, dtype=torch.int8, device=device)
    start = (-buf.data_ptr()) % 16 + offset
    q = buf[start:start + rows * length].view(rows, length)
    q.copy_(torch.from_numpy(rng.randint(-127, 128, (rows, length))
                             .astype(np.int8)))
    return q


@pytest.mark.parametrize("length,offset,want", [
    (4096, 0, 16), (4096, 16, 16), (4096, 4, 4), (4100, 0, 4), (20, 0, 4),
    (4096, 1, 1), (20, 3, 1)])
def test_dequant_sum_int8_picks_its_load_path(length, offset, want):
    q = _offset_codes(2, length, offset, seed=0)
    assert q.is_contiguous() and q.data_ptr() % 16 == offset % 16
    assert tck.dequant_sum_int8_load_bytes(q) == want


DQSUM_CARD_CASES = [(r, length, chunk, offset)
                    for r in (1, 2, 8)
                    for length, chunk in ((1 << 16, 256), (4100, 20),
                                          (20, 4), (4096, 4))
                    for offset in (0, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,length,chunk,offset", DQSUM_CARD_CASES)
def test_dequant_sum_int8_paths_match_plain_on_card(cuda_device, rows, length,
                                                    chunk, offset):
    # codes from a buffer offset by 0, 4 or 1 bytes (16-byte, char4 and
    # byte loads), rows whose length is or is not a multiple of 16, chunk
    # down to 4, scales with a NaN and an inf chunk
    qc = _offset_codes(rows, length, offset, seed=rows + length,
                       device=cuda_device)
    rng = np.random.RandomState(length)
    scale = np.exp(rng.uniform(-6, 6, (rows, length // chunk))).astype(
        np.float32)
    scale[0, 0] = np.nan
    scale[-1, -1] = np.inf
    sc = torch.from_numpy(scale).to(cuda_device)
    before = tck.dequant_sum_int8.launches
    got = tck.dequant_sum_int8(qc, sc, chunk)
    again = tck.dequant_sum_int8(qc, sc, chunk)
    torch.cuda.synchronize()
    assert tck.dequant_sum_int8.launches == before + 2
    want = tck.dequant_sum_int8_plain(qc.cpu(), torch.from_numpy(scale),
                                      chunk)
    _same(got.cpu(), want.numpy(), f"path {tck.dequant_sum_int8_load_bytes(qc)}")
    _same(got, again, "repeat")


# --------------------------------------------------------------------------
# quant_int8's two forms and dequant_int8's load paths
# --------------------------------------------------------------------------

def _offset_rows(x, offset_elems, device="cpu"):
    """``x`` copied into a view of a fresh flat f32 buffer that starts
    ``offset_elems`` floats past a 16-byte boundary, as a bucket view into
    the flat gradient buffer may start."""
    x = torch.as_tensor(x)
    buf = torch.empty(x.numel() + 8, dtype=torch.float32, device=device)
    start = (-buf.data_ptr() // 4) % 4 + offset_elems
    view = buf[start:start + x.numel()].view(x.shape)
    view.copy_(x)
    return view


# (shape, chunk, offset in floats): one 4 MB bucket of the overlapped
# exchange over two ranks, the same bucket 4 bytes off 16-byte alignment,
# the odd chunk 12 off alignment, and the largest chunk of the first form
INT8_FORM_CASES = [((2, 1 << 19), 256, 0), ((2, 1 << 19), 256, 1),
                   ((3, 1200), 12, 1), ((2, 4096), 1024, 0)]


@pytest.mark.parametrize("shape,chunk,offset", INT8_FORM_CASES)
def test_plain_int8_matches_jax_kernel_at_bucket_and_views(shape, chunk,
                                                           offset):
    """The plain ``quant_int8`` (codes, scales, round trip and both errors)
    and ``dequant_int8`` against the JAX package's Pallas kernels in
    interpret mode, jitted, on the same rows, NaN and inf chunks included,
    with the port's rows at the view the bucket would be."""
    js, ts = _specs("int8", chunk)
    x = _rows(shape, chunk, seed=shape[-1] + chunk + offset)

    @jax.jit
    def ref(v):
        p, dq = jck.fused_quantize(js, v, want_dequant=True)
        return p, dq, v - dq, jck.fused_dequant(js, p)

    # more than one grid step: JAX's error is the rounded product
    # subtracted, the port's "sub"
    jp, jdq, jerr, jdec = ref(x)
    rows = _offset_rows(x, offset)
    assert rows.data_ptr() % 16 == 4 * offset
    assert tck.quant_int8_form(rows, chunk) == \
        ("chunked" if offset == 0 and chunk % 128 == 0 else "general")
    q, scale, dq, _ = tck.quant_int8(rows, chunk, want_dq=True)
    _same(q, jp["q"], "q")
    _same(scale, jp["scale"], "scale")
    _same(dq, jdq, "dq")
    _same(tck.quant_int8(rows, chunk, err="sub")[3], jerr, "err sub")
    _same(tck.quant_int8(rows, chunk, err="fma")[3],
          tck.quant_int8_plain(torch.from_numpy(x.reshape(-1, shape[-1])),
                               chunk, False, "fma")[3].numpy(), "err fma")
    codes = torch.from_numpy(np.array(jp["q"]))
    qview = _offset_codes(*shape, 4 * offset, seed=0)
    qview.copy_(codes)
    _same(tck.dequant_int8(qview, scale, chunk), jdec, "dequant_int8")


@pytest.mark.parametrize("chunk,offset,want", [
    (256, 0, "chunked"), (128, 0, "chunked"), (1024, 0, "chunked"),
    (640, 0, "chunked"), (256, 1, "general"), (256, 2, "general"),
    (64, 0, "general"), (12, 0, "general"), (1152, 0, "general")])
def test_quant_int8_picks_its_form(chunk, offset, want):
    rows = _offset_rows(torch.zeros(2, 2304), offset)
    assert tck.quant_int8_form(rows, chunk) == want


@pytest.mark.parametrize("shape,offset,want", [
    ((2, 4096), 0, 16), ((2, 4096), 16, 16), ((3, 1200), 0, 16),
    ((1, 20), 0, 4), ((2, 4096), 4, 4), ((2, 4096), 1, 1), ((5, 12), 3, 1)])
def test_dequant_int8_picks_its_load_path(shape, offset, want):
    """16 bytes where the flat codes are a multiple of 16 and aligned (a
    row length that is not a multiple of 16 is fine: the kernel runs over
    the flat codes), else a char4 or single bytes."""
    q = _offset_codes(*shape, offset, seed=0)
    assert tck.dequant_int8_load_bytes(q) == want


def test_fused_quantize_error_rounding_overrides_the_grid_rule():
    """``error_rounding`` sets the error's rounding whatever the rows: the
    stage-1 error of the exchange is ``rows - dq1`` also for one row in one
    block, where the default takes the contracted form."""
    _, ts = _specs("int8", 4)
    x = torch.from_numpy(_rows((1, 64), 4, seed=9, specials=False))
    p, dq = tck.fused_quantize(ts, x, want_dequant=True)
    for rounding, want in (("sub", x - dq), ("fma", None)):
        _, none, err = tck.fused_quantize(ts, x, want_error=True,
                                          error_rounding=rounding)
        assert none is None
        if want is None:
            want = tck.quant_int8_plain(x, 4, False, "fma")[3]
            _same(err, tck.fused_quantize(ts, x, want_error=True)[2].numpy(),
                  "the one-block default")
        _same(err, want.numpy(), rounding)


# the card: every form of both kernels, bitwise their plain versions
QUANT_FORM_CARD_CASES = (
    [((2, (1 << 19) // c * c), c, 0)
     for c in (128, 256, 384, 512, 640, 768, 896, 1024)]
    + [((2, 1 << 19), 256, 1), ((2, 1 << 19), 1024, 3), ((3, 1200), 12, 0),
       ((3, 1200), 12, 1), ((4, 2048), 64, 0), ((1, 256), 256, 0)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,offset", QUANT_FORM_CARD_CASES)
def test_quant_int8_forms_match_plain_on_card(cuda_device, shape, chunk,
                                              offset):
    x = _rows(shape, chunk, seed=chunk + offset)
    rows = _offset_rows(x, offset, device=cuda_device)
    form = tck.quant_int8_form(rows, chunk)
    assert form == ("chunked" if offset == 0 and chunk % 128 == 0
                    else "general")
    before = tck.quant_int8.launches
    for want_dq, rounding in ((True, None), (False, "sub"), (True, "fma")):
        got = tck.quant_int8(rows, chunk, want_dq, rounding)
        want = tck.quant_int8_plain(rows.cpu(), chunk, want_dq, rounding)
        torch.cuda.synchronize()
        for name, g, w in zip(("q", "scale", "dq", "err"), got, want):
            assert (g is None) == (w is None), name
            if g is not None:
                _same(g.cpu(), w.numpy(), f"{form} {name} {rounding}")
    assert tck.quant_int8.launches == before + 3


DEQUANT_FORM_CARD_CASES = [((2, 1 << 19), 256, 0), ((2, 1 << 19), 256, 4),
                           ((2, 1 << 19), 256, 1), ((3, 1200), 12, 0),
                           ((1, 20), 4, 0), ((5, 12), 4, 3), ((2, 4096), 1024, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk,offset", DEQUANT_FORM_CARD_CASES)
def test_dequant_int8_paths_match_plain_on_card(cuda_device, shape, chunk,
                                                offset):
    """Codes 0, 4 or 1 bytes past a 16-byte boundary (16-byte, char4 and
    byte loads), flat counts that are and are not multiples of 16, scales
    with a NaN, an inf and a zero chunk."""
    qc = _offset_codes(*shape, offset, seed=offset + chunk,
                       device=cuda_device)
    rng = np.random.RandomState(chunk)
    scale = np.exp(rng.uniform(-6, 6, (shape[0], shape[1] // chunk))).astype(
        np.float32)
    scale.flat[0] = np.nan
    scale.flat[-1] = np.inf
    scale.flat[len(scale.flat) // 2] = 0.0
    sc = torch.from_numpy(scale).to(cuda_device)
    before = tck.dequant_int8.launches
    got = tck.dequant_int8(qc, sc, chunk)
    again = tck.dequant_int8(qc, sc, chunk)
    torch.cuda.synchronize()
    assert tck.dequant_int8.launches == before + 2
    want = tck.dequant_int8_plain(qc.cpu(), torch.from_numpy(scale), chunk)
    _same(got.cpu(), want.numpy(),
          f"load bytes {tck.dequant_int8_load_bytes(qc)}")
    _same(got, again, "repeat")


@pytest.mark.cuda
def test_dequant_int8_64bit_indices_on_card(cuda_device):
    """Past 2^30 codes the kernel takes 64-bit indices: 2^30 + 4096 codes
    of chunk 256, against the plain version on the card."""
    n = (1 << 30) + 4096
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randint(-127, 128, (1, n), generator=gen, device=cuda_device,
                      dtype=torch.int8)
    scale = torch.rand((1, n // 256), generator=gen, device=cuda_device)
    got = tck.dequant_int8(q, scale, 256)
    want = tck.dequant_int8_plain(q, scale, 256)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# --------------------------------------------------------------------------
# quant_twobit's two forms and dequant_sum_twobit's load widths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape,offset,want", [
    ((2, 3 << 19), 0, "vector"), ((2, 3 << 19), 8, "vector"),
    ((1, 3 << 19), 0, "vector"), ((4, 3 << 17), 8, "vector"),
    ((2, 1_024_000), 0, "vector"), ((2, 12_778_516), 8, "vector"),
    ((1, (3 << 19) - 4), 0, "scalar"), ((2, 1 << 19), 0, "scalar"),
    ((2, 2548), 8, "scalar"), ((2, 3 << 19), 1, "scalar"),
    ((2, 36), 2, "scalar"), ((1, 12), 3, "scalar")])
def test_quant_twobit_picks_its_form(shape, offset, want):
    """The vector form where the rows start 16-byte aligned (a bucket view
    8 elements, 32 bytes, into the flat buffer does; a view 1-3 elements
    off does not) and hold at least 3 x 2^19 elements in all, whatever
    their split into rows (the rows are taken flat): the 4 MB bucket (2 x
    2^19) and smaller take the scalar form, which measured as fast or
    faster there."""
    rows = _offset_rows(torch.zeros(shape), offset)
    assert rows.data_ptr() % 16 == (4 * offset) % 16
    assert tck.quant_twobit_form(rows) == want


@pytest.mark.parametrize("shape,offset,want", [
    ((2, 3 << 16), 0, 4), ((2, 3 << 16), 8, 4), ((2, 256000), 1, 4),
    ((2, 3194629), 0, 4), ((2, 3194629), 3, 4), ((1, (3 << 16) - 1), 0, 1),
    ((2, 131072), 0, 1), ((2, 131072), 1, 1), ((2, 128240), 0, 1),
    ((2, 637), 0, 1), ((2, 4096), 8, 1), ((2, 4096), 1, 1),
    ((4, 48), 3, 1)])
def test_dequant_sum_twobit_picks_its_load_bytes(shape, offset, want):
    """4 code bytes a thread for rows of at least 3 x 2^16 bytes, else 1
    (the 4 MB bucket's 131,072 too), as measured on the card. Both read rows at any byte alignment with
    aligned words, so neither an odd B (ResNet-50's two-rank row,
    3,194,629 bytes; the odd-B bucket's 637) nor codes 8, 1 or 3 bytes
    past a 16-byte boundary change the pick."""
    buf = torch.zeros(shape[0] * shape[1] + 48, dtype=torch.uint8)
    start = (-buf.data_ptr()) % 16 + offset
    q = buf[start:start + shape[0] * shape[1]].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == offset % 16
    assert tck.dequant_sum_twobit_load_bytes(q) == want


def test_twobit_wrappers_check_their_operands():
    with pytest.raises(ValueError, match="multiple of 4"):
        tck.quant_twobit(torch.zeros(2, 6), 0.5)
    with pytest.raises(ValueError, match="float32"):
        tck.quant_twobit(torch.zeros(2, 8, dtype=torch.float64), 0.5)
    with pytest.raises(ValueError, match="uint8"):
        tck.dequant_sum_twobit(torch.zeros(2, 8, dtype=torch.int8), 0.5)
    # the CPU takes the plain version, whatever the form its rows would pick
    rows = torch.ones(2, 3 << 18)
    assert tck.quant_twobit_form(rows) == "vector"
    q, dq, err = tck.quant_twobit(rows, 0.5, want_err=True)
    assert dq is None and q.shape == (2, 3 << 16)
    assert torch.equal(err, torch.full_like(rows, 0.5))


# the card: each form of both kernels bitwise its plain version at shapes
# where its wrapper picks it, every output poisoned first, so that a store
# the kernel misses reads 0xff (code 3, or a NaN) and differs

def _poison(device, *specs):
    """Fill, then free, blocks of the caching allocator of the sizes and
    types of the outputs to come, so that their tensors start as 0xff."""
    held = [torch.empty(shape, dtype=dtype, device=device).view(torch.uint8)
            .fill_(255) for shape, dtype in specs]
    torch.cuda.synchronize()
    del held


def _twobit_outputs(shape):
    R, L = shape
    return ((R, L // 4), torch.uint8), ((R, L), torch.float32), \
        ((R, L), torch.float32)


_VEC = tck.QUANT_TWOBIT_VECTOR_MIN
# (shape, offset in floats): the bucket (scalar) and 3 x 2^20 elements
# (vector), each with R = 1, 2, 4 and 8, ResNet-50's two-rank gradient
# (12,778,516 a row: 3,194,629 code bytes), views 8 elements and 1 or 3
# elements off a 16-byte boundary, tails of 4, 8 and 12 elements past a
# multiple of 16 (R x L is a multiple of 4), and small rows, which take
# the scalar form wherever they start
QUANT_TWOBIT_CARD_CASES = (
    [((2, 1 << 19), 0), ((2, 1 << 19), 8), ((2, 1 << 19), 1),
     ((2, 12_778_516), 0), ((2, 12_778_516), 8), ((2, 12_778_516), 3)]
    + [((r, n // r), 0) for r in (1, 2, 4, 8) for n in (1 << 20, 3 << 20)]
    + [((1, _VEC + 16 * k + t), off) for k in (0, 40) for t in (4, 8, 12)
       for off in (0, 8, 1)]
    + [((r, 4096 + 36), 0) for r in (1, 2, 4, 8)]
    + [((1, 16 * k + t), off) for k in (0, 1, 40) for t in (4, 8, 12)
       for off in (0, 8, 1)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", QUANT_TWOBIT_CARD_CASES)
def test_quant_twobit_forms_match_plain_on_card(cuda_device, shape, offset):
    x = _twobit_rows(shape, seed=shape[1] + offset, threshold=0.5)
    rows = _offset_rows(x, offset, device=cuda_device)
    form = tck.quant_twobit_form(rows)
    assert form == ("vector" if offset % 4 == 0 and rows.numel() >= _VEC
                    else "scalar")
    cpu = rows.cpu()
    before = tck.quant_twobit.launches
    for want_dq, want_err in ((True, False), (False, True), (True, True)):
        _poison(cuda_device, *_twobit_outputs(shape))
        got = tck.quant_twobit(rows, 0.5, want_dq, want_err)
        want = tck.quant_twobit_plain(cpu, 0.5, want_dq, want_err)
        torch.cuda.synchronize()
        for name, g, w in zip(("q", "dq", "err"), got, want):
            assert (g is None) == (w is None), name
            if g is not None:
                _same(g.cpu(), w.numpy(), f"{form} {name}")
    assert tck.quant_twobit.launches == before + 3


_FOUR = tck.DQSUM_TWOBIT_FOUR_MIN
# (rows, B, offset in bytes): the bucket and ResNet-50's odd B, R = 1, 2,
# 4 and 8, and B = 16k + 1 .. 15, codes 0, 8, 1 and 3 bytes past a
# 16-byte boundary, in rows of each load width
DQSUM_TWOBIT_CARD_CASES = (
    [(2, 131072, off) for off in (0, 8, 1)]
    + [(2, 3_194_629, off) for off in (0, 3)]
    + [(r, _FOUR + 13, off) for r in (1, 2, 4, 8) for off in (0, 1)]
    + [(r, 4096 + 13, off) for r in (1, 2, 4, 8) for off in (0, 1)]
    + [(2, base + 16 * k + t, off) for base in (0, _FOUR) for k in (0, 3)
       for t in range(1, 16) for off in (0, 8, 1, 3)])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,B,offset", DQSUM_TWOBIT_CARD_CASES)
def test_dequant_sum_twobit_forms_match_plain_on_card(cuda_device, rows, B,
                                                      offset):
    rng = np.random.RandomState(B + offset)
    codes = torch.from_numpy(rng.randint(0, 256, (rows, B)).astype(np.uint8))
    buf = torch.full((rows * B + 64,), 0xAA, dtype=torch.uint8,
                     device=cuda_device)
    start = (-buf.data_ptr()) % 16 + offset
    q = buf[start:start + rows * B].view(rows, B)
    q.copy_(codes)
    load = tck.dequant_sum_twobit_load_bytes(q)
    assert load == (4 if B >= _FOUR else 1)
    want = tck.dequant_sum_twobit_plain(codes, 0.5)
    before = tck.dequant_sum_twobit.launches
    _poison(cuda_device, ((4 * B,), torch.float32))
    got = tck.dequant_sum_twobit(q, 0.5)
    torch.cuda.synchronize()
    _same(got.cpu(), want.numpy(), f"{load} bytes")
    assert tck.dequant_sum_twobit.launches == before + 1
    # the launcher refuses another load width
    out = torch.empty(4 * B, device=cuda_device)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        tck._run("dequant_sum_twobit", q.device, q.data_ptr(),
                 out.data_ptr(), rows, B, 0.5, 2)


@pytest.mark.cuda
def test_quant_twobit_64bit_indices_on_card(cuda_device):
    """From 2^30 code bytes on the vector form takes 64-bit indices: 2^32
    + 12 elements (16 GiB; with its 16 GiB error and 1 GiB of codes it
    fits the card), against the plain version on the card, 2^28 elements
    at a time."""
    n = (1 << 32) + 12
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.empty((1, n), device=cuda_device).normal_(generator=gen)
    assert tck.quant_twobit_form(x) == "vector"
    q, _, err = tck.quant_twobit(x, 0.5, want_err=True)
    step = 1 << 28
    for a in range(0, n, step):
        b = min(a + step, n)
        wq, _, werr = tck.quant_twobit_plain(x[:, a:b], 0.5, False, True)
        assert torch.equal(q[:, a // 4:b // 4], wq), a
        assert torch.equal(err[:, a:b].view(torch.int32),
                           werr.view(torch.int32)), a
    del x, q, err, wq, werr
    torch.cuda.empty_cache()


@pytest.mark.parametrize("load", [1, 4])
@pytest.mark.cuda
def test_dequant_sum_twobit_64bit_indices_on_card(cuda_device, load):
    """From 2^30 code bytes (R x B) on both load widths take 64-bit
    indices: just over 2^30 bytes in rows of an odd B that picks each
    width, against the plain version on the card."""
    B = 2 * _FOUR + 1 if load == 4 else _FOUR - 1
    R = (1 << 30) // B + 1
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randint(0, 256, (R, B), generator=gen, device=cuda_device,
                      dtype=torch.uint8)
    assert R * B >= 1 << 30 and tck.dequant_sum_twobit_load_bytes(q) == load
    got = tck.dequant_sum_twobit(q, 0.5)
    want = tck.dequant_sum_twobit_plain(q, 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    del q, got, want
    torch.cuda.empty_cache()
