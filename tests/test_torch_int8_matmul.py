"""The port's int8_matmul against the JAX package's Pallas kernel.

The JAX side runs as its own tests run it on the CPU: Pallas in interpret
mode. Its serving path runs compiled (jit), where XLA turns the divide by the
constant 127 into a multiply by its f32 reciprocal; the port follows that
arithmetic, so the comparisons are against the compiled JAX calls and are
bitwise where the JAX kernel's f32 accumulation is exact.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import matmul as jm
from mxnet_tpu_torch.kernels import _common
from mxnet_tpu_torch.kernels import int8_matmul as k8
from mxnet_tpu_torch.kernels import registry

torch.set_num_threads(2)


def _operands(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K), np.float32),
            rng.standard_normal((N, K), np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(23, 100), (64, 512), (1000, 2048)])
def test_quantize_channels_matches_jax_compiled(shape):
    w = np.random.default_rng(1).standard_normal(shape, np.float32)
    wq_j, sw_j = jax.jit(jm.quantize_channels)(jnp.asarray(w))
    wq_t, sw_t = k8.quantize_channels(torch.from_numpy(w))
    assert wq_t.dtype == torch.int8 and sw_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))


# K <= 1024: the JAX kernel's f32 accumulation is exact (partial sums stay
# below 2**24), so the plain version must match it bitwise.
@pytest.mark.parametrize("M,K,N", [(37, 100, 23), (16, 1024, 48)])
def test_plain_matches_jax_kernel_bitwise(M, K, N):
    x, w = _operands(M, K, N)
    wq, sw = jax.jit(jm.quantize_channels)(jnp.asarray(w))
    y_j = jm.int8_matmul(jnp.asarray(x), wq, w_scale=sw, block_m=16,
                         block_n=16)
    y_t = k8.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(wq)),
                         w_scale=torch.from_numpy(np.array(sw)))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    # the float-weight entry point, against the JAX call compiled whole
    y_jf = jax.jit(lambda a, b: jm.int8_matmul(a, b, block_m=16, block_n=16))(
        jnp.asarray(x), jnp.asarray(w))
    y_tf = k8.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(y_tf.numpy(), np.asarray(y_jf))


def test_plain_matches_jax_kernel_fc1_width():
    """ResNet-50 fc1 (K=2048): the port sums exactly (int32 on the card, f64
    here); the JAX kernel sums in f32, which may round once partial sums pass
    2**24. Tolerance: a few f32 ulps of the largest output."""
    x, w = _operands(8, 2048, 1000, seed=2)
    wq, sw = jax.jit(jm.quantize_channels)(jnp.asarray(w))
    y_j = np.asarray(jm.int8_matmul(jnp.asarray(x), wq, w_scale=sw,
                                    block_m=16, block_n=256))
    y_t = k8.int8_matmul(torch.from_numpy(x), torch.from_numpy(np.array(wq)),
                         w_scale=torch.from_numpy(np.array(sw))).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=4e-7 * np.abs(y_j).max())


def test_error_bound_against_f32_matmul():
    """The JAX package's accuracy contract (tests/test_pallas_kernels.py):
    relative Frobenius error under 2e-2 for gaussian operands."""
    x, w = _operands(37, 100, 23, seed=4)
    y = k8.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    ref = x.astype(np.float64) @ w.T.astype(np.float64)
    assert y.shape == (37, 23) and y.dtype == np.float32
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 2e-2


def test_exact_on_int8_representable_inputs():
    """Rows whose largest entry is 127 and whose entries are integers
    quantize to themselves with scale 1, so the product is exact."""
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (9, 64)).astype(np.float32)
    w = rng.integers(-127, 128, (7, 64)).astype(np.float32)
    x[:, 0], w[:, 0] = 127, 127
    y = k8.int8_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(y, x @ w.T)


def test_prequantized_path_and_errors():
    x, w = _operands(37, 100, 23)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    wq, sw = k8.quantize_channels(wt)
    assert torch.equal(k8.int8_matmul(xt, wq, w_scale=sw), k8.int8_matmul(xt, wt))
    with pytest.raises(ValueError, match="w_scale"):
        k8.int8_matmul(xt, wq)
    with pytest.raises(ValueError, match="float32"):
        k8.int8_matmul(xt.double(), wq, w_scale=sw)
    with pytest.raises(ValueError):
        k8.int8_matmul(xt[:, :50].contiguous(), wq, w_scale=sw)
    with pytest.raises(ValueError):
        k8.int8_matmul(xt, wq, w_scale=sw[:5])


def test_cpu_tensor_takes_plain_version():
    x, w = _operands(5, 32, 6)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    before = k8.int8_matmul.launches
    y = k8.int8_matmul(xt, wt)
    assert k8.int8_matmul.launches == before
    assert torch.equal(y, k8.int8_matmul_plain(xt, *k8.quantize_channels(wt)))


def test_route_depends_on_device_only(monkeypatch):
    def on(device):
        return types.SimpleNamespace(device=torch.device(device))

    # no environment variable sends a CUDA tensor to the plain version
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")
    assert _common.use_kernel(on("cuda:0"), on("cuda:0")) is True
    assert _common.use_kernel(on("cpu"), on("cpu")) is False
    with pytest.raises(ValueError, match="several devices"):
        _common.use_kernel(on("cpu"), on("cuda:0"))
    with pytest.raises(ValueError, match="no kernel"):
        _common.use_kernel(on("meta"))


def test_predict_scope(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_INT8_PREDICT", "1")  # not read by the port
    assert not k8.int8_predict_active()
    with k8.int8_predict_scope():
        assert k8.int8_predict_active()
        with k8.int8_predict_scope(False):
            assert not k8.int8_predict_active()
        assert k8.int8_predict_active()
    assert not k8.int8_predict_active()


def test_cost_model_and_bound():
    """The JAX package's FLOP/byte model (matmul.py:140-146) on unpadded
    operands, priced against the H100 data sheet."""
    M, K, N = 32, 2048, 1000
    x = torch.empty((M, K))
    wq = torch.empty((N, K), dtype=torch.int8)
    sw, y = torch.empty(N), torch.empty((M, N))
    spec = registry.get_kernel("int8_matmul")
    assert spec.source == "mxnet_tpu_torch/csrc/int8_matmul.cu"
    assert spec.replaces == "mxnet_tpu/ops/pallas/matmul.py:123"
    cost = spec.cost([x, wq, sw], [y])
    assert cost.flops == 2.0 * M * N * K + 4.0 * M * K
    assert cost.bytes == M * K * 4 + N * K + N * 4 + M * N * 4  # 2.44 MB
    seconds, by = cost.bound()
    assert by == "bytes"
    assert seconds == pytest.approx(cost.bytes / 3.35e12)


@pytest.mark.parametrize("M,K,N,blocks,per", [
    (32, 2048, 1000, 8, 1),    # fc1: 16 N-tiles x 8 K-slices of one slab
    (1, 2048, 1000, 8, 1),
    (64, 2048, 1000, 8, 1),
    (65, 2048, 1000, 4, 2),    # 32 tiles: 4 slices of 2 slabs
    (32, 2064, 1000, 5, 2),    # 9 slabs do not split evenly
    (32, 16, 1000, 1, 1),
    (37, 100, 23, 1, 1),
    (8, 1000, 300, 4, 1),
    (256, 4096, 4096, 1, 16),  # 256 tiles fill the card: no split
])
def test_k_split_fills_the_card(M, K, N, blocks, per):
    slabs = -(-K // k8.SLAB)
    assert k8._k_split(M, N, K) == (blocks, per)
    # every slab in exactly one block, at most one cluster a tile
    assert (blocks - 1) * per < slabs <= blocks * per
    assert blocks <= k8.MAX_SPLIT


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(32, 2048, 1000), (1, 2048, 1000),
                                   (37, 100, 23), (130, 80, 70),
                                   (64, 2048, 1000), (65, 2048, 1000),
                                   (32, 2064, 1000), (32, 16, 1000),
                                   (32, 100, 1000), (8, 1000, 300),
                                   (256, 4096, 4096)])
def test_kernel_matches_plain_on_card(cuda_device, monkeypatch, M, K, N):
    monkeypatch.setenv("MXNET_TPU_PALLAS_INTERPRET", "1")  # has no effect
    x, w = _operands(M, K, N, seed=6)
    xt = torch.from_numpy(x).to(cuda_device)
    wq, sw = k8.quantize_channels(torch.from_numpy(w).to(cuda_device))
    before = k8.int8_matmul.launches
    y = k8.int8_matmul(xt, wq, w_scale=sw)
    torch.cuda.synchronize()
    assert k8.int8_matmul.launches == before + 1
    assert torch.equal(y, k8.int8_matmul_plain(xt, wq, sw))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(32, 2048, 1000), (8, 1000, 300),
                                   (256, 4096, 4096)])
def test_kernel_reads_its_prepass_not_stale_scratch(cuda_device, M, K, N):
    # the GEMM may start before the row pre-pass ends (programmatic
    # dependent launch) and must read qx and sx only after waiting for it:
    # scratch handed back NaN-filled by the allocator shows a read too early
    x, w = _operands(M, K, N, seed=7)
    xt = torch.from_numpy(x).to(cuda_device)
    wq, sw = k8.quantize_channels(torch.from_numpy(w).to(cuda_device))
    plain = k8.int8_matmul_plain(xt, wq, sw)
    for _ in range(20):
        junk = [torch.full((n,), float("nan"), device=cuda_device)
                for n in (M * K // 4, M, M * N, 4096)]
        del junk
        assert torch.equal(k8.int8_matmul(xt, wq, w_scale=sw), plain)
