"""The port's flash attention against the JAX package's.

Inputs are numpy-seeded and reach both packages as the same numbers. The JAX
side runs its Pallas kernels in interpret mode, as tests/test_pallas.py runs
them on the CPU; the port's CPU tensors take the plain versions
(``flash_fwd_plain``, ``flash_bwd_plain``), which are what the CUDA kernels
are held to on the card (the ``cuda``-marked tests at the end).

Tolerances. In f32 both sides compute the same blocked online softmax at the
same tiles and differ only in summation order: 2e-5 on outputs (the JAX
package's own bound against the dense reference), 1e-4 on gradients. In bf16
both round p and ds to bf16 at the same points, so a value differs by at
most one bf16 rounding step of the result (2^-8 of values below 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import flash_attention as jflash
from mxnet_tpu.ops.pallas.flash_attention import (
    flash_attention_with_lse as jflash_with_lse,
    flash_block_grads as jblock_grads)
from mxnet_tpu.parallel.sequence import attention_reference as jreference
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import flash_attention as tfa
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.base import set_matmul_precision
from mxnet_tpu_torch.parallel import (attention_reference, ring_attention,
                                      ring_flash_attention,
                                      ring_self_attention)

set_matmul_precision("highest")  # f32 contractions held to f32 references

torch.set_num_threads(1)

BLOCKS = dict(block_q=32, block_k=32)   # tests/test_pallas.py's tiles
# the port's functions take the key tile only: the query tile changes no
# result, and block_q is the JAX signature's, None or an error
TBLOCKS = dict(block_k=32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * 0.5 for _ in range(3)]


def _both(arrays, dtype=np.float32):
    jx = [jnp.asarray(a, dtype=jnp.bfloat16 if dtype == "bf16" else None)
          for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    if dtype == "bf16":
        tx = [t.bfloat16() for t in tx]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 64, 32), (2, 1, 128, 64),
                                   (1, 2, 48, 24)])
def test_plain_forward_matches_jax(causal, shape):
    jx, tx = _both(_qkv(shape, seed=3))
    want = jflash(*jx, causal=causal, **BLOCKS)
    got = tfa.flash_attention(*tx, causal=causal, **TBLOCKS)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_matches_jax(causal):
    jx, tx = _both(_qkv((1, 2, 48, 24), seed=4))
    jo, jl = jflash_with_lse(*jx, causal=causal, **BLOCKS)
    to, tl = tfa.flash_attention_with_lse(*tx, causal=causal, **TBLOCKS)
    assert tl.shape == (1, 2, 48) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax(causal):
    arrays = _qkv((1, 2, 64, 32), seed=1)
    jx, tx = _both(arrays)

    def loss(q, k, v):
        o = jflash(q, k, v, causal=causal, **BLOCKS)
        return jnp.sum(o * o)

    want = jax.grad(loss, argnums=(0, 1, 2))(*jx)
    leaves = [t.clone().requires_grad_(True) for t in tx]
    o = tfa.flash_attention(*leaves, causal=causal, **TBLOCKS)
    (o * o).sum().backward()
    for name, w, t in zip("qkv", want, leaves):
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_block_grads_use_the_global_lse():
    # each key/value half of a sequence with the (o, lse) of the whole,
    # against JAX; then the halves' dq, summed, is the whole's gradient
    arrays = _qkv((1, 2, 64, 32), seed=5)
    jx, tx = _both(arrays)
    do = np.random.RandomState(6).randn(1, 2, 64, 32).astype(np.float32)
    jo, jl = jflash_with_lse(*jx, causal=True, **BLOCKS)
    to, tl = tfa.flash_attention_with_lse(*tx, causal=True, **TBLOCKS)
    for half in (slice(0, 32), slice(32, 64)):
        jg = jblock_grads(jx[0], jx[1][:, :, half], jx[2][:, :, half], jo, jl,
                          jnp.asarray(do), causal=False, **BLOCKS)
        tg = tfa.flash_block_grads(tx[0], tx[1][:, :, half],
                                   tx[2][:, :, half], to, tl,
                                   torch.from_numpy(do), causal=False,
                                   **TBLOCKS)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)
    to_n, tl_n = tfa.flash_attention_with_lse(*tx, causal=False, **TBLOCKS)
    dq = sum(_np(tfa.flash_block_grads(tx[0], tx[1][:, :, h], tx[2][:, :, h],
                                       to_n, tl_n, torch.from_numpy(do),
                                       **TBLOCKS)[0])
             for h in (slice(0, 32), slice(32, 64)))
    leaves = [t.clone().requires_grad_(True) for t in tx]
    (tfa.flash_attention(*leaves, **TBLOCKS) * torch.from_numpy(do)).sum() \
        .backward()
    np.testing.assert_allclose(dq, _np(leaves[0].grad), rtol=1e-4, atol=1e-4)


def test_bf16_matches_jax():
    arrays = _qkv((1, 2, 64, 32), seed=2)
    jx, tx = _both(arrays, "bf16")
    want = jflash(*jx, causal=True, **BLOCKS)
    got = tfa.flash_attention(*tx, causal=True, **TBLOCKS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2.0 ** -8)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    jx, tx = _both(_qkv((2, 2, 40, 16), seed=7))
    np.testing.assert_allclose(_np(attention_reference(*tx, causal=causal)),
                               _np(jreference(*jx, causal=causal)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_at_kernel_tiles_matches_dense(causal):
    # block None: the kernels' 64x64 tiles, on a sequence of three tiles
    _, tx = _both(_qkv((1, 2, 150, 64), seed=8))
    np.testing.assert_allclose(_np(tfa.flash_attention(*tx, causal=causal)),
                               _np(attention_reference(*tx, causal=causal)),
                               rtol=2e-5, atol=2e-5)


def test_strided_views_give_the_contiguous_result():
    # the transformer hands q, k, v as views of one packed (b, s, 3, h, d)
    packed = torch.from_numpy(
        np.random.RandomState(9).randn(2, 40, 3, 2, 16).astype(np.float32))
    q, k, v = (packed[:, :, j].transpose(1, 2) for j in range(3))
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention(*(t.contiguous() for t in (q, k, v)),
                               causal=True)
    assert torch.equal(got, want)


def test_cpu_tensors_count_no_launch():
    _, tx = _both(_qkv((1, 2, 48, 24)))
    leaves = [t.requires_grad_(True) for t in tx]
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    tfa.flash_attention(*leaves, causal=True).sum().backward()
    o, lse = tfa.flash_fwd(*tx, causal=True)
    delta = tfa.attention_delta(o, o)
    tfa.flash_bwd_dq(*tx, o, lse, delta, causal=True)
    tfa.flash_bwd_dkv(*tx, o, lse, delta, causal=True)
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before


def test_wrappers_match_plain_versions_on_cpu():
    _, tx = _both(_qkv((1, 2, 48, 24), seed=10))
    do = torch.from_numpy(np.random.RandomState(11).randn(1, 2, 48, 24)
                          .astype(np.float32))
    o, lse = tfa.flash_fwd(*tx, causal=True)
    po, plse = tfa.flash_fwd_plain(*tx, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    delta = tfa.attention_delta(o, do)
    dq, dk, dv = tfa.flash_bwd_plain(*tx, do, lse, delta, causal=True)
    assert torch.equal(tfa.flash_bwd_dq(*tx, do, lse, delta, causal=True), dq)
    got_dk, got_dv = tfa.flash_bwd_dkv(*tx, do, lse, delta, causal=True)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)


def test_cuda_route_launches_or_raises(monkeypatch):
    # no fallback: where the route says "kernel", the call builds and
    # launches it or raises; here the build has no nvcc
    if torch.cuda.is_available():
        pytest.skip("checks the route without a card")
    monkeypatch.setattr(tfa, "use_kernel", lambda *tensors: True)
    _, tx = _both(_qkv((1, 2, 48, 24)))
    with pytest.raises(MXNetError, match="nvcc"):
        tfa.flash_fwd(*tx, causal=True)
    with pytest.raises(ValueError, match="64x64 tiles"):
        tfa.flash_attention(*tx, block_k=32)


def test_kernel_operands_are_read_in_place_or_copied():
    # TMA tensor maps take unit stride along head_dim and positive strides
    # that are multiples of 16 bytes: the transformer's views of its packed
    # qkv are read in place, anything else is copied
    packed = torch.zeros((2, 40, 3, 2, 16), dtype=torch.bfloat16)
    q = packed[:, :, 0].transpose(1, 2)
    assert tfa._kernel_operand(q) is q
    expanded = torch.zeros((1, 2, 40, 16), dtype=torch.bfloat16).expand(
        3, 2, 40, 16)
    copy = tfa._kernel_operand(expanded)
    assert copy is not expanded and copy.is_contiguous()
    assert torch.equal(copy, expanded)
    odd = torch.zeros((1, 2, 40, 20), dtype=torch.bfloat16)[..., :16]
    assert tfa._kernel_operand(odd).is_contiguous()
    assert tfa._kernel_operand(q.transpose(2, 3)).stride(3) == 1


def test_plain_route_takes_batch_x_heads_past_65535():
    # the JAX package has no batch x heads limit, and nor has the plain
    # version: 65,536 (batch, head) slabs against the dense reference,
    # values and gradients
    shape = (65536, 1, 2, 8)
    arrays = _qkv(shape, seed=13)
    do = np.random.RandomState(14).randn(*shape).astype(np.float32)
    jx, tx = _both(arrays)

    def loss(q, k, v):
        return jnp.sum(jreference(q, k, v, causal=True) * jnp.asarray(do))

    want_o = jreference(*jx, causal=True)
    want_grads = jax.grad(loss, argnums=(0, 1, 2))(*jx)
    leaves = [t.clone().requires_grad_(True) for t in tx]
    o = tfa.flash_attention(*leaves, causal=True)
    (o * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(_np(o), _np(want_o), rtol=2e-5, atol=2e-5)
    for name, w, t in zip("qkv", want_grads, leaves):
        np.testing.assert_allclose(_np(t.grad), _np(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


def test_cuda_route_refuses_a_grid_past_its_limit(monkeypatch):
    # one block per (64-row tile, batch x head) pair on a linear grid of at
    # most 2^31 - 1 blocks: a larger call raises before any build or copy
    monkeypatch.setattr(tfa, "use_kernel", lambda *tensors: True)
    q = torch.zeros((1, 1, 1, 8)).expand(2 ** 16, 2 ** 15, 1, 8)
    lse = torch.zeros((1, 1, 1)).expand(2 ** 16, 2 ** 15, 1)
    for call in (lambda: tfa.flash_fwd(q, q, q),
                 lambda: tfa.flash_bwd_dq(q, q, q, q, lse, lse),
                 lambda: tfa.flash_bwd_dkv(q, q, q, q, lse, lse)):
        with pytest.raises(ValueError, match=r"2\^31 - 1"):
            call()


def test_kernel_attributes_need_the_build():
    # the registers and shared memory of a kernel come from its compiled
    # library: without nvcc the query raises, as a launch does
    if torch.cuda.is_available():
        pytest.skip("checks the build's absence without a card")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        with pytest.raises(MXNetError, match="nvcc"):
            tfa.kernel_attributes(name, torch.bfloat16, 64)


def test_rejected_operands():
    _, tx = _both(_qkv((1, 2, 48, 24)))
    half = [t.half() for t in tx]
    with pytest.raises(ValueError, match="float16"):
        tfa.flash_attention(*half)
    odd = [t[..., :20] for t in tx]
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_attention(*odd)
    with pytest.raises(ValueError, match="do not match"):
        tfa.flash_attention(tx[0], tx[1][:, :1], tx[2])
    o, lse = tfa.flash_attention_with_lse(*tx)
    for call in (lambda: tfa.flash_attention(*tx, block_q=64),
                 lambda: tfa.flash_attention_with_lse(*tx, block_q=32),
                 lambda: tfa.flash_block_grads(*tx, o, lse, o, block_q=32)):
        with pytest.raises(ValueError, match="block_q"):
            call()


def test_ring_attention_is_not_ported():
    # Ring attention is ported (tests/test_torch_parallel.py runs it over
    # gloo ranks). On a ring of one rank (no process group) it is plain
    # attention: the dense ring within f32 rounding of the reference, the
    # flash ring bitwise flash_attention, values and gradients.
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch.parallel import make_mesh

    _, tx = _both(_qkv((1, 2, 48, 24)))
    for causal in (False, True):
        want = attention_reference(*tx, causal=causal)
        np.testing.assert_allclose(_np(ring_attention(*tx, causal=causal)),
                                   _np(want), rtol=2e-5, atol=2e-5)
        leaves = [t.clone().requires_grad_(True) for t in tx]
        flash = tfa.flash_attention(*leaves, causal=causal)
        grads = torch.autograd.grad(flash.sum(), leaves)
        leaves = [t.clone().requires_grad_(True) for t in tx]
        ring = ring_flash_attention(*leaves, causal=causal)
        assert torch.equal(ring, flash)
        for a, b in zip(torch.autograd.grad(ring.sum(), leaves), grads):
            assert torch.equal(a, b)
        mesh = make_mesh(devices=cpu())
        assert torch.equal(ring_self_attention(mesh, *tx, causal=causal,
                                               use_flash=True), flash)
    with pytest.raises(TypeError, match="MeshAxis"):
        ring_attention(*tx, "sp")


def test_cost_counts_the_causal_entries():
    q = torch.empty((8, 8, 2048, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((8, 8, 2048), device="meta")
    spec = registry.get_kernel("flash_fwd")
    assert spec.replaces == "mxnet_tpu/ops/pallas/flash_attention.py:120"
    full = spec.cost([q, q, q], [q, lse], causal=False)
    causal = spec.cost([q, q, q], [q, lse], causal=True)
    # the JAX package's model FLOPs (flash_attention.py:433), undiscounted
    assert full.flops == 4.0 * 64 * 2048 * 2048 * 64
    # query row i sees keys 0..i: the triangle and its diagonal, whatever
    # tile a kernel computes it in
    assert causal.flops == full.flops * (2048 * 2049 / 2) / 2048 ** 2
    assert causal.bound()[1] == "operations"
    assert set(causal.ops) == {"bf16"}
    for sq, sk in ((48, 48), (130, 130), (5, 9), (9, 5), (1, 1)):
        rows = np.arange(sq)[:, None] >= np.arange(sk)[None, :]
        assert tfa.attention_entries(sq, sk, True) == rows.sum(), (sq, sk)
        assert tfa.attention_entries(sq, sk, False) == sq * sk
    for name, products in (("flash_bwd_dq", 3), ("flash_bwd_dkv", 4)):
        c = registry.get_kernel(name).cost([q, q, q], [q], causal=True)
        assert c.flops == causal.flops * products / 2


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

# (q shape, seq_k or None for seq_q, dtype, causal, packed): packed q, k, v
# are strided views of one (b, s, 3, h, d) qkv, as the transformer hands
# them. The bf16 cases reach the Hopper kernels' edges: head_dim 32 and 40
# (TMA's zero fill of the 64-column box), 128 (two 64-column boxes a row),
# sequences that are a multiple of neither the 64-row tile nor the 128-row
# block (77, 130, 1000), seq_q != seq_k, and causal blocks of both halves.
CARD_SHAPES = [((2, 3, 256, 64), None, torch.bfloat16, True, False),
               ((2, 3, 200, 64), None, torch.bfloat16, False, False),
               ((1, 2, 48, 24), None, torch.float32, True, False),
               ((1, 2, 130, 128), None, torch.bfloat16, True, False),
               ((1, 2, 96, 32), None, torch.float32, False, False),
               ((2, 2, 77, 32), None, torch.bfloat16, True, False),
               ((1, 3, 1000, 40), None, torch.bfloat16, True, False),
               ((2, 2, 77, 40), None, torch.bfloat16, False, True),
               ((1, 2, 1000, 128), None, torch.bfloat16, False, True),
               ((2, 4, 512, 64), None, torch.bfloat16, True, True),
               ((1, 2, 100, 64), 300, torch.bfloat16, False, False),
               ((1, 2, 300, 128), 77, torch.bfloat16, False, False),
               ((1, 2, 130, 64), 200, torch.bfloat16, True, False)]


def _card_operands(shape, seq_k, dtype, packed, device):
    gen = torch.Generator(device=device).manual_seed(0)
    b, h, sq, d = shape
    sk = sq if seq_k is None else seq_k
    if packed:
        qkv = torch.randn((b, sq, 3, h, d), generator=gen,
                          device=device).to(dtype)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    else:
        q = torch.randn(shape, generator=gen, device=device).to(dtype)
        k, v = (torch.randn((b, h, sk, d), generator=gen, device=device)
                .to(dtype) for _ in range(2))
    do = torch.randn(shape, generator=gen, device=device).to(dtype)
    return q, k, v, do


def _row_bound_shares(got, want, tol):
    # per (batch, head, row) error over head_dim, as a share of tol times
    # that row's norm plus 2^-16 of the slab's RMS row norm: late causal
    # rows and keys, whose values are small, are held about as tightly as
    # the large ones, and a row that cancels to rounding noise (dq of the
    # first query: dp - delta is zero up to f32 rounding, read at 0.7-1.8e-6
    # of the RMS) is held at the floor
    g, w = got.float(), want.float()
    err, norm = (g - w).norm(dim=-1), w.norm(dim=-1)
    rms = norm.pow(2).mean(-1, keepdim=True).sqrt()
    return err / (tol * norm + 2.0 ** -16 * rms)


def _card_row_bound(dtype):
    # another summation order and, in bf16, an occasional other rounding of
    # an output, p or ds: one bf16 step of each element is 2^-7 of its row
    # at most (readings up to 3.6e-3); f32 sums in another order stay within
    # 1e-5 (readings up to 7.7e-7)
    return 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5


def _hold_kernels_to_plain(shape, seq_k, dtype, causal, packed, device):
    q, k, v, do = _card_operands(shape, seq_k, dtype, packed, device)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    po, plse = tfa.flash_fwd_plain(q, k, v, causal)
    delta = tfa.attention_delta(o, do)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    again = (*tfa.flash_fwd(q, k, v, causal),
             tfa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
             *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, causal))
    pgrads = tfa.flash_bwd_plain(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    # no atomics: a second launch is bitwise the first
    for name, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                          (o, lse, dq, dk, dv), again):
        assert torch.equal(a, b), name
    # lse is f32 on both sides
    assert bool(((lse - plse).abs() <= 1e-5 * plse.abs().clamp_min(1)).all())
    tol = _card_row_bound(dtype)
    for name, got, want in (("o", o, po), ("dq", dq, pgrads[0]),
                            ("dk", dk, pgrads[1]), ("dv", dv, pgrads[2])):
        share = float(_row_bound_shares(got, want, tol).max())
        assert share <= 1.0, (name, share)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,seq_k,dtype,causal,packed", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda_device, shape, seq_k, dtype,
                                     causal, packed):
    _hold_kernels_to_plain(shape, seq_k, dtype, causal, packed, cuda_device)


@pytest.mark.cuda
def test_kernels_take_batch_x_heads_past_65535(cuda_device):
    # 65,536 (batch, head) slabs: one linear grid, no "invalid argument"
    _hold_kernels_to_plain((65536, 1, 16, 64), None, torch.bfloat16, True,
                           True, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim", [32, 40, 64, 128])
def test_bf16_dq_launches_the_hopper_kernel(cuda_device, head_dim):
    # bf16 dq: the 384-thread warp-specialised kernel, Q and dO resident
    # and a ring of K/V stages (96 KB at d <= 64, 160 KB at d = 128, plus
    # barriers and 1 KB of alignment); f32 dq: the 128-thread CUDA-core one
    attrs = tfa.kernel_attributes("flash_bwd_dq", torch.bfloat16, head_dim)
    assert attrs["threads"] == 384, attrs
    ring = 96 if head_dim <= 64 else 160
    assert ring * 1024 < attrs["dynamic_smem_bytes"] <= ring * 1024 + 1100
    assert tfa.kernel_attributes("flash_bwd_dq", torch.float32,
                                 head_dim)["threads"] == 128


@pytest.mark.cuda
def test_bf16_dq_repeats_itself_bitwise(cuda_device):
    # no atomics and one summation order: three launches, one result
    q, k, v, do = _card_operands((2, 4, 512, 64), None, torch.bfloat16, True,
                                 cuda_device)
    o, lse = tfa.flash_fwd(q, k, v, True)
    delta = tfa.attention_delta(o, do)
    first = tfa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    for _ in range(2):
        assert torch.equal(tfa.flash_bwd_dq(q, k, v, do, lse, delta, True),
                           first)


@pytest.mark.cuda
def test_autograd_on_card_matches_cpu(cuda_device):
    arrays = _qkv((1, 2, 130, 32), seed=12)
    cpu = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    card = [torch.from_numpy(a).to(cuda_device).requires_grad_(True)
            for a in arrays]
    before = tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches
    for leaves in (cpu, card):
        o = tfa.flash_attention(*leaves, causal=True)
        (o * o).sum().backward()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(cpu, card):
        np.testing.assert_allclose(b.grad.cpu().numpy(), a.grad.numpy(),
                                   rtol=1e-4, atol=1e-4)
