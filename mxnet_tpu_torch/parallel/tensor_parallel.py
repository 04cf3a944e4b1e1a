"""Tensor (model) parallelism over a 'tp' axis of ranks.

Counterpart of ``mxnet_tpu/parallel/tensor_parallel.py``. There the
functions are plain einsums and XLA's SPMD partitioner inserts the
collectives; here each rank holds its shard and the collectives are written
out, as Megatron's pair of autograd functions:

- "copy": identity forward, sum over tp backward, in front of a
  column-parallel product; fused into that product's backward
  (``_ColumnMatmul``), so that the gradient's partial products are summed
  before they are rounded;
- "reduce" (:func:`reduce_from_axis`): sum over tp forward, identity
  backward, behind a row-parallel product.

Where the sums meet the rounding. Read from the compiled HLO of the JAX
LM's step (a bf16 config on a dp 2 x tp 2 x sp 2 CPU mesh,
``jax.jit(step).lower(...).compile().as_text()``): every all-reduce over tp
carries f32 elements. The row-parallel products' partial sums (the
attention output projection and the MLP's down projection) are summed in
f32 and then cast to bf16; so are the column-parallel products' input
gradients in backward, and the vocab-parallel embedding's gather. Casting
each partial first and summing after would round twice. So at tp > 1
:func:`row_parallel` forms its partial product in f32 and
:func:`column_parallel` its input gradient, and each sums over tp before
the one cast. Each such product is :func:`wide_product`: for bf16 or f16
operands, exact products summed in f32 with an f32 result, on the card one
tensor-core GEMM with an f32 output. At tp = 1 both are the single-card
GEMM of ``models/transformer.py``, bit for bit.

Every GEMM here sums in f32 and rounds once to its output type: cuBLAS's
reduced-precision bf16 reduction is switched off for each call
(:func:`one_rounding`), whatever the caller's process flag.

The LM head (:func:`column_parallel_f32`) keeps its product in f32: the JAX
model multiplies the bf16 operands with ``preferred_element_type=float32``
(transformer.py:217-218), one :func:`wide_product`. Its gradients multiply
the f32 cotangent by a bf16 operand and round the f32 sum to bf16 once;
the port splits the cotangent into two bf16 parts, ``hi = bf16(g)`` and
``lo = bf16(g - hi)`` (:func:`split_cotangent`, once for both gradients),
and sums the two tensor-core products of each gradient in f32: within about
2^-16 of sum |g||w| before the one rounding to bf16 (2^-9).
"""

from __future__ import annotations

import contextlib

import torch

from .mesh import P, all_gather, all_reduce_sum, as_axis

__all__ = ["column_parallel", "column_parallel_f32", "row_parallel",
           "transformer_param_specs", "reduce_from_axis", "gather_from_axis",
           "one_rounding", "Matmul", "wide_product", "split_cotangent"]


@contextlib.contextmanager
def one_rounding():
    """cuBLAS's reduced-precision bf16 reduction off for the GEMMs inside,
    restored after, whatever the caller set (PyTorch's default is on)."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


def _weight_grad(x, dy):
    return x.reshape(-1, x.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])


class Matmul(torch.autograd.Function):
    """``x @ w`` whose forward and gradient GEMMs each sum in f32 and round
    once to the operands' type: the model's own rounding, not a process
    flag's."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with one_rounding():
            return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        with one_rounding():
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(dy, w.t())
            if ctx.needs_input_grad[1]:
                dw = _weight_grad(x, dy)
        return dx, dw


class _ColumnMatmul(torch.autograd.Function):
    """``copy(x) @ w`` over a tp axis of more than one rank: forward and the
    weight gradient as :class:`Matmul`; the input gradient's partial
    product in f32 (:func:`wide_product`), summed over tp, then one
    cast."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.save_for_backward(x, w)
        ctx.axis = axis
        with one_rounding():
            return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            partial = wide_product(dy.reshape(-1, dy.shape[-1]), w.t())
            dx = all_reduce_sum(partial, ctx.axis).to(x.dtype).reshape(
                x.shape)
        if ctx.needs_input_grad[1]:
            with one_rounding():
                dw = _weight_grad(x, dy)
        return dx, dw, None


def wide_product(a, b):
    """``a @ b`` of two 2-D tensors of one type, summed in f32 with an f32
    result. For bf16 or f16 operands the products are exact: on a card the
    tensor cores' GEMM with an f32 output (``aten::mm.dtype``), on the CPU
    an f32 GEMM of the upcast operands, which gives the same products. f32
    operands take the f32 GEMM (TF32 as the caller set it)."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    with one_rounding():
        return torch.matmul(a.float(), b.float())


def split_cotangent(g, dtype):
    """The f32 cotangent ``g`` as two ``dtype`` parts, ``hi = dtype(g)`` and
    ``lo = dtype(g - hi)`` (``g - hi`` is exact in f32), in one pass each."""
    hi = g.to(dtype)
    return hi, torch.sub(g, hi, out=torch.empty_like(hi))


class _WideMatmul(torch.autograd.Function):
    """``x @ w`` of bf16 (or f16) operands with an f32 output, column
    parallel over ``axis``: the forward one :func:`wide_product`; each
    gradient the two :func:`wide_product` of the cotangent's parts
    (:func:`split_cotangent`) summed in f32, the input gradient's summed
    over tp in f32 too, then one cast."""

    @staticmethod
    def forward(ctx, x, w, axis):
        ctx.save_for_backward(x, w)
        ctx.axis = axis
        y = wide_product(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        hi, lo = split_cotangent(dy.reshape(-1, dy.shape[-1]), x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            partial = wide_product(hi, w.t()) + wide_product(lo, w.t())
            if ctx.axis.size > 1:
                partial = all_reduce_sum(partial, ctx.axis)
            dx = partial.to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            xt = x.reshape(-1, x.shape[-1]).t()
            dw = (wide_product(xt, hi) + wide_product(xt, lo)).to(w.dtype)
        return dx, dw, None


class _UpcastMatmul(torch.autograd.Function):
    """``x.float() @ w.float()``, f32 out, for a row-parallel partial
    product: the autograd of that expression (each gradient GEMM in f32,
    then rounded to its operand's type), every GEMM a :func:`wide_product`.
    The output's gradient comes back through a cast from ``x.dtype``, so
    it is exact in ``x.dtype`` and every operand is an upcast value."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        y = wide_product(x.reshape(-1, x.shape[-1]), w)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.reshape(-1, dy.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = wide_product(dy, w.t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = wide_product(x.reshape(-1, x.shape[-1]).t(), dy).to(w.dtype)
        return dx, dw


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's block concatenated along the last dimension; backward
    keeps this rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return torch.cat(list(all_gather(x, axis)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        i, w = ctx.axis.index, ctx.width
        return g[..., i * w:(i + 1) * w].contiguous(), None


def reduce_from_axis(x, group=None):
    """Sum over ``group`` forward (the same bits on every rank); identity
    backward."""
    axis = as_axis(group)
    return x if axis.size == 1 else _Reduce.apply(x, axis)


def gather_from_axis(x, group=None):
    """Concatenate every rank's ``x`` along the last dimension, in axis
    order; backward keeps this rank's block."""
    axis = as_axis(group)
    return x if axis.size == 1 else _Gather.apply(x, axis)


def column_parallel(x, w, b=None, group=None):
    """``y = x @ w`` where ``w`` is this rank's block of output columns over
    the tp axis ``group`` (a MeshAxis, a process group, or None for the
    world). ``x`` is the whole input on every rank; the output stays split
    on its feature dimension: follow with :func:`row_parallel`. The product
    sums in f32 and rounds once to ``x.dtype``; ``b`` (this rank's block)
    is added in ``x.dtype``."""
    axis = as_axis(group)
    w = w.to(x.dtype)
    y = Matmul.apply(x, w) if axis.size == 1 else _ColumnMatmul.apply(x, w,
                                                                      axis)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def column_parallel_f32(x, w, group=None):
    """:func:`column_parallel` with the product kept in f32, never rounded
    to ``x.dtype``: the LM head's logits. For bf16 or f16 ``x`` the
    operands are ``x`` and ``w`` cast to ``x.dtype``, multiplied on the
    tensor cores with f32 sums (:class:`_WideMatmul`); for f32 ``x`` this
    is :func:`column_parallel`."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return column_parallel(x, w, group=group)
    return _WideMatmul.apply(x, w.to(x.dtype), as_axis(group))


def row_parallel(x, w, b=None, group=None):
    """``y = x @ w`` where ``w`` is this rank's block of input rows over the
    tp axis ``group`` and ``x`` the matching block of features: the partial
    products are summed over tp in f32, then cast once to ``x.dtype``; ``b``
    (whole) is added after the sum, in ``x.dtype``."""
    axis = as_axis(group)
    w = w.to(x.dtype)
    if axis.size == 1:
        y = Matmul.apply(x, w)
    else:
        partial = _UpcastMatmul.apply(x, w)
        y = _Reduce.apply(partial, axis).to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def transformer_param_specs(n_layers: int) -> dict:
    """The JAX package's PartitionSpecs for the transformer, keyed by
    parameter name (``tensor_parallel.py:44-70``), as names and the global
    layout:
      attention qkv:  (d_model, 3*d_head*n_head) -> shard heads over tp
      attention out:  (d_head*n_head, d_model)   -> shard input over tp
      mlp up:         (d_model, d_ff)            -> column (tp on d_ff)
      mlp down:       (d_ff, d_model)            -> row (tp on d_ff)
      embeddings:     (vocab, d_model)           -> shard vocab over tp
      norms/biases:   replicated
    ``P(None, "tp")`` on the fused qkv weight cuts its columns in tp
    contiguous blocks, which GSPMD reshards after the head reshape; the
    port splits it by heads instead (``TransformerLM.param_shardings``)."""
    spec = {
        "embed": P("tp", None),
        "pos_embed": P(),
        "final_norm_scale": P(),
        "final_norm_bias": P(),
        "lm_head": P(None, "tp"),
    }
    for i in range(n_layers):
        spec.update({
            f"layer{i}_wqkv": P(None, "tp"),
            f"layer{i}_wo": P("tp", None),
            f"layer{i}_w1": P(None, "tp"),
            f"layer{i}_b1": P("tp"),
            f"layer{i}_w2": P("tp", None),
            f"layer{i}_b2": P(),
            f"layer{i}_ln1_scale": P(),
            f"layer{i}_ln1_bias": P(),
            f"layer{i}_ln2_scale": P(),
            f"layer{i}_ln2_bias": P(),
        })
    return spec
