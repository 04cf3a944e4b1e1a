"""Structural and elementwise operators.

Counterpart of ``mxnet_tpu/ops/tensor.py``: _Plus/_Minus/_Mul/_Div,
ElementWiseSum, Concat, SliceChannel, Reshape, Flatten, BlockGrad,
Transpose, the unary ops (square, sqrt, exp, log, abs, norm) and
Embedding, with the same parameters and shape rules. Their gradients come
from autograd; BlockGrad's output is detached, so nothing flows through it.
"""

from __future__ import annotations

import ast

import numpy as np
import torch

from ..base import MXNetError
from .registry import OpProp, Range, REQUIRED, as_dtype, register_op


class _BinaryOp(OpProp):
    def list_arguments(self):
        return ["lhs", "rhs"]

    def infer_shape(self, in_shapes):
        s = in_shapes[0] or in_shapes[1]
        if s is None:
            raise MXNetError(f"{self.name}: both input shapes unknown")
        s = tuple(s)
        return [s, s], [s], []


@register_op("_Plus", aliases=["elemwise_add"])
class PlusOp(_BinaryOp):
    """Elementwise addition."""

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0] + ins[1]], []


@register_op("_Minus")
class MinusOp(_BinaryOp):
    """Elementwise subtraction."""

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0] - ins[1]], []


@register_op("_Mul")
class MulOp(_BinaryOp):
    """Elementwise multiplication."""

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0] * ins[1]], []


@register_op("_Div")
class DivOp(_BinaryOp):
    """Elementwise division."""

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0] / ins[1]], []


@register_op("ElementWiseSum", aliases=["add_n"])
class ElementWiseSumOp(OpProp):
    """Sum of N inputs, added left to right."""

    params = {"num_args": (Range(int, lo=1), REQUIRED, "number of inputs")}

    def list_arguments(self):
        return [f"arg{i}" for i in range(self.num_args)]

    def infer_shape(self, in_shapes):
        s = next((tuple(x) for x in in_shapes if x is not None), None)
        if s is None:
            raise MXNetError("ElementWiseSum: no input shape known")
        return [s] * self.num_args, [s], []

    def fwd(self, ins, aux, is_train, rng):
        out = ins[0]
        for x in ins[1:]:
            out = out + x
        return [out], []


@register_op("Concat")
class ConcatOp(OpProp):
    """Concatenate along ``dim`` (default channel dim 1)."""

    params = {
        "num_args": (Range(int, lo=1), REQUIRED, "number of inputs"),
        "dim": (int, 1, "dimension to concatenate along"),
    }

    def list_arguments(self):
        return [f"arg{i}" for i in range(self.num_args)]

    def infer_shape(self, in_shapes):
        known = [tuple(s) for s in in_shapes if s is not None]
        if not known:
            raise MXNetError("Concat: no input shape known")
        ndim, dim = len(known[0]), self.dim
        out = list(known[0])
        out[dim] = 0
        filled = []
        for s in in_shapes:
            s = tuple(known[0] if s is None else s)
            if len(s) != ndim:
                raise MXNetError("Concat: rank mismatch")
            for ax in range(ndim):
                if ax != dim and s[ax] != out[ax]:
                    raise MXNetError(f"Concat: shape mismatch {s} vs {tuple(out)}")
            out[dim] += s[dim]
            filled.append(s)
        return filled, [tuple(out)], []

    def fwd(self, ins, aux, is_train, rng):
        return [torch.cat(ins, dim=self.dim)], []


@register_op("SliceChannel")
class SliceChannelOp(OpProp):
    """Split along ``axis`` into ``num_outputs`` equal parts."""

    params = {
        "num_outputs": (Range(int, lo=1), REQUIRED, "number of output splits"),
        "axis": (int, 1, "axis to split along (extension; reference fixes 1)"),
        "squeeze_axis": (bool, False, "remove the split axis if it becomes 1"),
    }

    def _n(self):
        # the param name collides with OpProp.num_outputs(); read the attr
        return self.attr["num_outputs"]

    def list_outputs(self):
        return [f"output{i}" for i in range(self._n())]

    def infer_shape(self, in_shapes):
        d = list(self._known(in_shapes, 0))
        ax = self.axis
        if d[ax] % self._n() != 0:
            raise MXNetError(
                f"SliceChannel: dim {d[ax]} not divisible by {self._n()}")
        d[ax] //= self._n()
        if self.squeeze_axis:
            if d[ax] != 1:
                raise MXNetError(
                    "SliceChannel: squeeze_axis requires axis size == "
                    f"num_outputs, got {d[ax] * self._n()} / {self._n()}")
            out = tuple(d[:ax] + d[ax + 1:])
        else:
            out = tuple(d)
        return [tuple(self._known(in_shapes, 0))], [out] * self._n(), []

    def fwd(self, ins, aux, is_train, rng):
        parts = torch.chunk(ins[0], self._n(), dim=self.axis)
        if self.squeeze_axis:
            parts = [p.squeeze(self.axis) for p in parts]
        return list(parts), []


@register_op("Reshape")
class ReshapeOp(OpProp):
    """Reshape to ``target_shape`` (first dim 0 keeps the batch dim, -1
    infers)."""

    params = {"target_shape": ((lambda v: v), REQUIRED, "new shape")}

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        ts = self.attr["target_shape"]
        if isinstance(ts, str):
            ts = ast.literal_eval(ts)
        self.attr["target_shape"] = tuple(int(x) for x in ts)

    def _resolve(self, in_shape):
        ts = list(self.target_shape)
        if ts and ts[0] == 0:
            ts[0] = in_shape[0]
        size = 1
        for d in in_shape:
            size *= d
        if -1 in ts:
            i = ts.index(-1)
            rest = 1
            for d in ts[:i] + ts[i + 1:]:
                rest *= d
            ts[i] = size // rest
        return tuple(ts)

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        return [d], [self._resolve(d)], []

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0].reshape(self._resolve(tuple(ins[0].shape)))], []


@register_op("Flatten")
class FlattenOp(OpProp):
    """Collapse all dims after the first."""

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        flat = 1
        for x in d[1:]:
            flat *= x
        return [d], [(d[0], flat)], []

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        return [x.reshape(x.shape[0], -1)], []


@register_op("BlockGrad")
class BlockGradOp(OpProp):
    """Identity forward, zero gradient (``lax.stop_gradient`` in the JAX
    package): the output is detached from the graph."""

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0].detach()], []


@register_op("Transpose")
class TransposeOp(OpProp):
    """Transpose by ``axes`` (default: reverse the dims)."""

    params = {"axes": (lambda v: v, None, "permutation, default reverse")}

    def _axes(self, ndim):
        axes = self.attr["axes"]
        if axes is None:
            return tuple(reversed(range(ndim)))
        if isinstance(axes, str):
            axes = ast.literal_eval(axes)
        return tuple(int(a) for a in axes)

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        axes = self._axes(len(d))
        return [d], [tuple(d[a] for a in axes)], []

    def fwd(self, ins, aux, is_train, rng):
        return [ins[0].permute(self._axes(ins[0].ndim))], []


class _UnaryOp(OpProp):
    """Elementwise unary math (the reference's TBlob-registry ops)."""

    _fn = None

    def fwd(self, ins, aux, is_train, rng):
        return [type(self)._fn(ins[0])], []


@register_op("square")
class SquareOp(_UnaryOp):
    _fn = staticmethod(torch.square)


@register_op("sqrt")
class SqrtOp(_UnaryOp):
    _fn = staticmethod(torch.sqrt)


@register_op("exp")
class ExpOp(_UnaryOp):
    _fn = staticmethod(torch.exp)


@register_op("log")
class LogOp(_UnaryOp):
    _fn = staticmethod(torch.log)


@register_op("abs")
class AbsOp(_UnaryOp):
    _fn = staticmethod(torch.abs)


@register_op("norm")
class NormOp(OpProp):
    """L2 norm of the whole input, as a length-1 vector: ``sqrt(sum(x²))``
    in the input's dtype, as the JAX package computes it."""

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        return [d], [(1,)], []

    def fwd(self, ins, aux, is_train, rng):
        return [torch.sqrt(torch.sum(torch.square(ins[0]))).reshape(1)], []


@register_op("Embedding")
class EmbeddingOp(OpProp):
    """Token embedding lookup: rows of ``weight`` (input_dim, output_dim)
    gathered by ``data`` taken as int32 token ids (fractional ids truncate
    toward zero, as ``astype(int32)`` does). Repeated ids add their
    gradients into the same row."""

    params = {
        "input_dim": (Range(int, lo=1), REQUIRED, "vocabulary size"),
        "output_dim": (Range(int, lo=1), REQUIRED, "embedding dimension"),
    }

    def list_arguments(self):
        return ["data", "weight"]

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        w = (self.input_dim, self.output_dim)
        return [d, w], [d + (self.output_dim,)], []

    def infer_dtype(self, in_dtypes):
        # heterogeneous: integer token ids, and an output in the table's
        # float dtype (mxnet_tpu/ops/tensor.py:328-336)
        data, weight = in_dtypes
        w = as_dtype(weight) if weight is not None else np.dtype("float32")
        d = as_dtype(data) if data is not None else np.dtype("int32")
        return [d, w], [w], []

    def fwd(self, ins, aux, is_train, rng):
        data, weight = ins
        ids = data.to(torch.int32).long()
        return [torch.nn.functional.embedding(ids, weight)], []
