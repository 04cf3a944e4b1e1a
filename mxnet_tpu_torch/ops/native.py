"""The ``_Native`` bridge: a user's numpy operator inside a graph.

Counterpart of ``mxnet_tpu/ops/native.py``. The JAX package runs the
user's numpy ``forward`` through ``jax.pure_callback`` and routes autodiff
to its numpy ``backward`` with a ``jax.custom_vjp``. Here one
``torch.autograd.Function`` does both: its forward copies the inputs to the
host as float32 numpy arrays, calls ``op.forward(in_data, out_data)`` and
copies the outputs back to the inputs' device; its backward does the same
with ``op.backward(out_grad, in_data, out_data, in_grad)``. On a CUDA tensor
each direction costs a copy each way and a wait for the card, the
counterpart of the callback's host round trip; a graph holding this node is
never captured into a CUDA graph (``executor.has_native``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import OpProp, register_op

__all__ = ["NativeOp"]


def _host(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().float().cpu().numpy(), np.float32)


class _NativeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, *ins):
        in_data = [_host(x) for x in ins]
        _, out_shapes = op.infer_shape([tuple(x.shape) for x in ins])
        out_data = [np.zeros(s, np.float32) for s in out_shapes]
        op.forward(in_data=in_data, out_data=out_data)
        device = ins[0].device
        outs = tuple(torch.from_numpy(np.ascontiguousarray(o, np.float32))
                     .to(device) for o in out_data)
        ctx.op, ctx.in_data, ctx.out_data = op, in_data, out_data
        ctx.device = device
        return outs

    @staticmethod
    def backward(ctx, *gs):
        out_grad = [_host(g) if g is not None else
                    np.zeros_like(o) for g, o in zip(gs, ctx.out_data)]
        in_grad = [np.zeros_like(x) for x in ctx.in_data]
        ctx.op.backward(out_grad=out_grad, in_data=ctx.in_data,
                        out_data=ctx.out_data, in_grad=in_grad)
        return (None,) + tuple(
            torch.from_numpy(np.ascontiguousarray(g, np.float32))
            .to(ctx.device) for g in in_grad)


@register_op("_Native")
class NativeOp(OpProp):
    """Wraps a Python object of the NumpyOp protocol (forward, backward,
    list_arguments, list_outputs, infer_shape)."""

    params = {
        "info": ((lambda v: v), None, "the python NumpyOp instance"),
        "need_top_grad": (bool, True, "whether backward consumes out_grad"),
    }

    def _op(self):
        op = self.attr["info"]
        if op is None:
            raise MXNetError("_Native op requires info= (a NumpyOp instance)")
        return op

    def list_arguments(self):
        return list(self._op().list_arguments())

    def list_outputs(self):
        return list(self._op().list_outputs())

    def infer_shape(self, in_shapes):
        # the user op receives the partial list and derives the rest (a loss
        # head infers its label shape from the data shape)
        known = [tuple(s) if s is not None else None for s in in_shapes]
        if known[0] is None:
            raise MXNetError("_Native: shape of the first input must be known")
        try:
            ins, outs = self._op().infer_shape(known)
        except MXNetError:
            raise
        except Exception as e:  # noqa: BLE001 - keep the op's name
            raise MXNetError(
                f"{type(self._op()).__name__}.infer_shape({known}) raised "
                f"{type(e).__name__}: {e}") from e
        if any(s is None for s in ins) or any(s is None for s in outs):
            raise MXNetError(
                f"{type(self._op()).__name__}.infer_shape left shapes "
                "unresolved")
        return [tuple(s) for s in ins], [tuple(s) for s in outs], []

    def fwd(self, ins, aux, is_train, rng):
        outs = _NativeFn.apply(self._op(), *[x.float() for x in ins])
        return list(outs), []

    def serialize_params(self):
        raise MXNetError("_Native ops hold live python objects and cannot be "
                         "serialized")
