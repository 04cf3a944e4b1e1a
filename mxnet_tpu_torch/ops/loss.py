"""Loss-head operators with the reference's injected gradients.

Counterpart of ``mxnet_tpu/ops/loss.py``. A loss head outputs its prediction
(the softmax in f32 for SoftmaxOutput, the identity or the sigmoid for the
regression heads), and its backward does not differentiate that output: it
injects the loss gradient (``p - onehot(label)`` scaled by ``grad_scale``;
``pred - label`` for the regression heads), ignores the incoming cotangent
and gives the label a zero gradient. Each is a ``torch.autograd.Function``,
as each is a ``jax.custom_vjp`` in the JAX package. The masked variants
(``fwd_masked``) multiply the injected gradient by a (batch,) row mask.
"""

from __future__ import annotations

import torch

from .nn import at_least_f32
from .registry import OpProp, register_op


def _softmax_axis(x, multi_output):
    return 1 if (multi_output or x.ndim > 2) else -1


def _softmax(x, axis):
    return torch.softmax(at_least_f32(x), dim=axis).to(x.dtype)


def _row_mask(mask, ndim):
    """(batch,) validity mask broadcast against a (batch, ...) gradient."""
    return mask.float().reshape(mask.shape + (1,) * (ndim - 1))


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax forward; backward ``(p - onehot) * grad_scale`` (times the
    row mask when one is given), mxnet_tpu/ops/loss.py:27-88."""

    @staticmethod
    def forward(ctx, data, label, mask, grad_scale, multi_output):
        out = _softmax(data, _softmax_axis(data, multi_output))
        ctx.save_for_backward(out, label, mask)
        ctx.grad_scale, ctx.multi_output = grad_scale, multi_output
        return out

    @staticmethod
    def backward(ctx, grad):
        del grad  # reference semantics: out_grad to a loss head is ignored
        out, label, mask = ctx.saved_tensors
        axis = _softmax_axis(out, ctx.multi_output)
        # a scatter, not F.one_hot, whose range check would sync with the card
        out_f = at_least_f32(out)
        onehot = torch.zeros_like(out_f)
        onehot.scatter_(axis, label.long().unsqueeze(axis), 1.0)
        d_data = (out_f - onehot) * ctx.grad_scale
        if mask is not None:
            # padded rows (mask 0) inject no gradient
            d_data = d_data * _row_mask(mask, d_data.ndim)
        return d_data.to(out.dtype), torch.zeros_like(label), None, None, None


@register_op("SoftmaxOutput", aliases=["Softmax"])
class SoftmaxOutputOp(OpProp):
    """Softmax forward, taken in f32 (axis 1 for multi_output or N-D data,
    else the last axis), with the cross-entropy gradient injected."""

    params = {
        "grad_scale": (float, 1.0, "multiplier applied to the injected gradient"),
        "multi_output": (bool, False, "softmax over axis 1 with per-position labels"),
    }
    is_loss = True
    supports_loss_mask = True

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        if self.multi_output or len(d) > 2:
            label = (d[0],) + tuple(d[2:])
        else:
            label = (d[0],)
        return [d, label], [d], []

    def fwd(self, ins, aux, is_train, rng):
        return self.fwd_masked(ins, aux, is_train, rng, None)

    def fwd_masked(self, ins, aux, is_train, rng, mask):
        return [_SoftmaxOutputFn.apply(ins[0], ins[1], mask, self.grad_scale,
                                       self.multi_output)], []

    def loss_value(self, out, label, mask=None):
        """Cross-entropy of the softmax output, the loss whose gradient the
        head injects: summed over (valid) rows and scaled like the injected
        gradient (mxnet_tpu/ops/loss.py:122-135)."""
        p = out.float()
        idx = label.long()
        nll = -torch.log(torch.gather(p, 1, idx[:, None])[:, 0] + 1e-12)
        nll = nll.reshape(nll.shape[0], -1).sum(dim=1)
        if mask is not None:
            nll = nll * mask
        return nll.sum() * self.grad_scale


class _RegressionFn(torch.autograd.Function):
    """``transform(data)`` forward; backward ``grad_fn(out, label)`` times
    the row mask when one is given, label gradient zero
    (mxnet_tpu/ops/loss.py:138-178)."""

    @staticmethod
    def forward(ctx, data, label, mask, transform, grad_fn):
        out = transform(data)
        ctx.save_for_backward(out, label, mask)
        ctx.grad_fn = grad_fn
        return out

    @staticmethod
    def backward(ctx, grad):
        del grad
        out, label, mask = ctx.saved_tensors
        out_f = at_least_f32(out)
        d = ctx.grad_fn(out_f, label.to(out_f.dtype).reshape(out.shape))
        if mask is not None:
            d = d * _row_mask(mask, d.ndim)
        return d.to(out.dtype), torch.zeros_like(label), None, None, None


def _identity(x):
    return x


def _residual(o, label):
    return o - label


def _sign_residual(o, label):
    return torch.sign(o - label)


class _RegressionBase(OpProp):
    """A regression head. ``grad_scale`` scales ``loss_value`` only: the JAX
    package wraps the output in a gradient scaler whose cotangent the head's
    backward then discards (mxnet_tpu/ops/loss.py:147-151, 215-220), so the
    injected gradient is unscaled there, and here."""

    params = {"grad_scale": (float, 1.0, "gradient multiplier")}
    is_loss = True
    supports_loss_mask = True
    _transform = staticmethod(_identity)
    _grad_fn = staticmethod(_residual)

    def list_arguments(self):
        return ["data", "label"]

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        return [d, d], [d], []

    def fwd(self, ins, aux, is_train, rng):
        return self.fwd_masked(ins, aux, is_train, rng, None)

    def fwd_masked(self, ins, aux, is_train, rng, mask):
        return [_RegressionFn.apply(ins[0], ins[1], mask, type(self)._transform,
                                    type(self)._grad_fn)], []

    def loss_value(self, out, label, mask=None):
        o = out.float()
        e = self._loss_elem(o, label.float().reshape(out.shape))
        if mask is not None:
            e = e * _row_mask(mask, e.ndim)
        return e.sum() * self.grad_scale


@register_op("LinearRegressionOutput")
class LinearRegressionOutputOp(_RegressionBase):
    """Identity forward, (pred - label) gradient."""

    @staticmethod
    def _loss_elem(o, label):
        return 0.5 * torch.square(o - label)


@register_op("LogisticRegressionOutput")
class LogisticRegressionOutputOp(_RegressionBase):
    """Sigmoid forward, (pred - label) gradient."""

    _transform = staticmethod(torch.sigmoid)

    @staticmethod
    def _loss_elem(o, label):
        # out is already sigmoid(data); (o - label) is the BCE gradient
        return -(label * torch.log(o + 1e-12)
                 + (1.0 - label) * torch.log(1.0 - o + 1e-12))


@register_op("MAERegressionOutput")
class MAERegressionOutputOp(_RegressionBase):
    """Identity forward, sign(pred - label) gradient."""

    _grad_fn = staticmethod(_sign_residual)

    @staticmethod
    def _loss_elem(o, label):
        return torch.abs(o - label)
