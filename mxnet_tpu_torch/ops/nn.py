"""Neural-network layer operators.

Counterpart of ``mxnet_tpu/ops/nn.py`` for FullyConnected (with its int8
serving route), Convolution, Deconvolution, Pooling, Activation,
LeakyReLU, Dropout, BatchNorm and LRN, including BatchNorm's fused ReLU
and fused add+ReLU forms that the executor's fusion plan selects. Parameters, shape rules and weight layouts
(OIHW in both activation layouts) are the JAX package's, so checkpoints and
serialised graphs map 1:1. Dense work goes to torch (cuBLAS and cuDNN on the
card); the int8 matmul goes to this package's own kernel. FullyConnected,
Convolution, Deconvolution, Pooling, Activation, LeakyReLU and LRN get
their gradients from autograd;
BatchNorm's training forms carry the JAX package's hand-written backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..kernels.int8_matmul import (QuantizedWeight, int8_matmul,
                                   int8_predict_active)
from .registry import (OpProp, Range, REQUIRED, TupleParam, draw,
                       register_op)


@register_op("FullyConnected")
class FullyConnectedOp(OpProp):
    """Affine layer: Y = X·Wᵀ + b, weight layout (num_hidden, input_dim).

    Under :func:`int8_predict_scope` (armed by ``Predictor(quantize="int8")``)
    the matmul runs the int8 kernel with per-channel weight scales. The
    weight may then arrive already quantized as a :class:`QuantizedWeight`.
    """

    params = {
        "num_hidden": (Range(int, lo=1), REQUIRED, "number of output units"),
        "no_bias": (bool, False, "omit the bias term"),
    }

    def list_arguments(self):
        return ["data", "weight"] if self.no_bias else ["data", "weight", "bias"]

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        in_dim = 1
        for x in d[1:]:
            in_dim *= x
        shapes = [d, (self.num_hidden, in_dim)]
        if not self.no_bias:
            shapes.append((self.num_hidden,))
        return shapes, [(d[0], self.num_hidden)], []

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        x = x.reshape(x.shape[0], -1)
        w = ins[1]
        if int8_predict_active():
            xf = x.float().contiguous()
            y = (int8_matmul(xf, w.wq, w_scale=w.scale)
                 if isinstance(w, QuantizedWeight)
                 else int8_matmul(xf, w)).to(x.dtype)
        else:
            y = torch.matmul(x, w.to(x.dtype).t())
        if not self.no_bias:
            y = y + ins[2].to(x.dtype)
        return [y], []


def at_least_f32(x):
    """``x`` in the type that sums and statistics are taken in: float32, or
    float64 for a float64 input (the JAX package, without x64, has no such
    input; the port takes one for a double-precision reference)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


@register_op("Convolution")
class ConvolutionOp(OpProp):
    """2-D convolution. Weights are OIHW in both layouts; ``layout`` only
    changes the activation layout."""

    params = {
        "kernel": (TupleParam(2), REQUIRED, "kernel (h, w)"),
        "stride": (TupleParam(2), (1, 1), "stride (h, w)"),
        "pad": (TupleParam(2), (0, 0), "zero-padding (h, w)"),
        "dilate": (TupleParam(2), (1, 1), "dilation (h, w) (extension)"),
        "num_filter": (Range(int, lo=1), REQUIRED, "number of output channels"),
        "num_group": (Range(int, lo=1), 1, "grouped-convolution group count"),
        "no_bias": (bool, False, "omit the bias term"),
        "workspace": (int, 512, "accepted for parity; cuDNN manages scratch"),
        "layout": (("NCHW", "NHWC"), "NCHW", "activation layout"),
    }

    def list_arguments(self):
        return ["data", "weight"] if self.no_bias else ["data", "weight", "bias"]

    def _out_hw(self, h, w):
        kh, kw = self.kernel
        sh, sw = self.stride
        ph, pw = self.pad
        dh, dw = self.dilate
        eh, ew = dh * (kh - 1) + 1, dw * (kw - 1) + 1
        return (h + 2 * ph - eh) // sh + 1, (w + 2 * pw - ew) // sw + 1

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        if len(d) != 4:
            raise MXNetError(f"Convolution expects 4-D input, got {d}")
        if self.layout == "NHWC":
            n, h, w, c = d
        else:
            n, c, h, w = d
        if c % self.num_group or self.num_filter % self.num_group:
            raise MXNetError("Convolution: channels not divisible by num_group")
        wshape = (self.num_filter, c // self.num_group) + self.kernel
        oh, ow = self._out_hw(h, w)
        out = (n, oh, ow, self.num_filter) if self.layout == "NHWC" else \
            (n, self.num_filter, oh, ow)
        shapes = [d, wshape] + ([] if self.no_bias else [(self.num_filter,)])
        return shapes, [out], []

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        w = ins[1].to(x.dtype)
        nhwc = self.layout == "NHWC"
        if (nhwc and self.kernel == (1, 1) and self.pad == (0, 0)
                and self.dilate == (1, 1) and self.num_group == 1):
            # the JAX package lowers a pointwise NHWC conv as a strided
            # slice and a channel matmul (mxnet_tpu/ops/nn.py:141-155)
            sh, sw = self.stride
            y = torch.matmul(x[:, ::sh, ::sw, :], w[:, :, 0, 0].t())
        else:
            # an NHWC tensor permuted to NCHW is a channels-last view, which
            # cuDNN convolves in place; the output permutes back for free
            y = F.conv2d(_nhwc_to_nchw(x) if nhwc else x, w,
                         stride=self.stride, padding=self.pad,
                         dilation=self.dilate, groups=self.num_group)
            if nhwc:
                y = _nchw_to_nhwc(y)
        if not self.no_bias:
            bshape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
            y = y + ins[2].to(x.dtype).reshape(bshape)
        return [y], []


@register_op("Deconvolution")
class DeconvolutionOp(OpProp):
    """Transposed convolution. The weight is ``(channels, num_filter /
    num_group, kh, kw)``, which is ``conv_transpose2d``'s own layout, so
    cuDNN runs it as it is. ``adj`` (extra rows and columns at the bottom
    and right, each below the stride) and ``target_shape`` (the output's
    (h, w): ``pad = ceil(total / 2)``, ``adj = total % 2`` for ``total =
    stride * (in - 1) + kernel - target``) are the reference's later
    parameters, beyond the JAX package's; left at their defaults they are
    not serialised, so the JAX package loads the graph."""

    params = {
        "kernel": (TupleParam(2), REQUIRED, "kernel (h, w)"),
        "stride": (TupleParam(2), (1, 1), "stride (h, w)"),
        "pad": (TupleParam(2), (0, 0), "padding (h, w)"),
        "adj": (TupleParam(2), (0, 0), "extra output rows/columns (h, w)"),
        "target_shape": (TupleParam(2), (0, 0),
                         "output (h, w); (0, 0) = from pad and adj"),
        "num_filter": (Range(int, lo=1), REQUIRED, "number of output channels"),
        "num_group": (Range(int, lo=1), 1, "group count"),
        "no_bias": (bool, True, "omit the bias term"),
        "workspace": (int, 512, "accepted for parity"),
        "layout": (("NCHW", "NHWC"), "NCHW", "activation layout"),
    }
    _EXTENSIONS = ("adj", "target_shape")

    def list_arguments(self):
        return ["data", "weight"] if self.no_bias else ["data", "weight", "bias"]

    def _pad_adj(self, h, w):
        """(pad, adj) for an input of spatial size (h, w)."""
        if self.target_shape == (0, 0):
            return self.pad, self.adj
        pad, adj = [], []
        for size, k, s, t in zip((h, w), self.kernel, self.stride,
                                 self.target_shape):
            total = s * (size - 1) + k - t
            if total < 0:
                raise MXNetError(f"Deconvolution: target_shape {t} exceeds "
                                 f"the full output {s * (size - 1) + k}")
            pad.append((total + 1) // 2)
            adj.append(total % 2)
        return tuple(pad), tuple(adj)

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        if len(d) != 4:
            raise MXNetError(f"Deconvolution expects 4-D input, got {d}")
        n, h, w, c = d if self.layout == "NHWC" else (d[0], d[2], d[3], d[1])
        if c % self.num_group or self.num_filter % self.num_group:
            raise MXNetError(
                "Deconvolution: channels not divisible by num_group")
        pad, adj = self._pad_adj(h, w)
        if any(a >= s for a, s in zip(adj, self.stride)):
            raise MXNetError(f"Deconvolution: adj {adj} must be below the "
                             f"stride {self.stride}")
        oh, ow = (s * (size - 1) + k - 2 * p + a for size, k, s, p, a in
                  zip((h, w), self.kernel, self.stride, pad, adj))
        wshape = (c, self.num_filter // self.num_group) + self.kernel
        out = (n, oh, ow, self.num_filter) if self.layout == "NHWC" else \
            (n, self.num_filter, oh, ow)
        shapes = [d, wshape] + ([] if self.no_bias else [(self.num_filter,)])
        return shapes, [out], []

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        nhwc = self.layout == "NHWC"
        xc = _nhwc_to_nchw(x) if nhwc else x
        pad, adj = self._pad_adj(xc.shape[2], xc.shape[3])
        y = F.conv_transpose2d(xc, ins[1].to(x.dtype), stride=self.stride,
                               padding=pad, output_padding=adj,
                               groups=self.num_group)
        if nhwc:
            y = _nchw_to_nhwc(y)
        if not self.no_bias:
            bshape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
            y = y + ins[2].to(x.dtype).reshape(bshape)
        return [y], []

    def serialize_params(self) -> dict:
        out = super().serialize_params()
        for key in self._EXTENSIONS:
            if self.attr[key] == (0, 0):
                del out[key]
        return out


@register_op("Pooling")
class PoolingOp(OpProp):
    """Max/avg/sum pooling, NCHW or NHWC per ``layout``, with floor output
    size. Avg divides by the kernel area, padding included."""

    params = {
        "kernel": (TupleParam(2), REQUIRED, "pooling window (h, w)"),
        "stride": (TupleParam(2), (1, 1), "stride (h, w)"),
        "pad": (TupleParam(2), (0, 0), "padding (h, w)"),
        "pool_type": (("max", "avg", "sum"), "max", "pooling reduction"),
        "global_pool": (bool, False, "pool over the full spatial extent"),
        "layout": (("NCHW", "NHWC"), "NCHW", "activation layout"),
    }

    def _dims(self, h, w):
        if self.global_pool:
            return 1, 1
        kh, kw = self.kernel
        sh, sw = self.stride
        ph, pw = self.pad
        oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
        if oh < 1 or ow < 1:
            raise MXNetError(
                f"Pooling: kernel {self.kernel} with pad {self.pad} exceeds "
                f"the input spatial extent ({h}, {w}); use global_pool=True "
                f"for whole-feature-map pooling")
        return oh, ow

    def _spatial(self):
        return (1, 2) if self.layout == "NHWC" else (2, 3)

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        sh, sw = self._spatial()
        oh, ow = self._dims(d[sh], d[sw])
        out = list(d)
        out[sh], out[sw] = oh, ow
        return [d], [tuple(out)], []

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        sdims = self._spatial()
        if self.global_pool:
            if self.pool_type == "max":
                y = torch.amax(x, dim=sdims, keepdim=True)
            else:
                y = torch.sum(at_least_f32(x), dim=sdims, keepdim=True)
                if self.pool_type == "avg":
                    y = y / (x.shape[sdims[0]] * x.shape[sdims[1]])
            return [y.to(x.dtype)], []
        nhwc = self.layout == "NHWC"
        xc = _nhwc_to_nchw(x) if nhwc else x
        kernel, stride, pad = self.kernel, self.stride, self.pad
        if pad[0] > kernel[0] // 2 or pad[1] > kernel[1] // 2:
            # torch's pooling takes at most half the kernel as implicit
            # padding; pad explicitly with the reduction's identity
            fill = float("-inf") if self.pool_type == "max" else 0.0
            xc = F.pad(xc, (pad[1], pad[1], pad[0], pad[0]), value=fill)
            pad = (0, 0)
        if self.pool_type == "max":
            y = F.max_pool2d(xc, kernel, stride, pad)
        else:
            # count_include_pad: the divisor is the kernel area (or 1 for sum)
            y = F.avg_pool2d(xc, kernel, stride, pad, count_include_pad=True,
                             divisor_override=1 if self.pool_type == "sum"
                             else None)
        if nhwc:
            y = _nchw_to_nhwc(y)
        return [y.to(x.dtype)], []


@register_op("Activation")
class ActivationOp(OpProp):
    """Elementwise activations."""

    params = {
        "act_type": (("relu", "sigmoid", "tanh", "softrelu"), REQUIRED,
                     "activation kind")
    }

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        if self.act_type == "relu":
            return [torch.relu(x)], []
        if self.act_type == "sigmoid":
            return [torch.sigmoid(x)], []
        if self.act_type == "tanh":
            return [torch.tanh(x)], []
        # softrelu = log(1 + exp(x)), without softplus's linear cut-over
        return [torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))], []


@register_op("LeakyReLU")
class LeakyReLUOp(OpProp):
    """Leaky, parametric, exponential and randomized rectifiers:
    ``where(x > 0, x, slope * x)`` (``leaky``), ``slope * (exp(x) - 1)``
    below zero (``elu``), a learned per-channel ``gamma`` over axis 1
    (``prelu``), and in training a slope per element drawn uniformly from
    ``[lower_bound, upper_bound)`` out of ``rng`` (``rrelu``; its mean
    slope at inference; torch and JAX draw different slopes)."""

    params = {
        "act_type": (("leaky", "prelu", "rrelu", "elu"), "leaky", "variant"),
        "slope": (float, 0.25, "negative slope (leaky/elu)"),
        "lower_bound": (float, 0.125, "rrelu slope lower bound"),
        "upper_bound": (float, 0.334, "rrelu slope upper bound"),
    }
    need_rng = True

    def list_arguments(self):
        return ["data", "gamma"] if self.act_type == "prelu" else ["data"]

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        if self.act_type == "prelu":
            return [d, (d[1],)], [d], []
        return [d], [d], []

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        if self.act_type == "leaky":
            neg = self.slope * x
        elif self.act_type == "elu":
            neg = self.slope * (torch.exp(x) - 1.0)
        elif self.act_type == "prelu":
            neg = ins[1].to(x.dtype).reshape((1, -1) + (1,) * (x.ndim - 2)) * x
        elif is_train:
            lo, hi = self.lower_bound, self.upper_bound
            slope = draw(x.shape, rng, x.device,
                         lambda u: (lo + (hi - lo) * u).to(x.dtype))
            neg = slope * x
        else:
            neg = (self.lower_bound + self.upper_bound) / 2.0 * x
        return [torch.where(x > 0, x, neg)], []


@register_op("Dropout")
class DropoutOp(OpProp):
    """Inverted dropout: at training time each unit is kept with
    probability ``1 - p`` and scaled by ``1 / (1 - p)``; identity at
    inference. The mask is drawn from ``rng``, the executor's generator
    (torch and JAX draw different bits from the same seed)."""

    params = {"p": (Range(float, lo=0.0, hi=1.0, hi_exclusive=True), 0.5,
                    "fraction of units to drop")}
    need_rng = True

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        if not is_train or self.p <= 0.0:
            return [x], []
        keep = 1.0 - self.p
        mask = draw(x.shape, rng, x.device, lambda u: u < keep)
        return [torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))], []


def _bn_reduce_axes(ndim, ch):
    return tuple(i for i in range(ndim) if i != ch)


def _bn_bshape(ndim, ch):
    return tuple(-1 if i == ch else 1 for i in range(ndim))


# BatchNorm's statistics over the rows of every rank: the process group
# ``[group]`` (None: the world) while a data-parallel step without
# compression runs (``batch_statistics_over``), else None
_RANK_STATS = [None]


class batch_statistics_over:
    """While the block runs, a training BatchNorm normalises over the batch
    rows of every rank of ``group`` (None: the world), as the JAX
    package's partitioned step over a mesh of processes does: its per
    channel sums are summed over the ranks in the forward, and so are the
    sums its backward reduces (the gradients of gamma and beta stay this
    rank's share, which the gradient exchange sums). Set for the whole of
    a step, forward and backward, since autograd may run the backward (and
    a remat recompute) on a thread of its own; every rank must run the
    same BatchNorms in the same order."""

    def __init__(self, group=None):
        self.group = [group]

    def __enter__(self):
        self._prev, _RANK_STATS[0] = _RANK_STATS[0], self.group
        return self

    def __exit__(self, *exc):
        _RANK_STATS[0] = self._prev
        return False


def _over_ranks(sums, n, group):
    """Per-channel sums (a tuple of tensors) and the row count ``n``
    summed over the ranks of ``group[0]`` in one collective."""
    from ..comm.allreduce import all_reduce_sum
    import torch.distributed as dist

    total = all_reduce_sum(torch.stack(sums), group[0])
    return tuple(total.unbind(0)), n * dist.get_world_size(group[0])


def _bn_stats(x, eps, ch, group=None):
    """One-pass batch statistics in f32 (mxnet_tpu/ops/nn.py:425-443):
    ``var = max(E[x²] - mean², 0)`` and ``inv = rsqrt(var + eps)``. Neither
    ``torch.var`` nor cuDNN's batch norm, which round differently. With
    ``group`` (``[process group]``) the sums are over every rank's rows."""
    axes = _bn_reduce_axes(x.ndim, ch)
    n = x.numel() // x.shape[ch]
    xf = at_least_f32(x)
    s1 = torch.sum(xf, dim=axes)
    s2 = torch.sum(xf * xf, dim=axes)
    if group is not None:
        (s1, s2), n = _over_ranks((s1, s2), n, group)
    mean = s1 / n
    var = torch.clamp_min(s2 / n - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def _bn_affine(x, g, b, mean, inv, ch):
    """y = x·scale + shift with per-channel f32 scalars, applied in x.dtype,
    in the JAX package's order (mxnet_tpu/ops/nn.py:446-453). Forward and
    backward share it, so the recomputed ReLU mask is the forward's."""
    bshape = _bn_bshape(x.ndim, ch)
    scale = g * inv
    shift = b - mean * scale
    return x * scale.reshape(bshape).to(x.dtype) + \
        shift.reshape(bshape).to(x.dtype)


def _bn_core_bwd(x, g, mean, inv, dy, ch, group=None):
    """BatchNorm's backward given the (already masked) cotangent, in the
    JAX package's order (mxnet_tpu/ops/nn.py:464-482): per-channel sums in
    f32, ``dx = g·inv · (dy - Σdy/n - x̂·Σ(dy·x̂)/n)`` elementwise in
    dy.dtype. Returns (dx, dgamma, dbeta). With ``group`` the sums in dx
    are over every rank's rows; dgamma and dbeta stay this rank's."""
    axes = _bn_reduce_axes(x.ndim, ch)
    n = x.numel() // x.shape[ch]
    bshape = _bn_bshape(x.ndim, ch)
    mean_b, inv_b = mean.reshape(bshape), inv.reshape(bshape)
    xhat_f = (at_least_f32(x) - mean_b) * inv_b
    xhat = xhat_f if x.dtype == xhat_f.dtype else \
        (x - mean_b.to(x.dtype)) * inv_b.to(x.dtype)
    dyf = at_least_f32(dy)
    dbeta = torch.sum(dyf, dim=axes)
    dgamma = torch.sum(dyf * xhat_f, dim=axes)
    sb, sg = dbeta, dgamma
    if group is not None:
        (sb, sg), n = _over_ranks((dbeta, dgamma), n, group)
    k = (g * inv).reshape(bshape).to(dy.dtype)
    dx = k * (dy - (sb / n).reshape(bshape).to(dy.dtype)
              - xhat * (sg / n).reshape(bshape).to(dy.dtype))
    return dx.to(x.dtype), dgamma, dbeta


class _BnActTrain(torch.autograd.Function):
    """Training BatchNorm, optionally + ReLU, with the JAX package's
    hand-written backward (``_bn_act_train``, mxnet_tpu/ops/nn.py:401-496).
    Saved tensors are (x, g, b, mean, inv): the input, already live as the
    conv output, and per-channel vectors. With ``relu`` the mask is
    recomputed in backward from the forward's exact expression, so the BN
    output is never saved. Returns (y, mean, var); mean and var feed the
    running stats and carry no gradient."""

    @staticmethod
    def forward(ctx, x, g, b, eps, ch, relu, group=None):
        mean, var, inv = _bn_stats(x, eps, ch, group)
        y = _bn_affine(x, g, b, mean, inv, ch)
        if relu:
            y = torch.relu(y)
        ctx.save_for_backward(x, g, b, mean, inv)
        ctx.ch, ctx.relu, ctx.group = ch, relu, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g, b, mean, inv = ctx.saved_tensors
        if ctx.relu:
            dy = torch.where(_bn_affine(x, g, b, mean, inv, ctx.ch) > 0, dy,
                             torch.zeros((), dtype=dy.dtype, device=dy.device))
        dx, dgamma, dbeta = _bn_core_bwd(x, g, mean, inv, dy, ctx.ch,
                                         ctx.group)
        return dx, dgamma, dbeta, None, None, None, None


class _BnAddReluTrain(torch.autograd.Function):
    """Training BatchNorm + residual add + ReLU (``_bn_add_relu_train``,
    mxnet_tpu/ops/nn.py:499-525). Saved: (x, g, b, z, mean, inv); the
    block output is not saved and the mask is recomputed."""

    @staticmethod
    def forward(ctx, x, g, b, z, eps, ch, group=None):
        mean, var, inv = _bn_stats(x, eps, ch, group)
        y = torch.relu(_bn_affine(x, g, b, mean, inv, ch) + z)
        ctx.save_for_backward(x, g, b, z, mean, inv)
        ctx.ch, ctx.group = ch, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, g, b, z, mean, inv = ctx.saved_tensors
        pre = _bn_affine(x, g, b, mean, inv, ctx.ch) + z  # the forward's
        dy = torch.where(pre > 0, dy,
                         torch.zeros((), dtype=dy.dtype, device=dy.device))
        dx, dgamma, dbeta = _bn_core_bwd(x, g, mean, inv, dy, ctx.ch,
                                         ctx.group)
        return dx, dgamma, dbeta, dy.to(z.dtype), None, None, None


@register_op("BatchNorm")
class BatchNormOp(OpProp):
    """Batch normalisation with running-stat auxiliary states.

    Train: normalise by the batch statistics and update the running stats in
    f32, ``momentum * moving + (1 - momentum) * batch``, detached. Eval:
    normalise by the running stats. Gamma/beta are per-channel (``axis``;
    last axis for 2-D inputs). ``fix_gamma`` uses 1 for gamma, which then
    gets no gradient. Inside :class:`batch_statistics_over` the training
    statistics are those of every rank's rows."""

    params = {
        "eps": (Range(float, lo=0.0), 1e-3, "numerical stability constant"),
        "momentum": (Range(float, lo=0.0, hi=1.0), 0.9, "running-average decay"),
        "fix_gamma": (bool, False, "freeze gamma at 1"),
        "axis": (int, 1, "channel axis (1 for NCHW, -1/3 for NHWC)"),
    }

    def list_arguments(self):
        return ["data", "gamma", "beta"]

    def list_auxiliary_states(self):
        return ["moving_mean", "moving_var"]

    def _channels(self, d):
        if len(d) < 2:
            return d[0]
        return d[self.axis % len(d)]

    def infer_shape(self, in_shapes):
        d = self._known(in_shapes, 0)
        c = (self._channels(d),)
        return [d, c, c], [d], [c, c]

    def fwd(self, ins, aux, is_train, rng):
        return self._fwd_impl(ins, aux, is_train, relu=False)

    def fwd_fused_relu(self, ins, aux, is_train, rng):
        """BatchNorm + ReLU, for BatchNorm -> Activation(relu) chains."""
        return self._fwd_impl(ins, aux, is_train, relu=True)

    def fwd_fused_add_relu(self, ins, aux, is_train, rng):
        """BatchNorm + residual add + ReLU; ``ins`` is [x, gamma, beta, z]
        with z the shortcut operand."""
        return self._fwd_impl(ins[:3], aux, is_train, relu=True, z=ins[3])

    def _fwd_impl(self, ins, aux, is_train, relu, z=None):
        x, gamma, beta = ins
        moving_mean, moving_var = aux
        ch = 1 if x.ndim == 2 else self.axis % x.ndim
        g = at_least_f32(torch.ones_like(gamma) if self.fix_gamma else gamma)
        b = at_least_f32(beta)
        if is_train:
            group = _RANK_STATS[0]
            if z is not None:
                y, mean, var = _BnAddReluTrain.apply(x, g, b, z, self.eps, ch,
                                                     group)
            else:
                y, mean, var = _BnActTrain.apply(x, g, b, self.eps, ch, relu,
                                                 group)
            m = self.momentum
            new_mean = m * moving_mean + (1 - m) * mean
            new_var = m * moving_var + (1 - m) * var
            return [y], [new_mean.detach(), new_var.detach()]
        inv = torch.rsqrt(moving_var + self.eps)
        y = _bn_affine(x, g, b, moving_mean, inv, ch)
        if z is not None:
            y = y + z
        if relu:
            y = torch.relu(y)
        return [y], [moving_mean, moving_var]


@register_op("LRN")
class LRNOp(OpProp):
    """Local response normalisation across channels (axis 1):
    ``y = x * (knorm + alpha / nsize * sum_window x²) ** -beta``, the window
    sum in f32 over channels ``[c - half, c + nsize - 1 - half]`` (zero
    outside), ``half = nsize // 2``, and the result in ``x.dtype``."""

    params = {
        "nsize": (Range(int, lo=1), REQUIRED, "normalization window (channels)"),
        "alpha": (float, 1e-4, "scale"),
        "beta": (float, 0.75, "exponent"),
        "knorm": (float, 2.0, "additive constant"),
    }

    def fwd(self, ins, aux, is_train, rng):
        x = ins[0]
        xf = at_least_f32(x)
        half = self.nsize // 2
        sq = torch.square(xf)
        # F.pad pads the last dims first: channels are axis 1 of a 4-D input
        pads = (0, 0) * (x.ndim - 2) + (half, self.nsize - 1 - half)
        ssum = F.pad(sq, pads).unfold(1, self.nsize, 1).sum(dim=-1)
        y = xf * torch.pow(self.knorm + (self.alpha / self.nsize) * ssum,
                           -self.beta)
        return [y.to(x.dtype)], []
