"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``, Accuracy,
TopKAccuracy, CrossEntropy, Perplexity, MAE, MSE, RMSE, CustomMetric,
CompositeEvalMetric, ``np_metric`` and ``create``. ``update(labels, preds)`` takes numpy
arrays or tensors and sums on the host. Metrics with ``device_supported``
also accumulate on the device: ``device_update`` folds a batch into a
(sum, count) pair of tensors without a host sync, and
``absorb_device_state`` pulls that pair once (per epoch, in
``FeedForward.fit``).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, Registry

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "CustomMetric",
           "CompositeEvalMetric", "np_metric", "create"]

METRICS = Registry("metric")


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


class EvalMetric:
    device_supported = False

    def __init__(self, name):
        self.name = name
        self.reset()

    def device_init(self, device):
        """A fresh on-device (sum, count) accumulator; the count is an
        integer, exact past 2^24."""
        return (torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def device_update(self, state, labels, preds):
        """Fold one batch into the device accumulator; returns the new
        state. No host sync."""
        raise NotImplementedError

    def device_key(self):
        """Identity of the ``device_update`` computation: the metric's type
        and hyperparameters (mxnet_tpu/metric.py:62-69)."""
        hyper = tuple(sorted(
            (k, repr(v)) for k, v in self.__dict__.items()
            if k not in ("name", "num_inst", "sum_metric")))
        return (type(self).__name__, hyper)

    def absorb_device_state(self, state):
        """Add a device accumulator into the host sums (one pull)."""
        s, n = state
        self.sum_metric += float(s)
        self.num_inst += int(n)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        return [(name, value)]

    def _as_lists(self, labels, preds):
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        if not isinstance(preds, (list, tuple)):
            preds = [preds]
        # preds may outnumber labels; pairs are zipped, extras ignored
        if len(labels) > len(preds):
            raise MXNetError(f"{self.name}: {len(labels)} labels vs {len(preds)} preds")
        return labels, preds[: len(labels)]


@METRICS.register("accuracy")
class Accuracy(EvalMetric):
    """Classification accuracy via argmax over the class axis."""

    device_supported = True

    def __init__(self):
        super().__init__("accuracy")

    def device_init(self, device):
        z = torch.zeros((), dtype=torch.int64, device=device)
        return (z, z.clone())

    def device_update(self, state, labels, preds):
        s, n = state
        for label, pred in zip(labels, preds[: len(labels)]):
            label = label.long().reshape(-1)
            if pred.ndim > 2:
                pred = pred.reshape(pred.shape[0], pred.shape[1], -1)
                hit = torch.argmax(pred, dim=1).reshape(-1) == label
            else:
                hit = torch.argmax(pred, dim=-1) == label
            s = s + hit.sum()
            n = n + label.numel()
        return (s, n)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int64).ravel()
            if pred.ndim > 2:
                pred = pred.reshape(pred.shape[0], pred.shape[1], -1)
                hit = (pred.argmax(axis=1).ravel() == label).sum()
                self.num_inst += label.size
            else:
                hit = (pred.argmax(axis=-1) == label).sum()
                self.num_inst += label.shape[0]
            self.sum_metric += float(hit)


@METRICS.register("top_k_accuracy")
class TopKAccuracy(EvalMetric):
    device_supported = True

    def __init__(self, top_k=5):
        self.top_k = top_k
        super().__init__(f"top_{top_k}_accuracy")

    def device_init(self, device):
        z = torch.zeros((), dtype=torch.int64, device=device)
        return (z, z.clone())

    def device_update(self, state, labels, preds):
        s, n = state
        for label, pred in zip(labels, preds[: len(labels)]):
            label = label.long().reshape(-1)
            topk = torch.topk(pred, self.top_k, dim=-1).indices
            s = s + (topk == label[:, None]).any(dim=1).sum()
            n = n + label.shape[0]
        return (s, n)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int64).ravel()
            topk = np.argsort(-pred, axis=-1)[:, : self.top_k]
            self.sum_metric += float((topk == label[:, None]).any(axis=1).sum())
            self.num_inst += label.shape[0]


def _batch_mean(err):
    return err.float().mean()


@METRICS.register("mae")
class MAE(EvalMetric):
    """Mean absolute error, averaged over batches."""

    device_supported = True

    def __init__(self):
        super().__init__("mae")

    def device_update(self, state, labels, preds):
        s, n = state
        for label, pred in zip(labels, preds[: len(labels)]):
            s = s + _batch_mean(torch.abs(label.reshape(pred.shape).float()
                                          - pred.float()))
            n = n + 1
        return (s, n)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            self.sum_metric += float(np.abs(label.reshape(pred.shape) - pred).mean())
            self.num_inst += 1


@METRICS.register("mse")
class MSE(EvalMetric):
    """Mean squared error, averaged over batches."""

    device_supported = True

    def __init__(self):
        super().__init__("mse")

    def device_update(self, state, labels, preds):
        s, n = state
        for label, pred in zip(labels, preds[: len(labels)]):
            s = s + _batch_mean((label.reshape(pred.shape).float()
                                 - pred.float()) ** 2)
            n = n + 1
        return (s, n)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2).mean())
            self.num_inst += 1


@METRICS.register("rmse")
class RMSE(EvalMetric):
    """Root mean squared error, averaged over batches (host only)."""

    def __init__(self):
        super().__init__("rmse")

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _to_numpy(label), _to_numpy(pred)
            self.sum_metric += float(np.sqrt(((label.reshape(pred.shape) - pred) ** 2).mean()))
            self.num_inst += 1


@METRICS.register("ce")
class CrossEntropy(EvalMetric):
    """Mean negative log-probability of the true class."""

    device_supported = True

    def __init__(self, eps=1e-8):
        self.eps = eps
        super().__init__("cross-entropy")

    def device_update(self, state, labels, preds):
        s, n = state
        for label, pred in zip(labels, preds[: len(labels)]):
            lab = label.long().reshape(-1)
            prob = pred.float()[torch.arange(lab.shape[0], device=lab.device), lab]
            s = s + torch.sum(-torch.log(prob + self.eps))
            n = n + lab.shape[0]
        return (s, n)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).astype(np.int64).ravel()
            pred = _to_numpy(pred)
            prob = pred[np.arange(label.shape[0]), label]
            self.sum_metric += float((-np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@METRICS.register("perplexity")
class Perplexity(EvalMetric):
    """``exp`` of the mean negative log-likelihood of the true class, each
    probability floored at ``eps``; labels equal to ``ignore_label`` are
    left out of both the sum and the count."""

    device_supported = True

    def __init__(self, ignore_label=None, eps=1e-10):
        self.ignore_label = ignore_label
        self.eps = eps
        super().__init__("perplexity")

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))

    def device_update(self, state, labels, preds):
        s, n = state
        for label, pred in zip(labels, preds[: len(labels)]):
            lab = label.long().reshape(-1)
            rows = torch.arange(lab.shape[0], device=lab.device)
            nll = -torch.log(torch.clamp_min(pred.float()[rows, lab],
                                             self.eps))
            if self.ignore_label is not None:
                keep = lab != self.ignore_label
                s = s + torch.where(keep, nll, torch.zeros_like(nll)).sum()
                n = n + keep.sum()
            else:
                s = s + nll.sum()
                n = n + lab.shape[0]
        return (s, n)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).astype(np.int64).ravel()
            pred = _to_numpy(pred)
            prob = pred[np.arange(label.shape[0]), label]
            nll = -np.log(np.maximum(prob, self.eps))
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                self.sum_metric += float(nll[keep].sum())
                self.num_inst += int(keep.sum())
            else:
                self.sum_metric += float(nll.sum())
                self.num_inst += label.shape[0]


class CustomMetric(EvalMetric):
    """Wrap ``feval(label, pred) -> float`` on numpy arrays."""

    def __init__(self, feval, name=None):
        name = name or getattr(feval, "__name__", "custom")
        if name.startswith("<"):
            name = "custom"
        self._feval = feval
        super().__init__(name)

    def update(self, labels, preds):
        labels, preds = self._as_lists(labels, preds)
        for label, pred in zip(labels, preds):
            self.sum_metric += float(self._feval(_to_numpy(label), _to_numpy(pred)))
            self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None):
        super().__init__("composite")
        self.metrics = list(metrics or [])

    def add(self, metric):
        self.metrics.append(metric)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)
        self.num_inst = 1

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values

    def get_name_value(self):
        return [m.get() for m in self.metrics]


def np_metric(numpy_feval):
    """A metric from ``numpy_feval(label, pred) -> float`` (reference:
    ``mx.metric.np``)."""
    return CustomMetric(numpy_feval)


def create(metric, **kwargs) -> EvalMetric:
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric)
    return METRICS.create(metric, **kwargs)
