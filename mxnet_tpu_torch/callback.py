"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py``: ``do_checkpoint``,
``log_train_metric``, ``Speedometer`` and ``ProgressBar``. Epoch callbacks get
``(epoch, symbol, arg_params, aux_params)``; batch callbacks get a
``BatchEndParam``.
"""

from __future__ import annotations

import logging
import sys
import time
from collections import namedtuple

__all__ = ["BatchEndParam", "do_checkpoint", "Speedometer", "ProgressBar",
           "log_train_metric"]

BatchEndParam = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric"])


def do_checkpoint(prefix):
    """Epoch-end callback saving ``prefix-symbol.json`` and
    ``prefix-%04d.params`` (epoch numbers from 1)."""

    def _callback(epoch, sym, arg_params, aux_params):
        from .model import save_checkpoint

        save_checkpoint(prefix, epoch + 1, sym, arg_params, aux_params)

    return _callback


def log_train_metric(period):
    """Batch-end callback logging the training metric every ``period``
    batches."""

    def _callback(param: BatchEndParam):
        if param.nbatch % period == 0:
            name, value = param.eval_metric.get()
            logging.info(
                "Iter[%d] Batch[%d] Train-%s=%f", param.epoch, param.nbatch, name, value
            )

    return _callback


class Speedometer:
    """Logs samples per second every ``frequent`` batches, on the host
    clock. A callback sees a batch once the host has queued its step; the
    card may still be working through earlier ones, so a window's rate
    converges to the card's only over many batches."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                     param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """A text progress bar of ``length`` characters over ``total`` batches,
    rewritten on standard output at every batch."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")
