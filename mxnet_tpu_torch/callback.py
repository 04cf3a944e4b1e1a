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
    converges to the card's only over many batches.

    Every reported window also lands as a ``samples_per_sec``
    gauge/histogram in the telemetry hub. A window in which a program was
    captured (the compile registry's count moved: the port's compile) is
    not reported as throughput: its seconds go to
    ``badput_compile_seconds_total`` and the clock restarts
    (mxnet_tpu/callback.py:78-110)."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0.0
        self.last_count = 0
        self._compile_snap = None

    def _compiles_in_window(self):
        """(compiles_delta, compile_seconds_delta) since the last call;
        updates the snapshot."""
        from .utils import compile as compile_mod

        snap = compile_mod.registry().snapshot()
        prev = self._compile_snap or snap
        self._compile_snap = snap
        return (snap["compiles"] - prev["compiles"],
                snap["compile_seconds"] - prev["compile_seconds"])

    def __call__(self, param: BatchEndParam):
        from . import telemetry

        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if not self.init:
            self.init = True
            self._compiles_in_window()  # the registry's baseline
            self.tic = time.time()
            return
        if count % self.frequent != 0:
            return
        compiles, compile_s = self._compiles_in_window()
        if compiles:
            telemetry.record_compile_badput(
                self._compile_snap["compile_seconds"], compile_s,
                epoch=param.epoch)
            logging.info(
                "Iter[%d] Batch [%d]\tSpeed: (window skipped: %d "
                "compile(s), %.2fs — counted as badput/compile)",
                param.epoch, count, compiles, compile_s)
            self.tic = time.time()
            return
        speed = self.frequent * self.batch_size / (time.time() - self.tic)
        telemetry.gauge("samples_per_sec", speed)
        telemetry.observe("samples_per_sec_window", speed)
        logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                     param.epoch, count, speed)
        self.tic = time.time()


class ProgressBar:
    """A text progress bar of ``length`` characters over ``total`` batches,
    rewritten on standard output at every batch; mirrored into a telemetry
    ``epoch_progress_pct`` gauge."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param: BatchEndParam):
        from . import telemetry

        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        telemetry.gauge("epoch_progress_pct", percents, epoch=param.epoch)
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")
