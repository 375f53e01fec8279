"""Training callbacks (the JAX package's ``callback.py``: the same hook
signatures and log formats).

Epoch-end hooks receive ``(epoch, symbol, arg_params, aux_params)``;
batch-end hooks receive a ``BatchEndParam`` with ``epoch nbatch
eval_metric``.
"""

from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "module_checkpoint"]


def _every(period):
    period = int(max(1, period))
    return lambda iter_no: (iter_no + 1) % period == 0


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Checkpoint the module every ``period`` epochs."""
    due = _every(period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if due(iter_no):
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def do_checkpoint(prefix, period=1):
    """Checkpoint the parameters every ``period`` epochs."""
    from .model import save_checkpoint

    due = _every(period)

    def _callback(iter_no, sym, arg, aux):
        if due(iter_no):
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Log the running metric every ``period`` batches."""

    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer(object):
    """Log throughput in samples/sec every ``frequent`` batches.

    Implementation: a sliding window anchored at the last emission; the
    anchor resets whenever the batch counter goes backwards (new epoch).
    """

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self._anchor = None   # (wall time, batch count) of last emission
        self._prev_count = -1

    def __call__(self, param):
        count = param.nbatch
        if count < self._prev_count or self._anchor is None:
            self._anchor = (time.time(), count)
            self._prev_count = count
            return
        self._prev_count = count
        if count % self.frequent:
            return
        t0, c0 = self._anchor
        elapsed = time.time() - t0
        if elapsed <= 0 or count == c0:
            return
        speed = (count - c0) * self.batch_size / elapsed
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            metric.reset()
            for name, value in pairs:
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t"
                    "Train-%s=%f", param.epoch, count, speed, name, value)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        self._anchor = (time.time(), count)
