"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``BatchEndParam``, ``Speedometer``, ``do_checkpoint`` (``module_checkpoint``),
``log_train_metric`` and ``ProgressBar``."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar",
           "module_checkpoint", "BatchEndParam"]


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class Speedometer:
    """Logs samples/s every ``frequent`` batches (``callback.py:22``)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    nv = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s"
                    logging.info(msg, param.epoch, count, speed,
                                 "\t".join("%s=%f" % kv for kv in nv))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-%04d.params`` every ``period`` epochs (``callback.py:58``)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    def _callback(param: BatchEndParam):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            nv = param.eval_metric.get_name_value()
            logging.info("Iter[%d] Batch[%d] Train-%s", param.epoch,
                         param.nbatch,
                         "\t".join("%s=%f" % kv for kv in nv))
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param: BatchEndParam):
        count = param.nbatch
        filled = int(round(self.bar_len * count / float(self.total)))
        pct = round(100.0 * count / float(self.total), 1)
        bar = "=" * filled + "-" * (self.bar_len - filled)
        logging.info("[%s] %s%s\r", bar, pct, "%")
