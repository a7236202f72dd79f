"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches are ``cpu()`` NDArrays, which the training loop moves to its
context.  ``num_workers > 0`` runs the dataset's ``__getitem__`` and the
batchify function on that many threads, as the reference's loader does
(``dataloader.py:88-158``): at most ``prefetch`` batches (default twice
the workers) are asked for ahead of the one being read, and batches come
out in the sampler's order.  Decoding and augmentation (cv2, numpy, torch
on the CPU) release the GIL for most of their time.  The threads hold no
reference to the iterator: they stop, and are joined, when the epoch
ends, when a batch raises (the error reaches ``next()``), or when the
iterator is dropped.  ``pin_memory`` is accepted and ignored, as in the
reference: pinned staging needs ``cpu_pinned()`` (Queue 1 item 7).
"""
from __future__ import annotations

import queue
import threading
import weakref

import numpy as np
import torch

from ...context import cpu
from ...ndarray import ndarray as nd
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]

#: the name prefix of the worker threads
WORKER_NAME = "dataloader-worker"


def default_batchify_fn(data):
    """A batch from a list of samples: NDArrays stacked, tuples batched
    field by field, anything else through numpy; on ``cpu()``."""
    if isinstance(data[0], nd.NDArray):
        return nd.NDArray(torch.stack([d._data.detach().cpu()
                                       for d in data]), cpu())
    if isinstance(data[0], tuple):
        return [default_batchify_fn(list(field)) for field in zip(*data)]
    arr = np.asarray(data)
    return nd.array(arr, ctx=cpu(), dtype=arr.dtype)


class DataLoader:
    """Mini-batches of ``dataset``: from ``batch_sampler``, or from
    ``batch_size`` with ``shuffle``, ``sampler`` and ``last_batch``
    ("keep", "discard" or "rollover")."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch if last_batch else "keep")
        elif batch_size is not None or shuffle or sampler is not None \
                or last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        if self._num_workers == 0:
            return (self._batchify_fn([self._dataset[i] for i in batch])
                    for batch in self._batch_sampler)
        return _MultiWorkerIter(self)

    def __len__(self):
        return len(self._batch_sampler)


def _work(jobs, results, cond, dataset, batchify):
    """A worker thread: batches from ``jobs`` until it reads None."""
    while True:
        job = jobs.get()
        if job is None:
            return
        idx, batch = job
        try:
            result = batchify([dataset[i] for i in batch])
        except Exception as e:  # noqa: BLE001  (handed to next())
            result = e
        with cond:
            results[idx] = result
            cond.notify_all()


def _stop(jobs, threads):
    """Drop the jobs not started, stop every worker and join it."""
    while True:
        try:
            jobs.get_nowait()
        except queue.Empty:
            break
    for _ in threads:
        jobs.put(None)
    for t in threads:
        if t is not threading.current_thread():
            t.join()


class _MultiWorkerIter:
    """Batches from worker threads, in the sampler's order."""

    def __init__(self, loader):
        self._batch_iter = iter(loader._batch_sampler)
        self._depth = loader._prefetch or 2 * loader._num_workers
        self._results = {}
        self._cond = threading.Condition()
        self._jobs = queue.Queue()
        self._sent = self._rcvd = 0
        threads = [threading.Thread(
            target=_work, name="%s-%d" % (WORKER_NAME, i), daemon=True,
            args=(self._jobs, self._results, self._cond, loader._dataset,
                  loader._batchify_fn))
            for i in range(loader._num_workers)]
        for t in threads:
            t.start()
        self._shutdown = weakref.finalize(self, _stop, self._jobs, threads)
        for _ in range(self._depth):
            self._push_next()

    def _push_next(self):
        batch = next(self._batch_iter, None)
        if batch is not None:
            self._jobs.put((self._sent, batch))
            self._sent += 1

    def __iter__(self):
        return self

    def __next__(self):
        if not self._shutdown.alive:
            raise StopIteration
        self._push_next()
        if self._rcvd == self._sent:
            self._shutdown()
            raise StopIteration
        with self._cond:
            while self._rcvd not in self._results:
                self._cond.wait()
            result = self._results.pop(self._rcvd)
        self._rcvd += 1
        if isinstance(result, Exception):
            self._shutdown()
            raise result
        return result

    next = __next__
