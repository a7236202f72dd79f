"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``).
``RandomSampler`` shuffles with numpy's global generator, as the
reference's does, so one numpy seed gives both packages one order."""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """An iterable over sample indices."""

    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    """0, 1, ..., length - 1."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    """A new permutation of range(length) each epoch."""

    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = np.arange(self._length)
        np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


_LAST = ("keep", "discard", "rollover")


class BatchSampler(Sampler):
    """Batches of ``batch_size`` indices from ``sampler``; the last, short
    batch is kept, discarded, or rolled over into the next epoch's first
    (``last_batch``)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def _check(self):
        if self._last_batch not in _LAST:
            raise ValueError("last_batch must be one of 'keep', 'discard', "
                             "or 'rollover', but got %s" % self._last_batch)

    def __iter__(self):
        self._check()
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        self._check()
        if self._last_batch == "keep":
            return -(-len(self._sampler) // self._batch_size)
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._prev) + len(self._sampler)) // self._batch_size
