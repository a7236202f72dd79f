"""Bucketing data iterator for variable-length sequences (counterpart of
``mxnet_tpu/rnn/io.py``).

Each sentence is padded with ``invalid_label`` to the smallest bucket that
holds it (longer ones are dropped with a warning); every batch is drawn
from one bucket and carries its ``bucket_key`` and its own
``provide_data``/``provide_label``, while the iterator's ``provide_data``
gives the default (largest) bucket's shape, which ``BucketingModule``
binds first.  ``reset`` shuffles the sentences within each bucket with
numpy's global generator and the order of the batches with Python's
``random``, as the reference does, so one seed of each gives both
packages the same batches.  Batches land on ``ctx`` (default: the current
context).
"""
from __future__ import annotations

import logging
import random
from typing import List, Optional, Sequence

import numpy as np

from ..context import Context, current_context
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import ndarray as nd

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Bucketed iterator over tokenized sentences (``io.py:22``).

    ``sentences`` are lists of token ids; ``buckets`` (sorted here)
    default to every length with at least ``batch_size`` sentences; the
    label of each position is the next token (or ``label[i]``), padding
    ``invalid_label``.  ``layout`` is ``"NT"`` (batch-major) or ``"TN"``
    (time-major)."""

    def __init__(self, sentences: Sequence[Sequence[int]], batch_size: int,
                 buckets: Optional[List[int]] = None, invalid_label: int = -1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT", label=None,
                 ctx: Optional[Context] = None):
        super().__init__(batch_size)
        if buckets is None:
            lens = np.array([len(s) for s in sentences])
            buckets = sorted({int(b) for b in np.unique(lens)
                              if (lens == b).sum() >= batch_size})
            if not buckets:
                buckets = [int(lens.max())]
        if layout not in ("NT", "TN"):
            raise ValueError("layout must be 'NT' (batch-major) or 'TN' "
                             "(time-major), got %r" % (layout,))
        buckets = sorted(buckets)
        self.data_name = data_name
        self.label_name = label_name
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.default_bucket_key = max(buckets)
        self.dtype = dtype
        self.layout = layout
        self.ctx = ctx or current_context()

        data = [[] for _ in buckets]
        labels = [[] for _ in buckets]
        ndiscard = 0
        for i, sent in enumerate(sentences):
            bkt = next((b for b in buckets if b >= len(sent)), None)
            if bkt is None:
                ndiscard += 1
                continue
            buf = np.full((bkt,), invalid_label, dtype)
            buf[:len(sent)] = sent
            lab = np.full((bkt,), invalid_label, dtype)
            if label is not None:
                lab[:len(label[i])] = label[i][:bkt]
            elif len(sent) > 1:     # a 0- or 1-token sentence has no target
                lab[:len(sent) - 1] = sent[1:]
            idx = buckets.index(bkt)
            data[idx].append(buf)
            labels[idx].append(lab)
        if ndiscard:
            logging.warning("discarded %d sentences longer than the "
                            "largest bucket", ndiscard)
        self._bucket_data = [np.asarray(b).astype(dtype) if b else
                             np.zeros((0, k), dtype)
                             for b, k in zip(data, buckets)]
        self._bucket_label = [np.asarray(b).astype(dtype) if b else
                              np.zeros((0, k), dtype)
                              for b, k in zip(labels, buckets)]
        self._plan = []       # (bucket index, first row) of each batch
        self.reset()

    def _shape(self, bucket):
        return ((self.batch_size, bucket) if self.layout == "NT"
                else (bucket, self.batch_size))

    def _desc(self, name, bucket):
        return DataDesc(name, self._shape(bucket), self.dtype)

    @property
    def provide_data(self):
        return [self._desc(self.data_name, self.default_bucket_key)]

    @property
    def provide_label(self):
        return [self._desc(self.label_name, self.default_bucket_key)]

    def reset(self):
        """Shuffle the sentences within each bucket and the batches'
        order."""
        for i in range(len(self._bucket_data)):
            if len(self._bucket_data[i]):
                perm = np.random.permutation(len(self._bucket_data[i]))
                self._bucket_data[i] = self._bucket_data[i][perm]
                self._bucket_label[i] = self._bucket_label[i][perm]
        self._plan = []
        for i, data in enumerate(self._bucket_data):
            for start in range(0, len(data) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((i, start))
        random.shuffle(self._plan)
        self._cursor = 0

    def next(self) -> DataBatch:
        if self._cursor >= len(self._plan):
            raise StopIteration
        i, start = self._plan[self._cursor]
        self._cursor += 1
        d = self._bucket_data[i][start:start + self.batch_size]
        lab = self._bucket_label[i][start:start + self.batch_size]
        if self.layout == "TN":
            d, lab = np.ascontiguousarray(d.T), np.ascontiguousarray(lab.T)
        bkt = self.buckets[i]
        return DataBatch(
            data=[nd.array(d, self.ctx)], label=[nd.array(lab, self.ctx)],
            pad=0, bucket_key=bkt,
            provide_data=[self._desc(self.data_name, bkt)],
            provide_label=[self._desc(self.label_name, bkt)])
