"""Data iterators (counterpart of ``mxnet_tpu/io.py``): ``DataDesc``,
``DataBatch``, the ``DataIter`` protocol and ``SyntheticLMIter``, the
deterministic next-token stream the transformer LM trains on.

``SyntheticLMIter`` makes the reference's corpus from the same seed with
numpy (the same token ids in the same batches) and places each batch on
``ctx``, by default the current context (``gpu(0)``).  ``NDArrayIter``,
``PrefetchingIter`` and the file iterators are not ported yet.
"""
from __future__ import annotations

from collections import namedtuple
from typing import Optional

import numpy as np

from .context import Context, current_context
from .ndarray import ndarray as nd

__all__ = ["DataDesc", "DataBatch", "DataIter", "SyntheticLMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Name, shape, dtype and layout of one input (``io.py:56``)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), np.dtype(dtype), layout)


class DataBatch:
    """One batch: lists of data and label NDArrays (``io.py:64``)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (``io.py:77``): ``next`` builds a :class:`DataBatch`
    from ``iter_next``, ``getdata``, ``getlabel``, ``getpad`` and
    ``getindex``."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


class SyntheticLMIter(DataIter):
    """Next-token prediction batches (``io.py:240``): data ``(B, T)`` token
    ids, label the same stream shifted by one position.  The corpus of
    ``num_batches * batch_size * seq_len + 1`` ids is drawn once from
    ``np.random.RandomState(seed)``, as the reference draws it, so both
    packages see the same batches.  The reference's ``num_parts``/
    ``part_index`` (one host's rows of each batch) wait for the port's
    multi-device layer."""

    def __init__(self, vocab_size, seq_len, batch_size=1, num_batches=16,
                 seed=0, data_name="data", label_name="softmax_label",
                 dtype="float32", ctx: Optional[Context] = None):
        super().__init__(batch_size)
        self.vocab_size = int(vocab_size)
        self.seq_len = int(seq_len)
        self.num_batches = int(num_batches)
        self.seed = int(seed)
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = np.dtype(dtype)
        self.ctx = ctx or current_context()
        rng = np.random.RandomState(self.seed)
        corpus = rng.randint(0, self.vocab_size,
                             size=self.num_batches * batch_size
                             * self.seq_len + 1)
        n = self.num_batches * batch_size * self.seq_len
        self._data = corpus[:n].reshape(
            self.num_batches, batch_size, self.seq_len).astype(self.dtype)
        self._label = corpus[1:n + 1].reshape(
            self.num_batches, batch_size, self.seq_len).astype(self.dtype)
        self.cursor = -1

    @property
    def provide_data(self):
        return [DataDesc(self.data_name, (self.batch_size, self.seq_len),
                         self.dtype, layout="NT")]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size, self.seq_len),
                         self.dtype, layout="NT")]

    def reset(self):
        self.cursor = -1

    def iter_next(self):
        self.cursor += 1
        return self.cursor < self.num_batches

    def getdata(self):
        return [nd.array(self._data[self.cursor], self.ctx)]

    def getlabel(self):
        return [nd.array(self._label[self.cursor], self.ctx)]
