"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``): the
``Dataset`` interface with ``transform``/``transform_first``,
``SimpleDataset``, ``ArrayDataset`` and ``RecordFileDataset`` over an
indexed RecordIO file."""
from __future__ import annotations

import os

from ... import recordio
from ...ndarray import ndarray as nd

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Samples by index: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """This dataset with ``fn`` applied to each sample (a tuple is
        passed as separate arguments); ``lazy=False`` applies it to every
        sample now."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """This dataset with ``fn`` applied to the first element of each
        sample only (the data, not the label)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """Any object with ``len`` and ``[]`` as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Several array-likes of one length; sample ``i`` is the tuple of
    their ``i``-th elements (the element itself for one array).  A 1-D
    NDArray is read as numpy, so its elements are numbers."""

    def __init__(self, *args):
        if not args:
            raise ValueError("ArrayDataset needs at least 1 array")
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            if len(data) != self._length:
                raise ValueError(
                    "All arrays must have the same length; array[0] has "
                    "length %d while array[%d] has %d."
                    % (self._length, i, len(data)))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """The records of a RecordIO file by index, through its ``.idx``
    sidecar; reads are serialized by the reader's lock, so DataLoader
    workers may share it."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
