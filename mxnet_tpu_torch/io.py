"""Data iterators (counterpart of ``mxnet_tpu/io.py``): ``DataDesc``,
``DataBatch``, the ``DataIter`` protocol, ``NDArrayIter`` (in-memory
arrays, with the last batch padded, discarded or rolled over),
``SyntheticLMIter`` (the deterministic next-token stream the transformer
LM trains on), ``PrefetchingIter`` (worker threads that fetch and place
the next batches while the step runs), ``ResizeIter`` and the file
iterators ``CSVIter``, ``MNISTIter`` (idx files, gzipped or not) and
``LibSVMIter`` (dense batches, as the reference's).

The iterators make their batches from numpy, as the reference's do (the
same rows in the same batches from the same seed), and place each batch on
``ctx``, by default the current context (``gpu(0)``).  ``ImageRecordIter``
and its decode pool are not ported yet (they stand on ``recordio.py`` and
``image.py``).
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from collections import namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError
from .context import Context, current_context
from .ndarray import ndarray as nd

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "SyntheticLMIter", "PrefetchingIter", "ResizeIter", "CSVIter",
           "MNISTIter", "LibSVMIter"]


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


def _init_data(data, allow_empty, default_name):
    """``[(name, numpy array)]`` from an array, a list or a dict."""
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, nd.NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise MXNetError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {default_name + "_%d" % i: d for i, d in enumerate(data)}
    out = {}
    for k, v in dict(data).items():
        if isinstance(v, nd.NDArray):
            v = v.asnumpy()
        out[k] = np.asarray(v)
    return list(out.items())


class NDArrayIter(DataIter):
    """In-memory iterator (``io.py:152``).  ``last_batch_handle`` is
    ``"pad"`` (the last batch wraps to the start and ``pad`` counts the
    extra rows), ``"discard"`` or ``"roll_over"`` (the rows left over start
    the next epoch).  ``shuffle`` permutes the rows at every ``reset`` with
    ``rng`` (a ``numpy.random.Generator`` or ``RandomState``; by default
    numpy's global generator, as the reference's ``np.random.shuffle``).
    Batches land on ``ctx`` (default: the current context)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", ctx: Optional[Context] = None,
                 rng=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise MXNetError("last_batch_handle %r: expected pad, discard "
                             "or roll_over" % (last_batch_handle,))
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.rng = rng if rng is not None else np.random
        self.last_batch_handle = last_batch_handle
        self.ctx = ctx or current_context()
        self.idx = np.arange(self.num_data)
        self.cursor = -batch_size
        if last_batch_handle == "discard":
            self.num_batches = self.num_data // batch_size
        else:
            self.num_batches = (self.num_data + batch_size - 1) // batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _slice(self, arrays):
        start, end = self.cursor, self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self.idx[start:end]
        else:               # wrap around to the start
            sel = np.concatenate([self.idx[start:],
                                  self.idx[:end - self.num_data]])
        return [nd.array(v[sel], self.ctx, dtype=v.dtype)
                for _, v in arrays]

    def getdata(self):
        return self._slice(self.data)

    def getlabel(self):
        return self._slice(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class SyntheticLMIter(DataIter):
    """Next-token prediction batches (``io.py:240``): data ``(B, T)`` token
    ids, label the same stream shifted by one position.  The corpus of
    ``num_batches * batch_size * seq_len + 1`` ids is drawn once from
    ``np.random.RandomState(seed)``, as the reference draws it, so both
    packages see the same batches.  ``num_parts``/``part_index`` keep one
    loading host's contiguous block of each batch's rows, and the batch
    size becomes ``batch_size / num_parts``."""

    def __init__(self, vocab_size, seq_len, batch_size=1, num_batches=16,
                 seed=0, data_name="data", label_name="softmax_label",
                 dtype="float32", num_parts=1, part_index=0,
                 ctx: Optional[Context] = None):
        super().__init__(batch_size)
        if not 0 <= part_index < num_parts:
            raise MXNetError("part_index %d out of range for num_parts %d"
                             % (part_index, num_parts))
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
        if num_parts > 1:
            if batch_size % num_parts:
                raise MXNetError("batch_size %d not divisible by "
                                 "num_parts %d" % (batch_size, num_parts))
            self.batch_size = batch_size // num_parts
            rows = slice(batch_size * part_index // num_parts,
                         batch_size * (part_index + 1) // num_parts)
            self._data = self._data[:, rows]
            self._label = self._label[:, rows]
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


class PrefetchingIter(DataIter):
    """Background prefetch (``io.py:412``): ``num_workers`` threads produce
    the next batches of ``iters`` (one or a list, whose batches are joined)
    while the consumer trains on the current one.

    The inner ``next`` calls run one at a time under a lock, in order (the
    inner iterators are not thread-safe, and the batches must come in the
    order the unprefetched iterator gives them); the per-batch work outside
    it — placing the arrays on ``device`` when one is given — runs in
    parallel, and the batches are put back in order into a queue of
    ``prefetch_depth`` entries.  ``prefetch_depth`` 0 reads
    ``MXNET_IO_PREFETCH_DEPTH`` (2) and ``num_workers`` 0 reads
    ``MXNET_IO_PIPELINE_WORKERS``, then ``MXNET_CPU_WORKER_NTHREADS`` (2).
    An error in a producer is raised to the consumer."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=0, device: Optional[Context] = None,
                 num_workers=0):
        if not isinstance(iters, list):
            iters = [iters]
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        super().__init__(iters[0].batch_size)
        if prefetch_depth <= 0:
            prefetch_depth = int(os.environ.get(
                "MXNET_IO_PREFETCH_DEPTH", "2"))
        self.prefetch_depth = max(1, prefetch_depth)
        if num_workers <= 0:
            num_workers = int(os.environ.get(
                "MXNET_IO_PIPELINE_WORKERS",
                os.environ.get("MXNET_CPU_WORKER_NTHREADS", "2")))
        self.num_workers = max(1, num_workers)
        self.device = device
        self.current_batch = None
        self._queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        self._stop = threading.Event()
        self._fetch_lock = threading.Lock()
        self._emit_cv = threading.Condition()
        self._threads: List[threading.Thread] = []
        self._start()

    def _descs(self, attr, rename):
        out = []
        for i, it in enumerate(self.iters):
            descs = getattr(it, attr)
            if rename:
                descs = [DataDesc(rename[i].get(d.name, d.name), d.shape,
                                  d.dtype, d.layout) for d in descs]
            out.extend(descs)
        return out

    @property
    def provide_data(self):
        return self._descs("provide_data", self.rename_data)

    @property
    def provide_label(self):
        return self._descs("provide_label", self.rename_label)

    def _put(self, item) -> bool:
        """Put unless ``reset`` stops the producers; False if it did."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _assemble(self, batches):
        data = sum((b.data for b in batches), [])
        label = sum((b.label or [] for b in batches), [])
        if self.device is not None:
            data = [a.as_in_context(self.device) for a in data]
            label = [a.as_in_context(self.device) for a in label]
        return DataBatch(data, label, pad=batches[0].pad,
                         index=batches[0].index)

    def _emit(self, seq, item) -> bool:
        """Deliver ``item`` as the ``seq``-th entry of the queue."""
        with self._emit_cv:
            while self._next_emit != seq:
                if self._stop.is_set():
                    return False
                self._emit_cv.wait(timeout=0.05)
            ok = self._put(item)
            self._next_emit = seq + 1
            self._emit_cv.notify_all()
        return ok

    def _worker(self):
        while not self._stop.is_set():
            with self._fetch_lock:
                if self._eof:
                    return
                seq = self._seq
                self._seq += 1
                try:
                    batches = [next(it) for it in self.iters]
                except StopIteration:
                    self._eof = True
                    batches = None
                except Exception as e:  # raised on the consumer's side
                    self._eof = True
                    batches = e
            if batches is None or isinstance(batches, Exception):
                self._emit(seq, batches)
                return
            try:
                item = self._assemble(batches)
            except Exception as e:  # raised on the consumer's side
                with self._fetch_lock:
                    self._eof = True
                item = e
            if not self._emit(seq, item):
                return

    def _start(self):
        self._seq = 0
        self._next_emit = 0
        self._eof = False
        self._done = False
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name="prefetch-worker-%d" % i)
            for i in range(self.num_workers)]
        for t in self._threads:
            t.start()

    def _halt(self):
        """Stop the producers, then empty the queue (a batch in flight
        would otherwise land after the drain)."""
        self._stop.set()
        with self._emit_cv:
            self._emit_cv.notify_all()
        for t in self._threads:
            while t.is_alive():
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def reset(self):
        self._halt()
        for it in self.iters:
            it.reset()
        self.current_batch = None
        self._stop.clear()
        self._start()

    def close(self):
        """Stop the producer threads."""
        self._halt()
        self._done = True

    def _consume(self):
        batch = self._queue.get()
        if batch is None:
            self._done = True
            return None
        if isinstance(batch, Exception):
            self._done = True
            raise batch
        return batch

    def __next__(self):
        if self.current_batch is not None:
            batch, self.current_batch = self.current_batch, None
            return batch
        if self._done:
            raise StopIteration
        batch = self._consume()
        if batch is None:
            raise StopIteration
        return batch

    next = __next__

    def iter_next(self):
        if self.current_batch is not None:
            return True
        if self._done:
            return False
        self.current_batch = self._consume()
        return self.current_batch is not None

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class ResizeIter(DataIter):
    """An iterator cut or repeated to ``size`` batches an epoch
    (``io.py:698``)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = next(self.data_iter)
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = next(self.data_iter)
        self.cur += 1
        return True

    def __next__(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    next = __next__

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class _FileIter(DataIter):
    """An iterator over arrays read from files, served by an inner
    :class:`NDArrayIter` (the reference's file iterators wrap one the same
    way)."""

    def __init__(self, inner: NDArrayIter):
        super().__init__(inner.batch_size)
        self._inner = inner

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self) -> DataBatch:
        return self._inner.next()


class CSVIter(_FileIter):
    """Rows of a CSV file as ``data_shape`` samples (``io.py:322``), with
    labels from ``label_csv`` (a trailing dim of 1 dropped) or zeros, named
    ``label``; ``round_batch`` pads the last batch from the start, else it
    is dropped."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", ctx: Optional[Context] = None, **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.dtype(dtype),
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1])
        else:
            label = np.zeros((data.shape[0],), np.float32)
        super().__init__(NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label", ctx=ctx))


def _read_idx(path):
    """The array in an idx file (MNIST's format, ``io.py:394``), gzipped or
    not; ``path + ".gz"`` is tried when ``path`` is missing."""
    if not os.path.exists(path):
        if not os.path.exists(path + ".gz"):
            raise MXNetError("MNIST file not found: %s" % path)
        path = path + ".gz"
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        buf = f.read()
    ndim = struct.unpack(">I", buf[:4])[0] & 0xFF
    dims = struct.unpack(">" + "I" * ndim, buf[4:4 + 4 * ndim])
    return np.frombuffer(buf, dtype=np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


class MNISTIter(_FileIter):
    """MNIST's idx files (``io.py:356``): images scaled to [0, 1], as
    (N, 1, H, W), (N, H*W) with ``flat`` or ``input_shape``; the labels as
    float32; shuffled at every reset by numpy's global generator, the last
    partial batch dropped."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, ctx: Optional[Context] = None, **kwargs):
        imgs = _read_idx(image).astype(np.float32) / 255.0
        labels = _read_idx(label)
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, imgs.shape[1],
                                imgs.shape[2])
        if input_shape is not None:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        super().__init__(NDArrayIter(
            imgs, labels.astype(np.float32), batch_size, shuffle=shuffle,
            last_batch_handle="discard", ctx=ctx))


class LibSVMIter(_FileIter):
    """A libsvm text file (``io.py:1188``: ``label index:value ...`` a
    line) as dense ``data_shape`` rows, labels named ``label``, the last
    batch padded."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_shape=(1,), ctx: Optional[Context] = None, **kwargs):
        dim = int(np.prod(data_shape))
        rows, labels = [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.strip().split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                row = np.zeros(dim, np.float32)
                for kv in parts[1:]:
                    k, v = kv.split(":")
                    row[int(k)] = float(v)
                rows.append(row)
        data = np.stack(rows).reshape((-1,) + tuple(data_shape))
        super().__init__(NDArrayIter(
            data, np.asarray(labels, np.float32), batch_size,
            label_name="label", ctx=ctx))
