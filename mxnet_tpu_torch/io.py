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
reads a ``.rec`` file (:mod:`.recordio`) and decodes and augments its JPEGs
in a pool of host threads; only the assembled batch goes to ``ctx``.
"""
from __future__ import annotations

import concurrent.futures
import gzip
import os
import queue
import struct
import threading
import warnings
import weakref
from collections import deque, namedtuple
from typing import List, Optional

import numpy as np

from .base import MXNetError
from .context import Context, current_context
from .ndarray import ndarray as nd

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "SyntheticLMIter", "PrefetchingIter", "ResizeIter", "CSVIter",
           "MNISTIter", "LibSVMIter", "ImageRecordIter"]


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


def _randint(rng, low, high):
    """An int in [low, high) from a ``Generator``, a ``RandomState`` or
    numpy's global generator (the same draw as ``np.random.randint``)."""
    integers = getattr(rng, "integers", None)
    return integers(low, high) if integers is not None \
        else rng.randint(low, high)


class ImageRecordIter(DataIter):
    """JPEG records of a ``.rec`` file, decoded and augmented on the host,
    in batches on ``ctx`` (``io.py:750``; the reference C++ iterator's
    pipeline, ``iter_image_recordio_2.cc``).

    One reader stage walks the records: through ``path_imgidx``'s index
    where it exists (shuffled at each ``reset``), else sequentially, or
    from memory when ``shuffle`` is asked without an index (the whole
    file is loaded, with a warning).  ``preprocess_threads`` workers
    (default ``MXNET_CPU_WORKER_NTHREADS``, else 4) decode and augment
    each image straight into its row of a staging slot; up to
    ``prefetch_buffer`` batches decode at once, in a ring of
    ``prefetch_buffer + 1`` reusable HWC slots, and the producer thread
    finishes them strictly in reader order, transposes each to CHW in one
    step, and places it on ``ctx``.  A short last batch is padded by
    repeating its row 0 (``pad`` counts the rows).  ``round_batch`` and
    ``label_width`` are accepted and ignored, as the reference's are; the
    label is the record's first.

    Augmentation (``image_aug_default.cc``): ``resize`` the short side,
    then a ``data_shape`` crop, random with ``rand_crop`` where the image
    is larger, else centred (resized to fit if it is smaller), a mirror
    with probability 0.5 under ``rand_mirror``, then BGR to RGB and
    ``(x - mean) / std * scale``.  The random draws come from ``rng`` (a
    ``Generator`` or ``RandomState``; by default numpy's global generator,
    as the reference's) and are made in the decode workers, in the order
    the workers reach them: with ``preprocess_threads=1`` that is record
    order, so a seeded run repeats exactly; with more threads the labels
    and their order repeat, but which image gets which draw follows the
    threads' timing, as in the reference.

    ``num_parts``/``part_index`` keep one loading host's share (a
    contiguous block of the index or of the records in memory, every
    ``num_parts``-th record of a sequential file); they default from
    :func:`parallel.mesh.host_shard_hint`.  A reader or decode error is
    raised to the consumer.  The producer holds the iterator only weakly
    between batches, so an abandoned iterator is collected and its
    threads end; :meth:`close` ends them at once, and :meth:`reset`
    restarts a closed iterator."""

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 resize=-1, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 preprocess_threads=0, prefetch_buffer=2, path_imgidx=None,
                 round_batch=True, data_name="data",
                 label_name="softmax_label", num_parts=None,
                 part_index=None, ctx: Optional[Context] = None, rng=None,
                 **kwargs):
        super().__init__(batch_size)
        from . import recordio
        self.data_shape = tuple(data_shape)
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self.scale = scale
        self.shuffle = shuffle
        self.data_name = data_name
        self.label_name = label_name
        self.ctx = ctx or current_context()
        self.rng = rng if rng is not None else np.random
        if preprocess_threads <= 0:
            preprocess_threads = int(os.environ.get(
                "MXNET_CPU_WORKER_NTHREADS", "4"))
        self._nthreads = max(1, preprocess_threads)
        self._prefetch = max(1, prefetch_buffer)
        self._pool = None
        self._queue = None
        self._producer_thread = None
        self._stop = threading.Event()
        self._mem = None
        self._inflight = deque()
        self._bufs = None
        self._chw = None
        self._closed = False
        self._reader_done = False
        self._seq_read = 0
        if path_imgidx and os.path.exists(path_imgidx):
            self.rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                                  "r")
            self.keys = list(self.rec.keys)
        else:
            self.rec = recordio.MXRecordIO(path_imgrec, "r")
            self.keys = None
            if shuffle:
                warnings.warn(
                    "ImageRecordIter: shuffle=True without path_imgidx "
                    "loads the whole .rec into memory; provide an .idx "
                    "file for large datasets")
                self._mem = []
                while True:
                    raw = self.rec.read()
                    if raw is None:
                        break
                    self._mem.append(raw)
        if num_parts is None and part_index is None:
            from .parallel.mesh import host_shard_hint
            part_index, num_parts = host_shard_hint()
        num_parts = 1 if num_parts is None else int(num_parts)
        part_index = 0 if part_index is None else int(part_index)
        if not 0 <= part_index < num_parts:
            raise MXNetError(
                "ImageRecordIter: part_index %d out of range for "
                "num_parts %d" % (part_index, num_parts))
        self.num_parts, self.part_index = num_parts, part_index
        if num_parts > 1:
            if self.keys is not None:
                n = len(self.keys)
                self.keys = self.keys[n * part_index // num_parts:
                                      n * (part_index + 1) // num_parts]
            elif self._mem is not None:
                n = len(self._mem)
                self._mem = self._mem[n * part_index // num_parts:
                                      n * (part_index + 1) // num_parts]
        self._order = None
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, (self.batch_size,))]

    def reset(self):
        """Stop the producer, reorder (``shuffle``) and start the epoch
        again; also brings a closed iterator back."""
        self._stop_producer()
        self._closed = False
        self.rec.reset()
        if self.keys is not None:
            self._order = list(self.keys)
            if self.shuffle:
                self.rng.shuffle(self._order)
            self._pos = 0
        elif self._mem is not None:
            self._order = self.rng.permutation(len(self._mem)).tolist()
            self._pos = 0
        self._seq_read = 0
        self._done = False
        self._start_producer()

    def close(self):
        """End the producer and the decode threads and free the staging
        buffers; :meth:`reset` restarts the iterator."""
        self._stop_producer()
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            pool.shutdown(wait=not _on_decode_thread())
        self._bufs = None
        self._chw = None
        self._closed = True

    __del__ = close

    def _read_raw(self):
        """The reader stage: the next record of this host's share."""
        if self.keys is not None:
            if self._pos >= len(self._order):
                return None
            raw = self.rec.read_idx(self._order[self._pos])
            self._pos += 1
            return raw
        if self._mem is not None:
            if self._pos >= len(self._order):
                return None
            raw = self._mem[self._order[self._pos]]
            self._pos += 1
            return raw
        if self.num_parts > 1:
            # skipped records are read but never decoded
            while True:
                raw = self.rec.read()
                if raw is None:
                    return None
                i = self._seq_read
                self._seq_read += 1
                if i % self.num_parts == self.part_index:
                    return raw
        return self.rec.read()

    def _decode_into(self, raw, buf, i):
        """The worker stage: decode and augment into row ``i`` of a
        staging slot (cv2 and PIL release the interpreter lock)."""
        from . import recordio
        header, img = recordio.unpack_img(raw, iscolor=1)
        if img is None:
            raise MXNetError("ImageRecordIter: cannot decode record %d of "
                             "its batch" % i)
        buf[0][i] = self._augment(img)
        buf[1][i] = float(np.asarray(header.label).ravel()[0])

    def _start_producer(self):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                self._nthreads, thread_name_prefix="imgrec-decode")
        if self._bufs is None:
            c, h, w = self.data_shape
            self._bufs = queue.Queue()
            for _ in range(self._prefetch + 1):
                self._bufs.put(
                    (np.empty((self.batch_size, h, w, c), np.float32),
                     np.empty((self.batch_size,), np.float32)))
        self._reader_done = False
        self._queue = queue.Queue(self._prefetch)
        self._stop.clear()
        # a weak reference only, so an abandoned iterator is collected
        self._producer_thread = threading.Thread(
            target=_imgrec_produce_loop, name="imgrec-producer",
            args=(weakref.ref(self), self._stop, self._queue), daemon=True)
        self._producer_thread.start()

    def _stop_producer(self):
        if getattr(self, "_producer_thread", None) is None:
            return
        self._stop.set()
        try:
            cur = threading.current_thread()
        except Exception:   # interpreter teardown: module globals cleared
            self._producer_thread = None
            return
        if self._producer_thread is cur:
            # collected on the producer thread itself: it cannot join itself
            self._producer_thread = None
            return
        while self._producer_thread.is_alive():
            try:    # unblock a producer waiting on a full queue
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._producer_thread.join(timeout=0.05)
        self._producer_thread = None
        # settle the decodes in flight before their slots are reused
        for futs, _n, buf in self._inflight:
            for f in futs:
                if not f.cancel():
                    try:
                        f.result()
                    except Exception:  # noqa: BLE001 - the epoch is dropped
                        pass
            if self._bufs is not None:
                self._bufs.put(buf)
        self._inflight.clear()

    def _pump(self):
        """One producer turn: keep up to ``prefetch_buffer`` batches
        decoding, then finish and assemble the oldest.  Returns
        ``(items for the queue, done)``."""
        while (not self._reader_done
               and len(self._inflight) < self._prefetch):
            raws = []
            while len(raws) < self.batch_size:
                raw = self._read_raw()
                if raw is None:
                    self._reader_done = True
                    break
                raws.append(raw)
            if not raws:
                break
            buf = self._bufs.get_nowait()   # the ring holds one spare slot
            futs = [self._pool.submit(self._decode_into, r, buf, i)
                    for i, r in enumerate(raws)]
            self._inflight.append((futs, len(raws), buf))
        if not self._inflight:
            return [None], True
        futs, n, buf = self._inflight.popleft()
        try:
            for f in futs:
                f.result()
            batch = self._assemble_batch(buf, n)
        finally:
            # after an error too, no worker may still write into the slot
            concurrent.futures.wait(futs)
            self._bufs.put(buf)
        pad = self.batch_size - n
        done = bool(pad) or (self._reader_done and not self._inflight)
        return ([batch, None], True) if done else ([batch], False)

    def _assemble_batch(self, buf, n):
        """Pad a staging slot, transpose it to CHW, place it on ``ctx``."""
        data, label = buf
        c, h, w = self.data_shape
        if self._chw is None:
            self._chw = np.empty((self.batch_size, c, h, w), np.float32)
        pad = self.batch_size - n
        if pad:
            data[n:] = data[:1]
            label[n:] = label[:1]
        np.copyto(self._chw, data.transpose(0, 3, 1, 2))
        return DataBatch(*self._place(self._chw, label), pad=pad)

    def _place(self, chw, label):
        """The batch's copies on ``ctx`` (``nd.array`` copies, so the host
        buffers are free to reuse when it returns)."""
        return [nd.array(chw, self.ctx)], [nd.array(label, self.ctx)]

    def _augment(self, img):
        c, h, w = self.data_shape
        if self.resize > 0:
            img = _resize_short(img, self.resize)
        ih, iw = img.shape[:2]
        if self.rand_crop and ih > h and iw > w:
            y = _randint(self.rng, 0, ih - h + 1)
            x = _randint(self.rng, 0, iw - w + 1)
        else:
            y, x = max(0, (ih - h) // 2), max(0, (iw - w) // 2)
        img = img[y:y + h, x:x + w]
        if img.shape[0] != h or img.shape[1] != w:
            img = _resize_exact(img, (w, h))
        if self.rand_mirror and self.rng.random() < 0.5:
            img = img[:, ::-1]
        # BGR -> RGB and (x - mean) / std * scale as x * a + b; cv2's arm
        # first (it releases the interpreter lock), then numpy's
        a = self.scale / self.std
        b = -self.mean * a
        try:
            import cv2
        except ImportError:
            return img[..., ::-1].astype(np.float32) * a + b
        rgb = cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_BGR2RGB)
        out = cv2.multiply(rgb, tuple(float(v) for v in a) + (0.0,),
                           dtype=cv2.CV_32F)
        return cv2.add(out, tuple(float(v) for v in b) + (0.0,))

    def __next__(self):
        if self._closed:
            raise MXNetError("ImageRecordIter: used after close(); call "
                             "reset() to restart it")
        if self._done:
            raise StopIteration
        batch = self._queue.get()
        if batch is None:
            self._done = True
            raise StopIteration
        if isinstance(batch, Exception):
            self._done = True
            raise batch
        return batch

    next = __next__


def _on_decode_thread():
    """Whether this is a decode worker (which, dropping the last reference
    to its iterator, runs ``close`` itself and cannot wait for its own
    pool), or the interpreter is shutting down."""
    try:
        return threading.current_thread().name.startswith("imgrec-decode")
    except Exception:   # noqa: BLE001 - interpreter teardown
        return True


def _imgrec_produce_loop(ref, stop, q):
    """The producer thread of :class:`ImageRecordIter`.  It holds the
    iterator only while a turn runs, and forwards any reader or decode
    error through the queue."""
    while not stop.is_set():
        it = ref()
        if it is None:
            return
        try:
            items, done = it._pump()
        except Exception as e:               # noqa: BLE001 - raised there
            items, done = [e, None], True
        del it
        for item in items:
            placed = False
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    placed = True
                    break
                except queue.Full:
                    if ref() is None:        # the consumer dropped it
                        return
            if not placed:
                return
        if done:
            return


def _resize_short(img, size):
    """``img`` with its short side resized to ``size`` (``io.py:1169``)."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, int(w * size / h)
    else:
        nh, nw = int(h * size / w), size
    return _resize_exact(img, (nw, nh))


def _resize_exact(img, wh):
    """``img`` resized to ``wh`` = (width, height) by cv2, else PIL."""
    try:
        import cv2
    except ImportError:
        from PIL import Image
        mode = "RGB" if img.ndim == 3 else "L"
        return np.asarray(Image.fromarray(img, mode).resize(wh))
    return cv2.resize(img, wh)
