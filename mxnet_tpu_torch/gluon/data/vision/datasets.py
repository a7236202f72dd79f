"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``).  ``MNIST`` and
``FashionMNIST`` read the IDX files, ``CIFAR10`` and ``CIFAR100`` the
binary batches, each from ``root`` only (plain or ``.gz``): a missing file
raises with its name, since the port downloads nothing.
``ImageRecordDataset`` decodes the images of a RecordIO file
(``recordio.unpack_img``, cv2), ``ImageFolderDataset`` those of a
``root/<class>/<image>`` tree.  Samples are (HWC uint8 NDArray on
``cpu()``, label)."""
from __future__ import annotations

import gzip
import os
import warnings

import numpy as np

from ....context import cpu
from ....ndarray import ndarray as nd
from ....recordio import unpack_img
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


def _host(arr):
    return nd.array(arr, ctx=cpu(), dtype=arr.dtype)


class _DownloadedDataset(Dataset):
    """A dataset whose files sit under ``root``."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise IOError("dataset file %s (or %s.gz) not found; the port downloads "
                  "nothing: place the file there by hand" % (path, path))


class MNIST(_DownloadedDataset):
    """MNIST digits: 28 x 28 x 1 uint8 images, int32 labels."""

    _train_data = "train-images-idx3-ubyte"
    _train_label = "train-labels-idx1-ubyte"
    _test_data = "t10k-images-idx3-ubyte"
    _test_label = "t10k-labels-idx1-ubyte"

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        data_file = self._train_data if self._train else self._test_data
        label_file = self._train_label if self._train else self._test_label
        with _open_maybe_gz(os.path.join(self._root, label_file)) as fin:
            fin.read(8)
            label = np.frombuffer(fin.read(), dtype=np.uint8) \
                .astype(np.int32)
        with _open_maybe_gz(os.path.join(self._root, data_file)) as fin:
            fin.read(16)
            data = np.frombuffer(fin.read(), dtype=np.uint8)
            data = data.reshape(len(label), 28, 28, 1)
        self._label = label
        self._data = _host(data)


class FashionMNIST(MNIST):
    """FashionMNIST: MNIST's layout, clothing articles."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10: 32 x 32 x 3 uint8 images, int32 labels."""

    _train_files = ["data_batch_%d.bin" % i for i in range(1, 6)]
    _test_files = ["test_batch.bin"]
    _label_bytes = 1
    _label_idx = 0

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with _open_maybe_gz(filename) as fin:
            raw = np.frombuffer(fin.read(), dtype=np.uint8)
        record = raw.reshape(-1, 3072 + self._label_bytes)
        data = record[:, self._label_bytes:].reshape(-1, 3, 32, 32)
        label = record[:, self._label_idx].astype(np.int32)
        return data.transpose(0, 2, 3, 1), label

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        data, label = zip(*[self._read_batch(os.path.join(self._root, f))
                            for f in files])
        self._data = _host(np.ascontiguousarray(np.concatenate(data)))
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """CIFAR-100: the coarse labels, or the fine ones with
    ``fine_label``."""

    _train_files = ["train.bin"]
    _test_files = ["test.bin"]
    _label_bytes = 2

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._label_idx = 1 if fine_label else 0
        super().__init__(root, train, transform)


class ImageRecordDataset(RecordFileDataset):
    """The images of a RecordIO file (``im2rec``'s), decoded in colour
    (``flag`` 1) or grey (0), with their labels."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        header, img = unpack_img(super().__getitem__(idx),
                                 iscolor=self._flag)
        img = _host(np.asarray(img))
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """The images of ``root/<class>/<file>`` (jpg, jpeg, png), each
    class's label its index in the sorted folder names (``synsets``)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn("Ignoring %s, which is not a directory." % path,
                              stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn("Ignoring %s of type %s. Only support %s"
                                  % (filename, ext, ", ".join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        import cv2
        flag = cv2.IMREAD_COLOR if self._flag else cv2.IMREAD_GRAYSCALE
        img = cv2.imread(self.items[idx][0], flag)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if self._flag \
            else img[..., None]
        img = _host(img)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
