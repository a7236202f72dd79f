"""Image decoding, augmentation and ``ImageIter`` (counterpart of
``mxnet_tpu/image.py``).

Everything here is host work, as in the reference: decoding (``cv2``),
resizing and cropping, the augmenters (numpy), one image at a time.  So
``imread``, ``imdecode`` and every function and augmenter return NDArrays
on ``cpu()``, as upstream MXNet's image operators do, and a chain of
augmenters never crosses the bus; :class:`ImageIter` puts only the
assembled batch on its ``ctx``.  Inputs may be NDArrays or numpy arrays
(HWC).

Random choices draw from the generators the reference uses: Python's
``random`` for crops, flips, jitters and shuffles, numpy's for
``LightingAug``; global by default, or from ``rng`` (a ``random.Random``;
``LightingAug`` and ``CreateAugmenter``'s ``np_rng``: a numpy
``Generator`` or ``RandomState``).  The detection names of the reference's
module (``ImageDetIter`` and its augmenters) are not ported yet.
"""
from __future__ import annotations

import json
import os
import random as _pyrandom

import numpy as np

from . import io as _io
from . import recordio
from .base import MXNetError
from .context import Context, cpu, current_context
from .ndarray import ndarray as nd
from .ndarray.ndarray import NDArray

__all__ = ["imread", "imdecode", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug",
           "RandomOrderAug", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "RandomSizedCropAug", "CenterCropAug", "BrightnessJitterAug",
           "ContrastJitterAug", "SaturationJitterAug", "HueJitterAug",
           "ColorJitterAug", "LightingAug", "ColorNormalizeAug",
           "RandomGrayAug", "HorizontalFlipAug", "CastAug", "CreateAugmenter",
           "ImageIter"]


def _cv2():
    import cv2
    return cv2


def _np(src) -> np.ndarray:
    """The host array of an NDArray (no copy on the CPU) or array-like."""
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _host(arr, dtype=None) -> NDArray:
    """An NDArray on ``cpu()`` holding a copy of ``arr``."""
    return nd.array(arr, cpu(), dtype=dtype)


def _float(arr) -> np.ndarray:
    """``arr`` as it enters float arithmetic: float32 unless it already is
    a float (the reference's arrays promote integers to float32)."""
    return arr if np.issubdtype(arr.dtype, np.floating) \
        else arr.astype(np.float32)


def _decoded(img, flag, to_rgb):
    cv2 = _cv2()
    if flag and to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return _host(img, np.uint8)


def imread(filename, flag=1, to_rgb=True):
    """Read and decode an image file: HWC uint8, RGB unless ``to_rgb`` is
    False, one channel when ``flag`` is 0."""
    cv2 = _cv2()
    img = cv2.imread(filename,
                     cv2.IMREAD_COLOR if flag else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("cannot read image %s" % filename)
    return _decoded(img, flag, to_rgb)


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an encoded image (bytes or a uint8 array) as :func:`imread`
    does a file."""
    cv2 = _cv2()
    raw = np.frombuffer(buf, dtype=np.uint8) \
        if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, np.uint8)
    img = cv2.imdecode(raw, cv2.IMREAD_COLOR if flag
                       else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("cannot decode image")
    return _decoded(img, flag, to_rgb)


def _get_interp(interp):
    cv2 = _cv2()
    return {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR, 2: cv2.INTER_CUBIC,
            3: cv2.INTER_AREA, 4: cv2.INTER_LANCZOS4}.get(interp,
                                                          cv2.INTER_LINEAR)


def imresize(src, w, h, interp=1):
    """``src`` resized to width ``w`` and height ``h``."""
    arr = _np(src)
    out = _cv2().resize(arr, (w, h), interpolation=_get_interp(interp))
    if out.ndim == 2:
        out = out[:, :, None]
    return _host(out, arr.dtype)


def scale_down(src_size, size):
    """``size`` (w, h) scaled down, keeping its aspect, to fit
    ``src_size``."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """``src`` with its shorter side resized to ``size``."""
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The (x0, y0, w, h) crop of ``src``, resized to ``size`` if given."""
    arr = _np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return _host(out, arr.dtype)


def random_crop(src, size, interp=2, rng=None):
    """A random crop of (w, h) = ``size`` (scaled down to fit, then
    resized up); returns ``(crop, (x0, y0, w, h))``."""
    rng = rng or _pyrandom
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = rng.randint(0, w - new_w)
    y0 = rng.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """The centred crop of (w, h) = ``size``; returns ``(crop, (x0, y0, w,
    h))``."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` (either may be None)."""
    out = _float(_np(src))
    if mean is not None:
        out = out - _np(mean)
    if std is not None:
        out = out / _np(std)
    return _host(out)


def random_size_crop(src, size, min_area, ratio, interp=2, rng=None,
                     **kwargs):
    """An Inception-style crop: a random area of at least ``min_area`` of
    the image and an aspect in ``ratio``, resized to ``size``; ten tries,
    then :func:`center_crop`."""
    rng = rng or _pyrandom
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(min_area, 1.0) * area
        new_ratio = rng.uniform(*ratio)
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if rng.random() < 0.5:
            new_h, new_w = new_w, new_h
        if new_w <= w and new_h <= h:
            x0 = rng.randint(0, w - new_w)
            y0 = rng.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


class Augmenter:
    """An image augmenter: ``aug(src)`` returns the augmented image."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """``'["name", {kwargs}]'``."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs],
                          default=str)

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    """The augmenters ``ts`` in order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """The augmenters ``ts`` in a random order."""

    def __init__(self, ts, rng=None):
        super().__init__()
        self.ts = ts
        self.rng = rng or _pyrandom

    def __call__(self, src):
        ts = list(self.ts)
        self.rng.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    """The short side resized to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    """Resized to (w, h) = ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    """:func:`random_crop` to ``size``."""

    def __init__(self, size, interp=2, rng=None):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp
        self.rng = rng

    def __call__(self, src):
        return random_crop(src, self.size, self.interp, rng=self.rng)[0]


class RandomSizedCropAug(Augmenter):
    """:func:`random_size_crop` to ``size``."""

    def __init__(self, size, min_area, ratio, interp=2, rng=None):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp
        self.rng = rng

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp, rng=self.rng)[0]


class CenterCropAug(Augmenter):
    """:func:`center_crop` to ``size``."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class BrightnessJitterAug(Augmenter):
    """Scaled by 1 + U(-brightness, brightness)."""

    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness)
        self.brightness = brightness
        self.rng = rng or _pyrandom

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.brightness, self.brightness)
        return _host(_float(_np(src)) * alpha)


class ContrastJitterAug(Augmenter):
    """Blended with its mean grey level by 1 + U(-contrast, contrast)."""

    coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.rng = rng or _pyrandom

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.contrast, self.contrast)
        arr = _np(src)
        gray = float((arr * self.coef).sum()) / arr.size * 3.0
        return _host(_float(arr) * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    """Blended with its per-pixel grey by 1 + U(-saturation,
    saturation)."""

    coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.rng = rng or _pyrandom

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.saturation, self.saturation)
        arr = _np(src)
        gray = (arr * self.coef).sum(axis=2, keepdims=True)
        return _host(arr * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """The hue rotated by U(-hue, hue) half-turns in YIQ space."""

    tyiq = np.array([[0.299, 0.587, 0.114],
                     [0.596, -0.274, -0.321],
                     [0.211, -0.523, 0.311]], np.float32)
    ityiq = np.array([[1.0, 0.956, 0.621],
                      [1.0, -0.272, -0.647],
                      [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue, rng=None):
        super().__init__(hue=hue)
        self.hue = hue
        self.rng = rng or _pyrandom

    def __call__(self, src):
        alpha = self.rng.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      np.float32)
        t = (self.ityiq @ bt @ self.tyiq).T
        return _host(_np(src) @ t)


class ColorJitterAug(RandomOrderAug):
    """Brightness, contrast and saturation jitters in a random order."""

    def __init__(self, brightness, contrast, saturation, rng=None):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness, rng=rng))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast, rng=rng))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation, rng=rng))
        super().__init__(ts, rng=rng)


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise: ``eigvec * N(0, alphastd) @ eigval``
    added to each pixel; the draw from ``rng`` (numpy; default its global
    generator)."""

    def __init__(self, alphastd, eigval, eigvec, rng=None):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)
        self.rng = rng if rng is not None else np.random

    def __call__(self, src):
        alpha = self.rng.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _host(_float(_np(src))
                     + rgb.reshape(1, 1, 3).astype(np.float32))


class ColorNormalizeAug(Augmenter):
    """:func:`color_normalize` by ``mean`` and ``std``."""

    def __init__(self, mean, std):
        super().__init__(mean=list(np.ravel(mean)) if mean is not None
                         else None,
                         std=list(np.ravel(std)) if std is not None else None)
        self.mean = np.asarray(mean, np.float32) if mean is not None \
            else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    """Grey (the same luma in every channel) with probability ``p``."""

    coef = np.array([[0.299], [0.587], [0.114]], np.float32)

    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng or _pyrandom

    def __call__(self, src):
        if self.rng.random() < self.p:
            arr = _np(src)
            gray = arr @ self.coef
            src = _host(np.broadcast_to(gray, arr.shape))
        return src


class HorizontalFlipAug(Augmenter):
    """Mirrored left to right with probability ``p``."""

    def __init__(self, p, rng=None):
        super().__init__(p=p)
        self.p = p
        self.rng = rng or _pyrandom

    def __call__(self, src):
        if self.rng.random() < self.p:
            src = _host(_np(src)[:, ::-1])
        return src


class CastAug(Augmenter):
    """Cast to ``typ`` (float32 by default)."""

    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_np(src), self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2, rng=None, np_rng=None):
    """The reference's standard augmenter list for a (C, H, W)
    ``data_shape`` (``image.py:389``); ``mean=True``/``std=True`` take
    ImageNet's.  ``rng`` (a ``random.Random``) and ``np_rng`` (numpy,
    for ``pca_noise``) replace the global generators."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise MXNetError("rand_resize needs rand_crop")
        auglist.append(RandomSizedCropAug(
            crop_size, 0.08, (3.0 / 4.0, 4.0 / 3.0), inter_method, rng=rng))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method, rng=rng))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5, rng=rng))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation,
                                      rng=rng))
    if hue:
        auglist.append(HueJitterAug(hue, rng=rng))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec, rng=np_rng))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray, rng=rng))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        mean = np.asarray(mean)
        if mean.shape[0] not in (1, 3):
            raise MXNetError("mean needs 1 or 3 values, got %d"
                             % mean.shape[0])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        std = np.asarray(std)
        if std.shape[0] not in (1, 3):
            raise MXNetError("std needs 1 or 3 values, got %d"
                             % std.shape[0])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(_io.DataIter):
    """Batches of images from a ``.rec`` file (with its ``.idx``), an
    ``.lst`` file (``path_imglist``, ``index<TAB>labels...<TAB>path``) or
    an ``imglist`` of ``(label, path)`` under ``path_root``, decoded and
    augmented one by one on the host (``image.py:436``).  ``shuffle``
    reorders at each ``reset`` with ``rng`` (a ``random.Random``; default
    Python's global generator); ``num_parts``/``part_index`` keep every
    ``num_parts``-th image; other keywords go to :func:`CreateAugmenter`
    unless ``aug_list`` is given.  A short last batch is zero-filled, and
    ``pad`` counts the rows.  Batches land on ``ctx`` (default: the
    current context)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=None,
                 num_parts=None, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 ctx: Context = None, rng=None, **kwargs):
        super().__init__(batch_size)
        if not (path_imgrec or path_imglist or isinstance(imglist, list)
                or path_root):
            raise MXNetError("ImageIter: give path_imgrec, path_imglist, "
                             "imglist or path_root")
        if num_parts is None and part_index is None:
            from .parallel.mesh import host_shard_hint
            part_index, num_parts = host_shard_hint()
        num_parts = 1 if num_parts is None else int(num_parts)
        part_index = 0 if part_index is None else int(part_index)
        if not 0 <= part_index < num_parts:
            raise MXNetError("ImageIter: part_index %d out of range for "
                             "num_parts %d" % (part_index, num_parts))
        if path_imgrec:
            if path_imgidx is None:
                path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(
                path_imgidx, path_imgrec, "r")
            self.imgidx = list(self.imgrec.keys)
        else:
            self.imgrec = None
        self.imglist = {}
        if path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.array(
                        [float(i) for i in parts[1:-1]], np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
        elif isinstance(imglist, list):
            for i, item in enumerate(imglist):
                self.imglist[i] = (np.array(item[0], np.float32)
                                   if isinstance(item[0], (list, tuple))
                                   else np.array([item[0]], np.float32),
                                   item[1])
            self.seq = list(self.imglist.keys())
        elif self.imgrec is not None:
            self.seq = self.imgidx
        else:
            raise MXNetError("path_root-only mode requires path_imglist")
        if num_parts > 1:
            self.seq = self.seq[part_index::num_parts]
        self.path_root = path_root
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.ctx = ctx or current_context()
        self.rng = rng or _pyrandom
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self._data_name = data_name
        self._label_name = label_name
        self.reset()

    @property
    def provide_data(self):
        return [_io.DataDesc(self._data_name,
                             (self.batch_size,) + self.data_shape,
                             np.float32)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [_io.DataDesc(self._label_name, shape, np.float32)]

    def reset(self):
        if self.shuffle:
            self.rng.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        """``(label, encoded image)`` of the next image."""
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            header, img = recordio.unpack(self.imgrec.read_idx(idx))
            if idx in self.imglist:
                return self.imglist[idx][0], img
            return header.label, img
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root or "", fname), "rb") as fin:
            img = fin.read()
        return label, img

    def next(self):
        batch_data = np.zeros(
            (self.batch_size,) + self.data_shape, np.float32)
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        batch_label = np.zeros(shape, np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, s = self.next_sample()
                data = imdecode(s)
                for aug in self.auglist:
                    data = aug(data)
                batch_data[i] = _np(data).transpose(2, 0, 1)
                batch_label[i] = label if self.label_width > 1 \
                    else (label[0] if hasattr(label, "__len__") else label)
                i += 1
        except StopIteration:
            if i == 0:
                raise
        return _io.DataBatch([nd.array(batch_data, self.ctx)],
                             [nd.array(batch_label, self.ctx)],
                             pad=self.batch_size - i)
