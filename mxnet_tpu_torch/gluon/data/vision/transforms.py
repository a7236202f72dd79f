"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, every name of it).

The pixel transforms run on HWC images on the host, as the reference's
do, through :mod:`mxnet_tpu_torch.image`; ``ToTensor`` and ``Normalize``
are HybridBlocks over the ``_image_to_tensor`` and ``_image_normalize``
ops, which ``Compose`` hybridizes together.  Random draws come from
Python's ``random`` (crops, flips, jitters, their order) and numpy's global
generator (``RandomLighting``), as the reference's: one seed of each gives
both packages the same draws.
"""
from __future__ import annotations

import random

import numpy as np

from .... import image as _image
from ....context import cpu
from ....ndarray import ndarray as nd
from ...block import Block, HybridBlock
from ...nn import HybridSequential, Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


def _host(arr):
    return nd.array(np.ascontiguousarray(arr), ctx=cpu())


class Compose(Sequential):
    """The transforms in order; each run of consecutive HybridBlocks is one
    hybridized HybridSequential."""

    def __init__(self, transforms):
        super().__init__()
        transforms = list(transforms) + [None]
        hybrid = []
        for t in transforms:
            if isinstance(t, HybridBlock):
                hybrid.append(t)
                continue
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif len(hybrid) > 1:
                block = HybridSequential()
                for h in hybrid:
                    block.add(h)
                block.hybridize()
                self.add(block)
            hybrid = []
            if t is not None:
                self.add(t)


class Cast(HybridBlock):
    """Casts the input to ``dtype``."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""

    def __init__(self):
        super().__init__()

    def hybrid_forward(self, F, x):
        return F.image.to_tensor(x)


class Normalize(HybridBlock):
    """``(x - mean) / std`` a channel of a CHW / NCHW tensor."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = tuple(np.atleast_1d(np.asarray(mean, np.float32))
                           .tolist())
        self._std = tuple(np.atleast_1d(np.asarray(std, np.float32))
                          .tolist())

    def hybrid_forward(self, F, x):
        return F.image.normalize(x, mean=self._mean, std=self._std)


class Resize(Block):
    """Resizes to ``size``: (w, h), or an int for both sides, or with
    ``keep_ratio`` for the shorter side."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if not self._keep:
                wsize = hsize = self._size
            else:
                h, w = x.shape[:2]
                if h > w:
                    wsize = self._size
                    hsize = int(h * wsize / w)
                else:
                    hsize = self._size
                    wsize = int(w * hsize / h)
        else:
            wsize, hsize = self._size
        return _image.imresize(x, wsize, hsize, self._interpolation)


class CenterCrop(Block):
    """The centred crop of ``size`` (w, h), resized up where the image is
    smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._interpolation = interpolation

    def forward(self, x):
        return _image.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    """A crop of a random area (at least ``scale[0]`` of the image) and
    aspect (in ``ratio``), resized to ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._args = (size, scale, ratio, interpolation)

    def forward(self, x):
        size, scale, ratio, interp = self._args
        return _image.random_size_crop(x, size, scale[0], ratio,
                                       interp=interp)[0]


class RandomFlipLeftRight(Block):
    """Mirrors the image left to right with probability 1/2."""

    def forward(self, x):
        if random.random() < 0.5:
            x = _host(x.asnumpy()[:, ::-1, :])
        return x


class RandomFlipTopBottom(Block):
    """Flips the image top to bottom with probability 1/2."""

    def forward(self, x):
        if random.random() < 0.5:
            x = _host(x.asnumpy()[::-1, :, :])
        return x


class _RandomJitterBase(Block):
    def __init__(self, value):
        super().__init__()
        self._value = value


class RandomBrightness(_RandomJitterBase):
    """Scales the pixels by 1 + U(-value, value), clipped to [0, 255]."""

    def forward(self, x):
        alpha = 1.0 + random.uniform(-self._value, self._value)
        return (x.astype("float32") * alpha).clip(0, 255)


class RandomContrast(_RandomJitterBase):
    """Moves the pixels from the image's mean by 1 + U(-value, value)."""

    def forward(self, x):
        alpha = 1.0 + random.uniform(-self._value, self._value)
        f = x.astype("float32")
        gray = f.mean()
        return ((f - gray) * alpha + gray).clip(0, 255)


class RandomSaturation(_RandomJitterBase):
    """Moves each pixel from its grey level by 1 + U(-value, value)."""

    def forward(self, x):
        alpha = 1.0 + random.uniform(-self._value, self._value)
        f = x.astype("float32")
        coef = _host(np.array([0.299, 0.587, 0.114], np.float32))
        gray = (f * coef.reshape((1, 1, 3))).sum(axis=2, keepdims=True)
        return (f * alpha + gray * (1.0 - alpha)).clip(0, 255)


class RandomHue(_RandomJitterBase):
    """Rotates the hue by U(-value, value) half turns in YIQ space."""

    def forward(self, x):
        alpha = random.uniform(-self._value, self._value)
        f = x.asnumpy().astype(np.float32)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      np.float32)
        tyiq = np.array([[0.299, 0.587, 0.114],
                         [0.596, -0.274, -0.321],
                         [0.211, -0.523, 0.311]], np.float32)
        ityiq = np.array([[1.0, 0.956, 0.621],
                          [1.0, -0.272, -0.647],
                          [1.0, -1.107, 1.705]], np.float32)
        t = ityiq @ bt @ tyiq
        return _host(np.clip(f @ t.T, 0, 255))


class RandomColorJitter(Block):
    """Brightness, contrast, saturation and hue jitters (those given) in a
    random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._transforms)
        random.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise: the eigenvectors of ImageNet's RGB
    covariance, weighted by N(0, alpha) draws times their eigenvalues."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = np.random.normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)
        return (x.astype("float32") + _host(rgb.reshape(1, 1, 3))) \
            .clip(0, 255)
