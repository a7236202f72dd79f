"""Vision datasets and transforms (counterpart of
``mxnet_tpu/gluon/data/vision``)."""
from .datasets import (CIFAR10, CIFAR100, MNIST, FashionMNIST,
                       ImageFolderDataset, ImageRecordDataset)
from . import transforms
