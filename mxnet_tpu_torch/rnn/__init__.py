"""The symbolic-era RNN package (counterpart of ``mxnet_tpu/rnn``):
:class:`BucketSentenceIter`, the iterator that groups sentences into
length buckets for ``module.BucketingModule``."""
from .io import BucketSentenceIter

__all__ = ["BucketSentenceIter"]
