"""Gluon contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``): ``Concurrent`` and
``HybridConcurrent`` (the children on one input, their outputs
concatenated), ``Identity``, ``SyncBatchNorm`` (on one context it is
``BatchNorm``) and ``SparseEmbedding``, which raises: row-sparse
parameters are not ported yet (Queue 1 item 9)."""
from __future__ import annotations

from ....base import MXNetError
from ...block import Block, HybridBlock
from ...nn import BatchNorm, HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm"]


class Concurrent(Sequential):
    """Feeds the input to every child and concatenates their outputs on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray
        return ndarray.concat(*[block(x) for block in
                                self._children.values()], dim=self.axis)


class HybridConcurrent(HybridSequential):
    """:class:`Concurrent` as a HybridBlock."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)

    def _infer_out_shape(self, in_shape):
        """Every child from the input's shape; the output's is theirs
        joined along ``axis``."""
        outs = [block._infer_out_shape(in_shape)
                for block in self._children.values()]
        axis = self.axis % len(outs[0])
        out = list(outs[0])
        out[axis] = sum(o[axis] for o in outs)
        return tuple(out)


class Identity(HybridBlock):
    """Returns its input (a branch of a Concurrent)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x

    def _infer_out_shape(self, in_shape):
        return tuple(in_shape)


class SparseEmbedding(Block):
    """An Embedding with a row-sparse weight and gradient: not ported yet
    (Queue 1 item 9)."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("SparseEmbedding is not ported yet (Queue 1 item 9)")


class SyncBatchNorm(BatchNorm):
    """BatchNorm whose statistics span the devices of a data-parallel
    step.  The port trains on one context, or on several that the local
    kvstore joins, each with its own statistics; on one context this is
    BatchNorm (``num_devices`` accepted)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
