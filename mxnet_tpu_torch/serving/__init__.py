"""Inference serving (counterpart of ``mxnet_tpu/serving``): a
:class:`ModelServer` with dynamic batching into padded buckets, an
SLO-aware scheduler (``realtime`` > ``standard`` > ``batch``, EDF within a
class), deadlines and admission shedding.

    from mxnet_tpu_torch import serving
    server = serving.ModelServer(sym.tojson(), params,
                                 example_shapes={"data": (3, 224, 224)},
                                 max_batch_size=32).start()
    probs, = server.predict({"data": image}, slo_class="realtime")
"""
from __future__ import annotations

from .batcher import (DeadlineExceededError, DynamicBatcher, QueueFullError,
                      Request, ServerClosedError, ServingError, pow2_buckets)
from .scheduler import SLO_CLASSES, AdmissionError, SloScheduler
from .server import ModelServer, ServingConfig

__all__ = ["ModelServer", "ServingConfig", "DynamicBatcher", "SloScheduler",
           "Request", "SLO_CLASSES", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError", "AdmissionError",
           "pow2_buckets"]
