"""Inference serving (counterpart of ``mxnet_tpu/serving``): a
:class:`ModelServer` with dynamic batching into padded buckets, an
SLO-aware scheduler (``realtime`` > ``standard`` > ``batch``, EDF within a
class), deadlines, admission shedding and atomic hot swap of the weights
between batches; a :class:`ModelRegistry` of named models, each its own
server; and a stdlib JSON endpoint over either (:mod:`.http`).

    from mxnet_tpu_torch import serving
    reg = serving.ModelRegistry()
    reg.register("m1", sym.tojson(), params,
                 example_shapes={"data": (3, 224, 224)}, max_batch_size=32)
    probs, = reg.predict({"data": image}, model="m1", slo_class="realtime")
    port = serving.start_http_server(reg, port=0)   # POST /predict
"""
from __future__ import annotations

from .batcher import (DeadlineExceededError, DynamicBatcher, QueueFullError,
                      Request, ServerClosedError, ServingError, pow2_buckets)
from .scheduler import SLO_CLASSES, AdmissionError, SloScheduler
from .server import ModelServer, ServingConfig
from .registry import ModelRegistry, UnknownModelError
from .http import start_http_server, stop_http_server

__all__ = ["ModelServer", "ModelRegistry", "ServingConfig",
           "DynamicBatcher", "SloScheduler", "Request", "SLO_CLASSES",
           "ServingError", "QueueFullError", "DeadlineExceededError",
           "ServerClosedError", "AdmissionError", "UnknownModelError",
           "pow2_buckets", "start_http_server", "stop_http_server"]
