"""ModelRegistry: N named models behind one serving gateway (counterpart of
``mxnet_tpu/serving/registry.py``).

Each registered model is a full :class:`~mxnet_tpu_torch.serving.server.
ModelServer` (its own bucket ladder, warmup, SLO scheduler, admission
control and atomic hot swap), so models are isolated: swapping or
unregistering model A never pauses model B's batches, and one model's
saturation sheds *its* low-class traffic without touching its neighbours.

A server is built **and warmed** before it becomes routable, so a request
never reaches a model whose kernels are still being built.  The registry
lock guards only the name -> server map; warmup, drain and thread joins
happen outside it.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .batcher import Request, ServingError
from .server import ModelServer, ServingConfig

__all__ = ["UnknownModelError", "ModelRegistry"]


class UnknownModelError(ServingError):
    """Request named a model this registry does not host (HTTP 404)."""


class ModelRegistry:
    """Name -> :class:`ModelServer` map with routed submit/predict.

    ``register`` builds and warms a server, then publishes it; ``submit`` /
    ``predict`` route by model name (optional while exactly one model is
    registered).  ``stats()`` / ``health()`` aggregate across models: the
    registry is degraded iff any model is.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._models: Dict[str, ModelServer] = {}

    # -- membership --------------------------------------------------------
    def register(self, name, symbol_json, params, example_shapes,
                 ctx=None, mesh=None, sharding_rules=None,
                 config: Optional[ServingConfig] = None, start: bool = True,
                 **config_kwargs) -> ModelServer:
        """Build, warm and publish a model; every bucket has run once
        before the name becomes routable."""
        name = str(name)
        with self._lock:
            if name in self._models:
                raise ServingError("model %r already registered" % name)
        srv = ModelServer(symbol_json, params, example_shapes, ctx=ctx,
                          config=config, name=name, mesh=mesh,
                          sharding_rules=sharding_rules, **config_kwargs)
        if start:
            srv.start()
        published = False
        with self._lock:
            if name not in self._models:
                self._models[name] = srv
                published = True
        if not published:
            srv.stop(drain=False)
            raise ServingError("model %r already registered" % name)
        return srv

    def unregister(self, name, drain: bool = True):
        """Remove a model and stop its server (drain by default: queued
        requests finish; the name stops routing at once)."""
        with self._lock:
            srv = self._models.pop(str(name), None)
        if srv is None:
            raise UnknownModelError("unknown model %r" % (name,))
        srv.stop(drain=drain)
        return srv

    def models(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def get(self, name=None) -> ModelServer:
        """Resolve a model name; ``None`` routes to the single registered
        model (explicit names required once there are several)."""
        with self._lock:
            if name is None:
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                raise UnknownModelError(
                    "model name required (%d models registered)"
                    % len(self._models))
            srv = self._models.get(str(name))
        if srv is None:
            raise UnknownModelError(
                "unknown model %r (have %s)" % (name, self.models()))
        return srv

    def __contains__(self, name):
        with self._lock:
            return str(name) in self._models

    def __len__(self):
        with self._lock:
            return len(self._models)

    # -- routed request path -----------------------------------------------
    def submit(self, inputs, model=None, deadline_ms=None,
               slo_class: str = "standard") -> Request:
        return self.get(model).submit(inputs, deadline_ms=deadline_ms,
                                      slo_class=slo_class)

    def predict(self, inputs, model=None, deadline_ms=None,
                slo_class: str = "standard", timeout: float = 30.0):
        return self.get(model).predict(inputs, deadline_ms=deadline_ms,
                                       slo_class=slo_class, timeout=timeout)

    def swap_params(self, name, params, aux_params=None):
        """Atomic hot swap of one model's weights; the other models keep
        serving (per-model swap locks)."""
        self.get(name).swap_params(params, aux_params)

    # -- lifecycle / introspection ------------------------------------------
    def stop_all(self, drain: bool = True):
        with self._lock:
            models = list(self._models.values())
            self._models.clear()
        for srv in models:
            srv.stop(drain=drain)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            models = dict(self._models)
        return {"models": {n: s.stats() for n, s in models.items()}}

    def health(self) -> Dict[str, object]:
        """Aggregate verdict: degraded iff any model is, with causes
        namespaced ``<model>:<cause>``."""
        with self._lock:
            models = dict(self._models)
        per = {n: s.health() for n, s in models.items()}
        causes = sorted("%s:%s" % (n, c)
                        for n, doc in per.items() for c in doc["causes"])
        return {
            "status": "degraded" if causes else "serving",
            "causes": causes,
            "models": per,
        }
