"""Stdlib JSON inference endpoint over a :class:`ModelServer` or a
multi-model :class:`~mxnet_tpu_torch.serving.registry.ModelRegistry`
(counterpart of ``mxnet_tpu/serving/http.py``).

``http.server`` on daemon threads, loopback bind by default (the wire is
unauthenticated JSON: exposing it wider is an explicit operator choice via
``MXNET_SERVING_HOST``).

Routes::

    POST /predict        {"inputs": {name: nested list}, "deadline_ms": n?,
                          "model": "name"?, "slo_class": "realtime|standard|batch"?}
                         -> 200 {"outputs": [...], "rows": n}
    GET  /healthz        -> 200 {"status": "serving", ...verdict} when
                         healthy; 503 {"status": "degraded",
                         "causes": [...]} on queue saturation or a high
                         deadline-miss rate
    GET  /stats          -> 200 server (or per-model registry) stats JSON
    GET  /models         -> 200 {"models": [names]} (registry only)

Overload maps to status codes a load balancer understands: 503 for
queue-full rejection and shutdown, **429 + Retry-After** when admission
control sheds the request's SLO class, 504 for an expired deadline, **404**
for an unknown model name, **413** for a request body over
``MXNET_SERVING_MAX_BODY_BYTES`` (default 8 MiB: an unbounded read would
let one client buffer arbitrary memory in the server), 400 for malformed
requests.
"""
from __future__ import annotations

import json
import threading

from ..base import get_env
from .batcher import (DeadlineExceededError, QueueFullError,
                      ServerClosedError, ServingError)
from .registry import ModelRegistry, UnknownModelError
from .scheduler import AdmissionError

__all__ = ["start_http_server", "stop_http_server"]

_server = None
_server_thread = None
_server_lock = threading.Lock()


def start_http_server(model_server, port=None, host=None,
                      max_body_bytes=None):
    """Serve the inference endpoint for ``model_server`` (a ModelServer or
    a ModelRegistry) on a daemon thread; returns the bound port (``port=0``
    picks a free one).  Defaults: ``MXNET_SERVING_PORT`` (0),
    ``MXNET_SERVING_HOST`` (127.0.0.1), ``MXNET_SERVING_MAX_BODY_BYTES``
    (8 MiB)."""
    import http.server

    if port is None:
        port = get_env("MXNET_SERVING_PORT", 0, int)
    if host is None:
        host = get_env("MXNET_SERVING_HOST", "127.0.0.1")
    if max_body_bytes is None:
        max_body_bytes = get_env("MXNET_SERVING_MAX_BODY_BYTES",
                                 8 << 20, int)
    max_body_bytes = int(max_body_bytes)
    is_registry = isinstance(model_server, ModelRegistry)

    class Handler(http.server.BaseHTTPRequestHandler):
        def _reply(self, code, doc, headers=None):
            body = json.dumps(doc).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - stdlib API
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                doc = model_server.health()
                self._reply(
                    503 if doc.get("status") == "degraded" else 200, doc)
            elif path == "/stats":
                self._reply(200, model_server.stats())
            elif path == "/models" and is_registry:
                self._reply(200, {"models": model_server.models()})
            else:
                self.send_error(404)

        def do_POST(self):  # noqa: N802 - stdlib API
            path = self.path.split("?", 1)[0]
            if path != "/predict":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except (TypeError, ValueError):
                self._reply(400, {"error": "bad Content-Length"})
                return
            if length > max_body_bytes:
                # reject BEFORE reading: the bound is the whole point; the
                # unread body makes the connection unreusable
                self.close_connection = True
                self._reply(413, {
                    "error": "request body %d bytes > limit %d "
                             "(MXNET_SERVING_MAX_BODY_BYTES)"
                             % (length, max_body_bytes),
                    "outcome": "too_large"})
                return
            try:
                doc = json.loads(self.rfile.read(length) or b"{}")
                inputs = doc["inputs"]
                if not isinstance(inputs, dict):
                    raise ValueError("inputs must be an object")
                deadline_ms = doc.get("deadline_ms")
                slo_class = doc.get("slo_class") or "standard"
                model = doc.get("model")
            except (ValueError, KeyError, TypeError) as e:
                self._reply(400, {"error": "bad request: %s" % e})
                return
            try:
                if is_registry:
                    outs = model_server.predict(
                        inputs, model=model, deadline_ms=deadline_ms,
                        slo_class=slo_class)
                else:
                    if model is not None and \
                            model != getattr(model_server, "name", model):
                        raise UnknownModelError(
                            "unknown model %r (serving %r)"
                            % (model, model_server.name))
                    outs = model_server.predict(
                        inputs, deadline_ms=deadline_ms,
                        slo_class=slo_class)
            except UnknownModelError as e:
                self._reply(404, {"error": str(e)})
            except AdmissionError as e:
                self._reply(429, {"error": str(e), "outcome": "shed"},
                            headers={"Retry-After":
                                     "%.3f" % e.retry_after_s})
            except (QueueFullError, ServerClosedError) as e:
                self._reply(503, {"error": str(e), "outcome": "rejected"})
            except DeadlineExceededError as e:
                self._reply(504, {"error": str(e), "outcome": "deadline"})
            except ServingError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 - surface, don't kill
                self._reply(500, {"error": "%s: %s" % (type(e).__name__, e)})
            else:
                self._reply(200, {"outputs": [o.tolist() for o in outs],
                                  "rows": int(outs[0].shape[0]) if outs
                                  else 0})

        def log_message(self, *args):  # keep request lines out of stderr
            pass

    global _server, _server_thread
    with _server_lock:
        if _server is not None:
            return _server.server_address[1]
        srv = http.server.ThreadingHTTPServer((host, int(port)), Handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="mxtt-serving-http", daemon=True)
        t.start()
        _server, _server_thread = srv, t
        return srv.server_address[1]


def stop_http_server():
    """Shut the endpoint down and close its socket (a no-op when none
    runs)."""
    global _server, _server_thread
    with _server_lock:
        if _server is None:
            return
        _server.shutdown()
        _server.server_close()
        _server = None
        _server_thread = None
