"""ModelServer: dynamic-batching inference over forward-only Predictors
(counterpart of ``mxnet_tpu/serving/server.py``).

The server owns one :class:`~mxnet_tpu_torch.predictor.Predictor` **per
declared batch bucket**, all sharing the same symbol and parameter tensors
(``Predictor.reshape``), so the card holds one copy of the weights.
``warmup()`` runs every bucket once at startup, so the kernels' build and
the libraries' first-call set-up happen before traffic.

Request path: ``submit`` validates and admits into the SLO scheduler
(bounded queue, explicit :class:`QueueFullError` / :class:`AdmissionError`
on overload); a worker thread forms a batch, drops expired-deadline
requests *before* execution, concatenates the survivors' rows, zero-pads
to the bucket size, runs the bucket's predictor under the swap lock and
slices each request's rows back out.  ``swap_params`` takes the same lock,
so every batch runs against exactly one weight set: a hot swap is atomic
at batch granularity.  Worker threads launch on the card themselves: every
kernel runs on the calling thread's current stream.

Not ported yet: the mesh-sharded Predictor (``mesh=``,
``sharding_rules=``), which needs sharded execution, and the telemetry,
tracing, runlog and memory-census hooks of the reference server.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..base import get_env
from .batcher import (DeadlineExceededError, QueueFullError, Request,
                      ServerClosedError, ServingError, pow2_buckets)
from .scheduler import SLO_CLASSES, AdmissionError, SloScheduler

__all__ = ["ServingConfig", "ModelServer"]


class ServingConfig:
    """Server knobs; constructor arguments override the ``MXNET_SERVING_*``
    environment defaults, as in the reference (``server.py:87-132``)."""

    def __init__(self, max_batch_size=None, batch_buckets=None,
                 batch_timeout_ms=None, queue_depth=None,
                 default_deadline_ms=None, num_workers=None,
                 shed_batch_at=None, shed_standard_at=None,
                 retry_after_ms=None):
        if max_batch_size is None:
            max_batch_size = get_env("MXNET_SERVING_MAX_BATCH", 8, int)
        if batch_timeout_ms is None:
            batch_timeout_ms = get_env(
                "MXNET_SERVING_BATCH_TIMEOUT_MS", 2.0, float)
        if queue_depth is None:
            queue_depth = get_env("MXNET_SERVING_QUEUE_DEPTH", 256, int)
        if default_deadline_ms is None:
            default_deadline_ms = get_env(
                "MXNET_SERVING_DEADLINE_MS", 0.0, float)
        if num_workers is None:
            num_workers = get_env("MXNET_SERVING_WORKERS", 1, int)
        if batch_buckets is None:
            env_buckets = get_env("MXNET_SERVING_BUCKETS", None)
            if env_buckets:
                batch_buckets = tuple(
                    int(b) for b in env_buckets.split(",") if b.strip())
            else:
                batch_buckets = pow2_buckets(int(max_batch_size))
        if shed_batch_at is None:
            shed_batch_at = get_env("MXNET_SERVING_SHED_BATCH_AT", 0.5,
                                    float)
        if shed_standard_at is None:
            shed_standard_at = get_env("MXNET_SERVING_SHED_STANDARD_AT",
                                       0.8, float)
        if retry_after_ms is None:
            retry_after_ms = get_env("MXNET_SERVING_RETRY_AFTER_MS", 50.0,
                                     float)
        self.max_batch_size = int(max_batch_size)
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.queue_depth = int(queue_depth)
        self.default_deadline_ms = float(default_deadline_ms)
        self.num_workers = max(1, int(num_workers))
        self.shed_batch_at = float(shed_batch_at)
        self.shed_standard_at = float(shed_standard_at)
        self.retry_after_ms = float(retry_after_ms)


class ModelServer:
    """Dynamic-batching model server over forward-only Predictors.

    Parameters
    ----------
    symbol_json, params, ctx
        Forwarded to :class:`~mxnet_tpu_torch.predictor.Predictor`; ``ctx``
        defaults to ``gpu(0)``.
    example_shapes : dict of name -> per-example shape (NO batch dim)
        e.g. ``{"data": (3, 224, 224)}``; the server prepends the bucket
        batch dimension itself.
    config : ServingConfig, optional
        Extra keyword arguments build one (``max_batch_size=...`` etc.).
    name : str
        Model name, reported by ``stats()``; the key it registers under in
        a :class:`~mxnet_tpu_torch.serving.registry.ModelRegistry`.
    mesh, sharding_rules
        The reference's mesh-sharded Predictor; not ported yet (raises).
    """

    def __init__(self, symbol_json, params, example_shapes, ctx=None,
                 config: Optional[ServingConfig] = None,
                 name: str = "default", mesh=None, sharding_rules=None,
                 **config_kwargs):
        from ..predictor import Predictor

        if mesh is not None or sharding_rules is not None:
            raise ServingError("ModelServer(mesh=, sharding_rules=): the "
                               "mesh-sharded Predictor is not ported yet")
        if config is None:
            config = ServingConfig(**config_kwargs)
        elif config_kwargs:
            raise ServingError("pass either config= or config kwargs, "
                               "not both")
        self.config = config
        self.name = str(name)
        self._example_shapes = {k: tuple(int(d) for d in s)
                                for k, s in dict(example_shapes).items()}
        if not self._example_shapes:
            raise ServingError("example_shapes must name at least one input")
        self._batcher = SloScheduler(
            config.batch_buckets, config.max_batch_size,
            config.batch_timeout_ms, config.queue_depth,
            shed_batch_at=config.shed_batch_at,
            shed_standard_at=config.shed_standard_at,
            retry_after_ms=config.retry_after_ms)
        self._admission_checked_at = 0.0

        # one predictor per bucket, sharing symbol/params via reshape
        buckets = self._batcher.buckets
        base = Predictor(symbol_json, params, ctx=ctx, input_shapes={
            k: (buckets[-1],) + s for k, s in self._example_shapes.items()})
        self._predictors = {buckets[-1]: base}
        for b in buckets[:-1]:
            self._predictors[b] = base.reshape(
                {k: (b,) + s for k, s in self._example_shapes.items()})

        self._swap_lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self._started = False
        self._stopped = False
        self._warmed = False
        self._recent_outcomes: collections.deque = collections.deque(
            maxlen=256)
        self._count_lock = threading.Lock()
        #: executed (padded) batches, one forward each
        self.batches = 0
        self.warmup_seconds: Optional[float] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, warmup: bool = True):
        """Spawn the worker thread(s), after running every bucket once
        when ``warmup`` is set."""
        if self._stopped:
            raise ServerClosedError("server already stopped")
        if self._started:
            return self
        if warmup:
            self.warmup()
        for i in range(self.config.num_workers):
            t = threading.Thread(target=self._worker_loop,
                                 name="mxtt-serving-worker-%d" % i,
                                 daemon=True)
            t.start()
            self._workers.append(t)
        self._started = True
        return self

    def warmup(self):
        """Run every bucket once on zeros, so that no request waits on a
        kernel build or a library's first-call set-up."""
        if self._warmed:
            return
        t0 = time.perf_counter()
        with self._swap_lock:
            for b, pred in sorted(self._predictors.items()):
                feed = {k: np.zeros((b,) + s, np.float32)
                        for k, s in self._example_shapes.items()}
                outs = pred.forward(**feed)
                for o in outs:
                    o.asnumpy()          # waits for the device
        self.warmup_seconds = time.perf_counter() - t0
        self._warmed = True

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Shut down.  ``drain=True`` (graceful): stop admitting, execute
        everything already queued, then join the workers.  ``drain=False``:
        fail queued requests with :class:`ServerClosedError` immediately."""
        if self._stopped:
            return
        self._stopped = True
        self._batcher.close()
        if not drain:
            self._batcher.drop_all(
                lambda: ServerClosedError("server shut down before "
                                          "this request executed"))
        for t in self._workers:
            t.join(timeout)
        self._workers = []

    # -- request admission -------------------------------------------------
    def _validate(self, inputs):
        """Normalize to {name: (rows, *example)} float arrays; returns
        (feed, rows)."""
        feed, rows = {}, None
        if set(inputs) != set(self._example_shapes):
            raise ServingError(
                "inputs %s do not match declared %s"
                % (sorted(inputs), sorted(self._example_shapes)))
        for name, value in inputs.items():
            eshape = self._example_shapes[name]
            arr = value.asnumpy() if hasattr(value, "asnumpy") \
                else np.asarray(value)
            if arr.shape == eshape:            # single example: add row dim
                arr = arr[None]
            elif arr.shape[1:] != eshape:
                raise ServingError(
                    "input %r has shape %s; want (rows,)+%s or %s"
                    % (name, arr.shape, eshape, eshape))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ServingError(
                    "inputs disagree on rows: %d vs %d for %r"
                    % (rows, arr.shape[0], name))
            feed[name] = arr
        if rows < 1:
            raise ServingError("request carries zero rows")
        return feed, rows

    def _update_admission(self):
        """Rate-limited re-evaluation of the health verdict into the
        scheduler's shed floor: a degraded server sheds ``batch`` traffic
        even before occupancy alone would."""
        now = time.monotonic()
        if now - self._admission_checked_at < 0.2:
            return
        self._admission_checked_at = now
        causes = [c for c in self.health()["causes"] if c != "stopped"]
        self._batcher.set_shed_floor(1 if causes else 0)

    def submit(self, inputs, deadline_ms: Optional[float] = None,
               slo_class: str = "standard") -> Request:
        """Admit one request; returns a :class:`Request` future.

        Raises :class:`QueueFullError` when the bounded queue is full,
        :class:`AdmissionError` when admission control is shedding
        ``slo_class`` (carries ``retry_after_s``),
        :class:`ServerClosedError` after shutdown, :class:`ServingError`
        on malformed inputs.  ``deadline_ms`` (or the configured default)
        bounds end-to-end latency: requests still queued past the deadline
        are dropped unexecuted (and order execution within a class: EDF).
        """
        feed, rows = self._validate(inputs)
        if slo_class not in SLO_CLASSES:
            raise ServingError("unknown slo_class %r (one of %s)"
                               % (slo_class, list(SLO_CLASSES)))
        if deadline_ms is None and self.config.default_deadline_ms > 0:
            deadline_ms = self.config.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = Request(feed, rows, deadline, slo_class=slo_class)
        self._update_admission()
        try:
            self._batcher.put(req)
        except AdmissionError as e:
            req._fail(e, "shed")
            raise
        except (QueueFullError, ServerClosedError) as e:
            req._fail(e, "rejected")
            raise
        return req

    def predict(self, inputs, deadline_ms=None, timeout=30.0,
                slo_class: str = "standard"):
        """Synchronous convenience: submit + wait; returns the list of
        per-output arrays, each ``(rows, *out_shape)``."""
        return self.submit(inputs, deadline_ms=deadline_ms,
                           slo_class=slo_class).result(timeout)

    # -- hot swap ----------------------------------------------------------
    def swap_params(self, params, aux_params=None):
        """Atomically replace the served weights between batches.

        ``params`` is a {name: array} dict (``arg:``/``aux:`` prefixes
        accepted, checkpoint convention).  Shapes must match the bound
        graph: a swap never rebinds.  The swap lock excludes batch
        execution, so every request's batch runs against exactly one
        weight set (old or new, never a mix)."""
        args, auxs = {}, dict(aux_params or {})
        for k, v in dict(params).items():
            if k.startswith("arg:"):
                args[k[4:]] = v
            elif k.startswith("aux:"):
                auxs[k[4:]] = v
            else:
                args[k] = v
        with self._swap_lock:
            for pred in self._predictors.values():
                pred.copy_params_from(args, auxs or None,
                                      allow_extra_params=True)

    # -- execution ---------------------------------------------------------
    def _worker_loop(self):
        while True:
            reqs = self._batcher.get_batch()
            if reqs is None:
                return
            now = time.monotonic()
            live = []
            for r in reqs:
                if r.expired(now):
                    self._finish(r, DeadlineExceededError(
                        "deadline expired %.1fms before execution"
                        % ((now - r.deadline) * 1e3)), "deadline")
                else:
                    live.append(r)
            if not live:
                continue
            try:
                self._execute(live)
            except Exception as e:  # noqa: BLE001 - a batch failure must
                # fail its requests, never kill the worker loop
                err = e if isinstance(e, ServingError) else ServingError(
                    "batch execution failed: %s: %s" % (type(e).__name__, e))
                for r in live:
                    self._finish(r, err, "error")

    def _execute(self, live):
        rows = sum(r.rows for r in live)
        bucket = self._batcher.bucket_for(rows)
        feed = {}
        for name, eshape in self._example_shapes.items():
            mats = [r.inputs[name] for r in live]
            arr = mats[0] if len(mats) == 1 else np.concatenate(mats, axis=0)
            if rows < bucket:
                arr = np.concatenate(
                    [arr, np.zeros((bucket - rows,) + eshape, arr.dtype)],
                    axis=0)
            feed[name] = arr
        pred = self._predictors[bucket]
        # the host copy waits for the device, so a fault in the batch's
        # kernels surfaces here and fails this batch's requests
        with self._swap_lock:
            outs = [o.asnumpy() for o in pred.forward(**feed)]
        with self._count_lock:
            self.batches += 1
        offset = 0
        for r in live:
            r._outputs = [o[offset:offset + r.rows] for o in outs]
            offset += r.rows
            self._finish(r, None, "ok")

    def _finish(self, req, error, outcome):
        self._recent_outcomes.append(outcome)
        if error is None:
            req.outcome = "ok"
            req._event.set()
        else:
            req._fail(error, outcome)

    # -- introspection -----------------------------------------------------
    def health(self) -> Dict[str, object]:
        """Health verdict: degraded on queue saturation or a high
        deadline-miss rate."""
        causes = []
        qcap = self.config.queue_depth
        saturation = (len(self._batcher) / float(qcap)) if qcap else 0.0
        if saturation >= 0.9:
            causes.append("queue_saturated")
        recent = list(self._recent_outcomes)
        misses = sum(1 for o in recent if o == "deadline")
        miss_rate = (misses / float(len(recent))) if recent else 0.0
        if len(recent) >= 20 and miss_rate > 0.5:
            causes.append("deadline_misses")
        if self._stopped:
            causes.append("stopped")
        return {
            "status": "degraded" if causes else "serving",
            "causes": causes,
            "queue_saturation": saturation,
            "deadline_miss_rate": miss_rate,
            "recent_requests": len(recent),
            **self.stats(),
        }

    def stats(self) -> Dict[str, object]:
        return {
            "model": self.name,
            "buckets": list(self._batcher.buckets),
            "max_batch_size": self.config.max_batch_size,
            "batch_timeout_ms": self.config.batch_timeout_ms,
            "queue_depth": len(self._batcher),
            "queue_capacity": self.config.queue_depth,
            "rows_queued": self._batcher.rows_queued,
            "queued_by_class": self._batcher.queued_by_class(),
            "admission_level": self._batcher.level,
            "batches": self.batches,
            "workers": len(self._workers),
            "started": self._started,
            "stopped": self._stopped,
            "warmed": self._warmed,
        }
