"""Bounded request queue + dynamic batcher with shape buckets
(counterpart of ``mxnet_tpu/serving/batcher.py``).

Reference analog: Clipper's adaptive batching and TF-Serving's
``BatchingSession`` — concurrent single-request callers are coalesced
into one device-sized batch.  Batches are padded up to the next size in a
small declared ``batch_buckets`` set, so the card only ever sees
``len(batch_buckets)`` input shapes, each bound and warmed up before
traffic, whatever the traffic's shape.

The queue is bounded (admission control): ``put`` rejects with
:class:`QueueFullError` instead of queueing unboundedly — overload
surfaces at the edge as an explicit, cheap rejection rather than as
collapse.  Each request may carry a deadline; the server drops expired
requests *before* execution (a late answer costs a full batch slot and
is still useless to the caller).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..base import MXNetError

__all__ = ["Request", "DynamicBatcher", "ServingError", "QueueFullError",
           "DeadlineExceededError", "ServerClosedError", "pow2_buckets"]


class ServingError(MXNetError):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Admission control: the bounded request queue is full."""


class DeadlineExceededError(ServingError):
    """The request's deadline expired before execution."""


class ServerClosedError(ServingError):
    """The server is shut down (or draining) and not accepting work."""


def pow2_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Power-of-two bucket ladder up to (and always including)
    ``max_batch_size``: 8 -> (1, 2, 4, 8); 6 -> (1, 2, 4, 6)."""
    if max_batch_size < 1:
        raise ServingError("max_batch_size must be >= 1, got %r"
                           % (max_batch_size,))
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


class Request:
    """One in-flight inference request: inputs, deadline, and a
    one-shot completion event the caller blocks on.

    ``inputs`` maps input name -> np.ndarray of shape ``(rows, *example)``;
    a request may carry several examples (``rows`` >= 1).  ``deadline``
    is an absolute ``time.monotonic()`` instant or None.  ``slo_class``
    is the scheduling class (see :mod:`~mxnet_tpu_torch.serving.scheduler`);
    the plain FIFO batcher ignores it.
    """

    __slots__ = ("inputs", "rows", "deadline", "slo_class", "submit_t",
                 "dequeue_t", "outcome", "_event", "_outputs", "_error")

    def __init__(self, inputs: Dict[str, np.ndarray], rows: int,
                 deadline: Optional[float] = None,
                 slo_class: str = "standard"):
        self.inputs = inputs
        self.rows = int(rows)
        self.deadline = deadline
        self.slo_class = slo_class
        self.submit_t = time.monotonic()
        self.dequeue_t = None
        self.outcome = None          # ok | rejected | deadline | error
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= self.deadline

    # -- completion (server side) ------------------------------------------
    def _fail(self, error: Exception, outcome: str):
        self._error = error
        self.outcome = outcome
        self._event.set()

    # -- waiting (caller side) ---------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until completion; returns the list of per-output arrays
        (each ``(rows, *out_shape)``) or raises the failure."""
        if not self._event.wait(timeout):
            raise ServingError("request not completed within %.3fs"
                               % (timeout,))
        if self._error is not None:
            raise self._error
        return self._outputs


class DynamicBatcher:
    """Bounded FIFO of :class:`Request` + batch formation.

    ``get_batch`` blocks for the first request, then holds the batch open
    for up to ``batch_timeout_ms`` (or until ``max_batch_size`` rows are
    queued) so concurrent callers coalesce, and dequeues a prefix of the
    queue that fits ``max_batch_size`` rows.  FIFO order is never
    reordered — a large request at the head is not overtaken by smaller
    ones behind it (no starvation).
    """

    def __init__(self, batch_buckets: Sequence[int], max_batch_size: int,
                 batch_timeout_ms: float, queue_depth: int):
        buckets = sorted(set(int(b) for b in batch_buckets))
        if not buckets or buckets[0] < 1:
            raise ServingError("batch_buckets must be positive ints, got %r"
                               % (batch_buckets,))
        if buckets[-1] != int(max_batch_size):
            raise ServingError(
                "largest bucket (%d) must equal max_batch_size (%d)"
                % (buckets[-1], max_batch_size))
        self.buckets = tuple(buckets)
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout = float(batch_timeout_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue = collections.deque()
        self._rows_queued = 0
        self._closed = False

    # -- introspection -----------------------------------------------------
    def __len__(self):
        with self._lock:
            return len(self._queue)

    @property
    def rows_queued(self) -> int:
        with self._lock:
            return self._rows_queued

    @property
    def closed(self) -> bool:
        return self._closed

    def bucket_for(self, rows: int) -> Optional[int]:
        """Smallest declared bucket >= rows, or None if rows exceeds the
        largest bucket."""
        for b in self.buckets:
            if rows <= b:
                return b
        return None

    # -- producer side -----------------------------------------------------
    def put(self, req: Request):
        """Admit a request or reject loudly (never blocks)."""
        if req.rows > self.max_batch_size:
            raise ServingError(
                "request carries %d rows > max_batch_size %d (split it)"
                % (req.rows, self.max_batch_size))
        with self._nonempty:
            if self._closed:
                raise ServerClosedError("server is shut down")
            if len(self._queue) >= self.queue_depth:
                raise QueueFullError(
                    "serving queue full (%d requests); retry with backoff"
                    % len(self._queue))
            self._queue.append(req)
            self._rows_queued += req.rows
            self._nonempty.notify()

    def close(self):
        """Stop admitting; wakes all ``get_batch`` waiters so workers can
        drain the remaining queue and exit."""
        with self._nonempty:
            self._closed = True
            self._nonempty.notify_all()

    def drop_all(self, error_factory):
        """Fail every queued request (non-draining shutdown); returns the
        number dropped."""
        with self._nonempty:
            dropped = list(self._queue)
            self._queue.clear()
            self._rows_queued = 0
        for req in dropped:
            req._fail(error_factory(), "error")
        return len(dropped)

    # -- consumer side -----------------------------------------------------
    def _hold_window(self):
        """With the lock held and a request queued: hold the batch open for
        up to ``batch_timeout`` or until ``max_batch_size`` rows are queued,
        so that stragglers coalesce."""
        window_end = time.monotonic() + self.batch_timeout
        while self._rows_queued < self.max_batch_size and not self._closed:
            remaining = window_end - time.monotonic()
            if remaining <= 0:
                break
            self._nonempty.wait(remaining)

    def get_batch(self):
        """Next batch of requests (FIFO prefix fitting max_batch_size rows)
        or None when closed and fully drained."""
        with self._nonempty:
            while not self._queue:
                if self._closed:
                    return None
                self._nonempty.wait()
            self._hold_window()
            reqs, rows = [], 0
            now = time.monotonic()
            while self._queue:
                nxt = self._queue[0]
                if rows + nxt.rows > self.max_batch_size:
                    break
                self._queue.popleft()
                self._rows_queued -= nxt.rows
                nxt.dequeue_t = now
                reqs.append(nxt)
                rows += nxt.rows
            return reqs
