"""SLO-aware request scheduler: priority classes, EDF, admission shedding
(counterpart of ``mxnet_tpu/serving/scheduler.py``).

Replaces the FIFO pop of :class:`~mxnet_tpu_torch.serving.batcher.DynamicBatcher`
with service-level-objective scheduling (the Clipper/INFaaS lineage):

* every request carries an **SLO class** — ``realtime`` > ``standard`` >
  ``batch`` — and batches are formed strictly by class priority;
* **within** a class requests are ordered earliest-deadline-first (EDF);
  deadline-less requests keep submission order, so a default-class,
  deadline-less workload degenerates to exactly FIFO;
* **admission control sheds lowest class first**: as queue occupancy
  crosses ``shed_batch_at`` / ``shed_standard_at`` (or when the server's
  ``health()`` verdict degrades — the server raises the *shed floor*),
  ``batch`` then ``standard`` submissions are rejected with
  :class:`AdmissionError` (HTTP 429 + Retry-After) while ``realtime``
  traffic is admitted until the queue is genuinely full.

Everything under ``self._nonempty`` is O(queued requests) Python
bookkeeping: no device work, no I/O.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import Sequence

from .batcher import (DynamicBatcher, QueueFullError, Request,
                      ServerClosedError, ServingError)

__all__ = ["SLO_CLASSES", "AdmissionError", "SloScheduler"]

#: priority order, highest first; index == priority value (lower = better)
SLO_CLASSES = ("realtime", "standard", "batch")
_PRIORITY = {c: i for i, c in enumerate(SLO_CLASSES)}


class AdmissionError(ServingError):
    """Admission control shed this request (HTTP 429): the server is
    saturated/degraded and the request's SLO class is below the current
    admission floor.  ``retry_after_s`` is the client backoff hint."""

    def __init__(self, msg, retry_after_s: float = 0.05):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class SloScheduler(DynamicBatcher):
    """Drop-in DynamicBatcher replacement with SLO classes.

    Storage is one EDF heap per class (entries ``(deadline|inf, seq,
    req)``); ``put``/``get_batch``/``drop_all`` are overridden, the
    bucket/window/close plumbing is inherited.  Batch formation pops the
    highest-priority class first and never lets a lower-priority request
    overtake a higher-priority head that doesn't fit.

    Shed levels: 0 admit all, 1 shed ``batch``, 2 shed ``standard`` too.
    The effective level is ``max(occupancy-derived level, shed floor)``
    where the floor is set by the owning server from its health verdict
    (:meth:`set_shed_floor`).
    """

    def __init__(self, batch_buckets: Sequence[int], max_batch_size: int,
                 batch_timeout_ms: float, queue_depth: int,
                 shed_batch_at: float = 0.5, shed_standard_at: float = 0.8,
                 retry_after_ms: float = 50.0):
        super().__init__(batch_buckets, max_batch_size, batch_timeout_ms,
                         queue_depth)
        self.shed_batch_at = float(shed_batch_at)
        self.shed_standard_at = float(shed_standard_at)
        self.retry_after_s = float(retry_after_ms) / 1e3
        self._heaps = {c: [] for c in SLO_CLASSES}
        self._count = 0
        self._seq = itertools.count()
        self._shed_floor = 0
        self._level = 0

    # -- introspection -----------------------------------------------------
    def __len__(self):
        with self._lock:
            return self._count

    @property
    def level(self) -> int:
        """Current effective shed level (0..2)."""
        with self._lock:
            return max(self._level, self._shed_floor)

    def queued_by_class(self):
        with self._lock:
            return {c: len(h) for c, h in self._heaps.items()}

    # -- admission control -------------------------------------------------
    def set_shed_floor(self, floor: int):
        """Minimum shed level, driven by the server's health verdict: a
        degraded server sheds ``batch`` (floor 1) even before the queue
        saturates."""
        with self._nonempty:
            self._shed_floor = max(0, min(2, int(floor)))

    # -- producer side -----------------------------------------------------
    def put(self, req: Request):
        """Admit or shed; never blocks.  Raises :class:`AdmissionError`
        when the request's class is currently shed, :class:`QueueFullError`
        when the queue is full outright (any class)."""
        if req.rows > self.max_batch_size:
            raise ServingError(
                "request carries %d rows > max_batch_size %d (split it)"
                % (req.rows, self.max_batch_size))
        cls = req.slo_class
        if cls not in _PRIORITY:
            raise ServingError("unknown slo_class %r (one of %s)"
                               % (cls, list(SLO_CLASSES)))
        with self._nonempty:
            if self._closed:
                raise ServerClosedError("server is shut down")
            occ = (self._count / float(self.queue_depth)
                   if self.queue_depth else 1.0)
            occ_level = 0
            if occ >= self.shed_standard_at:
                occ_level = 2
            elif occ >= self.shed_batch_at:
                occ_level = 1
            self._level = occ_level
            level = max(occ_level, self._shed_floor)
            if self._count >= self.queue_depth:
                raise QueueFullError(
                    "serving queue full (%d requests); retry with backoff"
                    % self._count)
            if level > 0 and _PRIORITY[cls] >= 3 - level:
                raise AdmissionError(
                    "admission control shedding %r traffic (level %d, "
                    "queue %.0f%% full); retry after %.0f ms"
                    % (cls, level, occ * 100.0, self.retry_after_s * 1e3),
                    retry_after_s=self.retry_after_s)
            dkey = req.deadline if req.deadline is not None else float("inf")
            heapq.heappush(self._heaps[cls], (dkey, next(self._seq), req))
            self._count += 1
            self._rows_queued += req.rows
            self._nonempty.notify()

    def drop_all(self, error_factory):
        with self._nonempty:
            dropped = [entry[2] for c in SLO_CLASSES
                       for entry in self._heaps[c]]
            for c in SLO_CLASSES:
                self._heaps[c] = []
            self._count = 0
            self._rows_queued = 0
        for req in dropped:
            req._fail(error_factory(), "error")
        return len(dropped)

    # -- consumer side -----------------------------------------------------
    def get_batch(self):
        """Next batch: highest class first, EDF within class, stop at the
        first head that doesn't fit (no overtaking across or within
        classes).  None when closed and drained."""
        with self._nonempty:
            while self._count == 0:
                if self._closed:
                    return None
                self._nonempty.wait()
            self._hold_window()
            reqs, rows = [], 0
            now = time.monotonic()
            for cls in SLO_CLASSES:
                heap = self._heaps[cls]
                blocked = False
                while heap:
                    nxt = heap[0][2]
                    if rows + nxt.rows > self.max_batch_size:
                        blocked = True
                        break
                    heapq.heappop(heap)
                    self._count -= 1
                    self._rows_queued -= nxt.rows
                    nxt.dequeue_t = now
                    reqs.append(nxt)
                    rows += nxt.rows
                if blocked:
                    break
            return reqs
