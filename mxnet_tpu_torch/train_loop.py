"""Overlapped train loop (counterpart of ``mxnet_tpu/train_loop.py``): keep
a bounded window of dispatched steps in flight, so that the host-side tail
of step N (a metric's ``asnumpy``, logging) waits on the device only once
steps N+1..N+depth are queued behind it.  PyTorch's CUDA calls return
before the card finishes, so the loop itself runs ahead; any copy to the
host in its body would stop it there.  ``OverlappedLoop`` defers those
tails by ``depth`` steps:

    loop = OverlappedLoop(depth=2)
    for batch in train_iter:
        loss = trainer.step(batch)          # queued on the card
        loop.push(lambda l=loss: float(l.asnumpy()))   # blocks step N-2
    loop.drain()                            # settle the window

``depth=0`` is the serial loop.  The default depth comes from
``MXNET_IO_OVERLAP_DEPTH`` (2).
"""
from __future__ import annotations

import os
from collections import deque
from typing import Callable, Iterable, Optional

__all__ = ["OverlappedLoop", "default_overlap_depth", "run_epoch"]


def default_overlap_depth() -> int:
    """Window size for overlapped loops (``MXNET_IO_OVERLAP_DEPTH``, 2)."""
    try:
        return max(0, int(os.environ.get("MXNET_IO_OVERLAP_DEPTH", "2")))
    except ValueError:
        return 2


class OverlappedLoop:
    """Bounded FIFO of deferred per-step blockers.

    ``push(fn)`` enqueues the blocking tail of the step just dispatched;
    once more than ``depth`` tails are pending, the OLDEST one runs — so
    the host blocks on step N-depth while the device still has steps
    N-depth+1..N queued.  FIFO order means side effects (metric updates,
    callbacks) run in exact step order, just late.
    """

    def __init__(self, depth: Optional[int] = None):
        self.depth = default_overlap_depth() if depth is None else max(
            0, int(depth))
        self._pending: deque = deque()

    def __len__(self):
        return len(self._pending)

    def push(self, blocker: Callable[[], object]):
        """Defer `blocker`; run (and return the result of) the tail that
        falls out of the window, if any."""
        self._pending.append(blocker)
        out = None
        while len(self._pending) > self.depth:
            out = self._pending.popleft()()
        return out

    def drain(self):
        """Run every pending tail (epoch end); returns the last result."""
        out = None
        while self._pending:
            out = self._pending.popleft()()
        return out


def run_epoch(data_iter: Iterable, step_fn: Callable,
              block_fn: Optional[Callable] = None,
              depth: Optional[int] = None):
    """Drive one epoch with the dispatch/block phases overlapped.

    ``step_fn(batch)`` dispatches the (async) step and returns its
    handle; ``block_fn(handle, i)`` — optional — is the blocking tail,
    deferred ``depth`` steps behind dispatch.  Returns the number of
    batches consumed.
    """
    loop = OverlappedLoop(depth)
    n = 0
    for batch in data_iter:
        handle = step_fn(batch)
        if block_fn is not None:
            i = n
            loop.push(lambda h=handle, i=i: block_fn(h, i))
        n += 1
    loop.drain()
    return n
