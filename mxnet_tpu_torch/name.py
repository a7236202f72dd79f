"""Name manager (counterpart of ``mxnet_tpu/name.py``): automatic node
names ``<hint><i>`` from per-scope counters, and ``Prefix`` scopes that
prepend a Gluon block's prefix to every name made inside them."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current_scope"]

_local = threading.local()


class NameManager:
    """Counts names per hint; ``with NameManager():`` starts fresh counts."""

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return "%s%d" % (hint, i)

    def __enter__(self):
        self._old = getattr(_local, "scope", None)
        _local.scope = self
        return self

    def __exit__(self, *exc):
        _local.scope = self._old


class Prefix(NameManager):
    """Prepends ``prefix`` to every name, explicit names included."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + (name if name else super().get(None, hint))


def current_scope() -> NameManager:
    """The innermost scope of this thread, else a per-thread default whose
    counts persist for the thread's life."""
    scope = getattr(_local, "scope", None)
    if scope is None:
        scope = getattr(_local, "default", None)
        if scope is None:
            scope = _local.default = NameManager()
    return scope
