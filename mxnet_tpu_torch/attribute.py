"""Attribute scope (counterpart of ``mxnet_tpu/attribute.py``): default
attributes (``ctx_group`` for model parallelism across devices,
``__lr_mult__``, ...) stamped onto every Symbol node made inside the
scope, variables and the nodes of operator overloads included.  An op's
own keywords beat an explicit ``attr`` dict, which beats the scope; nested
scopes merge, the inner one winning."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current_attrs"]

_local = threading.local()


class AttrScope:
    """``with AttrScope(ctx_group="dev1"): ...``; values are kept as
    strings, as the reference keeps them."""

    def __init__(self, **kwargs):
        self._attr = {k: str(v) for k, v in kwargs.items()}
        self._old = None

    def get(self, attr):
        """The scope's attributes updated with ``attr``."""
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        self._old = getattr(_local, "scope", None)
        if self._old is not None:
            self._attr = dict(self._old._attr, **self._attr)
        _local.scope = self
        return self

    def __exit__(self, *exc):
        _local.scope = self._old


def current_attrs():
    """The attributes of the innermost scope (a new dict)."""
    scope = getattr(_local, "scope", None)
    return dict(scope._attr) if scope is not None else {}
