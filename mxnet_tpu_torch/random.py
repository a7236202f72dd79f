"""Seeding, one ``torch.Generator`` per device, and a stream of seeds for
per-step generators (counterpart of ``mxnet_tpu/random.py``, whose
per-context threefry streams and fresh keys become PyTorch generators).
The same seed gives the same draws on a device in every run; draws differ
from the reference package's, so tests that compare the two packages make
their inputs with numpy."""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from .context import Context, current_context

__all__ = ["seed", "generator", "next_seed"]

_lock = threading.Lock()
_seed: Optional[int] = None
_gens: Dict[Tuple[int, int], torch.Generator] = {}
_seeds: Optional[torch.Generator] = None     # host stream behind next_seed


def seed(seed_state: int, ctx: Optional[Context] = None):
    """Seed the generators (parity: ``mxnet.random.seed``): with no ``ctx``
    every device's generator restarts from ``seed_state``, with one only
    that device's."""
    global _seed, _seeds
    with _lock:
        if ctx is None:
            _seed = int(seed_state)
            _gens.clear()
            _seeds = None
        else:
            _gens[(ctx.device_typeid, ctx.device_id)] = \
                torch.Generator(device=ctx.torch_device) \
                .manual_seed(int(seed_state))


def generator(ctx: Optional[Context] = None) -> torch.Generator:
    """The generator of ``ctx`` (default: the current context), made at
    first use from the global seed, or from PyTorch's initial seed when
    ``seed`` was never called."""
    ctx = ctx or current_context()
    key = (ctx.device_typeid, ctx.device_id)
    with _lock:
        gen = _gens.get(key)
        if gen is None:
            gen = torch.Generator(device=ctx.torch_device)
            gen.manual_seed(_seed if _seed is not None
                            else torch.initial_seed())
            _gens[key] = gen
        return gen


def next_seed() -> int:
    """A fresh seed for a per-step generator (the reference's
    ``next_key``): the next draw of a host stream that :func:`seed`
    restarts, so a run is repeated exactly from the same seed."""
    global _seeds
    with _lock:
        if _seeds is None:
            _seeds = torch.Generator().manual_seed(
                _seed if _seed is not None else torch.initial_seed())
        return int(torch.randint(0, 2 ** 62, (1,), generator=_seeds))
