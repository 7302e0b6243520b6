"""Shape-count instrumentation for the port's hot-path functions: the eager
counterpart of ``repro/utils/jit_stats.py``.

The reference counts how often a jitted function traces, since each trace
is a compile for a new input signature. PyTorch runs eagerly, so the port
counts the distinct input shapes a function has seen instead. The hot-path
invariant "compile once, no retrace after warmup" becomes "one input shape
from the first call on", asserted through ``shape_count``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _signature(x) -> Any:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    shards = getattr(x, "shards", None)     # a core.roles.RowShards
    if isinstance(shards, list):
        return ("shards",) + tuple(_signature(v) for v in shards)
    return type(x).__name__  # e.g. the LM, or a host int like a ring's size


class ShapeCounted:
    """Callable wrapper that records the distinct input shapes of its
    calls: the eager counterpart of a jit's trace count."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._seen = set()

    def __call__(self, *args):
        self._seen.add(_signature(args))
        return self.fn(*args)

    @property
    def shape_count(self) -> int:
        return len(self._seen)
