"""Small tree helpers over nested dicts, lists and tuples of tensors: the
port of ``repro/utils/tree.py``, plus the map/flatten primitives that JAX
provides as ``jax.tree`` and the port has to spell out.

Every helper visits leaves in one order (dict insertion order, then list
order), so ``tree_leaves`` and ``tree_unflatten`` round-trip.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_sub(a, b):
    return tree_map(lambda x, y: x - y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b):
    leaves = tree_leaves(tree_map(lambda x, y: torch.vdot(
        x.reshape(-1), y.reshape(-1)), a, b))
    return sum(leaves, start=torch.zeros((), dtype=torch.float32,
                                         device=leaves[0].device))


def tree_norm(a):
    return torch.sqrt(tree_dot(a, a))


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_to(a, device):
    return tree_map(lambda x: x.to(device), a)
