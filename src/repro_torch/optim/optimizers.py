"""Minimal functional optimizers over trees of tensors: the port of
``repro/optim/optimizers.py``, spelled as the reference spells them.

An ``Optimizer`` is an (init, update) pair:

    opt = adam(3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``torch.optim`` is not used: its Adam divides by ``sqrt(v)/sqrt(bc2)``
and keeps its step on the host, so it does not reproduce the reference's
f32 ``m/bc1 / (sqrt(v/bc2) + eps)``. The step counter is a 0-d int32
tensor on the parameters' device, so an update never waits on the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ----------------------------------------------------------------- schedules
def constant_schedule(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_schedule(lr: float, decay_steps: int, final_frac: float = 0.0):
    def f(step):
        t = torch.clamp(step / max(decay_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(torch.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  final_frac: float = 0.0):
    cos = cosine_schedule(lr, max(decay_steps - warmup_steps, 1), final_frac)

    def f(step):
        warm = lr * step / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))
    return f


def _as_schedule(lr):
    return lr if callable(lr) else constant_schedule(lr)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------- optimizers
class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params)
        return AdamState(_step0(params), zeros, tree_map(torch.clone, zeros))

    def update(grads, state: AdamState, params=None):
        step = state.step + 1
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                      grads)
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)
        lr_t = sched(step)

        def upd(m, v, p):
            u = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        if params is None:
            updates = tree_map(lambda m, v: upd(m, v, None), mu, nu)
        else:
            updates = tree_map(upd, mu, nu, params)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Any


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        mom = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        return SGDState(_step0(params), mom)

    def update(grads, state: SGDState, params=None):
        step = state.step + 1
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                           state.momentum, grads)
        else:
            mom = tree_map(lambda g: g.to(torch.float32), grads)
        lr_t = sched(step)
        updates = tree_map(lambda m: -lr_t * m, mom)
        return updates, SGDState(step, mom)

    return Optimizer(init, update)


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    """Wrap an optimizer with global-norm gradient clipping."""
    def update(grads, state, params=None):
        norm = torch.sqrt(sum(torch.vdot(g.reshape(-1), g.reshape(-1))
                              for g in tree_leaves(grads)) + 1e-12)
        scale = torch.clamp(max_norm / norm, max=1.0).to(torch.float32)
        grads = tree_map(lambda g: g * scale, grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)
