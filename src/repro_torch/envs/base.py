"""Batched continuous-control environments in PyTorch: the port of
``repro/envs/base.py``.

Each env is a stateless frozen dataclass. Its functions work on tensors of
any leading shape, ``(..., obs_dim)`` states and ``(..., act_dim)``
actions, which takes the place of the reference's ``vmap``::

  reset_from(draws)     -> state  (obs == state here)
  step(state, action)   -> (next_state, reward)
  reward(s, a, s2)      -> reward
  obs_dim / act_dim / horizon / dt (control period, seconds)

Randomness is injected. torch cannot replay ``jax.random``, so a reset
takes its draws as a tensor: ``reset_shape`` standard draws per lane, from
``reset_dist`` ("uniform" on [0, 1) or "normal"), which ``reset_from``
maps to a state exactly as the reference's ``reset(key)`` maps its own
draws. ``rollout``/``rollout_batch`` take the reset draws and the
``(H, B, act_dim)`` policy noise, or a ``torch.Generator`` to make them.
``dt`` drives the paper's wall-clock simulation: collecting one trajectory
"takes" horizon * dt seconds of robot time (§5.1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.utils.tree import tree_leaves

# policy_fn(params, states (B, obs_dim), eps (B, act_dim)) -> actions
PolicyFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Env:
    obs_dim: int
    act_dim: int
    horizon: int
    dt: float  # control period in seconds (1/control frequency)
    name: str = "env"
    reset_shape: tuple = ()
    reset_dist: str = "normal"

    def reset_from(self, draws: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state, action):
        raise NotImplementedError

    def reward(self, s, a, s2):
        """Reward as a function of (s, a, s') — used by imagination."""
        raise NotImplementedError

    def reset_draws(self, n: int, generator: torch.Generator
                    ) -> torch.Tensor:
        """``n`` lanes of reset draws from ``generator``, on its device."""
        shape = (int(n),) + tuple(self.reset_shape)
        draw = torch.rand if self.reset_dist == "uniform" else torch.randn
        return draw(shape, generator=generator, device=generator.device)

    def reset_batch(self, generator: torch.Generator, n: int
                    ) -> torch.Tensor:
        """``n`` start states from ``generator``: the imagination algos'
        ``init_state_fn``, as the reference's ``reset_batch(key, n)``."""
        return self.reset_from(self.reset_draws(n, generator))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def rollout_batch(self, policy_fn: PolicyFn, policy_params, n: int, *,
                      reset_draws: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      horizon: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """Collect ``n`` trajectories at once — the env farm: ``n`` robots
        stepped together on the policy's device. Returns ``obs``, ``act``,
        ``next_obs`` of shape (n, H, ·) and ``rew`` of shape (n, H).

        ``reset_draws`` (n, *reset_shape) and ``noise`` (H, n, act_dim)
        default to draws from ``generator``: the reset draws first, then
        the noise."""
        n, H = int(n), int(horizon or self.horizon)
        if n < 1:
            raise ValueError(f"rollout_batch needs n >= 1, got {n}")
        dev = tree_leaves(policy_params)[0].device
        if (reset_draws is None or noise is None) and generator is None:
            raise ValueError("rollout_batch needs reset_draws and noise, or "
                             "a torch.Generator to draw them")
        if reset_draws is None:
            reset_draws = self.reset_draws(n, generator)
        if noise is None:
            noise = torch.randn((H, n, self.act_dim), generator=generator,
                                device=generator.device)
        if tuple(reset_draws.shape) != (n,) + tuple(self.reset_shape):
            raise ValueError(f"reset_draws {tuple(reset_draws.shape)} for "
                             f"{n} lanes of {self.name}")
        if tuple(noise.shape) != (H, n, self.act_dim):
            raise ValueError(f"noise {tuple(noise.shape)}, expected "
                             f"{(H, n, self.act_dim)}")
        s = self.reset_from(reset_draws.to(dev))
        noise = noise.to(dev)
        obs, act, nobs, rew = [], [], [], []
        for h in range(H):
            a = policy_fn(policy_params, s, noise[h])
            s2, r = self.step(s, a)
            obs.append(s)
            act.append(a)
            nobs.append(s2)
            rew.append(r)
            s = s2
        return {"obs": torch.stack(obs, 1), "act": torch.stack(act, 1),
                "next_obs": torch.stack(nobs, 1), "rew": torch.stack(rew, 1)}

    def rollout(self, policy_fn: PolicyFn, policy_params, *,
                reset_draw: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                horizon: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """One trajectory: ``reset_draw`` (*reset_shape), ``noise``
        (H, act_dim). Returns (H, ·) arrays."""
        traj = self.rollout_batch(
            policy_fn, policy_params, 1,
            reset_draws=None if reset_draw is None else reset_draw[None],
            noise=None if noise is None else noise[:, None],
            generator=generator, horizon=horizon)
        return {k: v[0] for k, v in traj.items()}


def uniform(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """A [0, 1) draw mapped to [minval, maxval), as ``jax.random.uniform``
    maps its bits."""
    return torch.clamp(u * (maxval - minval) + minval, min=minval)


def angle_normalize(x):
    return ((x + math.pi) % (2 * math.pi)) - math.pi
