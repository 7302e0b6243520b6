"""Tanh-squashed Gaussian MLP policy (the paper's pi_theta): the port of
``repro/mbrl/policy.py``.

Params are ``{"w": [(a, b) ...], "b": [(b,) ...], "log_std": (act,)}``,
the reference's tree. Every sampler takes its standard-normal noise
``eps`` injected, or draws it from an explicit ``torch.Generator``: torch
cannot replay ``jax.random``, so the tests hand both packages the same
noise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    obs_dim: int
    act_dim: int
    hidden: int = 64
    depth: int = 2
    init_log_std: float = -0.5


def init_policy(cfg: PolicyConfig, generator: torch.Generator):
    """Random init on the generator's device: normal weights scaled by
    fan_in ** -0.5, zero biases, as the reference draws them."""
    dims = [cfg.obs_dim] + [cfg.hidden] * cfg.depth + [cfg.act_dim]
    dev = generator.device
    return {
        "w": [torch.randn((a, b), generator=generator, device=dev)
              * (a ** -0.5) for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.zeros((b,), device=dev) for b in dims[1:]],
        "log_std": torch.full((cfg.act_dim,), cfg.init_log_std,
                              dtype=torch.float32, device=dev),
    }


def mean_action(params, obs):
    h = obs
    n = len(params["w"])
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ w + b
        if i < n - 1:
            h = torch.tanh(h)
    return h


def _noise(params, obs, eps, generator):
    if eps is not None:
        return eps
    if generator is None:
        raise ValueError("pass the policy noise eps, or a torch.Generator "
                         "to draw it")
    shape = obs.shape[:-1] + (params["w"][-1].shape[1],)
    return torch.randn(shape, generator=generator, device=obs.device)


def sample_from_eps(params, obs, eps):
    """Reparameterised sample from PRE-DRAWN standard-normal noise:
    ``pre = mu + exp(log_std) * eps``, returns ``(tanh(pre), pre)``.

    The single source of the sampling arithmetic: ``sample_action`` and
    ``sample_with_logp`` delegate here."""
    mu = mean_action(params, obs)
    pre = mu + torch.exp(params["log_std"]) * eps
    return torch.tanh(pre), pre


def sample_action(params, obs, eps=None, *,
                  generator: Optional[torch.Generator] = None):
    return sample_from_eps(params, obs,
                           _noise(params, obs, eps, generator))[0]


def sample_action_scaled(params, obs, noise_scale: float, eps=None, *,
                         generator: Optional[torch.Generator] = None):
    """Exploration-scaled sampling for heterogeneous collector fleets:
    the policy's Gaussian std is multiplied by ``noise_scale`` (scale 1.0
    reproduces :func:`sample_action` exactly under the same noise)."""
    mu = mean_action(params, obs)
    std = torch.exp(params["log_std"]) * noise_scale
    return torch.tanh(mu + std * _noise(params, obs, eps, generator))


def deterministic_action(params, obs, eps=None):
    return torch.tanh(mean_action(params, obs))


def log_prob(params, obs, act_pre_tanh):
    """Gaussian log-prob of the PRE-tanh action (pre-tanh actions are
    stored during collection for exact densities)."""
    mu = mean_action(params, obs)
    log_std = params["log_std"]
    z = (act_pre_tanh - mu) / torch.exp(log_std)
    return (-0.5 * z ** 2 - log_std - 0.5 * math.log(2 * math.pi)).sum(-1)


def sample_with_logp(params, obs, eps=None, *,
                     generator: Optional[torch.Generator] = None):
    a, pre = sample_from_eps(params, obs, _noise(params, obs, eps, generator))
    return a, pre, log_prob(params, obs, pre)


def kl_divergence(params_old, params_new, obs):
    """KL(old || new) of the Gaussians (pre-tanh), averaged over obs."""
    mu0 = mean_action(params_old, obs)
    mu1 = mean_action(params_new, obs)
    ls0, ls1 = params_old["log_std"], params_new["log_std"]
    v0, v1 = torch.exp(2 * ls0), torch.exp(2 * ls1)
    kl = (ls1 - ls0 + (v0 + (mu0 - mu1) ** 2) / (2 * v1) - 0.5).sum(-1)
    return kl.mean()


def entropy(params):
    return (params["log_std"]
            + 0.5 * math.log(2 * math.pi * math.e)).sum()
