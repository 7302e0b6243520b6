"""PPO (clipped surrogate) [27]: the port of ``repro/mbrl/ppo.py``. Used by
ME-PPO; one gradient step per call, so the policy worker's Step is the
paper's minimal unit of work."""
from __future__ import annotations

import torch

from repro_torch.mbrl import policy as PI
from repro_torch.mbrl.dynamics import value_and_grad
from repro_torch.optim.optimizers import adam, apply_updates


def ppo_loss(params, params_old, batch, *, clip=0.2, ent_coef=0.0):
    lp = PI.log_prob(params, batch["obs"], batch["act_pre"])
    lp_old = PI.log_prob(params_old, batch["obs"], batch["act_pre"])
    ratio = torch.exp(lp - lp_old)
    adv = batch["adv"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    pg = -torch.minimum(unclipped, clipped).mean()
    return pg - ent_coef * PI.entropy(params)


def make_ppo_step(lr=3e-4, clip=0.2, ent_coef=0.0):
    """Returns ``(opt, step)``; ``step(params, opt_state, params_old,
    batch) -> (params, opt_state, loss)`` takes one Adam step on the clipped
    loss, differentiating ``params`` only."""
    opt = adam(lr)

    def step(params, opt_state, params_old, batch):
        loss, grads = value_and_grad(
            lambda p: ppo_loss(p, params_old, batch, clip=clip,
                               ent_coef=ent_coef), params)
        with torch.no_grad():
            upd, opt_state = opt.update(grads, opt_state, params)
            return apply_updates(params, upd), opt_state, loss

    return opt, step
