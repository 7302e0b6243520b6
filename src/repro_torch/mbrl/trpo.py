"""TRPO: conjugate-gradient natural step + KL line search [Schulman 15]:
the port of ``repro/mbrl/trpo.py``.

Operates on imagined (model) or real batches: dict with obs (N, D),
act_pre (N, A), adv (N,). Nothing here reads a value back to the host:
``found``, the step fraction and the NaN guard are device tensors, as in
the reference's jitted step.
"""
from __future__ import annotations

import torch
from torch.func import jvp, vjp, vmap

from repro_torch.mbrl import policy as PI
from repro_torch.mbrl.dynamics import value_and_grad
from repro_torch.utils.tree import (tree_add, tree_dot, tree_map, tree_scale,
                                    tree_zeros_like)


def surrogate(params, params_old, batch):
    lp = PI.log_prob(params, batch["obs"], batch["act_pre"])
    lp_old = PI.log_prob(params_old, batch["obs"], batch["act_pre"])
    ratio = torch.exp(lp - lp_old)
    return (ratio * batch["adv"]).mean()


def _cg(hvp, g, iters=10, damping=1e-2):
    """Conjugate gradient for (H + damping I) x = g over trees, ``iters``
    steps from x = 0."""
    x = tree_zeros_like(g)
    r = g
    p = g
    rs = tree_dot(r, r)
    for _ in range(iters):
        hp = tree_add(hvp(p), tree_scale(p, damping))
        alpha = rs / (tree_dot(p, hp) + 1e-10)
        x = tree_add(x, tree_scale(p, alpha))
        r = tree_add(r, tree_scale(hp, -alpha))
        rs_new = tree_dot(r, r)
        p = tree_add(r, tree_scale(p, rs_new / (rs + 1e-10)))
        rs = rs_new
    return x


@torch.no_grad()
def trpo_step(params, batch, *, max_kl=0.01, cg_iters=10, backtrack=10,
              backtrack_coef=0.8, fvp_subsample=4):
    """One TRPO update. Returns (new_params, info).

    Every constant of the frozen pre-step policy (mean actions, log-probs,
    variances) is computed once up front. The CG step direction uses the
    Gauss-Newton Fisher-vector product (one ``jvp`` + one ``vjp`` of the
    mean network, exact at the pre-step point) on every
    ``fvp_subsample``-th row, keeping at least 256 rows. The KL trust region
    is enforced on the FULL batch by the line search, which evaluates all
    backtrack candidates as one ``vmap``-ed batch and takes the first
    acceptable one."""
    obs = batch["obs"]
    mu_old = PI.mean_action(params, obs)
    ls_old = params["log_std"]
    v_old = torch.exp(2 * ls_old)
    lp_old = PI.log_prob(params, obs, batch["act_pre"])

    def surrogate_new(p):
        lp = PI.log_prob(p, obs, batch["act_pre"])
        return (torch.exp(lp - lp_old) * batch["adv"]).mean()

    def kl_new(p):
        """KL(old || p) with the old policy's stats precomputed."""
        mu1 = PI.mean_action(p, obs)
        ls1 = p["log_std"]
        v1 = torch.exp(2 * ls1)
        return (ls1 - ls_old + (v_old + (mu_old - mu1) ** 2) / (2 * v1)
                - 0.5).sum(-1).mean()

    g = value_and_grad(surrogate_new, params)[1]

    # keep >=256 rows in the Fisher estimate: tiny batches subsampled
    # further yield directions the line search rejects outright
    stride = max(1, min(fvp_subsample, obs.shape[0] // 256))
    obs_fvp = obs[::stride]
    n_fvp = obs_fvp.shape[0]

    def mu_fvp(p):
        return PI.mean_action(p, obs_fvp)
    _, vjp_mu = vjp(mu_fvp, params)

    def fvp(v):
        jv = jvp(mu_fvp, (params,), (v,))[1]
        out = vjp_mu(jv / v_old / n_fvp)[0]
        # log_std block of the Gaussian Fisher is diagonal 2; mean/log_std
        # cross terms vanish at the pre-step point
        return {**out, "log_std": out["log_std"] + 2.0 * v["log_std"]}

    step_dir = _cg(fvp, g, iters=cg_iters)
    shs = tree_dot(step_dir, fvp(step_dir))
    lm = torch.sqrt(torch.clamp(shs, min=1e-10) / (2 * max_kl))
    full_step = tree_scale(step_dir, 1.0 / torch.clamp(lm, min=1e-10))
    expected = tree_dot(g, full_step)

    fracs = backtrack_coef ** torch.arange(backtrack, dtype=obs.dtype,
                                           device=obs.device)

    def eval_frac(frac):
        cand = tree_add(params, tree_scale(full_step, frac))
        return surrogate_new(cand), kl_new(cand)

    ss, kls = vmap(eval_frac)(fracs)
    oks = (kls <= max_kl * 1.5) & (ss > 0)
    found = oks.any()
    # argmax of a bool tensor is not defined in torch; the first maximum of
    # its int cast is the first acceptable candidate
    first = torch.argmax(oks.to(torch.int32))
    frac = torch.where(found, fracs[first], torch.zeros_like(fracs[0]))
    stepped = tree_add(params, tree_scale(full_step, frac))
    # select, don't scale-by-zero: a NaN/Inf step direction (diverged
    # rollout) must leave the pre-step params untouched when rejected
    new_params = tree_map(lambda p, q: torch.where(found, q, p), params,
                          stepped)
    # the candidates' values beside the reference's keys, so a caller can
    # see how far each decision sat from its threshold
    info = {"found": found, "surrogate": ss[0], "kl": kls[0],
            "expected_improve": expected, "candidate_surrogate": ss,
            "candidate_kl": kls}
    return new_params, info


def compute_advantages(rews, gamma=0.99, lam=0.97, values=None):
    """Discounted reward-to-go, baseline-centred advantages.
    rews: (H, B). Without a value net, uses return-to-go minus its
    per-timestep batch mean, normalised by the population std (ddof 0, as
    ``jnp.std``)."""
    H = rews.shape[0]
    g = torch.zeros_like(rews[0])
    rtg = [None] * H
    for h in range(H - 1, -1, -1):
        g = rews[h] + gamma * g
        rtg[h] = g
    rtg = torch.stack(rtg)                              # (H, B)
    adv = rtg - rtg.mean(dim=1, keepdim=True)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    return rtg, adv
