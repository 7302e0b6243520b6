"""Model-free TRPO/PPO baselines (the paper's dotted lines in Figs. 2-3):
the port of ``repro/mbrl/model_free.py``.

On-policy: collect a batch of real trajectories per iteration, then take
one TRPO step or several PPO steps. Virtual-time accounting matches the
MBRL engines (collection = horizon * dt per trajectory, plus
``policy_step_time`` per policy step).

Draws are injected as the port's env rollouts take them: each iteration's
``(reset_draws (n, *reset_shape), noise (H, n, act_dim))`` come from
``draw_source(iteration)`` when given (a test replays the reference's key
splits through it), else from the trainer's collection generator. Seeds:
torch cannot replay the reference's split of ``key(seed)``, so the
collection, initial-policy and eval generators are seeded with three of
the four integers :func:`repro_torch.core.runtime.run_seeds` derives from
``RunConfig.seed`` (collector, policy, eval).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.runtime import RunConfig, _Recorder, run_seeds
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl import ppo as PPO
from repro_torch.mbrl import trpo as TRPO
from repro_torch.utils.tree import tree_map, tree_to

# draw_source(iteration) -> (reset_draws, noise) of one collection batch
CollectDraws = Callable[[int], tuple]


class ModelFreeTrainer:
    def __init__(self, env, pol_cfg, run_cfg: Optional[RunConfig] = None, *,
                 algo: str = "ppo", trajs_per_iter: int = 4,
                 ppo_epochs: int = 10, gamma: float = 0.99, params=None,
                 draw_source: Optional[CollectDraws] = None, device=None):
        """``params`` replaces the random initial policy (the parity tests
        start both packages from one converted tree). ``device``: None
        means CUDA."""
        if algo not in ("ppo", "trpo"):
            raise ValueError(f"algo must be 'ppo' or 'trpo', got {algo!r}")
        self.env = env
        run_cfg = RunConfig() if run_cfg is None else run_cfg
        self.rc = run_cfg
        self.algo = algo
        self.trajs_per_iter = trajs_per_iter
        self.ppo_epochs = ppo_epochs
        self.gamma = gamma
        self.draw_source = draw_source
        self.device = resolve_device(device)
        sc, _, sp, se = run_seeds(run_cfg.seed)
        self._gen = torch.Generator(self.device).manual_seed(sc)
        self._eval_gen = torch.Generator(self.device).manual_seed(se)
        self.params = (PI.init_policy(
            pol_cfg, torch.Generator(self.device).manual_seed(sp))
            if params is None else tree_to(params, self.device))
        if algo == "ppo":
            self._opt, self._ppo_step = PPO.make_ppo_step()
            self.opt_state = self._opt.init(self.params)
        self.recorder = _Recorder(env, run_cfg.eval_rollouts)
        self.iterations = 0

    def _collect(self, draws):
        """One batch of ``trajs_per_iter`` trajectories under the current
        policy: (obs, pre-tanh actions, rewards), each (H, n, ·)."""
        reset_draws, noise = (None, None) if draws is None else draws
        pres = []

        def policy_fn(p, s, eps):
            a, pre = PI.sample_from_eps(p, s, eps)
            pres.append(pre)
            return a
        traj = self.env.rollout_batch(
            policy_fn, self.params, self.trajs_per_iter,
            reset_draws=reset_draws, noise=noise, generator=self._gen)
        return (traj["obs"].transpose(0, 1), torch.stack(pres),
                traj["rew"].transpose(0, 1))

    def run(self):
        rc = self.rc
        t = 0.0
        collected = 0
        traj_t = self.env.horizon * self.env.dt
        while collected < rc.total_trajs:
            draws = (None if self.draw_source is None
                     else self.draw_source(self.iterations))
            obs, pre, rew = self._collect(draws)
            collected += self.trajs_per_iter
            t += traj_t * self.trajs_per_iter
            _, adv = TRPO.compute_advantages(rew, gamma=self.gamma)

            def flat(x):
                return x.reshape((-1,) + tuple(x.shape[2:]))
            batch = {"obs": flat(obs), "act_pre": flat(pre),
                     "adv": adv.reshape(-1)}
            if self.algo == "trpo":
                self.params, _ = TRPO.trpo_step(self.params, batch)
                t += rc.policy_step_time
            else:
                old = tree_map(lambda x: x.detach().clone(), self.params)
                for _ in range(self.ppo_epochs):
                    self.params, self.opt_state, _ = self._ppo_step(
                        self.params, self.opt_state, old, batch)
                    t += rc.policy_step_time
            self.iterations += 1
            self.recorder.record(t, collected, self.params, self._eval_gen)
        return self.recorder.trace
