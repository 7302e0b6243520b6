"""Dyna with a transformer world model on the PyTorch port.

The MLP ensemble of the paper is swapped for a token-level decoder LM
behind the SAME ``predict(params, obs, act, generator)`` contract;
imagination becomes one lock-step prefill (through the flash-attention
kernel on the card, at head dim 24 here) and greedy decodes. This example
trains the world model on pendulum transitions and takes ME-TRPO policy
steps against it. The port of ``examples/wm_imagination.py``::

    PYTHONPATH=src python examples/torch_wm_imagination.py          # the card
    PYTHONPATH=src python examples/torch_wm_imagination.py --device cpu
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.envs import make_env
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl.algos import AlgoConfig, make_algo
from repro_torch.mbrl.policy import PolicyConfig
from repro_torch.mbrl.wm_dynamics import WMConfig, WorldModelDynamics


def main(device=None, epochs: int = 15, policy_steps: int = 5):
    dev = resolve_device(device)
    env = make_env("pendulum")
    wm = WorldModelDynamics(WMConfig(env.obs_dim, env.act_dim, bins=33,
                                     d_model=96, num_layers=2), 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    pol = PI.init_policy(PolicyConfig(env.obs_dim, env.act_dim, hidden=16),
                         gen)
    trajs = [env.rollout(PI.sample_action, pol, generator=gen)
             for _ in range(8)]
    obs, act, nobs = (torch.cat([t[k] for t in trajs])
                      for k in ("obs", "act", "next_obs"))
    wm.update_normalizer(torch.cat([obs, nobs]))

    def mse():
        pred = wm.predict(obs[:128], act[:128])
        return float(((pred - nobs[:128]) ** 2).mean())

    before = mse()
    print(f"world-model MSE before training: {before:.3f}")
    for _ in range(epochs):
        loss = wm.train_epoch(obs, act, nobs, generator=gen)
    after = mse()
    print(f"after {epochs} epochs: token loss {loss:.3f}, MSE {after:.3f}")

    acfg = AlgoConfig(algo="me-trpo", imagine_batch=16, imagine_horizon=10)
    algo = make_algo(acfg, PolicyConfig(env.obs_dim, env.act_dim, hidden=16),
                     env.reward, env.reset_batch,
                     predict_fn=wm.predict_fn())
    state = algo.init(gen)
    returns = []
    for i in range(policy_steps):
        state, info = algo.improve(state, wm.params, generator=gen)
        returns.append(float(info["imagined_return"]))
        print(f"policy step {i}: imagined return {returns[-1]:.1f}")
    print("the policy-improvement worker ran entirely on transformer "
          "imagination (prefill + decode).")
    return {"mse_before": before, "mse_after": after, "loss": loss,
            "returns": returns}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
