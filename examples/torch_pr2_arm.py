"""Section 5.5 in simulation on the PyTorch port: contact-style
manipulation on the 7-DOF arm.

Runs asynch MBRL on the three PR2-style tasks (reach / shape-match /
lego-stack) with the paper's exact reward r(d) = -d^2 - log(d^2 + 1e-5)
and 10 Hz torque control, and reports the final end-effector distance and
the simulated run time — the paper's result is task success within ~10
minutes of robot time (Fig. 7). The port of ``examples/pr2_arm.py``; it
runs on the CUDA card::

    PYTHONPATH=src python examples/torch_pr2_arm.py              # the card
    PYTHONPATH=src python examples/torch_pr2_arm.py --device cpu
"""
import argparse

import torch

from repro_torch.core import AsyncTrainer, RunConfig
from repro_torch.envs import make_env
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl.algos import AlgoConfig, make_algo
from repro_torch.mbrl.dynamics import EnsembleConfig

TASKS = ("pr2_reach", "pr2_shape_match", "pr2_lego_stack")


def final_distance(env, params, generator, n=8):
    """Mean end-effector distance at the last observed state of ``n``
    deterministic rollouts, their resets drawn from ``generator``."""
    draws = env.reset_draws(n, generator)
    noise = torch.zeros((env.horizon, n, env.act_dim),
                        device=generator.device)
    tr = env.rollout_batch(PI.deterministic_action, params, n,
                           reset_draws=draws, noise=noise)
    return float(env.distance(tr["obs"][:, -1]).mean())


def main(tasks=TASKS, total_trajs: int = 20, device=None):
    results = {}
    for task in tasks:
        env = make_env(task)
        ens = EnsembleConfig(env.obs_dim, env.act_dim, hidden=128,
                             n_models=3)
        pol = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=64)
        acfg = AlgoConfig(algo="me-trpo", imagine_batch=48,
                          imagine_horizon=50, n_models=3)
        algo = make_algo(acfg, pol, env.reward, env.reset_batch)
        tr = AsyncTrainer(env, ens, algo,
                          RunConfig(total_trajs=total_trajs, seed=0),
                          device=device)
        trace = tr.run()
        d = final_distance(env, tr.policy_worker.state["policy"],
                           torch.Generator(tr.device).manual_seed(123))
        mins = trace[-1]["time"] / 60.0
        print(f"{task:18s}: final distance {d:.3f} m after "
              f"{mins:.1f} simulated minutes "
              f"(best return {max(r['eval_return'] for r in trace):.1f})")
        results[task] = {"final_distance": d, "trace": trace}
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
