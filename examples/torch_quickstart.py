"""Quickstart on the PyTorch port: asynchronous ME-TRPO on the pendulum.

The three workers (data collection / model learning / policy improvement)
run under the deterministic discrete-event engine; the x-axis is the
simulated ROBOT time (Fig. 2 methodology), so you can see directly that
the run time is ~ the data-collection time. The port of
``examples/quickstart.py``; it runs on the CUDA card::

    PYTHONPATH=src python examples/torch_quickstart.py           # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.core import AsyncTrainer, RunConfig
from repro_torch.envs import make_env
from repro_torch.mbrl.algos import AlgoConfig, make_algo
from repro_torch.mbrl.dynamics import EnsembleConfig
from repro_torch.mbrl.policy import PolicyConfig


def main(total_trajs: int = 12, device=None):
    env = make_env("pendulum")
    ens = EnsembleConfig(env.obs_dim, env.act_dim, hidden=64, n_models=3)
    pol = PolicyConfig(env.obs_dim, env.act_dim, hidden=32)
    acfg = AlgoConfig(algo="me-trpo", imagine_batch=48, imagine_horizon=40,
                      n_models=3)
    algo = make_algo(acfg, pol, env.reward, env.reset_batch)

    trainer = AsyncTrainer(env, ens, algo,
                           RunConfig(total_trajs=total_trajs, seed=0),
                           device=device)
    trace = trainer.run()

    print(f"{'robot-time':>10s} {'trajs':>6s} {'eval return':>12s}")
    for row in trace:
        print(f"{row['time']:10.1f} {row['trajs']:6d} "
              f"{row['eval_return']:12.1f}")
    print("\ntotal simulated robot time:", trace[-1]["time"], "s "
          "(= collection time — the async property)")
    return trace


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
