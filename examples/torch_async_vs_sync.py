"""Figure-2-in-miniature on the PyTorch port: the same algorithm,
asynchronous vs sequential. The port of ``examples/async_vs_sync.py``.

Reproduces the paper's headline claim — the asynchronous framework brings
the run time down to the data-collection time, while the sequential
version pays for model fitting and policy optimisation serially — and the
Fig. 4 follow-up: a fleet of parallel collectors
(``AsyncTrainer(n_collectors=N)``) shrinks that collection time again,
reaching the same global trajectory criterion in fewer policy steps. It
runs on the CUDA card::

    PYTHONPATH=src python examples/torch_async_vs_sync.py           # the card
    PYTHONPATH=src python examples/torch_async_vs_sync.py --device cpu
"""
import argparse

from repro_torch.core import AsyncTrainer, RunConfig, SequentialTrainer
from repro_torch.envs import make_env
from repro_torch.mbrl.algos import AlgoConfig, make_algo
from repro_torch.mbrl.dynamics import EnsembleConfig
from repro_torch.mbrl.policy import PolicyConfig


def build(env):
    ens = EnsembleConfig(env.obs_dim, env.act_dim, hidden=64, n_models=3)
    pol = PolicyConfig(env.obs_dim, env.act_dim, hidden=32)
    acfg = AlgoConfig(algo="me-trpo", imagine_batch=48, imagine_horizon=40,
                      n_models=3)
    algo = make_algo(acfg, pol, env.reward, env.reset_batch)
    return ens, algo


def main(total_trajs: int = 10, device=None, **sequential_kw):
    """The three runs and their rows; ``sequential_kw`` goes to
    ``SequentialTrainer`` (its defaults otherwise). Returns the traces."""
    env = make_env("pendulum")
    rc = RunConfig(total_trajs=total_trajs, seed=0)

    ens, algo = build(env)
    t_async = AsyncTrainer(env, ens, algo, rc, device=device).run()
    ens, algo = build(env)
    fleet = AsyncTrainer(env, ens, algo, rc, n_collectors=4, device=device)
    t_fleet = fleet.run()
    fleet_steps = fleet.policy_worker.steps
    ens, algo = build(env)
    t_seq = SequentialTrainer(env, ens, algo, rc, device=device,
                              **sequential_kw).run()

    ta, tf, ts = (t_async[-1]["time"], t_fleet[-1]["time"],
                  t_seq[-1]["time"])
    print(f"async          : {ta:8.1f}s simulated robot time "
          f"(best return {max(r['eval_return'] for r in t_async):.1f})")
    print(f"async, fleet=4 : {tf:8.1f}s simulated robot time "
          f"(criterion reached after {fleet_steps} policy steps; "
          f"best return {max(r['eval_return'] for r in t_fleet):.1f})")
    print(f"sequential     : {ts:8.1f}s simulated robot time "
          f"(best return {max(r['eval_return'] for r in t_seq):.1f})")
    print(f"wall-clock speed-up: {ts / ta:.2f}x async, {ts / tf:.2f}x "
          "with the fleet (paper reports >10x on quadruped locomotion)")
    return {"async": t_async, "fleet": t_fleet, "sequential": t_seq}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
