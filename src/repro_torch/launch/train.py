"""Launcher: the port of ``repro/launch/train.py``, ``--task mbrl``.

Asynchronous model-based RL on a PyTorch env with ME-TRPO / ME-PPO /
MB-MPO, async (under the event engine, on host threads with ``--mode
threads``, or as supervised OS processes with ``--mode procs``) or one of
the synchronous engines::

    python -m repro_torch.launch.train --task mbrl --env pendulum \\
        --algo me-trpo --engine async --trajs 60

It runs on the card; ``--device cpu`` runs it on the CPU. The flags are
the reference's, plus ``--device``; with ``--mode procs`` the ``--out``
JSON gains the reference's ``procs`` block (restarts, trajectories,
versions, the snapshot directory) and each child's kernel launches. What
is not ported exits with a message that names ROADMAP.md: ``--transport
tcp``, ``--mesh``, ``--connect`` and ``--task lm``.
"""
from __future__ import annotations

import argparse
import json
import time


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to repro_torch yet: only the "
                      "event, threads and procs engines of --task mbrl "
                      "over the in-host stores are (ROADMAP.md §1, open "
                      "items)")


def run_mbrl(args):
    from repro_torch.core import (AsyncTrainer, PartialAsyncDataPolicy,
                                  PartialAsyncModelPolicy, RunConfig,
                                  SequentialTrainer)
    from repro_torch.envs import make_env
    from repro_torch.mbrl.algos import AlgoConfig, make_algo
    from repro_torch.mbrl.dynamics import EnsembleConfig
    from repro_torch.mbrl.policy import PolicyConfig

    if args.transport != "shm":
        raise _not_ported(f"--transport {args.transport}")
    if args.mesh != "none":
        raise _not_ported("--mesh")
    env = make_env(args.env)
    ens = EnsembleConfig(env.obs_dim, env.act_dim, hidden=args.model_hidden,
                         n_models=args.n_models)
    pol = PolicyConfig(env.obs_dim, env.act_dim, hidden=args.policy_hidden)
    acfg = AlgoConfig(algo=args.algo, imagine_batch=args.imagine_batch,
                      imagine_horizon=args.imagine_horizon,
                      n_models=args.n_models)
    algo = make_algo(acfg, pol, env.reward, env.reset_batch)
    collect_noise = (tuple(float(x) for x in args.collect_noise.split(","))
                     if args.collect_noise else None)
    rc = RunConfig(total_trajs=args.trajs, seed=args.seed,
                   collect_speed=args.collect_speed,
                   ema_weight=args.ema_weight,
                   early_stop=not args.no_early_stop,
                   ckpt_dir=args.ckpt_dir,
                   n_collectors=args.n_collectors,
                   collect_noise=collect_noise,
                   envs_per_collector=args.envs_per_collector,
                   transport=args.transport, bind=args.bind)
    if args.n_collectors > 1 and args.engine != "async":
        raise SystemExit("--n-collectors > 1 needs --engine async "
                         "(collector fleets belong to the async engine)")
    if args.envs_per_collector > 1 and args.engine != "async":
        raise SystemExit("--envs-per-collector > 1 needs --engine async "
                         "(env farms belong to the async engine)")
    if args.mode == "procs" and args.engine != "async":
        raise SystemExit("--mode procs is only meaningful with "
                         "--engine async")
    dev = args.device
    engines = {
        # procs children rebuild the algorithm from plain configs, so the
        # async engine gets them beside the built algorithm
        "async": lambda: AsyncTrainer(env, ens, algo, rc, mode=args.mode,
                                      algo_cfg=acfg, pol_cfg=pol,
                                      device=dev),
        "sequential": lambda: SequentialTrainer(env, ens, algo, rc,
                                                device=dev),
        "partial-model": lambda: PartialAsyncModelPolicy(env, ens, algo, rc,
                                                         device=dev),
        "partial-data": lambda: PartialAsyncDataPolicy(env, ens, algo, rc,
                                                       device=dev),
    }
    tr = engines[args.engine]()
    t0 = time.perf_counter()  # monotonic: an NTP step must not skew this
    trace = tr.run()
    out = {"engine": args.engine, "algo": args.algo, "env": args.env,
           "real_seconds": round(time.perf_counter() - t0, 1),
           "trace": trace}
    if getattr(tr, "collectors", None) is not None:
        # fleet report: each member's exploration rung and, for the
        # in-process engines, its share of the global criterion (the procs
        # fleet lives in child processes; its counts are in the "procs"
        # block below)
        n = tr.run_cfg.n_collectors
        out["fleet"] = {
            "n_collectors": n,
            "envs_per_collector": tr.run_cfg.envs_per_collector,
            "sim_robots": n * tr.run_cfg.envs_per_collector,
            "noise_scales": [tr.exploration.scale_for(i)
                             for i in range(n)],
        }
        if args.mode != "procs":
            out["fleet"]["trajs_per_collector"] = \
                [c.collected for c in tr.collectors]
    if getattr(tr, "proc_info", None):
        out["procs"] = tr.proc_info
    print(json.dumps(out["trace"][-1], indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return trace


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__)
    # --task lm (the reference's LM trainer and its flags) is not ported
    ap.add_argument("--task", choices=["mbrl", "lm"], default="mbrl")
    # mbrl
    ap.add_argument("--env", default="pendulum")
    ap.add_argument("--algo", default="me-trpo",
                    choices=["me-trpo", "me-ppo", "mb-mpo"])
    ap.add_argument("--engine", default="async",
                    choices=["async", "sequential", "partial-model",
                             "partial-data"])
    ap.add_argument("--mode", default="event",
                    choices=["event", "threads", "procs"],
                    help="async engine execution: simulated (event), "
                         "host threads, or OS processes over file-backed "
                         "stores (procs)")
    ap.add_argument("--trajs", type=int, default=40)
    ap.add_argument("--n-models", type=int, default=5)
    ap.add_argument("--model-hidden", type=int, default=128)
    ap.add_argument("--policy-hidden", type=int, default=64)
    ap.add_argument("--imagine-batch", type=int, default=64)
    ap.add_argument("--imagine-horizon", type=int, default=40)
    ap.add_argument("--collect-speed", type=float, default=1.0)
    ap.add_argument("--n-collectors", type=int, default=1,
                    help="size of the data-collection fleet (async "
                         "engine): N parallel collectors share the one "
                         "global --trajs criterion")
    ap.add_argument("--collect-noise", default=None,
                    help="comma-separated per-collector exploration "
                         "noise scales, cycled across the fleet "
                         "(default: 1.0 everywhere)")
    ap.add_argument("--envs-per-collector", type=int, default=1,
                    help="env farm (async engine): each collector "
                         "simulates B envs per step and pushes the whole "
                         "batch at once")
    ap.add_argument("--ema-weight", type=float, default=0.9)
    ap.add_argument("--no-early-stop", action="store_true")
    ap.add_argument("--mesh", default="none",
                    help="none; role meshes are not ported")
    ap.add_argument("--role-ratios", default="1,2,1",
                    help="collector,model,policy share of a role mesh "
                         "(ignored: role meshes are not ported)")
    ap.add_argument("--transport", default="shm", choices=["shm", "tcp"],
                    help="shm = in-process servers (default); tcp is not "
                         "ported")
    ap.add_argument("--bind", default=None,
                    help="tcp transport only (not ported)")
    ap.add_argument("--connect", default=None,
                    help="join a live run as remote collectors (not "
                         "ported)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="procs mode: where the supervisor snapshots "
                         "params + versions (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.task != "mbrl":
        raise _not_ported(f"--task {args.task}")
    if args.connect:
        raise _not_ported("--connect")
    return run_mbrl(args)


if __name__ == "__main__":
    main()
