"""Launcher: the port of ``repro/launch/train.py``.

``--task mbrl``: asynchronous model-based RL on a PyTorch env with ME-TRPO
/ ME-PPO / MB-MPO, async (under the event engine, on host threads with
``--mode threads``, or as supervised OS processes with ``--mode procs``)
or one of the synchronous engines::

    python -m repro_torch.launch.train --task mbrl --env pendulum \\
        --algo me-trpo --engine async --trajs 60

``--task lm``: the LM trainer, ``api.build(..., "train")`` on random
tokens for ``--steps`` steps, for every family (the encdec's batch adds
random frame embeddings, a vision model's random patch embeddings over the
first ``--seq // 8`` positions, as in the reference; the moe experts and
the hybrid's scan train through their plain routes, as the dense
attention does)::

    python -m repro_torch.launch.train --task lm --arch glm4-9b --reduced \\
        --steps 10

It runs on the card; ``--device cpu`` runs it on the CPU. The flags are
the reference's, plus ``--device``; with ``--mode procs`` the ``--out``
JSON gains the reference's ``procs`` block (restarts, trajectories,
versions, the snapshot directory) and each child's kernel launches.
``--transport tcp`` (threads and procs modes) routes the stores through a
socket control plane bound to ``--bind``; ``--connect HOST:PORT`` trains
nothing and joins a live procs run's plane as ``--n-collectors`` more
collectors::

    python -m repro_torch.launch.train --task mbrl --mode procs \
        --transport tcp --bind 0.0.0.0:7447 --trajs 60
    python -m repro_torch.launch.train --connect trainer-host:7447

``--mesh auto|N`` role-shards the async engine (event and threads modes)
over a mesh (core/roles.py) split by ``--role-ratios``: ``auto`` is every
local card, ``N`` the first N cards (more than the host has raises). With
``--device`` the mesh is N stand-ins of that one device (``--device cpu
--mesh 4``, as the CPU tests run it)::

    python -m repro_torch.launch.train --task mbrl --mode threads \
        --mesh auto --role-ratios 1,2,1 --trajs 60
"""
from __future__ import annotations

import argparse
import json
import time


def build_mesh(spec: str, device=None):
    """``--mesh`` -> Mesh: "none" (one device), "auto" (every local card on
    one ("data",) axis; with ``device``, that one device), or a device
    count "N" (the first N cards, raising if the host has fewer; with
    ``device``, N stand-ins of it)."""
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    if spec == "none":
        return None
    if spec == "auto":
        return make_local_mesh(device)
    return make_mesh(int(spec), device)


def run_mbrl(args):
    from repro_torch.core import (AsyncTrainer, PartialAsyncDataPolicy,
                                  PartialAsyncModelPolicy, RunConfig,
                                  SequentialTrainer)
    from repro_torch.envs import make_env
    from repro_torch.mbrl.algos import AlgoConfig, make_algo
    from repro_torch.mbrl.dynamics import EnsembleConfig
    from repro_torch.mbrl.policy import PolicyConfig

    mesh = build_mesh(args.mesh, args.device)
    role_ratios = tuple(int(x) for x in args.role_ratios.split(","))
    if mesh is not None and args.engine != "async":
        raise SystemExit("--mesh is only supported by --engine async "
                         "(role meshes belong to the async engine)")
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
    if args.transport == "tcp" and args.engine != "async":
        raise SystemExit("--transport tcp needs --engine async "
                         "(the control plane serves the async servers)")
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
                                      mesh=mesh, role_ratios=role_ratios,
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


def run_join(args):
    """``--connect host:port``: no training here; this process gives
    ``--n-collectors`` collectors to a live run's control plane and exits
    when the run's global criterion is fully claimed."""
    from repro_torch.net import join_as_collectors
    t0 = time.perf_counter()
    n = join_as_collectors(args.connect, n_collectors=args.n_collectors,
                           device=args.device)
    print(json.dumps({"connect": args.connect,
                      "n_collectors": args.n_collectors,
                      "trajs_contributed": n,
                      "real_seconds": round(time.perf_counter() - t0, 1)},
                     indent=1))
    return n


def run_lm(args):
    """``--task lm``: ``--steps`` train steps of ``--arch`` on random tokens
    (labels equal to tokens, as in the reference), with bf16 frame or patch
    embeddings drawn by the same generator where the family takes them
    (the reference's ``batch_for``). Returns the losses."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import lm as LM
    from repro_torch.models.config import InputShape
    from repro_torch.optim.optimizers import adam

    dev = resolve_device(args.device)
    shape = InputShape("cli", args.seq, args.batch, "train")
    cfg = get_config(args.arch, reduced=args.reduced)
    bundle = api.build(cfg, shape, device=dev)
    params = api._mod(cfg).init_params(cfg, args.seed, device=dev)
    opt_state = adam(cfg.lr).init(LM.trainable(params))
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def embeds(rows):
        return torch.randn((args.batch, rows, cfg.d_model), generator=gen,
                           device=dev).to(torch.bfloat16)
    losses = []
    for step in range(args.steps):
        tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                               generator=gen, device=dev,
                               dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens}
        if cfg.family == "encdec":
            batch["enc_embeds"] = embeds(args.seq)
        if cfg.modality == "vision":
            batch["patch_embeds"] = embeds(args.seq // 8)
        params, opt_state, m = bundle.fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(m['gnorm']):.3f}", flush=True)
    return losses


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description=__doc__)
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
                    help="none | auto | <device count>: role-shard the "
                         "async engine over a device mesh (core/roles.py); "
                         "with --device, stand-ins of that one device")
    ap.add_argument("--role-ratios", default="1,2,1",
                    help="collector,model,policy share of the mesh axis")
    ap.add_argument("--transport", default="shm", choices=["shm", "tcp"],
                    help="how workers reach the servers: shm = in-process "
                         "or file-backed stores (default); tcp = socket "
                         "control plane (repro_torch.net), reachable from "
                         "other hosts via --bind")
    ap.add_argument("--bind", default=None,
                    help="tcp transport: HOST:PORT the control plane "
                         "listens on (default 127.0.0.1:<ephemeral>); "
                         "bind :PORT or 0.0.0.0:PORT to let remote "
                         "collectors --connect")
    ap.add_argument("--connect", default=None,
                    help="join a LIVE run as extra remote collectors "
                         "instead of training: HOST:PORT of its control "
                         "plane (with --n-collectors for fan-out). Connect "
                         "only to planes you trust: the join ticket is a "
                         "pickle (docs/WIRE_PROTOCOL.md)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="procs mode: where the supervisor snapshots "
                         "params + versions (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    # lm
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.task == "lm":
        return run_lm(args)
    if args.connect:
        return run_join(args)
    return run_mbrl(args)


if __name__ == "__main__":
    main()
