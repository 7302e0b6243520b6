"""Soak harness: seeded chaos runs with always-on invariant checks. The
port of ``repro/chaos/soak.py``.

Usage::

    python -m repro_torch.chaos.soak --profile short --seed 0 \\
        --out SOAK_report.json
    python -m repro_torch.chaos.soak --profile micro --device cpu
    python -m repro_torch.chaos.soak --profile long --duration 3600

It runs on the card; ``--device cpu`` runs it on the CPU. With no card and
no ``--device cpu`` it raises: it never falls back.

Each soak = (optionally) one CLEAN run, then one or more CHAOS runs, each a
full ``AsyncTrainer(mode="procs")`` training on Pendulum with a seeded
:class:`~repro_torch.chaos.faults.FaultPlan` injected through the
supervisor seam while an :class:`~repro_torch.chaos.monitor.InvariantMonitor`
checks the engine's invariants live. After EVERY run the
:class:`~repro_torch.chaos.audit.ResourceAuditor` diffs what this process
owns against the pre-soak baseline: one leaked resource fails the soak.
The soak removes each run's checkpoint directory when the run is done.

``--duration S`` keeps launching chaos runs (seed, seed+1000, ...) until S
seconds have passed; without it exactly one chaos run executes.

The report (``SOAK_report.json``, the reference's keys) is machine-readable;
the exit status is 0 only when every run had ZERO violations, ZERO leaks,
and the first chaos run injected at least the profile's ``min_faults``
spanning all three role families. A watchdog ends a wedged run's process
(exit 70): a hung soak fails, it is never cut short and passed.

Collection is paced (``pace_collection`` + ``collect_speed``), so progress,
the fault schedule's clock, advances over real seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time
from typing import Any, Dict, Optional

PROFILES: Dict[str, Dict[str, Any]] = {
    # tests / smoke: a few faults, ~1-2 min
    "micro": dict(total_trajs=12, clean_trajs=0, n_collectors=2,
                  n_faults=5, min_faults=3, max_kills_per_role=2,
                  max_restarts=3, collect_speed=40.0,
                  hard_timeout_s=540.0),
    # per-change CI: >= 10 faults across all roles, a few minutes
    "short": dict(total_trajs=40, clean_trajs=8, n_collectors=2,
                  n_faults=14, min_faults=10, max_kills_per_role=3,
                  max_restarts=4, collect_speed=20.0,
                  hard_timeout_s=1500.0),
    # scheduled job, optionally with --duration
    "long": dict(total_trajs=120, clean_trajs=16, n_collectors=3,
                 n_faults=40, min_faults=30, max_kills_per_role=6,
                 max_restarts=8, collect_speed=10.0,
                 hard_timeout_s=7200.0),
}

_FAMILIES = ("collector", "model", "policy")


def _build(profile: Dict[str, Any], seed: int, total_trajs: int):
    """Env + configs + RunConfig for one soak run: the tiny shapes the
    procs tests train, so a soak exercises the paths the tests trust."""
    from repro_torch.core import RunConfig
    from repro_torch.envs import make_env
    from repro_torch.mbrl.algos import AlgoConfig
    from repro_torch.mbrl.dynamics import EnsembleConfig
    from repro_torch.mbrl.policy import PolicyConfig
    env = make_env("pendulum")
    ens = EnsembleConfig(env.obs_dim, env.act_dim, hidden=32, n_models=2)
    pol = PolicyConfig(env.obs_dim, env.act_dim, hidden=16)
    acfg = AlgoConfig(algo="me-trpo", imagine_batch=16,
                      imagine_horizon=15, n_models=2)
    rc = RunConfig(total_trajs=int(total_trajs), seed=int(seed),
                   n_collectors=int(profile["n_collectors"]),
                   max_restarts=int(profile["max_restarts"]),
                   collect_speed=float(profile["collect_speed"]),
                   pace_collection=True,
                   snapshot_every_s=0.5,
                   push_timeout_s=90.0,
                   eval_rollouts=2, eval_every_policy_steps=20,
                   min_final_model_version=1,
                   min_final_policy_version=1,
                   transport=str(profile.get("transport", "shm")))
    return env, ens, pol, acfg, rc


def _one_run(profile: Dict[str, Any], seed: int, *,
             chaos: bool, report: Dict[str, Any],
             out_path: Optional[str], device) -> Dict[str, Any]:
    """One training run (chaotic or clean) under a watchdog -> its report
    entry."""
    from repro_torch.chaos.faults import ChaosSupervisor, FaultPlan
    from repro_torch.chaos.monitor import InvariantMonitor
    from repro_torch.core import AsyncTrainer, SupervisorChain
    trajs = profile["total_trajs"] if chaos else profile["clean_trajs"]
    env, ens, pol, acfg, rc = _build(profile, seed, trajs)
    monitor = InvariantMonitor()
    sups = [monitor]
    injector = None
    if chaos:
        plan = FaultPlan.generate(
            seed, n_collectors=rc.n_collectors,
            n_faults=int(profile["n_faults"]),
            max_kills_per_role=int(profile["max_kills_per_role"]))
        injector = ChaosSupervisor(plan)
        sups.insert(0, injector)
    tr = AsyncTrainer(env, ens, None, rc, mode="procs",
                      algo_cfg=acfg, pol_cfg=pol,
                      supervisor=SupervisorChain(*sups), device=device)

    done = threading.Event()

    def watchdog():
        if done.wait(float(profile["hard_timeout_s"])):
            return
        report["aborted"] = (f"watchdog: run (seed={seed}, "
                             f"chaos={chaos}) exceeded hard timeout "
                             f"{profile['hard_timeout_s']}s")
        if out_path:
            _write_report(report, out_path)
        for p in list(getattr(tr, "_procs", {}).values()):
            try:
                p.kill()
            except Exception:
                pass
        os._exit(70)

    threading.Thread(target=watchdog, daemon=True).start()
    t0 = time.monotonic()
    error = None
    try:
        trace = tr.run()
    except Exception as e:      # noqa: BLE001 — the soak reports it
        trace = []
        error = f"{type(e).__name__}: {e}"
    finally:
        done.set()
        ckpt = getattr(tr, "proc_info", {}).get("ckpt_dir")
        if ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    info = getattr(tr, "proc_info", {})
    entry: Dict[str, Any] = {
        "kind": "chaos" if chaos else "clean",
        "seed": int(seed),
        "wall_s": round(time.monotonic() - t0, 2),
        "error": error,
        "trace_rows": len(trace),
        "trajs": info.get("trajs"),
        "model_version": info.get("model_version"),
        "policy_version": info.get("policy_version"),
        "restarts": {k: int(v)
                     for k, v in info.get("restarts", {}).items()},
        "monitor": monitor.report(),
    }
    if injector is not None:
        entry["faults"] = injector.report()
    return entry


def _write_report(report: Dict[str, Any], out_path: str) -> None:
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, out_path)


def run_soak(profile_name: str = "short", seed: int = 0, *,
             duration: Optional[float] = None,
             out: str = "SOAK_report.json",
             overrides: Optional[Dict[str, Any]] = None,
             device=None) -> int:
    """Run the soak on ``device`` (None: the card); write ``out``; return
    the process exit code."""
    from repro_torch import resolve_device
    from repro_torch.chaos.audit import ResourceAuditor, warmup_ipc
    from repro_torch.chaos.faults import role_family
    device = resolve_device(device)
    profile = dict(PROFILES[profile_name])
    profile.update(overrides or {})
    report: Dict[str, Any] = {
        "profile": profile_name, "seed": int(seed),
        "config": {k: v for k, v in profile.items()},
        "started_unix": time.time(), "runs": [], "aborted": None,
    }
    # open the parent's process-lifetime resources (the resource tracker,
    # the CUDA context) BEFORE the leak baseline
    warmup_ipc(str(device))
    auditor = ResourceAuditor()
    auditor.baseline()

    t_start = time.monotonic()
    if profile["clean_trajs"]:
        entry = _one_run(profile, seed, chaos=False, report=report,
                         out_path=out, device=device)
        entry["audit"] = auditor.audit()
        report["runs"].append(entry)
        _write_report(report, out)
    run_i = 0
    while True:
        entry = _one_run(profile, seed + 1000 * run_i, chaos=True,
                         report=report, out_path=out, device=device)
        entry["audit"] = auditor.audit()
        report["runs"].append(entry)
        _write_report(report, out)
        run_i += 1
        elapsed = time.monotonic() - t_start
        if duration is None or elapsed >= float(duration):
            break

    # ------------------------------------------------- verdict
    chaos_runs = [r for r in report["runs"] if r["kind"] == "chaos"]
    first = chaos_runs[0]
    injected = first.get("faults", {}).get("injected", [])
    families = sorted({role_family(f["role"]) for f in injected})
    problems = []
    for r in report["runs"]:
        tag = f"{r['kind']} run seed={r['seed']}"
        if r["error"]:
            problems.append(f"{tag}: {r['error']}")
        problems += [f"{tag}: {v}"
                     for v in r["monitor"]["violations"]]
        if not r["audit"]["ok"]:
            problems.append(f"{tag}: resource leak {r['audit']}")
    if len(injected) < int(profile["min_faults"]):
        problems.append(
            f"only {len(injected)} faults injected, profile requires >= "
            f"{profile['min_faults']}")
    if families != sorted(_FAMILIES):
        problems.append(
            f"faults only hit {families}, need all of {_FAMILIES}")
    report.update({
        "wall_s": round(time.monotonic() - t_start, 2),
        "totals": {
            "runs": len(report["runs"]),
            "faults_injected": sum(
                len(r.get("faults", {}).get("injected", []))
                for r in chaos_runs),
            "families_first_run": families,
            "restarts": sum(sum(r["restarts"].values())
                            for r in report["runs"]),
        },
        "required": {"min_faults": int(profile["min_faults"]),
                     "families": list(_FAMILIES)},
        "problems": problems,
        "ok": not problems,
    })
    _write_report(report, out)
    status = "OK" if report["ok"] else "FAIL"
    print(f"soak {status}: {report['totals']['faults_injected']} faults "
          f"over {len(report['runs'])} run(s) in {report['wall_s']}s "
          f"-> {out}")
    for p in problems:
        print(f"  problem: {p}")
    return 0 if report["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos.soak", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", choices=sorted(PROFILES), default="short")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration", type=float, default=None,
                    help="keep launching chaos runs until this many "
                         "seconds have passed (default: one run)")
    ap.add_argument("--out", default="SOAK_report.json")
    ap.add_argument("--trajs", type=int, default=None,
                    help="override the profile's total_trajs")
    ap.add_argument("--faults", type=int, default=None,
                    help="override the profile's planned fault count")
    ap.add_argument("--transport", choices=["shm", "tcp"], default="shm",
                    help="the stores under chaos: the file-backed ones "
                         "(default) or the tcp control plane")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    overrides: Dict[str, Any] = {"transport": args.transport}
    if args.trajs is not None:
        overrides["total_trajs"] = args.trajs
    if args.faults is not None:
        overrides["n_faults"] = args.faults
    return run_soak(args.profile, args.seed, duration=args.duration,
                    out=args.out, overrides=overrides, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
