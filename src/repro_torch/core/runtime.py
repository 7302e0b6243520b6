"""Training engines: the port of ``repro/core/runtime.py``.

* ``AsyncTrainer`` — the paper's contribution (Fig. 1a). It runs a FLEET of
  ``n_collectors`` data-collection workers, each an env farm of
  ``envs_per_collector`` robots, against the one global ``total_trajs``
  criterion, in one of three modes sharing the same worker objects:
    - ``mode="event"``: the deterministic discrete-event engine. Each
      worker has a virtual-time cursor; the engine always advances the
      worker with the SMALLEST cursor, so relative speeds (robot control
      frequency vs. compute) are reproduced exactly.
    - ``mode="threads"``: real host threads on the wall clock, one per
      collector plus the model and the policy worker, all at once. Each
      collector claims its batch's tickets from the data server before it
      collects, so N racing collectors land on ``total_trajs`` EXACTLY;
      ``RunConfig.pace_collection`` sleeps out each batch's robot time,
      so the wall clock runs at the robots' rate. Trace times are seconds
      since the run started. On CUDA each role (each collector, the model
      worker, the policy worker with its evals) runs on a
      ``torch.cuda.Stream`` of its own, so one worker's host sync (the
      model worker reads its validation loss) waits for its own kernels
      only; the servers' events order the handoffs between streams
      (``core/servers.py``), and nothing on a worker's path synchronises
      the whole device.
    - ``mode="procs"``: each collector, the model worker and the policy
      worker is an OS process of its own, started from the ``spawn``
      context; on the card each holds one CUDA context and loads the
      kernels the parent built before it spawned them. They meet through
      file-backed stores under the run's temporary directory
      (``servers.ShmParameterServer``, ``ProcDataServer``,
      ``ProcControl``), never a ``multiprocessing`` shared-memory or
      synchronisation primitive and never a pickled tensor. The parent
      supervises: snapshots of both stores through ``checkpoint/io.py``
      every ``snapshot_every_s``, a dead child restarted from the latest
      one (``max_restarts`` a role, then a loud ``RuntimeError``), a dead
      collector's tickets refunded, and a ``Supervisor`` seam for fault
      injection. Each child reports its kernel launches in its heartbeat
      (``proc_info["children"]``).
* ``SequentialTrainer`` — the classic synchronous baseline (Fig. 1b).
* ``PartialAsyncModelPolicy`` — §5.2 ablation (interleave model/policy).
* ``PartialAsyncDataPolicy`` — §5.3 ablation (interleave data/policy).

All engines record an eval trace: list of dicts
(time, trajs, env_steps, eval_return) — one row per evaluation.

The schedule is the reference's bit for bit: the cursors are Python floats
advanced by the same expressions in the same order, and ties resolve by
dict insertion order (``collect:0..N-1``, then ``model``, then
``policy``). So for one ``RunConfig`` the sequence of worker steps, and
the trace's ``time``, ``trajs`` and ``env_steps`` columns, equal the
reference's whenever each step's outcome (work or idle) does — always
with ``early_stop=False``.

Seeds. torch cannot replay the reference's split of ``key(seed)`` into
the collector, model, policy and eval streams, so :func:`run_seeds`
derives four integer seeds from ``RunConfig.seed`` instead: one CPU
``torch.Generator`` seeded with it draws four integers in ``[0, 2**62)``
by one ``torch.randint`` call, in the order collector, model, policy,
eval. Collector ``i`` draws from ``collector_generator(collector_seed,
i)``; the model and policy workers seed their own generators with theirs;
the eval generator lives on the trainer's device.

Transport. ``RunConfig(transport="tcp")`` routes the threads and procs
engines' stores through one socket control plane (``repro_torch.net``,
the reference's wire format) bound to ``RunConfig.bind``; the workers do
not know which transport they hold. A procs run over tcp publishes its
``ProcSpec`` on the plane, so collectors on other hosts can join it
(``--connect``). The event engine refuses tcp, as the reference does.

Role meshes (core/roles.py). ``AsyncTrainer(mesh=..., role_ratios=...)``
(or ``roles=`` a ``RoleSplit``) runs each worker on its own sub-mesh in the
event and threads engines: collectors round-robin over the collector
sub-mesh, the model learner's ring sharded over the model sub-mesh, the
policy improver's imagination over the policy sub-mesh, the eval on the
policy sub-mesh's first device. In threads mode each role has a CUDA stream
on every card of its sub-mesh. A mesh with fewer devices than roles (one
card) falls back to shared sub-meshes, as in the reference. The procs
engine takes no mesh (the reference's ``ValueError``): each child owns its
whole device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import roles as ROLES
from repro_torch.core.servers import (DataServer, ParameterServer,
                                      ProcControl, ProcDataServer,
                                      ShmParameterServer)
from repro_torch.core.workers import (DataCollectionWorker,
                                      ExplorationSchedule,
                                      ModelLearningWorker,
                                      PolicyImprovementWorker, ProcChannels,
                                      ProcSpec, default_burst,
                                      heartbeat_slot, heartbeat_slots,
                                      proc_worker_main)
from repro_torch.kernels import LAUNCH_COUNTERS
from repro_torch.mbrl import policy as PI
from repro_torch.utils.tree import tree_leaves, tree_to


@dataclasses.dataclass
class RunConfig:
    total_trajs: int = 40              # global stopping criterion (§4)
    eval_every_policy_steps: int = 5
    eval_rollouts: int = 4
    seed: int = 0
    # virtual durations for the event engine
    model_epoch_time: float = 1.0
    policy_step_time: float = 1.25   # ~GPU TRPO update on an imagined batch
    collect_speed: float = 1.0         # Fig. 5b: 2.0 = twice as fast
    ema_weight: float = 0.9            # Fig. 5a
    early_stop: bool = True
    min_warmup_trajs: int = 4          # initial dataset before model pushes
    # collector fleet: N data-collection workers sharing the ONE global
    # total_trajs criterion. collect_noise optionally sets per-collector
    # exploration noise scales (cycled across the fleet); None = every
    # collector at 1.0.
    n_collectors: int = 1
    collect_noise: Optional[tuple] = None
    # env farm: each collector simulates B envs per step and pushes the
    # whole batch at once; a step claims min(B, remaining), so the global
    # criterion still lands exactly
    envs_per_collector: int = 1
    # threads mode: sleep out each trajectory's robot time (horizon * dt /
    # collect_speed) so wall-clock reproduces the paper's real-robot rate
    # instead of racing simulated rollouts at compute speed
    pace_collection: bool = False
    # procs mode: how long a collector may block on a full trajectory
    # spool before ProcDataServer raises its BackpressureError
    push_timeout_s: float = 30.0
    # procs mode: parent supervision — snapshot cadence for the
    # params+versions checkpoint (checkpoint/io.py), where to put it
    # (None -> a fresh temporary directory), and how many crash-restarts
    # each worker role gets before the run fails
    snapshot_every_s: float = 2.0
    ckpt_dir: Optional[str] = None
    max_restarts: int = 3
    # procs mode: after the collectors reach total_trajs, keep the learner
    # processes running until their stores reach these versions (0 = stop
    # at once, the paper's pure criterion). The model worker pushes only
    # after min_warmup_trajs, so never set min_final_model_version > 0
    # with total_trajs < min_warmup_trajs.
    min_final_model_version: int = 0
    min_final_policy_version: int = 0
    # the transport behind the servers: "shm" keeps the in-process stores
    # (threads) and the file-backed ones (procs); "tcp" routes every store
    # through the socket control plane (repro_torch.net): the same
    # version gating and exact-criterion tickets across a machine
    # boundary, and remote collectors may join a live procs run with
    # --connect. Threads and procs modes only.
    transport: str = "shm"
    # tcp: "host:port" the control plane listens on. None = loopback with
    # an ephemeral port; "0.0.0.0:5555" publishes the plane for joiners
    bind: Optional[str] = None


def run_seeds(seed: int) -> tuple:
    """The run's (collector, model, policy, eval) seeds from
    ``RunConfig.seed``: one CPU generator seeded with it, one draw of four
    integers in ``[0, 2**62)``."""
    gen = torch.Generator().manual_seed(int(seed))
    return tuple(int(s) for s in torch.randint(0, 2 ** 62, (4,),
                                               generator=gen))


def _not_ported(what: str) -> str:
    return (f"{what} is not ported to repro_torch: only the event, "
            "threads and procs engines are (ROADMAP.md §1, open items)")


# Every run and checkpoint directory this process's procs trainers created,
# recorded where they are made, so that a resource auditor can check that
# none outlives its run without listing the host's temporary directory
_DIRS_LOCK = threading.Lock()
_CREATED_DIRS: List[str] = []


def _made_dir(prefix: str) -> str:
    path = tempfile.mkdtemp(prefix=prefix)
    with _DIRS_LOCK:
        _CREATED_DIRS.append(path)
    return path


def created_run_dirs() -> tuple:
    """The run and checkpoint directories this process's procs trainers
    created, removed since or not (a caller-given ``ckpt_dir`` is not
    among them)."""
    with _DIRS_LOCK:
        return tuple(_CREATED_DIRS)


def clear_eval_cache() -> None:
    """Kept for the reference's API, and does nothing: the reference caches
    one compiled eval program per (env, eval_rollouts), while here an eval
    is a plain closure that each recorder builds for itself."""


def _make_eval(env, n: int) -> Callable:
    def evaluate(policy_params, *, generator=None, reset_draws=None):
        """Mean over ``n`` rollouts of the summed reward under the
        deterministic policy, all rollouts stepped together on the
        policy's device in the policy's dtype. ``reset_draws`` (n,
        *reset_shape) default to draws from ``generator``."""
        if reset_draws is None:
            reset_draws = env.reset_draws(n, generator)
        leaf = tree_leaves(policy_params)[0]
        reset_draws = reset_draws.to(leaf.device, leaf.dtype)
        noise = torch.zeros((env.horizon, n, env.act_dim), device=leaf.device,
                            dtype=leaf.dtype)
        traj = env.rollout_batch(PI.deterministic_action, policy_params, n,
                                 reset_draws=reset_draws, noise=noise)
        return traj["rew"].sum(1).mean()
    return evaluate


class _Recorder:
    def __init__(self, env, eval_rollouts):
        self.env = env
        self.n = eval_rollouts
        self.trace: List[Dict[str, float]] = []
        self._eval = _make_eval(env, eval_rollouts)

    def record(self, t, trajs, policy_params, generator=None, *,
               reset_draws=None):
        """Evaluate the policy with ``n`` rollouts whose resets are drawn
        from ``generator`` (or given as ``reset_draws``) and append a
        trace row."""
        ret = float(self._eval(policy_params, generator=generator,
                               reset_draws=reset_draws))
        self.trace.append({"time": float(t), "trajs": int(trajs),
                           "env_steps": int(trajs * self.env.horizon),
                           "eval_return": ret})
        return ret


class Supervisor:
    """Hook seam into ``AsyncTrainer(mode="procs")`` supervision, the
    reference's. The parent's supervision loop calls these at fixed points;
    the default does nothing, so plugging one in changes nothing about a
    healthy run. Fault injection and invariant monitors build on it; the
    trainer knows nothing of them.

    Lifecycle (every call happens in the PARENT process):

    * ``attach(trainer)``      once, before any child is spawned.
    * ``on_spawn(role, proc, resume)``  after every child start (initial
      spawns and crash-restarts alike).
    * ``on_tick()``            every supervision-loop iteration (~50 Hz).
    * ``on_child_exit(role, exitcode, n_restarts)``  when the parent finds
      a dead child, BEFORE the budget check, so it fires even for the crash
      that exhausts the budget.
    * ``respawn_delay(role) -> float``  seconds to delay that role's
      restart (0 = at once). While delayed, the dead child stays visible
      in ``trainer._procs``.
    * ``on_snapshot(step)``    after every parent snapshot attempt.
    * ``on_complete()``        when the stopping criterion is reached
      cleanly, before the learners are stopped.
    * ``on_teardown(procs)``   FIRST in the teardown path, clean or not;
      must leave every child joinable.
    """

    trainer: Any = None

    def attach(self, trainer) -> None:
        self.trainer = trainer

    def detach(self) -> None:
        """Drop the trainer reference; the trainer calls this LAST in its
        teardown, breaking the trainer<->supervisor reference cycle."""
        self.trainer = None

    def on_spawn(self, role: str, proc, resume: bool) -> None:
        pass

    def on_tick(self) -> None:
        pass

    def on_child_exit(self, role: str, exitcode: int,
                      n_restarts: int) -> None:
        pass

    def respawn_delay(self, role: str) -> float:
        return 0.0

    def on_snapshot(self, step: int) -> None:
        pass

    def on_complete(self) -> None:
        pass

    def on_teardown(self, procs: Dict[str, Any]) -> None:
        pass


class SupervisorChain(Supervisor):
    """Fan one supervision seam out to several supervisors, in order;
    ``respawn_delay`` is the MAX across members (the most patient wins)."""

    def __init__(self, *members: Supervisor):
        self.members = list(members)

    def attach(self, trainer) -> None:
        self.trainer = trainer
        for m in self.members:
            m.attach(trainer)

    def detach(self) -> None:
        self.trainer = None
        for m in self.members:
            m.detach()

    def on_spawn(self, role, proc, resume) -> None:
        for m in self.members:
            m.on_spawn(role, proc, resume)

    def on_tick(self) -> None:
        for m in self.members:
            m.on_tick()

    def on_child_exit(self, role, exitcode, n_restarts) -> None:
        for m in self.members:
            m.on_child_exit(role, exitcode, n_restarts)

    def respawn_delay(self, role) -> float:
        return max([m.respawn_delay(role) for m in self.members],
                   default=0.0)

    def on_snapshot(self, step) -> None:
        for m in self.members:
            m.on_snapshot(step)

    def on_complete(self) -> None:
        for m in self.members:
            m.on_complete()

    def on_teardown(self, procs) -> None:
        for m in self.members:
            m.on_teardown(procs)


_SUMMED = (("work", "work_s", "eval_s", "warmup_s")
           + tuple(f"launches:{k}" for k in LAUNCH_COUNTERS)
           + tuple(f"warmup:{k}" for k in LAUNCH_COUNTERS))


def _child_report(slot: Dict[str, float], past: Dict[str, float]) -> dict:
    """One role's heartbeat telemetry, its dead incarnations' work, step
    seconds, warm-ups and launches added (``past``). ``launches`` holds
    every launch of the role, its warm-ups' (``warmup_launches``)
    included; ``last_launches`` / ``last_warmup_launches`` are the live
    (last) incarnation's own, so a restarted child's work shows apart."""
    def total(k):
        return slot[k] + past.get(k, 0.0)
    return {"work": int(total("work")), "work_s": total("work_s"),
            "first_s": slot["first_s"], "eval_s": total("eval_s"),
            "warmup_s": total("warmup_s"),
            "launches": {k: int(total(f"launches:{k}"))
                         for k in LAUNCH_COUNTERS},
            "warmup_launches": {k: int(total(f"warmup:{k}"))
                                for k in LAUNCH_COUNTERS},
            "last_work": int(slot["work"]),
            "last_launches": {k: int(slot[f"launches:{k}"])
                              for k in LAUNCH_COUNTERS},
            "last_warmup_launches": {k: int(slot[f"warmup:{k}"])
                                     for k in LAUNCH_COUNTERS},
            "route": "cuda" if slot["cuda"] else "plain",
            "compile_count": int(slot["compiles"]),
            "resumed_step": int(slot["resumed"]) - 1}


class AsyncTrainer:
    def __init__(self, env, ens_cfg, algo,
                 run_cfg: Optional[RunConfig] = None, *,
                 mode: str = "event", mesh=None, roles=None,
                 role_ratios=(1, 2, 1), role_axis: Optional[str] = None,
                 algo_cfg=None, pol_cfg=None,
                 n_collectors: Optional[int] = None,
                 envs_per_collector: Optional[int] = None,
                 exploration: Optional[ExplorationSchedule] = None,
                 supervisor: Optional[Supervisor] = None, device=None):
        """``n_collectors``: size of the data-collection fleet (overrides
        ``run_cfg.n_collectors``); collector 0's stream is the lone
        collector's, so N=1 is the single-collector engine.
        ``exploration`` plugs in a per-collector
        :class:`~repro_torch.core.workers.ExplorationSchedule` (default:
        built from ``run_cfg.collect_noise``, or uniform 1.0).

        ``envs_per_collector``: the env farm — each collector runs B
        simulated robots per step (overrides
        ``run_cfg.envs_per_collector``).

        ``device``: where every worker and the eval run; None means CUDA.
        ``mode``: ``"event"``, ``"threads"`` or ``"procs"``.

        ``mesh``/``roles``: run each worker on its own role sub-mesh
        (core/roles.py), in the event and threads modes. Pass a ``roles``
        RoleSplit, or a ``mesh`` to split by ``role_ratios`` along
        ``role_axis``; ``device`` is then not used (the eval runs on the
        policy sub-mesh's first device). Both None is the one-device
        engine.

        ``mode="procs"`` also needs ``algo_cfg`` / ``pol_cfg`` (the plain
        ``AlgoConfig`` / ``PolicyConfig``): spawned children rebuild the
        algorithm from them. ``algo=None`` is then allowed and built here
        the same way. ``supervisor``: a :class:`Supervisor` hooked into the
        procs supervision loop; procs mode only."""
        if supervisor is not None and mode != "procs":
            raise ValueError(
                f'supervisor= hooks into the mode="procs" supervision '
                f"loop only (got mode={mode!r})")
        if mode not in ("event", "threads", "procs"):
            raise NotImplementedError(_not_ported(f"mode={mode!r}"))
        if mode == "procs" and (mesh is not None or roles is not None):
            raise ValueError(
                'mode="procs" does not take a role mesh: each child '
                "owns its whole local backend (per-process meshes "
                "are future work, see ROADMAP.md)")
        self.supervisor = supervisor
        self.algo_cfg = algo_cfg
        self.pol_cfg = pol_cfg
        self.ens_cfg = ens_cfg
        self.env = env
        # fresh per-instance config: a shared mutable default would leak
        # one caller's tweaks into every later trainer
        run_cfg = RunConfig() if run_cfg is None else run_cfg
        if n_collectors is not None:
            run_cfg = dataclasses.replace(run_cfg,
                                          n_collectors=int(n_collectors))
        if envs_per_collector is not None:
            run_cfg = dataclasses.replace(
                run_cfg, envs_per_collector=int(envs_per_collector))
        if run_cfg.n_collectors < 1:
            raise ValueError(f"n_collectors must be >= 1, got "
                             f"{run_cfg.n_collectors}")
        if run_cfg.envs_per_collector < 1:
            raise ValueError(f"envs_per_collector must be >= 1, got "
                             f"{run_cfg.envs_per_collector}")
        if run_cfg.transport not in ("shm", "tcp"):
            raise ValueError(f"transport must be 'shm' or 'tcp', got "
                             f"{run_cfg.transport!r}")
        if run_cfg.transport == "tcp" and mode == "event":
            raise ValueError(
                'transport="tcp" needs a real engine (mode="threads" or '
                '"procs"): the event engine is a single-process virtual-'
                "clock simulation with nothing to transport")
        if mode == "procs":
            if algo_cfg is None or pol_cfg is None:
                raise ValueError(
                    'mode="procs" needs algo_cfg= and pol_cfg= (children '
                    "rebuild the algorithm from plain configs)")
            if algo is None:
                from repro_torch.mbrl.algos import make_algo
                algo = make_algo(algo_cfg, pol_cfg, env.reward,
                                 env.reset_batch)
        self.run_cfg = run_cfg
        self.mode = mode
        self.exploration = exploration if exploration is not None else (
            ExplorationSchedule(tuple(run_cfg.collect_noise))
            if run_cfg.collect_noise else ExplorationSchedule())
        if roles is None and mesh is not None:
            roles = ROLES.split_roles(mesh, ratios=tuple(role_ratios),
                                      axis=role_axis)
        self.roles = roles
        self.device = (ROLES.home_device(roles.policy) if roles is not None
                       else resolve_device(device))
        sc, sm, sp, se = run_seeds(run_cfg.seed)
        self._eval_gen = torch.Generator(self.device).manual_seed(se)
        # threads + tcp: every store behind ONE control plane, owned by
        # this trainer for one run; the codecs come from the first pushes
        # (the workers that own the templates are built below). procs mode
        # picks its transport inside _run_procs
        self._plane = None
        if run_cfg.transport == "tcp" and mode == "threads":
            from repro_torch.net import ControlPlane
            self._plane = ControlPlane(run_cfg.bind or "127.0.0.1:0")
            self.model_server = self._plane.parameter_server("model")
            self.policy_server = self._plane.parameter_server("policy")
            self.data_server = self._plane.data_server(
                n_collectors=run_cfg.n_collectors,
                push_timeout=run_cfg.push_timeout_s)
        else:
            self.data_server = DataServer()
            self.model_server = ParameterServer()
            self.policy_server = ParameterServer()
        # workers shard batches along the axis the split was carved on
        # (not axis_names[0]: a 2-pod mesh splits its wide "data" axis)
        axis = roles.axis if roles is not None else None
        self.policy_worker = PolicyImprovementWorker(
            algo, self.policy_server, self.model_server, sp,
            mesh=roles.policy if roles is not None else None,
            batch_axis=axis, device=self.device)
        # the collector FLEET: every member shares the policy/data
        # servers but owns its generator (collector 0 = the lone
        # collector's stream), its exploration rung and, under a role
        # mesh, its own device of the collector sub-mesh. In procs mode the
        # fleet lives in child processes, so the parent keeps one
        # collector (the ``collector`` alias) for the final count
        n_local = 1 if mode == "procs" else run_cfg.n_collectors
        self.collectors = [
            DataCollectionWorker(
                env, self.policy_server, self.data_server,
                self.policy_worker.state["policy"], sc,
                speed=run_cfg.collect_speed,
                mesh=roles.collector if roles is not None else None,
                collector_id=i,
                noise_scale=self.exploration.scale_for(i),
                envs_per_step=run_cfg.envs_per_collector, device=self.device)
            for i in range(n_local)]
        self.collector = self.collectors[0]     # back-compat alias
        self.model_worker = ModelLearningWorker(
            ens_cfg, self.data_server, self.model_server, sm,
            ema_weight=run_cfg.ema_weight, early_stop=run_cfg.early_stop,
            min_trajs=run_cfg.min_warmup_trajs,
            burst=default_burst(run_cfg.n_collectors,
                                run_cfg.envs_per_collector),
            mesh=roles.model if roles is not None else None,
            batch_axis=axis, device=self.device)
        self.recorder = _Recorder(env, run_cfg.eval_rollouts)

    def run(self) -> List[Dict[str, float]]:
        try:
            if self.mode == "threads":
                return self._run_threads()
            if self.mode == "procs":
                return self._run_procs()
            return self._run_event()
        finally:
            if self._plane is not None:
                self._close_plane()

    def _close_plane(self) -> None:
        """Threads + tcp: record the final versions and count in
        ``net_info``, then close the clients and the plane (the trainer
        owns the plane for one run)."""
        try:
            self.net_info = {
                "model_version": int(self.model_server.version),
                "policy_version": int(self.policy_server.version),
                "trajs": int(self.data_server.total_pushed),
                "addr": "%s:%d" % self._plane.connect_addr}
        finally:
            for srv in (self.model_server, self.policy_server,
                        self.data_server):
                srv.close()
            self._plane.close()
            self._plane = None

    def _run_event(self):
        rc = self.run_cfg
        traj_t = (self.env.horizon * self.env.dt) / rc.collect_speed
        # cursors: virtual time at which each worker becomes free. The
        # FLEET gets one cursor per collector, so N collectors overlap in
        # virtual time exactly like N robots (Fig. 4); ties resolve by
        # dict insertion order, so the schedule (and the trace) is a pure
        # function of the RunConfig and each step's outcome.
        cur = {f"collect:{i}": 0.0 for i in range(len(self.collectors))}
        cur.update({"model": 0.0, "policy": 0.0})
        collect_t = (lambda: max(cur[f"collect:{i}"]
                                 for i in range(len(self.collectors))))
        ds = self.data_server
        since_eval = 0
        B = rc.envs_per_collector
        while ds.total_pushed < rc.total_trajs:
            w = min(cur, key=cur.get)
            t = cur[w]
            if w.startswith("collect:"):
                # env farm: B robots run in PARALLEL, so a batch step
                # advances this collector's cursor by ONE trajectory
                # time. The single-threaded engine needs no tickets:
                # claim min(B, remaining) directly
                g = min(B, rc.total_trajs - ds.total_pushed)
                self.collectors[int(w.split(":", 1)[1])].step(g)
                cur[w] = t + traj_t
            elif w == "model":
                out = self.model_worker.step()
                # idle model worker re-checks for data shortly
                cur[w] = t + (rc.model_epoch_time if out is not None
                              else min(traj_t, rc.model_epoch_time) * 0.5)
            else:
                did = self.policy_worker.step()
                cur[w] = t + (rc.policy_step_time if did
                              else min(traj_t, rc.policy_step_time) * 0.5)
                if did:
                    since_eval += 1
                    if since_eval >= rc.eval_every_policy_steps:
                        since_eval = 0
                        self.recorder.record(
                            collect_t(), ds.total_pushed,
                            self.policy_worker.state["policy"],
                            self._eval_gen)
        # final eval at the end of collection
        self.recorder.record(collect_t(), ds.total_pushed,
                             self.policy_worker.state["policy"],
                             self._eval_gen)
        return self.recorder.trace

    # ----------------------------------------------------------- threads
    def _run_threads(self):
        rc = self.run_cfg
        stop = threading.Event()
        t0 = time.monotonic()   # all trace rows are relative to t0
        ds = self.data_server
        # fleet stopping criterion: each collector CLAIMS its slots before
        # collecting (one lock in the server), so the run finishes with
        # total_pushed EXACTLY total_trajs
        ds.set_target(rc.total_trajs)
        errors: List[tuple] = []
        roles = [f"collect:{w.collector_id}" for w in self.collectors]
        roles += ["model", "policy"]
        streams = self._role_streams(roles)

        def guarded(role, body):
            # a dead thread cannot push its claimed tickets, so the run
            # would otherwise end short with only a stderr traceback:
            # record the error, stop the fleet, raise it from this thread
            try:
                with contextlib.ExitStack() as on_streams:
                    # the role's home card last, so that it is current
                    for s in reversed(streams[role] or ()):
                        on_streams.enter_context(torch.cuda.stream(s))
                    body()
            except Exception as e:
                errors.append((role, e))
                stop.set()

        def collect_loop(w):
            while not stop.is_set():
                # env farm: claim up to a whole batch of slots; the server
                # grants min(B, remaining), so the last batch shrinks to
                # land the criterion exactly
                g = ds.try_claim(w.collector_id, k=w.envs_per_step)
                if not g:
                    return
                t_step = time.monotonic()
                dur = w.step(g)
                if rc.pace_collection and dur is not None:
                    # the robot's control frequency: a batch occupies `dur`
                    # seconds of wall time however fast the simulation runs
                    time.sleep(max(dur - (time.monotonic() - t_step), 0.0))

        def model_loop():
            while not stop.is_set():
                if self.model_worker.step() is None:
                    time.sleep(0.002)

        def policy_loop():
            n = 0
            while not stop.is_set():
                if self.policy_worker.step():
                    n += 1
                    if n % rc.eval_every_policy_steps == 0:
                        self.recorder.record(
                            time.monotonic() - t0, ds.total_pushed,
                            self.policy_worker.state["policy"],
                            self._eval_gen)
                else:
                    time.sleep(0.002)

        collect_threads = [
            threading.Thread(target=guarded, daemon=True, name=role,
                             args=(role, lambda w=w: collect_loop(w)))
            for role, w in zip(roles, self.collectors)]
        learner_threads = [
            threading.Thread(target=guarded, daemon=True, name=role,
                             args=(role, body))
            for role, body in (("model", model_loop),
                               ("policy", policy_loop))]
        for th in collect_threads + learner_threads:
            th.start()
        for th in collect_threads:  # every claimed slot has been pushed
            th.join()               # once the whole fleet exits
        stop.set()
        for th in learner_threads:
            th.join(timeout=10)
        stuck = [th.name for th in learner_threads if th.is_alive()]
        if stuck:
            raise RuntimeError(f"{stuck} did not stop within 10 s of the "
                               "end of collection")
        self._join_streams(streams)
        if errors:
            role, err = errors[0]
            if role.startswith("collect:"):
                raise RuntimeError(
                    f"collector {role.split(':', 1)[1]} failed mid-run; the "
                    f"fleet stopped at {ds.total_pushed}/{rc.total_trajs} "
                    "trajectories") from err
            raise RuntimeError(f"the {role} worker failed mid-run") from err
        self.recorder.record(time.monotonic() - t0, ds.total_pushed,
                             self.policy_worker.state["policy"],
                             self._eval_gen)
        return self.recorder.trace

    def _role_devices(self) -> Dict[str, List[torch.device]]:
        """The devices each role runs on, its home device first: a
        collector its own; the model and policy roles their device, or
        every device of their sub-mesh under a role mesh."""
        out = {f"collect:{w.collector_id}": [w.device]
               for w in self.collectors}
        for role in ("model", "policy"):
            mesh = getattr(self.roles, role, None)
            out[role] = ([self.device] if mesh is None
                         else list(dict.fromkeys(mesh.devices.flat)))
        return out

    def _role_streams(self, roles
                      ) -> Dict[str, Optional[List[torch.cuda.Stream]]]:
        """A CUDA stream per role on each card it runs on (its home card
        first), each ordered after the work the caller has queued there so
        far (the workers' initial params); None for a role on the CPU."""
        devices = self._role_devices()
        out = {}
        for r in roles:
            out[r] = None
            for dev in devices[r]:
                if dev.type == "cuda":
                    s = torch.cuda.Stream(device=dev)
                    s.wait_stream(torch.cuda.current_stream(dev))
                    out[r] = (out[r] or []) + [s]
        return out

    def _join_streams(self, streams) -> None:
        """Order the caller's stream on each card after every role's work
        there, without a host sync."""
        for role_streams in streams.values():
            for s in role_streams or ():
                torch.cuda.current_stream(s.device).wait_stream(s)


    # ------------------------------------------------------------- procs
    def _drain_trace(self, reader) -> None:
        while reader.poll():
            self.recorder.trace.append(reader.recv())

    def _snapshot(self, ckpt_dir, model_srv, policy_srv, step) -> int:
        """Checkpoint both stores' params and versions. Until a store's
        first push its slot holds the parent's (deterministic) initial
        params at version 0: restoring that is a restart from scratch.

        A DEGRADED pull (None while the version is above 0: a writer died
        mid-push) is not snapshotted, since initial params there would
        ratchet the newest checkpoint back to scratch; the previous
        snapshot stays and the next cycle retries."""
        m, mv = model_srv.pull()
        p, pv = policy_srv.pull()
        if (m is None and model_srv.version > 0) or \
                (p is None and policy_srv.version > 0):
            return step
        if m is None:
            m, mv = self.model_worker.params, 0
        if p is None:
            p, pv = self.policy_worker.state["policy"], 0
        tree = {"model": m, "model_version": np.int64(mv),
                "policy": p, "policy_version": np.int64(pv)}
        ckpt_io.save_pytree(ckpt_dir, tree, step=step, keep=3)
        return step + 1

    def _build_kernels(self) -> None:
        """On the card, build the kernels the roles launch (``gmm_equal``
        in the model child, ``imag_fused`` in the policy child) before any
        child starts, so each child only loads the library."""
        if self.device.type != "cuda":
            return
        from repro_torch.kernels import build
        from repro_torch.kernels.gmm import cuda as gmm_cuda
        from repro_torch.kernels.imag import cuda as imag_cuda
        build.build([gmm_cuda.SOURCE, imag_cuda.SOURCE])

    def _run_procs(self):
        import repro_torch
        rc = self.run_cfg
        sup = self.supervisor if self.supervisor is not None else Supervisor()
        ctx = mp.get_context("spawn")   # never fork a process with CUDA
        self._build_kernels()
        ckpt_dir = Path(rc.ckpt_dir) if rc.ckpt_dir else \
            Path(_made_dir("repro_torch_procs_ckpt_"))
        n_slots = heartbeat_slots(rc.n_collectors)
        # every IPC resource belongs to this ExitStack: whatever path
        # leaves the method closes the stores, and the run's directory
        # (registered first, so removed last) takes every file with it
        with contextlib.ExitStack() as stack:
            run_dir = _made_dir("repro_torch_procs_")
            stack.callback(shutil.rmtree, run_dir, True)
            self._run_dir = run_dir
            # the transport seam: everything after this block is the same
            # for both families of stores (pull / version for snapshots and
            # completion, refund_inflight for crash refunds)
            plane = None
            if rc.transport == "tcp":
                from repro_torch.net import ControlPlane
                plane = stack.enter_context(
                    ControlPlane(rc.bind or "127.0.0.1:0"))
                model_srv = stack.enter_context(plane.parameter_server(
                    "model", self.model_worker.params))
                policy_srv = stack.enter_context(plane.parameter_server(
                    "policy", self.policy_worker.state["policy"]))
                # the ticket counters live on the plane, so remote joiners
                # (--connect) share the one exact criterion
                data_srv = stack.enter_context(plane.data_server(
                    n_collectors=rc.n_collectors, target=rc.total_trajs,
                    push_timeout=rc.push_timeout_s))
            else:
                model_srv = stack.enter_context(ShmParameterServer(
                    self.model_worker.params, dir=run_dir))
                policy_srv = stack.enter_context(ShmParameterServer(
                    self.policy_worker.state["policy"], dir=run_dir))
                # ticket-armed: collector processes claim slots from the
                # shared counters, so the criterion lands exactly even
                # across collector crashes (the parent refunds in-flight
                # tickets)
                data_srv = stack.enter_context(ProcDataServer(
                    n_collectors=rc.n_collectors, target=rc.total_trajs,
                    push_timeout=rc.push_timeout_s, dir=run_dir))
            control = ProcControl(n_slots, dir=run_dir)
            stack.callback(control.close)
            reader, writer = ctx.Pipe(duplex=False)
            stack.callback(reader.close)
            stack.callback(writer.close)
            ch = ProcChannels(model_srv, policy_srv, data_srv, writer,
                              control, t0=time.monotonic())
            spec = ProcSpec(self.env, self.ens_cfg, self.algo_cfg,
                            self.pol_cfg, rc, rc.seed,
                            exploration=self.exploration,
                            device=str(self.device))
            if plane is not None:
                # the spec remote joiners (--connect) rebuild a collector
                # from; they claim from the same ticket counters
                plane.set_join_spec(pickle.dumps(spec))
                self.net_info = {"addr": "%s:%d" % plane.connect_addr}
            self._proc_servers = {"model": model_srv, "policy": policy_srv,
                                  "data": data_srv}
            self._proc_channels = ch
            # one supervised child per collector, each with its OWN
            # restart budget
            collector_roles = [f"collector:{i}"
                               for i in range(rc.n_collectors)]
            roles = ["model", "policy"] + collector_roles
            restarts = {r: 0 for r in roles}
            # dead incarnations' telemetry, added to the live slot's
            past: Dict[str, Dict[str, float]] = {r: {} for r in roles}
            # shared LIVE so a supervisor's on_tick sees the budget move
            self.proc_info: Dict[str, Any] = {
                "restarts": restarts, "ckpt_dir": str(ckpt_dir)}
            src_root = str(Path(repro_torch.__file__).resolve().parents[1])

            def slot_of(role):
                return heartbeat_slot(role, rc.n_collectors)

            def spawn(role, resume=False):
                # children must import repro_torch whatever launched the
                # parent (pytest, a notebook, an installed script)
                old_pp = os.environ.get("PYTHONPATH")
                if src_root not in (old_pp or "").split(os.pathsep):
                    os.environ["PYTHONPATH"] = \
                        src_root + (os.pathsep + old_pp if old_pp else "")
                try:
                    p = ctx.Process(
                        target=proc_worker_main, name=f"repro_torch-{role}",
                        args=(role, spec, ch,
                              str(ckpt_dir) if resume else None),
                        daemon=True)
                    p.start()
                finally:
                    if old_pp is None:
                        os.environ.pop("PYTHONPATH", None)
                    else:
                        os.environ["PYTHONPATH"] = old_pp
                sup.on_spawn(role, p, resume)
                return p

            def bury(role):
                # keep a dead child's work and launches; the slot starts
                # from zero for the next incarnation
                slot = control.read(slot_of(role))
                for k in _SUMMED:
                    past[role][k] = past[role].get(k, 0.0) + slot[k]
                control.write(slot_of(role), [0.0] * len(control.FIELDS))

            self._procs = {}
            pending_respawn: Dict[str, float] = {}
            last_snap = time.monotonic()
            snap_step = 0
            # seconds since the run's start, as the supervision loop sees
            # them (to its ~20 ms tick): the first policy a collector can
            # pull, and the whole fleet's clean exit
            timeline: Dict[str, float] = {}
            sup.attach(self)
            try:
                for r in ["policy", "model"] + collector_roles:
                    self._procs[r] = spawn(r)
                while True:
                    self._drain_trace(reader)
                    sup.on_tick()
                    if "policy_ready_s" not in timeline and \
                            policy_srv.version >= 1:
                        timeline["policy_ready_s"] = time.monotonic() - ch.t0
                    collected = all(self._procs[r].exitcode == 0
                                    for r in collector_roles)
                    if collected and "collection_done_s" not in timeline:
                        timeline["collection_done_s"] = \
                            time.monotonic() - ch.t0
                    if collected and model_srv.version >= \
                            rc.min_final_model_version and \
                            policy_srv.version >= \
                            rc.min_final_policy_version:
                        break       # stopping criterion reached cleanly
                    for role, p in list(self._procs.items()):
                        ec = p.exitcode
                        if ec is None or ec == 0:
                            continue
                        if role in pending_respawn:
                            if time.monotonic() < pending_respawn[role]:
                                continue
                            del pending_respawn[role]
                            self._procs[role] = spawn(role, resume=True)
                            continue
                        restarts[role] += 1
                        sup.on_child_exit(role, ec, restarts[role])
                        if restarts[role] > rc.max_restarts:
                            raise RuntimeError(
                                f"{role} worker crashed (exit {ec}) more "
                                f"than max_restarts={rc.max_restarts} "
                                "times")
                        p.join()
                        bury(role)
                        if role.startswith("collector:"):
                            # a crash between claim and push would strand
                            # its tickets and stall the criterion
                            data_srv.refund_inflight(
                                int(role.split(":", 1)[1]))
                        # restart from the LATEST snapshot, at once unless
                        # a supervisor asks for a delay
                        delay = float(sup.respawn_delay(role))
                        if delay > 0:
                            pending_respawn[role] = time.monotonic() + delay
                        else:
                            self._procs[role] = spawn(role, resume=True)
                    if time.monotonic() - last_snap >= rc.snapshot_every_s:
                        snap_step = self._snapshot(ckpt_dir, model_srv,
                                                   policy_srv, snap_step)
                        sup.on_snapshot(snap_step)
                        last_snap = time.monotonic()
                    time.sleep(0.02)
                sup.on_complete()
                ch.request_stop()
                for role in ("model", "policy"):
                    self._procs[role].join(timeout=120)
                # the final eval row arrives AFTER the policy child saw
                # the stop word
                if reader.poll(10):
                    self.recorder.trace.append(reader.recv())
                self._drain_trace(reader)
                # adopt the children's final published params, so the
                # parent looks like a threads-mode trainer afterwards
                m_final, mv = model_srv.pull()
                p_final, pv = policy_srv.pull()
                if p_final is not None:
                    self.policy_worker.state = {
                        **self.policy_worker.state,
                        "policy": tree_to(p_final, self.device)}
                    self.policy_server.push(
                        self.policy_worker.state["policy"])
                if m_final is not None:
                    self.model_worker.params = tree_to(m_final, self.device)
                    self.model_server.push(self.model_worker.params)
                self.collector.collected = data_srv.total_pushed
                snap_step = self._snapshot(ckpt_dir, model_srv, policy_srv,
                                           snap_step)
                self.proc_info.update({
                    "model_version": int(mv), "policy_version": int(pv),
                    "restarts": dict(restarts),
                    "trajs": data_srv.total_pushed,
                    "n_collectors": rc.n_collectors,
                    "noise_scales": [self.exploration.scale_for(i)
                                     for i in range(rc.n_collectors)],
                    "timeline": {**timeline,
                                 "stopped_s": time.monotonic() - ch.t0},
                    "children": {r: _child_report(
                        control.read(slot_of(r)), past[r]) for r in roles}})
            finally:
                # FIRST: let the supervisor make every child joinable
                try:
                    sup.on_teardown(self._procs)
                except Exception:   # the children must still be stopped
                    print("supervisor on_teardown failed:", file=sys.stderr)
                    traceback.print_exc()
                control.request_stop()
                for p in self._procs.values():
                    if p.is_alive():
                        p.join(timeout=10)
                    if p.is_alive():
                        p.terminate()
                        p.join(timeout=5)
                    if p.is_alive():
                        p.kill()    # even a wedged child must not
                        p.join(timeout=5)   # outlive the run
                sup.detach()
                # the stores and the run directory close via the ExitStack
        return self.recorder.trace


class SequentialTrainer:
    """Classic synchronous MBRL (Fig. 1b): collect N -> fit model to
    convergence (early stop / max epochs) -> G policy steps -> repeat.
    Seeded as :class:`AsyncTrainer` is (:func:`run_seeds`)."""

    def __init__(self, env, ens_cfg, algo,
                 run_cfg: Optional[RunConfig] = None,
                 *, n_rollouts: int = 5, max_model_epochs: int = 50,
                 policy_steps: int = 20, device=None):
        self.env = env
        run_cfg = RunConfig() if run_cfg is None else run_cfg
        self.run_cfg = run_cfg
        self.n_rollouts = n_rollouts
        self.max_model_epochs = max_model_epochs
        self.policy_steps = policy_steps
        self.device = resolve_device(device)
        sc, sm, sp, se = run_seeds(run_cfg.seed)
        self._eval_gen = torch.Generator(self.device).manual_seed(se)
        self.data_server = DataServer()
        self.model_server = ParameterServer()
        self.policy_server = ParameterServer()
        self.policy_worker = PolicyImprovementWorker(
            algo, self.policy_server, self.model_server, sp,
            device=self.device)
        self.collector = DataCollectionWorker(
            env, self.policy_server, self.data_server,
            self.policy_worker.state["policy"], sc, device=self.device)
        self.model_worker = ModelLearningWorker(
            ens_cfg, self.data_server, self.model_server, sm,
            ema_weight=run_cfg.ema_weight, early_stop=run_cfg.early_stop,
            min_trajs=run_cfg.min_warmup_trajs, device=self.device)
        self.recorder = _Recorder(env, run_cfg.eval_rollouts)

    def _record(self, t) -> None:
        self.recorder.record(t, self.collector.collected,
                             self.policy_worker.state["policy"],
                             self._eval_gen)

    def run(self):
        rc = self.run_cfg
        t = 0.0
        traj_t = self.env.horizon * self.env.dt
        while self.collector.collected < rc.total_trajs:
            for _ in range(self.n_rollouts):
                self.collector.step()
                t += traj_t
            self.model_worker.stopper.reset()
            for _ in range(self.max_model_epochs):
                out = self.model_worker.step()
                if out is None:
                    break
                t += rc.model_epoch_time
            for i in range(self.policy_steps):
                if self.policy_worker.step():
                    t += rc.policy_step_time
            self._record(t)
        return self.recorder.trace


class PartialAsyncModelPolicy(SequentialTrainer):
    """§5.2: collect N rollouts, then ALTERNATE (1 model epoch, G' policy
    steps) — policy sees models before they converge."""

    def run(self):
        rc = self.run_cfg
        t = 0.0
        traj_t = self.env.horizon * self.env.dt
        g_alt = max(self.policy_steps // self.max_model_epochs, 1)
        while self.collector.collected < rc.total_trajs:
            for _ in range(self.n_rollouts):
                self.collector.step()
                t += traj_t
            self.model_worker.stopper.reset()
            for e in range(self.max_model_epochs):
                out = self.model_worker.step()
                if out is not None:
                    t += rc.model_epoch_time
                for _ in range(g_alt):
                    if self.policy_worker.step():
                        t += rc.policy_step_time
                if out is None:
                    break
            self._record(t)
        return self.recorder.trace


class PartialAsyncDataPolicy(SequentialTrainer):
    """§5.3: fit the model, then ALTERNATE (G policy steps, collect one
    rollout) N times — collection uses fresh mid-training policies."""

    def run(self):
        rc = self.run_cfg
        t = 0.0
        traj_t = self.env.horizon * self.env.dt
        g_alt = max(self.policy_steps // max(self.n_rollouts, 1), 1)
        # initial data
        for _ in range(self.n_rollouts):
            self.collector.step()
            t += traj_t
        while self.collector.collected < rc.total_trajs:
            self.model_worker.stopper.reset()
            for _ in range(self.max_model_epochs):
                out = self.model_worker.step()
                if out is None:
                    break
                t += rc.model_epoch_time
            for _ in range(self.n_rollouts):
                for _ in range(g_alt):
                    if self.policy_worker.step():
                        t += rc.policy_step_time
                self.collector.step()
                t += traj_t
            self._record(t)
        return self.recorder.trace
