"""The three workers of Figure 1a (Alg. 1, 2 and 3): the port of
``repro/core/workers.py``.

Each worker is a pull -> step -> push loop with the minimal unit of work
(one batch of rollouts / one model epoch / one policy-improvement step),
run on one device, or on its role's sub-mesh (``mesh=``, core/roles.py):
a collector on its device of the collector sub-mesh (round-robin over the
fleet), the model learner on a ring sharded over the model sub-mesh and
trained data-parallel, the policy improver with its imagination sharded
over the policy sub-mesh. Parameters live on a sub-mesh's first device.
Parameter pulls are version-gated: an unchanged version costs one lock +
integer compare against a device-resident cache.
Randomness comes from explicit ``torch.Generator``s on the worker's device:
one per collector (``collector_generator``), one per model learner, one per
policy improver; the learner's minibatch index grid (``index_source``) and
the improver's imagination draws (``draw_source``) can be injected to
replay another run's draws.

The model learner and the policy improver keep the reference's no-retrace
invariant in eager form: ``train_epoch``, ``val_loss`` and ``improve`` each
see one input shape in steady state (``compile_count``).

Process isolation (``mode="procs"``, ``runtime._run_procs``): the same
worker objects also run as separate OS processes, started from the
``spawn`` context. The module-level ``proc_worker_main(role, spec,
channels)`` rebuilds env, algorithm and worker inside the child from plain
configs (:class:`ProcSpec`) and the seed; each child on the card holds its
own CUDA context, and talks to the others only through the file-backed
stores in ``channels`` (``servers.ShmParameterServer`` /
``ProcDataServer`` / ``ProcControl``). Nothing crosses the process boundary
but bytes and numpy arrays: a pull returns CPU tensors, and the workers
move them onto their device once per version change.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import roles as ROLES
from repro_torch.core.servers import DataServer, ParameterServer, ReplayBuffer
from repro_torch.kernels import LAUNCH_COUNTERS, launch_counts
from repro_torch.mbrl import dynamics as DYN
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl.early_stop import EMAEarlyStop
from repro_torch.utils.tree import tree_to

# index_source(nb, bs, size) -> (nb, bs) integer tensor of ring rows
IndexSource = Callable[[int, int, int], torch.Tensor]
# draw_source(model_params) -> the draws of one ``algo.improve`` call
DrawSource = Callable[[Any], Any]


@dataclasses.dataclass
class WorkerTimes:
    """Nominal virtual durations (seconds) of each worker's step — used by
    the discrete-event engine to reproduce the paper's real-robot timing."""
    trajectory: float       # horizon * env.dt (robot time; exact)
    model_epoch: float = 1.0
    policy_step: float = 0.5


@dataclasses.dataclass(frozen=True)
class ExplorationSchedule:
    """Per-collector exploration for a fleet: each collector samples with
    its own action-noise scale. Scales cycle when the fleet is larger than
    the tuple; scale 1.0 is exactly the single-collector behaviour."""
    noise_scales: tuple = (1.0,)

    def scale_for(self, collector_id: int) -> float:
        return float(self.noise_scales[collector_id
                                       % len(self.noise_scales)])

    @classmethod
    def ladder(cls, n_collectors: int, lo: float = 0.75,
               hi: float = 1.5) -> "ExplorationSchedule":
        """Evenly spaced lo..hi noise ladder across the fleet; collector
        0 keeps scale 1.0. A two-collector fleet gets (1.0, hi)."""
        if n_collectors <= 1:
            return cls((1.0,))
        k = n_collectors - 1            # varied rungs
        if k == 1:
            return cls((1.0, hi))
        rest = tuple(lo + (hi - lo) * i / (k - 1) for i in range(k))
        return cls((1.0,) + rest)


def collector_generator(seed: int, collector_id: int,
                        device) -> torch.Generator:
    """Per-collector RNG stream, the counterpart of the reference's
    ``collector_key``: collector 0 is seeded with ``seed`` itself (a fleet
    of one draws the lone collector's stream); every other collector with
    a seed derived from ``(seed, collector_id)``."""
    s = int(seed) if collector_id == 0 else int(
        np.random.SeedSequence([int(seed), int(collector_id)])
        .generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(s)


def heartbeat_slot(role: str, n_collectors: int = 1) -> int:
    """Index of ``role``'s slot in the control block's heartbeats
    (``servers.ProcControl``): model=0, policy=1, collector:<i>=2+i."""
    if role == "model":
        return 0
    if role == "policy":
        return 1
    cid = int(role.split(":", 1)[1]) if ":" in role else 0
    return 2 + (cid % max(int(n_collectors), 1))


def heartbeat_slots(n_collectors: int) -> int:
    """Total heartbeat slots for a run: model + policy + the fleet."""
    return 2 + max(int(n_collectors), 1)


def default_burst(n_collectors: int, envs_per_step: int = 1) -> int:
    """Drain burst capacity for a fleet of N collectors running B envs
    each: an env farm's whole batch fits one burst, so its drain stays a
    single ring scatter per chunk."""
    return max(8, 2 * int(n_collectors), int(envs_per_step))


def _sampler_for(noise_scale: float):
    if noise_scale == 1.0:
        return PI.sample_action

    def sampler(p, s, eps):
        return PI.sample_action_scaled(p, s, noise_scale, eps)
    return sampler


class DataCollectionWorker:
    """Algorithm 1. Pull policy θ -> collect a batch of ``envs_per_step``
    trajectories -> push.

    The pull is version-gated against a device-resident policy cache.
    Every ``step`` draws the batch's reset draws and its (H, B, act)
    policy noise from this collector's generator and steps the B robots
    together (``Env.rollout_batch``); one trajectory is pushed alone,
    more as one stacked batch."""

    def __init__(self, env, policy_server: ParameterServer,
                 data_server: DataServer, init_policy_params, seed: int,
                 *, speed: float = 1.0, mesh=None, collector_id: int = 0,
                 noise_scale: float = 1.0, envs_per_step: int = 1,
                 device=None):
        """``mesh``: the collector sub-mesh. This collector then runs on
        its one device of it (``roles.collector_sharding``: round-robin
        over the fleet), where its pulls land; ``device`` is not used."""
        self.env = env
        self.policy_server = policy_server
        self.data_server = data_server
        self.collector_id = int(collector_id)
        self.noise_scale = float(noise_scale)
        self.envs_per_step = int(envs_per_step)
        if self.envs_per_step < 1:
            raise ValueError(f"envs_per_step must be >= 1, got "
                             f"{self.envs_per_step}")
        self._sharding = None
        if mesh is not None:
            self._sharding = ROLES.collector_sharding(mesh,
                                                      self.collector_id)
            self.device = self._sharding.device
        else:
            self.device = resolve_device(device)
        self._gen = collector_generator(seed, self.collector_id, self.device)
        # init_policy_params=None (procs mode): no in-process policy worker
        # to borrow initial params from; ``step`` returns None until the
        # policy process publishes version 1
        self._policy_cache = (None if init_policy_params is None else
                              tree_to(init_policy_params, self.device))
        self._policy_ver = 0
        self._sampler = _sampler_for(self.noise_scale)
        self.speed = speed  # >1: faster collection (Fig. 5b)
        self.collected = 0
        self._batch_sizes = set()

    def compile_count(self) -> int:
        """Input shapes seen by the reference's two compiled rollouts: the
        one-robot rollout and, for a farm, the full-batch rollout, each
        counted once it has run. Steady state is 1 for one robot and at
        most 2 for a farm (a last grant of one robot runs the single
        rollout); a partial grant of 1 < g < B runs another program the
        reference does not count either."""
        return sum(1 for g in self._batch_sizes
                   if g == 1 or g == self.envs_per_step)

    def poll_policy(self) -> bool:
        """Refresh the policy cache (version-gated) without collecting.
        True once a policy is available. A pull across processes gives CPU
        tensors: they move onto this worker's device here, once."""
        fresh, self._policy_ver = self.policy_server.pull_if_newer(
            self._policy_ver, sharding=self._sharding)
        if fresh is not None:
            self._policy_cache = tree_to(fresh, self.device)
        return self._policy_cache is not None

    def step(self, n: Optional[int] = None) -> Optional[float]:
        """One batch of ``n`` trajectories (default ``envs_per_step``; the
        engines pass a partial ticket grant near the criterion). Returns
        its robot-time duration — one trajectory's, since the batch's
        robots run in parallel — or None before any policy exists."""
        if not self.poll_policy():                          # Pull (gated)
            return None
        g = self.envs_per_step if n is None else int(n)
        self._batch_sizes.add(g)
        batch = self.env.rollout_batch(self._sampler, self._policy_cache, g,
                                       generator=self._gen)  # Step
        if g == 1:
            self.data_server.push({k: v[0] for k, v in batch.items()},
                                  collector_id=self.collector_id)  # Push
        else:
            self.data_server.push_batch(batch, g,
                                        collector_id=self.collector_id)
        self.collected += g
        return (self.env.horizon * self.env.dt) / self.speed


class ModelLearningWorker:
    """Algorithm 2. Drain data -> one epoch on the local FIFO ring buffer
    (with EMA-validation early stopping, §5.4) -> push φ.

    Storage is a preallocated :class:`ReplayBuffer` built on first data
    (capacity = max_trajs * horizon); after that every epoch runs on the
    same shapes. ``params`` replaces the random init (the parity tests
    start both packages from one converted tree). ``index_source(nb, bs,
    size)`` gives each epoch's (nb, bs) minibatch grid; by default it is
    drawn with replacement from ``[0, max(size, 1))`` on this worker's
    generator, the whole static grid every epoch, as the reference does.

    ``mesh`` (the model sub-mesh) and ``batch_axis``: the ring is sharded
    over the sub-mesh's ``batch_axis`` (``roles.batch_sharded``) and each
    epoch trains data-parallel over its shards
    (``make_ring_trainer(batch_sharding=)``); the parameters, the optimizer
    state and the generator live on the sub-mesh's first device, so the
    grid's draws are one device's. ``device`` is then not used."""

    def __init__(self, ens_cfg: DYN.EnsembleConfig,
                 data_server: DataServer, model_server: ParameterServer,
                 seed: int, *, params=None, max_trajs: int = 200,
                 ema_weight: float = 0.9, early_stop: bool = True,
                 min_trajs: int = 4, burst: int = 8,
                 index_source: Optional[IndexSource] = None, mesh=None,
                 batch_axis: Optional[str] = None, device=None):
        self.cfg = ens_cfg
        self.data_server = data_server
        self.model_server = model_server
        self.max_trajs = max_trajs
        self.burst = max(int(burst), 1)
        self._batch_shard = None
        if mesh is not None:
            self._batch_shard = ROLES.batch_sharded(mesh, batch_axis)
            self.device = ROLES.home_device(mesh)
        else:
            self.device = resolve_device(device)
        self._gen = torch.Generator(self.device).manual_seed(int(seed))
        self.params = (DYN.init_ensemble(ens_cfg, self._gen) if params is None
                       else tree_to(params, self.device))
        self.index_source = index_source or self._draw_indices
        self.buffer: Optional[ReplayBuffer] = None    # lazy: needs horizon
        self._grid = None
        self._train_epoch = None
        self._val_loss = None
        self._update_norm = None
        self.opt_state = None
        self.stopper = EMAEarlyStop(weight=ema_weight, enabled=early_stop)
        self.epochs = 0
        self.last_train_loss = None
        self._have_data = False
        # deferring the first push until a small initial dataset exists
        # reproduces the paper's 'acquire an initial dataset' phase (§5.3)
        self.min_trajs = min_trajs

    def _draw_indices(self, nb: int, bs: int, size: int) -> torch.Tensor:
        return torch.randint(0, max(size, 1), (nb, bs), generator=self._gen,
                             device=self.device)

    def _ensure_trainer(self, traj) -> None:
        if self.buffer is not None:
            return
        horizon = int(next(iter(traj.values())).shape[0])
        capacity = self.max_trajs * horizon
        # a sharded ReplayBuffer rounds its capacity up to the shard
        # count; the trainer's grid reads the final value back
        self.buffer = ReplayBuffer(capacity, burst_capacity=self.burst,
                                   device=self.device,
                                   sharding=self._batch_shard)
        self._grid = DYN.ring_grid(self.cfg, self.buffer.capacity)
        opt, self._train_epoch, self._val_loss, self._update_norm = \
            DYN.make_ring_trainer(self.cfg, self.buffer.capacity,
                                  batch_sharding=self._batch_shard)
        self.opt_state = opt.init(self.params)

    def compile_count(self) -> int:
        """Distinct input shapes of ``train_epoch``: 1 for the whole life
        of the worker once data exists (the reference's trace count)."""
        return 0 if self._train_epoch is None else \
            self._train_epoch.shape_count

    def val_compile_count(self) -> int:
        return 0 if self._val_loss is None else self._val_loss.shape_count

    def _refresh_data(self) -> bool:
        new = self.data_server.drain()                  # Pull (move all)
        if new:
            self._ensure_trainer(new[0])
            self.buffer.extend(new)
            self._have_data = True
            self.stopper.reset()                        # §4: resume training
        return bool(new)

    def step(self) -> Optional[float]:
        """One epoch; returns its validation loss, or None when idle (no
        data / early-stopped)."""
        self._refresh_data()
        if not self._have_data or self.buffer.total_seen < self.min_trajs:
            return None
        if self.stopper.stopped:
            return None
        data, size = self.buffer.train_view()
        self.params = {**self.params,
                       "norm": self._update_norm(data, size)}
        idx = self.index_source(*self._grid, size)
        self.params, self.opt_state, tr_loss = self._train_epoch(
            self.params, self.opt_state, data, size, idx)
        vdata, vsize = self.buffer.val_view()
        if vsize == 0:
            # no held-out traj yet: validate on a val-ring-SHAPED slice
            # of the train ring, so val_loss keeps one shape
            vcap = self.buffer.val_capacity
            vdata = {k: (v[:vcap] if self._batch_shard is None
                         else v.head(vcap)) for k, v in data.items()}
            vsize = min(size, vcap)
        vloss = float(self._val_loss(self.params, vdata, vsize))
        self.last_train_loss = tr_loss
        self.stopper.update(vloss)
        self.epochs += 1
        self.model_server.push(self.params)             # Push
        return vloss


class PolicyImprovementWorker:
    """Algorithm 3. Pull φ -> ONE policy-improvement step (TRPO/PPO/MB-MPO
    on imagined rollouts) -> push θ.

    Keeps a device-resident model cache; an unchanged model version costs
    one lock + integer compare. ``policy`` replaces the random initial
    policy (the parity tests start both packages from one converted tree);
    the initial policy is pushed at construction. Each step's
    imagination draws come from ``draw_source(model_params)`` when given
    (a test replays the reference's key splits through it), else from this
    worker's generator. ``push_init=False`` (a procs-mode crash restart)
    holds back the push of the initial policy, so that a restarted worker
    can load the latest snapshot and publish THAT: collectors never fall
    back to a fresh random policy.

    ``mesh`` (the policy sub-mesh) and ``batch_axis``: the algorithm's
    imagination is sharded over the sub-mesh (``algo.configure_mesh``),
    the state lives on its first device and model pulls land there
    (``sharding=roles.replicated(mesh)``). ``device`` is then not used."""

    def __init__(self, algo, policy_server: ParameterServer,
                 model_server: ParameterServer, seed: int, *, policy=None,
                 draw_source: Optional[DrawSource] = None,
                 push_init: bool = True, mesh=None,
                 batch_axis: Optional[str] = None, device=None):
        self.algo = algo
        self.policy_server = policy_server
        self.model_server = model_server
        self._repl = None
        if mesh is not None:
            self._repl = ROLES.replicated(mesh)
            self.device = ROLES.home_device(mesh)
            if hasattr(algo, "configure_mesh"):
                algo.configure_mesh(mesh, batch_axis)
        else:
            self.device = resolve_device(device)
        self._gen = torch.Generator(self.device).manual_seed(int(seed))
        self.draw_source = draw_source
        self.state = algo.init(
            self._gen, policy=None if policy is None
            else tree_to(policy, self.device))
        if push_init:
            self.policy_server.push(self.state["policy"])
        self._model_cache = None
        self._model_ver = 0
        self.steps = 0
        self.last_info = None

    def compile_count(self) -> int:
        """Distinct input shapes of the algo's ``improve`` (1 in steady
        state): the reference's compile count of its one ``_improve`` jit."""
        return self.algo.shape_count()

    def step(self) -> bool:
        fresh, self._model_ver = self.model_server.pull_if_newer(
            self._model_ver, sharding=self._repl)       # Pull (gated)
        if fresh is not None:
            self._model_cache = tree_to(fresh, self.device)
        if self._model_cache is None:
            return False
        draws = (None if self.draw_source is None
                 else self.draw_source(self._model_cache))
        self.state, self.last_info = self.algo.improve(
            self.state, self._model_cache, draws, generator=self._gen)
        self.steps += 1
        self.policy_server.push(self.state["policy"])   # Push
        return True


# --------------------------------------------------------------- procs mode
#
# The paper's deployment shape: collectors, model learner and policy
# improver as SEPARATE OS processes, so the learners' compute cannot steal
# the collector's interpreter. Everything below stays picklable through
# the spawn context: plain-config dataclasses in, a module-level entry
# point, the file-backed stores of servers.py. Envs, algorithms and
# ensembles are rebuilt inside the child from (configs, seed, role).

@dataclasses.dataclass
class ProcSpec:
    """Everything a spawned worker needs to rebuild its role: plain
    dataclass configs, the run's seed and the device. The child derives
    the same per-role seeds as the in-process engines (``run_seeds``);
    fleet collectors take their own stream by id
    (``collector_generator``). ``device`` is what the child runs on: a
    child asked for the card on a host without one raises. On the CPU each
    child runs ``cpu_threads`` intra-op threads, so a few children do not
    oversubscribe the host."""
    env: Any                    # frozen env dataclass
    ens_cfg: DYN.EnsembleConfig
    algo_cfg: Any               # mbrl.algos.AlgoConfig
    pol_cfg: PI.PolicyConfig
    run_cfg: Any                # core.runtime.RunConfig
    seed: int
    exploration: Any = None     # ExplorationSchedule (or None: all 1.0)
    device: str = "cuda"
    cpu_threads: int = 1


@dataclasses.dataclass
class ProcChannels:
    """The IPC endpoints every worker process shares: the two parameter
    stores, the data spool, the control block (stop word and heartbeats,
    ``servers.ProcControl``) and the write end of the trace pipe, whose one
    writer is the policy child (a row is far below ``PIPE_BUF``, so a write
    is atomic)."""
    model_server: Any           # ShmParameterServer (written by model)
    policy_server: Any          # ShmParameterServer (written by policy)
    data: Any                   # ProcDataServer (collectors -> model)
    trace: Any                  # multiprocessing Connection: rows -> parent
    control: Any                # ProcControl
    t0: float                   # the parent's CLOCK_MONOTONIC run start

    def stop_requested(self) -> bool:
        return self.control.stop_requested()

    def request_stop(self) -> None:
        self.control.request_stop()

    def beat(self, slot: int, compiles: int, timer: "StepTimer", *,
             cuda: bool = False, resumed: int = 0) -> None:
        """One worker-loop heartbeat: the clock, the worker's compile count,
        its ``timer`` (work so far, the host seconds of the steps that did
        it, of the first of them, of its evals and of its warm-up), and this
        process's kernel launches, all of them and the warm-up's apart (the
        counters of ``kernels/*/ops.py`` are per process, so the parent
        reads them here)."""
        launches = launch_counts()
        self.control.write(slot, (
            time.monotonic(), compiles, timer.work, timer.work_s,
            timer.first_s, timer.eval_s, timer.warmup_s, float(cuda),
            resumed, *(launches[k] for k in LAUNCH_COUNTERS),
            *(timer.warmup.get(k, 0) for k in LAUNCH_COUNTERS)))

    def read_heartbeat(self, slot: int):
        """(last_beat_monotonic, compile_count) for one slot; (0.0, 0.0)
        until the child's first beat."""
        hb = self.control.read(slot)
        return hb["beat"], hb["compiles"]

    def close(self) -> None:
        """Drop this process's handles (the creator's also remove their
        files)."""
        for res in (self.model_server, self.policy_server, self.data,
                    self.control, self.trace):
            res.close()


class StepTimer:
    """A child's step telemetry: the work done, the host seconds of the
    steps that did it, of the first of them and of the evals, and the
    seconds and kernel launches of a warm-up run before the first step."""

    def __init__(self):
        self.work, self.work_s, self.first_s, self.eval_s = 0, 0.0, 0.0, 0.0
        self.warmup_s, self.warmup = 0.0, {}

    def add(self, seconds: float, work: int = 1) -> None:
        if not self.work:
            self.first_s = seconds
        self.work += work
        self.work_s += seconds


def snapshot_template(spec: ProcSpec):
    """The tree a procs snapshot holds, built on the CPU from the configs:
    the ensemble, the policy and both versions."""
    gen = torch.Generator().manual_seed(0)
    return {"model": DYN.init_ensemble(spec.ens_cfg, gen),
            "model_version": np.int64(0),
            "policy": PI.init_policy(spec.pol_cfg, gen),
            "policy_version": np.int64(0)}


def _load_snapshot(resume_dir, spec: ProcSpec):
    """The latest COMPLETE parent snapshot as (tree of CPU tensors, step),
    or (None, None). ``restore`` skips torn snapshots, and if nothing under
    the directory loads, a restarting worker starts fresh instead of
    crash-looping on a poisoned checkpoint."""
    if resume_dir is None or ckpt_io.latest_step(resume_dir) is None:
        return None, None
    try:
        return ckpt_io.restore(resume_dir, snapshot_template(spec))
    except (OSError, ValueError):
        return None, None


def _proc_collector(spec: ProcSpec, ch: ProcChannels, seed: int,
                    collector_id: int, device) -> None:
    rc = spec.run_cfg
    sched = spec.exploration or ExplorationSchedule()
    slot = heartbeat_slot(f"collector:{collector_id}", rc.n_collectors)
    w = DataCollectionWorker(spec.env, ch.policy_server, ch.data, None, seed,
                             speed=rc.collect_speed,
                             collector_id=collector_id,
                             noise_scale=sched.scale_for(collector_id),
                             envs_per_step=rc.envs_per_collector,
                             device=device)

    timer = StepTimer()

    def beat():
        ch.beat(slot, w.compile_count(), timer, cuda=device.type == "cuda")
    # warmup: claim no slot until a policy exists, so a claimed ticket is
    # always fulfilled by the very next step
    while not ch.stop_requested() and not w.poll_policy():
        beat()
        time.sleep(0.005)
    # the tickets live in the shared spool's counters, so a restarted
    # collector resumes the GLOBAL count (the parent refunds the tickets
    # of a crash-interrupted batch)
    while not ch.stop_requested():
        beat()
        g = ch.data.try_claim(collector_id, k=w.envs_per_step)
        if not g:
            break                   # the target is fully claimed: done
        t_step = time.monotonic()
        dur = w.step(g)
        timer.add(time.monotonic() - t_step, g)
        if rc.pace_collection and dur is not None:
            # the robots' control rate: a batch occupies `dur` seconds of
            # wall time however fast the simulation runs
            time.sleep(max(dur - (time.monotonic() - t_step), 0.0))
    beat()


def _proc_model(spec: ProcSpec, ch: ProcChannels, seed: int, resume_dir,
                device) -> None:
    rc = spec.run_cfg
    w = ModelLearningWorker(spec.ens_cfg, ch.data, ch.model_server, seed,
                            ema_weight=rc.ema_weight,
                            early_stop=rc.early_stop,
                            min_trajs=rc.min_warmup_trajs,
                            burst=default_burst(rc.n_collectors,
                                                rc.envs_per_collector),
                            device=device)
    snap, step = _load_snapshot(resume_dir, spec)
    resumed = 0
    if snap is not None:
        # crash restart: resume from the parent's latest snapshot and
        # republish at once, so the policy worker sees a version NEWER
        # than at the crash (the optimizer state restarts fresh; the ring
        # refills from the spool)
        w.params = tree_to(snap["model"], device)
        ch.model_server.push(w.params)
        resumed = step + 1
    slot = heartbeat_slot("model", rc.n_collectors)
    timer = StepTimer()

    def beat():
        ch.beat(slot, w.compile_count(), timer, cuda=device.type == "cuda",
                resumed=resumed)
    while not ch.stop_requested():
        beat()
        t = time.monotonic()
        if w.step() is None:
            time.sleep(0.002)
        else:
            timer.add(time.monotonic() - t)
    beat()


def _warm_up_improve(algo, state, spec: ProcSpec, device,
                     timer: StepTimer) -> None:
    """One ``improve`` on a random ensemble, its result dropped: a fresh
    process pays its first step's one-time costs here (``torch.func``'s
    lazy imports; on the card, the first use of each kernel), while the
    collectors gather the model's first trajectories. Its own generators
    leave the worker's stream untouched; its seconds and launches go to
    ``timer``, apart from the steps'."""
    t, before = time.monotonic(), launch_counts()
    model = tree_to(DYN.init_ensemble(spec.ens_cfg,
                                      torch.Generator().manual_seed(0)),
                    device)
    algo.improve(state, model,
                 generator=torch.Generator(device).manual_seed(0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timer.warmup_s = time.monotonic() - t
    timer.warmup = {k: n - before[k] for k, n in launch_counts().items()}


def _proc_policy(spec: ProcSpec, ch: ProcChannels, seed: int,
                 eval_seed: int, resume_dir, device) -> None:
    from repro_torch.core.runtime import _Recorder
    from repro_torch.mbrl.algos import make_algo
    rc = spec.run_cfg
    algo = make_algo(spec.algo_cfg, spec.pol_cfg, spec.env.reward,
                     spec.env.reset_batch)
    # push_init=False: on a crash restart the snapshot's policy is
    # published FIRST, so collectors never fall back to a fresh init
    w = PolicyImprovementWorker(algo, ch.policy_server, ch.model_server,
                                seed, push_init=False, device=device)
    snap, step = _load_snapshot(resume_dir, spec)
    resumed = 0
    if snap is not None:
        w.state = {**w.state, "policy": tree_to(snap["policy"], device)}
        resumed = step + 1
    w.policy_server.push(w.state["policy"])
    timer = StepTimer()
    _warm_up_improve(algo, w.state, spec, device, timer)
    rec = _Recorder(spec.env, rc.eval_rollouts)
    gen = torch.Generator(device).manual_seed(eval_seed)

    slot = heartbeat_slot("policy", rc.n_collectors)

    def record():
        t = time.monotonic()
        rec.record(t - ch.t0, ch.data.total_pushed, w.state["policy"], gen)
        ch.trace.send(dict(rec.trace[-1]))     # plain floats and ints
        timer.eval_s += time.monotonic() - t

    def beat():
        ch.beat(slot, w.compile_count(), timer, cuda=device.type == "cuda",
                resumed=resumed)
    while not ch.stop_requested():
        beat()
        t = time.monotonic()
        if w.step():
            timer.add(time.monotonic() - t)
            if timer.work % rc.eval_every_policy_steps == 0:
                record()
        else:
            time.sleep(0.002)
    record()                        # final eval at shutdown
    beat()


def proc_worker_main(role: str, spec: ProcSpec, ch: ProcChannels,
                     resume_dir: Optional[str] = None) -> None:
    """The child's entry point (spawn context). The child runs on
    ``spec.device`` and raises when that is the card and none is present;
    on the card it loads the kernels the parent built (no ``nvcc`` here).
    Fleet collectors are addressed ``"collector:<id>"``; the id picks the
    collector's stream and exploration rung."""
    from repro_torch.core.runtime import run_seeds
    try:
        device = resolve_device(spec.device)
        if device.type == "cpu":
            torch.set_num_threads(int(spec.cpu_threads))
        sc, sm, sp, se = run_seeds(spec.seed)
        if role == "collector" or role.startswith("collector:"):
            cid = int(role.split(":", 1)[1]) if ":" in role else 0
            _proc_collector(spec, ch, sc, cid, device)
        elif role == "model":
            _proc_model(spec, ch, sm, resume_dir, device)
        elif role == "policy":
            _proc_policy(spec, ch, sp, se, resume_dir, device)
        else:
            raise ValueError(f"unknown role {role!r}")
    except KeyboardInterrupt:
        pass
    finally:
        ch.close()
