"""The three workers of Figure 1a (Alg. 1, 2 and 3): the port of the
in-process half of ``repro/core/workers.py``.

Each worker is a pull -> step -> push loop with the minimal unit of work
(one batch of rollouts / one model epoch / one policy-improvement step),
run on one device. Parameter pulls are version-gated: an unchanged version
costs one lock + integer compare against a device-resident cache.
Randomness comes from explicit ``torch.Generator``s on the worker's device:
one per collector (``collector_generator``), one per model learner, one per
policy improver; the learner's minibatch index grid (``index_source``) and
the improver's imagination draws (``draw_source``) can be injected to
replay another run's draws.

The model learner and the policy improver keep the reference's no-retrace
invariant in eager form: ``train_epoch``, ``val_loss`` and ``improve`` each
see one input shape in steady state (``compile_count``).

Not ported yet: ``ProcSpec`` and the procs entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.servers import DataServer, ParameterServer, ReplayBuffer
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
                 *, speed: float = 1.0, collector_id: int = 0,
                 noise_scale: float = 1.0, envs_per_step: int = 1,
                 device=None):
        self.env = env
        self.policy_server = policy_server
        self.data_server = data_server
        self.collector_id = int(collector_id)
        self.noise_scale = float(noise_scale)
        self.envs_per_step = int(envs_per_step)
        if self.envs_per_step < 1:
            raise ValueError(f"envs_per_step must be >= 1, got "
                             f"{self.envs_per_step}")
        self.device = resolve_device(device)
        self._gen = collector_generator(seed, self.collector_id, self.device)
        self._policy_cache = (None if init_policy_params is None else
                              tree_to(init_policy_params, self.device))
        self._policy_ver = 0
        self._sampler = _sampler_for(self.noise_scale)
        self.speed = speed  # >1: faster collection (Fig. 5b)
        self.collected = 0

    def poll_policy(self) -> bool:
        """Refresh the policy cache (version-gated) without collecting.
        True once a policy is available."""
        fresh, self._policy_ver = self.policy_server.pull_if_newer(
            self._policy_ver)
        if fresh is not None:
            self._policy_cache = fresh
        return self._policy_cache is not None

    def step(self, n: Optional[int] = None) -> Optional[float]:
        """One batch of ``n`` trajectories (default ``envs_per_step``; the
        engines pass a partial ticket grant near the criterion). Returns
        its robot-time duration — one trajectory's, since the batch's
        robots run in parallel — or None before any policy exists."""
        if not self.poll_policy():                          # Pull (gated)
            return None
        g = self.envs_per_step if n is None else int(n)
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
    generator, the whole static grid every epoch, as the reference does."""

    def __init__(self, ens_cfg: DYN.EnsembleConfig,
                 data_server: DataServer, model_server: ParameterServer,
                 seed: int, *, params=None, max_trajs: int = 200,
                 ema_weight: float = 0.9, early_stop: bool = True,
                 min_trajs: int = 4, burst: int = 8,
                 index_source: Optional[IndexSource] = None, device=None):
        self.cfg = ens_cfg
        self.data_server = data_server
        self.model_server = model_server
        self.max_trajs = max_trajs
        self.burst = max(int(burst), 1)
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
        self.buffer = ReplayBuffer(capacity, burst_capacity=self.burst,
                                   device=self.device)
        self._grid = DYN.ring_grid(self.cfg, self.buffer.capacity)
        opt, self._train_epoch, self._val_loss, self._update_norm = \
            DYN.make_ring_trainer(self.cfg, self.buffer.capacity)
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
            vdata = {k: v[:vcap] for k, v in data.items()}
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
    worker's generator."""

    def __init__(self, algo, policy_server: ParameterServer,
                 model_server: ParameterServer, seed: int, *, policy=None,
                 draw_source: Optional[DrawSource] = None, device=None):
        self.algo = algo
        self.policy_server = policy_server
        self.model_server = model_server
        self.device = resolve_device(device)
        self._gen = torch.Generator(self.device).manual_seed(int(seed))
        self.draw_source = draw_source
        self.state = algo.init(
            self._gen, policy=None if policy is None
            else tree_to(policy, self.device))
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
            self._model_ver)                            # Pull (gated)
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
