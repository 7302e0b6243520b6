"""Dynamics-model ensembles (the paper's p-hat_phi_1..K): the port of the
model-learning half of ``repro/mbrl/dynamics.py`` and of its assigned
predictor.

An ensemble of K MLPs trained on (s, a) -> delta-s with input/output
normalisation; sampling uses a uniform prior over ensemble members
(Section 3 of the paper). Params are the reference's tree,
``{"members": {"w": [(K, a, b) ...], "b": [(K, b) ...]}, "norm": {...}}``.

Training evaluates every member on every row (``ensemble_mlp``: the
``gmm_equal`` kernel on the card, forward and backward). ``predict_assigned``
evaluates one member per row (``ensemble_mlp_select``: the ``gmm_ragged``
kernel). Imagination runs one fused step per horizon step (``step_fused``:
the ``imag_fused`` kernel on the card, policy head and assigned member in
one launch). Draws are injected: member indices by ``sample_members`` and
policy noise by ``hoisted_noise`` from an explicit generator, or passed in;
the ring trainer's minibatch index grid by the caller
(``ModelLearningWorker`` draws it, or replays one), and the legacy trainer's
epoch permutation likewise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.imag import ops as imag_ops
from repro_torch.mbrl import policy as PI
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.utils.shape_stats import ShapeCounted
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    obs_dim: int
    act_dim: int
    hidden: int = 256
    depth: int = 2
    n_models: int = 5
    lr: float = 1e-3
    train_batch: int = 256
    holdout_frac: float = 0.2


def _dims(cfg: EnsembleConfig):
    return [cfg.obs_dim + cfg.act_dim] + [cfg.hidden] * cfg.depth \
        + [cfg.obs_dim]


def init_member(cfg: EnsembleConfig, generator: torch.Generator):
    """One member on the generator's device: normal weights scaled by
    fan_in ** -0.5, zero biases, as the reference draws them."""
    dims, dev = _dims(cfg), generator.device
    return {
        "w": [torch.randn((a, b), generator=generator, device=dev)
              * (a ** -0.5) for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.zeros((b,), device=dev) for b in dims[1:]],
    }


def init_ensemble(cfg: EnsembleConfig, generator: torch.Generator):
    members = [init_member(cfg, generator) for _ in range(cfg.n_models)]
    dev = generator.device
    din = cfg.obs_dim + cfg.act_dim
    norm = {"mu_in": torch.zeros(din, device=dev),
            "sig_in": torch.ones(din, device=dev),
            "mu_out": torch.zeros(cfg.obs_dim, device=dev),
            "sig_out": torch.ones(cfg.obs_dim, device=dev)}
    return {"members": {
        "w": [torch.stack([m["w"][i] for m in members])
              for i in range(len(members[0]["w"]))],
        "b": [torch.stack([m["b"][i] for m in members])
              for i in range(len(members[0]["b"]))]},
        "norm": norm}


def update_normalizer(state, obs, act, next_obs):
    return {**state,
            "norm": masked_norm_stats(obs, act, next_obs, obs.shape[0])}


def member_forward(member, xn):
    h = xn
    n = len(member["w"])
    for i, (w, b) in enumerate(zip(member["w"], member["b"])):
        h = h @ w + b
        if i < n - 1:
            h = torch.tanh(h)
    return h


def _normalized_input(params, obs, act):
    n = params["norm"]
    return (torch.cat([obs, act], -1) - n["mu_in"]) / n["sig_in"]


def ensemble_forward(params, obs, act):
    """Per-member predictions. obs/act: (B, ·) -> (K, B, obs_dim)."""
    n = params["norm"]
    dyn = gmm_ops.ensemble_mlp(params["members"],
                               _normalized_input(params, obs, act))
    return obs[None] + dyn * n["sig_out"] + n["mu_out"]


def n_members(params) -> int:
    return params["members"]["w"][0].shape[0]


def sample_members(params, shape, generator: torch.Generator):
    """Uniform prior over ensemble members (Sec. 3): I ~ U[K], iid per
    element of ``shape``, on the generator's device."""
    return torch.randint(0, n_members(params), tuple(shape),
                         generator=generator, device=generator.device)


def predict_assigned(params, obs, act, member_idx):
    """Next-state prediction with rows pre-assigned to members.

    member_idx: (B,) int in [0, K). Row b is evaluated by member
    ``member_idx[b]`` ONLY — via the sort / ragged-grouped-matmul /
    unsort path (``ensemble_mlp_select``), so a batch costs B rows of
    FLOPs, not K*B. Identical output to ``predict`` under the same
    assignment."""
    n = params["norm"]
    dyn = gmm_ops.ensemble_mlp_select(
        params["members"], _normalized_input(params, obs, act), member_idx)
    return obs + dyn * n["sig_out"] + n["mu_out"]


def predict(params, obs, act, member_idx):
    """Uniform-prior ensemble sample, the legacy compute-all-then-select
    path: it PAYS for all K members. ``member_idx`` (B,) is the draw the
    reference makes inside (``sample_members(params, (B,), generator)``)."""
    preds = ensemble_forward(params, obs, act)           # (K, B, D)
    return torch.take_along_dim(preds, member_idx[None, :, None].long(),
                                dim=0)[0]


def _row_losses(params, obs, act, next_obs):
    """Each row's squared error, averaged over members and outputs:
    (B,)."""
    n = params["norm"]
    target = (next_obs - obs - n["mu_out"]) / n["sig_out"]
    pred = gmm_ops.ensemble_mlp(params["members"],
                                _normalized_input(params, obs, act))
    return torch.mean((pred - target[None]) ** 2, dim=(0, 2))


def masked_mse_loss(params, obs, act, next_obs, weights):
    """MSE over rows where ``weights`` is 1 — used against full-capacity
    ring storage, where rows past the valid count are garbage."""
    per_row = _row_losses(params, obs, act, next_obs)
    w = weights.to(per_row.dtype)
    return torch.sum(per_row * w) / torch.clamp(torch.sum(w), min=1.0)


def _rows_loss(params, obs, act, next_obs, denom: int):
    """One shard's part of a minibatch's MSE: its rows' summed losses over
    the whole minibatch's row count."""
    return _row_losses(params, obs, act, next_obs).sum() / denom


def mse_loss(params, obs, act, next_obs):
    return masked_mse_loss(params, obs, act, next_obs,
                           torch.ones(obs.shape[0], dtype=obs.dtype,
                                      device=obs.device))


def value_and_grad(fn, params, *args):
    """(fn(params, *args), d fn / d params) for a scalar ``fn``, with the
    gradient as a tree shaped like ``params`` — every leaf differentiated,
    as ``jax.value_and_grad`` does (the normaliser's leaves included)."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        value = fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(value, leaves)
    return value.detach(), tree_unflatten(params, grads)


def _sgd_epoch(opt, params, opt_state, obs, act, next_obs, batches,
               n_active: Optional[int] = None):
    """Minibatch SGD over the first ``n_active`` rows of a precomputed
    (nb, bs) index grid (all of them when ``n_active`` is None).

    The reference scans the whole grid and skips rows past a traced
    ``n_active`` with ``lax.cond``; here ``n_active`` is a host int, so
    the loop stops there. The summed loss is divided by ``n_active``
    (the mean over the grid without a count), the same math."""
    nb = batches.shape[0]
    steps = nb if n_active is None else n_active
    total = torch.zeros((), dtype=obs.dtype, device=obs.device)
    for i in range(steps):
        idx = batches[i]
        loss, g = value_and_grad(mse_loss, params, obs[idx], act[idx],
                                 next_obs[idx])
        with torch.no_grad():
            upd, opt_state = opt.update(g, opt_state, params)
            params = apply_updates(params, upd)
        total = total + loss
    return params, opt_state, total / max(steps, 1)


def make_model_trainer(cfg: EnsembleConfig):
    """Legacy dynamic-shape trainer (its shapes follow the data; prefer
    :func:`make_ring_trainer` on the hot path). Returns ``(opt,
    train_epoch, val_loss)``:

    * ``train_epoch(params, opt_state, obs, act, next_obs, perm=None, *,
      generator=None)`` — one epoch of Adam over ``nb = max(n // bs, 1)``
      minibatches of ``bs = min(cfg.train_batch, n)`` rows, taken from the
      first ``nb * bs`` entries of the permutation ``perm`` of
      ``range(n)``: the reference's ``jax.random.permutation(key, n)``, to
      inject, or drawn from ``generator``. Returns ``(params, opt_state,
      mean loss)``.
    * ``val_loss(params, obs, act, next_obs)`` — MSE over every row.
    """
    opt = adam(cfg.lr)

    def train_epoch(params, opt_state, obs, act, next_obs, perm=None, *,
                    generator: Optional[torch.Generator] = None):
        n = obs.shape[0]
        bs = min(cfg.train_batch, n)
        nb = max(n // bs, 1)
        if perm is None:
            if generator is None:
                raise ValueError("train_epoch needs the permutation perm, "
                                 "or a torch.Generator to draw it")
            perm = torch.randperm(n, generator=generator,
                                  device=generator.device)
        batches = perm.to(obs.device)[:nb * bs].reshape(nb, bs)
        return _sgd_epoch(opt, params, opt_state, obs, act, next_obs,
                          batches)

    @torch.no_grad()
    def val_loss(params, obs, act, next_obs):
        return mse_loss(params, obs, act, next_obs)

    return opt, train_epoch, val_loss


def masked_norm_stats(obs, act, next_obs, size: int):
    """Normalizer stats against ring storage: moments over the first
    ``size`` valid rows, by mask, so shapes stay those of the ring.
    Returns only the ``norm`` dict."""
    w = (torch.arange(obs.shape[0], device=obs.device) < size).to(obs.dtype)
    tot = torch.clamp(w.sum(), min=1.0)

    def moments(v):
        mu = (v * w[:, None]).sum(0) / tot
        var = (((v - mu) ** 2) * w[:, None]).sum(0) / tot
        return mu, torch.sqrt(var) + 1e-4

    x = torch.cat([obs, act], -1)
    dy = next_obs - obs
    mu_in, sig_in = moments(x)
    mu_out, sig_out = moments(dy)
    return {"mu_in": mu_in, "sig_in": sig_in,
            "mu_out": mu_out, "sig_out": sig_out}


def ring_grid(cfg: EnsembleConfig, capacity: int, *,
              epoch_batches: Optional[int] = None,
              max_epoch_batches: int = 64) -> Tuple[int, int]:
    """The ring trainer's static minibatch grid ``(nb, bs)``."""
    bs = min(cfg.train_batch, max(int(capacity), 1))
    nb = epoch_batches if epoch_batches is not None else \
        min(max(int(capacity) // bs, 1), max_epoch_batches)
    return nb, bs


def _gather_grid(data, idx, devices):
    """The minibatches of the (nb, bs) index grid ``idx`` gathered from
    row-sharded ring storage (a dict of ``RowShards``), batch-sharded over
    ``devices``: shard j gets ``split_bounds``' block j of every minibatch's
    rows, ``{key: (nb, c_j, ...)}`` on its device, or None for an empty
    block. Every source block is read at the clamped local rows and only
    the rows it owns are kept, so the gather has the grid's shape whatever
    rows it draws; no shape depends on the data and nothing waits on the
    device."""
    from repro_torch.core.roles import split_bounds
    first = next(iter(data.values()))
    per, srcs = first.rows_per_shard, first.devices
    on_src = {d: idx.to(d) for d in dict.fromkeys(srcs)}
    out = []
    for dev, (lo, hi) in zip(devices, split_bounds(idx.shape[1],
                                                   len(devices))):
        if hi == lo:
            out.append(None)
            continue
        owner = idx[:, lo:hi].to(dev) // per
        mb = {}
        for k, rows in data.items():
            got = None
            for s, sdev in enumerate(srcs):
                local = (on_src[sdev][:, lo:hi] - s * per).clamp(0, per - 1)
                vals = rows.shards[s].index_select(0, local.reshape(-1))
                vals = vals.reshape(local.shape + vals.shape[1:]).to(dev)
                if got is None:
                    got = vals
                else:
                    mask = (owner == s).reshape(owner.shape + (1,) * (
                        vals.dim() - 2))
                    got = torch.where(mask, vals, got)
            mb[k] = got
        out.append(mb)
    return out


def _sgd_epoch_sharded(opt, params, opt_state, data, batches, n_active: int,
                       devices):
    """``_sgd_epoch`` data-parallel over ``devices``: every minibatch's
    rows split into one block a shard, each shard's loss and gradients of
    its block (its rows' summed losses over the minibatch's row count) on
    its device against its replica of the parameters, the gradients
    summed on the home device in shard order, ONE update, and the new
    parameters placed back on every shard. The same math as one device."""
    from repro_torch.core.roles import replicas
    home = tree_leaves(params)[0].device
    bs = batches.shape[1]
    mbs = _gather_grid(data, batches, devices)
    total = torch.zeros((), dtype=torch.float32, device=home)
    for i in range(n_active):
        reps = replicas(params, devices)
        loss = grads = None
        for dev, mb in zip(devices, mbs):
            if mb is None:
                continue
            lj, gj = value_and_grad(_rows_loss, reps[dev], mb["obs"][i],
                                    mb["act"][i], mb["next_obs"][i], bs)
            lj, gj = lj.to(home), tree_map(lambda g: g.to(home), gj)
            if grads is None:
                loss, grads = lj, gj
            else:
                loss = loss + lj
                grads = tree_map(torch.add, grads, gj)
        with torch.no_grad():
            upd, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, upd)
        total = total + loss
    return params, opt_state, total / max(n_active, 1)


def _val_loss_sharded(params, data, size: int):
    """``masked_mse_loss`` over row-sharded storage: each shard's masked
    sum on its device, the sums and weights added on the home device in
    shard order."""
    from repro_torch.core.roles import replicas
    home = tree_leaves(params)[0].device
    obs = data["obs"]
    per = obs.rows_per_shard
    reps = replicas(params, obs.devices)
    num = torch.zeros((), dtype=obs.dtype, device=home)
    den = torch.zeros((), dtype=obs.dtype, device=home)
    for j, dev in enumerate(obs.devices):
        w = ((torch.arange(per, device=dev) + j * per) < size).to(obs.dtype)
        per_row = _row_losses(reps[dev], obs.shards[j],
                              data["act"].shards[j],
                              data["next_obs"].shards[j])
        num = num + (per_row * w).sum().to(home)
        den = den + w.sum().to(home)
    return num / torch.clamp(den, min=1.0)


def _norm_stats_sharded(data, size: int):
    """``masked_norm_stats`` over row-sharded storage: each moment's
    masked sums per shard, added on the first shard's device in shard
    order."""
    obs = data["obs"]
    per, devs = obs.rows_per_shard, obs.devices
    home = devs[0]
    parts = []
    for j, dev in enumerate(devs):
        w = ((torch.arange(per, device=dev) + j * per) < size).to(obs.dtype)
        o = obs.shards[j]
        parts.append((w, torch.cat([o, data["act"].shards[j]], -1),
                      data["next_obs"].shards[j] - o))
    tot = torch.clamp(sum(w.sum().to(home) for w, _, _ in parts), min=1.0)

    def moments(which):
        mu = sum((p[which] * p[0][:, None]).sum(0).to(home)
                 for p in parts) / tot
        var = sum((((p[which] - mu.to(p[which].device)) ** 2)
                   * p[0][:, None]).sum(0).to(home) for p in parts) / tot
        return mu, torch.sqrt(var) + 1e-4
    mu_in, sig_in = moments(1)
    mu_out, sig_out = moments(2)
    return {"mu_in": mu_in, "sig_in": sig_in,
            "mu_out": mu_out, "sig_out": sig_out}


def make_ring_trainer(cfg: EnsembleConfig, capacity: int,
                      *, epoch_batches: Optional[int] = None,
                      max_epoch_batches: int = 64, batch_sharding=None):
    """Trainer over fixed-capacity ring storage. Returns
    ``(opt, train_epoch, val_loss, update_norm)``:

    * ``update_norm(data, size)`` — masked normalizer stats (the ``norm``
      dict only).
    * ``train_epoch(params, opt_state, data, size, idx)`` — Adam over the
      static ``(nb, bs)`` index grid ``idx`` (see :func:`ring_grid`),
      drawn by the caller uniformly with replacement from
      ``[0, max(size, 1))``, as the reference draws it inside its jit.
      Only the first ``clip(size // bs, 1, nb)`` rows of the grid apply,
      so one epoch is one pass over the CURRENT data while the shapes
      never change.
    * ``val_loss(params, data, size)`` — masked MSE over a val ring.

    ``train_epoch`` and ``val_loss`` count the distinct input shapes they
    see (``shape_count``): the eager form of the reference's "compiles
    exactly once regardless of how full the buffer is".

    ``batch_sharding`` (role meshes): a ``roles.batch_sharded`` placement
    over the owning sub-mesh. The ring storage arrives as ``RowShards``
    from a ``ReplayBuffer`` with that sharding, and the epoch runs
    data-parallel: the grid is gathered once from the row-sharded ring
    into batch-sharded minibatches at the grid's fixed shape, each shard
    takes the loss and gradients of its own block of every minibatch (the
    ``gmm_equal`` kernel on its device), the gradients are summed in shard
    order and the update applied once (``_sgd_epoch_sharded``); the
    normaliser's statistics and the validation loss reduce across shards.
    The same math as one device, and one input shape as the ring fills and
    wraps. The parameters stay on the sub-mesh's first device.
    """
    opt = adam(cfg.lr)
    nb, bs = ring_grid(cfg, capacity, epoch_batches=epoch_batches,
                       max_epoch_batches=max_epoch_batches)
    devices = None
    if batch_sharding is not None:
        from repro_torch.core.roles import shard_devices
        devices = shard_devices(batch_sharding)

    def _train_epoch(params, opt_state, data, size: int, idx):
        if tuple(idx.shape) != (nb, bs):
            raise ValueError(f"index grid {tuple(idx.shape)}, expected "
                             f"{(nb, bs)}")
        # one pass over the VALID region per epoch, not the whole grid
        n_active = min(max(int(size) // bs, 1), nb)
        if devices is not None:
            return _sgd_epoch_sharded(opt, params, opt_state, data, idx,
                                      n_active, devices)
        return _sgd_epoch(opt, params, opt_state, data["obs"], data["act"],
                          data["next_obs"], idx, n_active=n_active)

    @torch.no_grad()
    def _val_loss(params, data, size: int):
        if devices is not None:
            return _val_loss_sharded(params, data, size)
        obs = data["obs"]
        w = torch.arange(obs.shape[0], device=obs.device) < size
        return masked_mse_loss(params, obs, data["act"], data["next_obs"], w)

    @torch.no_grad()
    def _update_norm(data, size: int):
        if devices is not None:
            return _norm_stats_sharded(data, size)
        return masked_norm_stats(data["obs"], data["act"],
                                 data["next_obs"], size)

    return (opt, ShapeCounted(_train_epoch), ShapeCounted(_val_loss),
            ShapeCounted(_update_norm))


# ------------------------------------------------------------ imagination
def step_fused(params, policy_params, s, eps, member_idx, *, impl=None,
               plan=None):
    """One FUSED imagination step: policy head + reparameterised action +
    assigned-member dynamics forward as one ``kernels/imag`` dispatch (the
    kernel on the card, the plain version on the CPU).

    s: (B, obs); eps: (B, act) standard normal (pre-drawn for the whole
    horizon); member_idx: (B,) int. ``plan``: this step's slice of
    ``horizon_plan`` (kernel route). Returns ``(s2, a, pre)``."""
    return imag_ops.fused_step(params["members"], params["norm"],
                               policy_params, s, eps, member_idx, impl=impl,
                               plan=plan)


def horizon_plan(params, member_idx):
    """Sort plans for a whole horizon of member assignments ((H, B) int),
    computed once before the rollout loop, or None when the step will not
    launch the kernel (the plain version is row-order-blind)."""
    if not imag_ops.uses_kernel(member_idx):
        return None
    return imag_ops.sort_plan(member_idx, n_members(params))


def hoisted_noise(horizon: int, batch: int, act_dim: int,
                  generator: torch.Generator):
    """The whole horizon's policy noise, (H, B, act) standard normal, in one
    draw on the generator's device."""
    return torch.randn((int(horizon), int(batch), int(act_dim)),
                       generator=generator, device=generator.device)


def rollout_draws(params, horizon: int, batch: int, act_dim: int,
                  generator: torch.Generator):
    """A rollout's draws from ``generator``: member assignments (H, B), then
    policy noise (H, B, act)."""
    return (sample_members(params, (horizon, batch), generator),
            hoisted_noise(horizon, batch, act_dim, generator))


def imagine_rollout(params, policy_fn, policy_params, s0, horizon: int,
                    reward_fn, *, fused=None, members=None, eps=None,
                    generator: Optional[torch.Generator] = None):
    """Dyna imagination: roll the ensemble from s0 under the policy.

    s0: (B, obs). Returns ``{"obs", "act", "rew"}`` of (H, B, ·). The whole
    horizon's member assignments ``members`` (H, B) and policy noise ``eps``
    (H, B, act) are drawn up front (from ``generator``, members first, or
    passed in), and each step is ONE ``step_fused`` dispatch.

    ``fused=None`` takes the fused path exactly when ``policy_fn`` is
    ``PI.sample_action`` (the only policy the fused step reproduces); any
    other ``policy_fn(params, s, eps)``, or ``fused=False``, takes the legacy
    per-step path (``policy_fn`` + ``predict_assigned``)."""
    if fused is None:
        fused = policy_fn is PI.sample_action
    B = s0.shape[0]
    act_dim = policy_params["w"][-1].shape[1]
    if members is None or eps is None:
        if generator is None:
            raise ValueError("imagine_rollout needs members and eps, or a "
                             "torch.Generator to draw them")
        members, eps = rollout_draws(params, horizon, B, act_dim, generator)
    plan = horizon_plan(params, members) if fused else None
    s = s0
    obs, act, rew = [], [], []
    for h in range(int(horizon)):
        if fused:
            step_plan = None if plan is None else (plan[0][h], plan[1][h])
            s2, a, _pre = step_fused(params, policy_params, s, eps[h],
                                     members[h], plan=step_plan)
        else:
            a = policy_fn(policy_params, s, eps[h])
            s2 = predict_assigned(params, s, a, members[h])
        obs.append(s)
        act.append(a)
        rew.append(reward_fn(s, a, s2))
        s = s2
    return {"obs": torch.stack(obs), "act": torch.stack(act),
            "rew": torch.stack(rew)}
