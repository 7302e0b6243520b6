"""Model-based 'policy improvement steps' (Alg. 3, the Step op): the port of
``repro/mbrl/algos.py``.

Each algorithm exposes::

  init(generator=None, *, policy=None)           -> algo_state
  draw(model_params, generator)                  -> draws
  improve(algo_state, model_params, draws=None, *, generator=None)
                                                 -> (algo_state, info)

where ``improve`` is the MINIMAL unit of work the paper assigns to the
policy-improvement worker: sample a batch of imaginary trajectories from
the current dynamics model and take ONE policy-gradient step.

* ME-TRPO  [10]: imagined rollouts from the ensemble -> TRPO step.
* ME-PPO   [paper §5.1]: same, PPO clipped step.
* MB-MPO   [4]: per-model inner VPG adaptation, outer Adam step on the
  post-adaptation surrogate (meta-policy optimization).

Randomness is injected. ``draws`` holds what the reference draws inside
its jitted ``improve`` from the key it is given: for ME-*, the start states
``s0`` (B, obs), the member assignments ``members`` (H, B) and the policy
noise ``eps`` (H, B, act); for MB-MPO, one ``{"inner": ..., "outer": ...}``
pair of those per ensemble member. Without ``draws``, ``improve`` draws
them from ``generator`` (``draw``). ``init_state_fn(generator, n)`` makes
start states, as the reference's ``init_state_fn(key, n)`` does.

Role meshes (core/roles.py): ``configure_mesh(mesh, batch_axis)`` (the
reference's ``_MeshMixin``) shards ME-TRPO's and ME-PPO's imagination over
the policy sub-mesh: each shard rolls its block of the imagined starts on
its own device, and the flat batch is joined on the sub-mesh's first
device for the TRPO or PPO statistics. MB-MPO's meta-step runs replicated,
as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.mbrl import dynamics as DYN
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl import ppo as PPO
from repro_torch.mbrl import trpo as TRPO
from repro_torch.optim.optimizers import adam, apply_updates
from repro_torch.utils.shape_stats import ShapeCounted
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AlgoConfig:
    algo: str = "me-trpo"           # me-trpo | me-ppo | mb-mpo
    imagine_batch: int = 64         # parallel imagined starts
    imagine_horizon: int = 50
    gamma: float = 0.99
    max_kl: float = 0.01
    ppo_lr: float = 3e-4
    inner_lr: float = 0.05          # MB-MPO inner adaptation step size
    n_models: int = 5


def _rollout_with_logp(model_params, pol_params, s0, H, reward_fn,
                       predict_fn=None, *, eps, members=None, fused=True,
                       generator=None):
    """Imagined rollout recording pre-tanh actions for exact densities.
    Returns ``(obs, pre, rew)`` of (H, B, ·); ``eps`` (H, B, act) is the
    horizon's policy noise.

    ``predict_fn=None`` is the ensemble fast path: one fused
    ``DYN.step_fused`` dispatch per step on the horizon's pre-drawn member
    assignments ``members`` (H, B). ``fused=False`` keeps the legacy
    two-call step (``PI.sample_with_logp`` + ``DYN.predict_assigned``). A
    non-None ``predict_fn(params, obs, act, generator)`` swaps in any other
    world model; it makes its own draws from ``generator``."""
    plan = None
    if predict_fn is None and fused:
        plan = DYN.horizon_plan(model_params, members)
    s = s0
    obs, pre, rew = [], [], []
    for h in range(int(H)):
        if predict_fn is None and fused:
            step_plan = None if plan is None else (plan[0][h], plan[1][h])
            s2, a, p = DYN.step_fused(model_params, pol_params, s, eps[h],
                                      members[h], plan=step_plan)
        else:
            a, p, _lp = PI.sample_with_logp(pol_params, s, eps[h])
            if predict_fn is None:
                s2 = DYN.predict_assigned(model_params, s, a, members[h])
            else:
                s2 = predict_fn(model_params, s, a, generator)
        obs.append(s)
        pre.append(p)
        rew.append(reward_fn(s, a, s2))
        s = s2
    return torch.stack(obs), torch.stack(pre), torch.stack(rew)


def _flat_batch(obs, pre, rew, gamma):
    rtg, adv = TRPO.compute_advantages(rew, gamma=gamma)

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return {"obs": flat(obs), "act_pre": flat(pre), "adv": adv.reshape(-1)}


class _MeshMixin:
    """Shared role-mesh hook: ``configure_mesh`` shards imagined-rollout
    batches over the policy sub-mesh's batch axis. The state stays on the
    sub-mesh's first device, where the worker places it
    (core/workers.py). Without a mesh nothing is sharded."""

    _batch_sharding = None

    def configure_mesh(self, mesh, batch_axis: str | None = None) -> None:
        from repro_torch.core.roles import batch_sharded
        self._batch_sharding = batch_sharded(mesh, batch_axis)
        # count the shapes afresh from the mesh on
        self._improve = ShapeCounted(self._improve_impl)


class _Algo(_MeshMixin):
    """What ME-* and MB-MPO share: the draws and the shape-counted step."""

    def __init__(self, cfg: AlgoConfig, pol_cfg: PI.PolicyConfig, reward_fn,
                 init_state_fn, *, predict_fn=None, mesh=None,
                 batch_axis=None):
        self.cfg = cfg
        self.pol_cfg = pol_cfg
        self.reward_fn = reward_fn
        self.init_state_fn = init_state_fn  # generator, n -> (n, obs_dim)
        self.predict_fn = predict_fn        # None = ensemble fast path;
        #                                     swap in a world model here
        self._improve = ShapeCounted(self._improve_impl)
        if mesh is not None:
            self.configure_mesh(mesh, batch_axis)

    def _rollout_draws(self, params, generator):
        cfg = self.cfg
        shape = (cfg.imagine_horizon, cfg.imagine_batch,
                 self.pol_cfg.act_dim)
        d = {"s0": self.init_state_fn(generator, cfg.imagine_batch)}
        if self.predict_fn is None:
            d["members"], d["eps"] = DYN.rollout_draws(params, *shape,
                                                       generator)
        else:
            d["eps"] = DYN.hoisted_noise(*shape, generator)
        return d

    def _rollout(self, model_params, pol, d, generator, *, shard=False,
                 fused=True):
        """The imagined rollout of draws ``d`` (``fused=False``: the legacy
        two-call step, ``_rollout_with_logp``). With ``shard`` and a mesh
        configured (the ensemble fast path), each shard rolls its block of
        the starts on its device and the blocks are joined on the policy's
        device; a swapped-in world model draws from ``generator`` and so
        rolls on one device."""
        if not (shard and self._batch_sharding is not None
                and self.predict_fn is None):
            return _rollout_with_logp(
                model_params, pol, d["s0"], self.cfg.imagine_horizon,
                self.reward_fn, self.predict_fn, eps=d["eps"],
                members=d.get("members"), fused=fused, generator=generator)
        from repro_torch.core.roles import replicas, shard_slices
        home = d["s0"].device
        slices = shard_slices(self._batch_sharding, d["s0"].shape[0])
        devs = [dev for dev, _, _ in slices]
        models, pols = replicas(model_params, devs), replicas(pol, devs)
        parts = [_rollout_with_logp(
            models[dev], pols[dev], d["s0"][lo:hi].to(dev),
            self.cfg.imagine_horizon, self.reward_fn, None,
            eps=d["eps"][:, lo:hi].to(dev),
            members=d["members"][:, lo:hi].to(dev), fused=fused)
            for dev, lo, hi in slices]
        return tuple(torch.cat([p[i].to(home) for p in parts], dim=1)
                     for i in range(3))

    def improve(self, state, model_params, draws=None, *, generator=None):
        """One policy-improvement step on ``draws``, or on draws made from
        ``generator``. Counts the distinct input shapes it sees
        (``shape_count``: 1 in steady state)."""
        if draws is None:
            if generator is None:
                raise ValueError("improve needs draws, or a torch.Generator "
                                 "to make them")
            draws = self.draw(model_params, generator)
        return self._improve(state, model_params, draws, generator)

    def shape_count(self) -> int:
        return self._improve.shape_count


class MEAlgo(_Algo):
    """ME-TRPO / ME-PPO policy improvement."""

    def __init__(self, cfg: AlgoConfig, pol_cfg: PI.PolicyConfig, reward_fn,
                 init_state_fn, *, predict_fn=None, mesh=None,
                 batch_axis=None):
        super().__init__(cfg, pol_cfg, reward_fn, init_state_fn,
                         predict_fn=predict_fn, mesh=mesh,
                         batch_axis=batch_axis)
        if cfg.algo == "me-ppo":
            self._ppo_opt, self._ppo_step = PPO.make_ppo_step(cfg.ppo_lr)

    def init(self, generator=None, *, policy=None):
        """Fresh state: a random policy from ``generator``, or ``policy``."""
        pol = PI.init_policy(self.pol_cfg, generator) if policy is None \
            else policy
        dev = tree_leaves(pol)[0].device
        state = {"policy": pol,
                 "steps": torch.zeros((), dtype=torch.int32, device=dev)}
        if self.cfg.algo == "me-ppo":
            state["opt"] = self._ppo_opt.init(pol)
        return state

    def draw(self, model_params, generator):
        return self._rollout_draws(model_params, generator)

    @torch.no_grad()
    def _improve_impl(self, state, model_params, draws, generator):
        cfg = self.cfg
        # imagination sharded over the policy sub-mesh when a mesh is
        # configured; the TRPO/PPO statistics on the joined flat batch
        obs, pre, rew = self._rollout(model_params, state["policy"], draws,
                                      generator, shard=True)
        batch = _flat_batch(obs, pre, rew, cfg.gamma)
        info = {"imagined_return": rew.sum(0).mean()}
        if cfg.algo == "me-trpo":
            new_pol, tinfo = TRPO.trpo_step(state["policy"], batch,
                                            max_kl=cfg.max_kl)
            info.update(tinfo)
            new_state = {**state, "policy": new_pol,
                         "steps": state["steps"] + 1}
        else:
            new_pol, opt, loss = self._ppo_step(
                state["policy"], state["opt"], state["policy"], batch)
            info["ppo_loss"] = loss
            new_state = {**state, "policy": new_pol, "opt": opt,
                         "steps": state["steps"] + 1}
        return new_state, info


class MBMPO(_Algo):
    """MB-MPO [4]: meta-policy optimization over the model ensemble.

    Inner loop: for each ensemble member m, adapt theta with one VPG step
    on imagined data from member m. Outer loop: Adam step on the
    post-adaptation surrogate averaged over members.

    The reference ``vmap``s the members; a ctypes kernel launch cannot be
    batched that way, so the port loops over them, each a K = 1 slice of
    the stacked ensemble (``_member_params``). The inner gradient is taken
    with ``create_graph=True`` and the outer gradient differentiates through
    it: second order through every fused step (``kernels/imag``'s
    ``FusedStep`` on the card).

    On a role mesh the whole meta-step runs on the policy sub-mesh's first
    device, replicated as in the reference: ``_vpg_loss`` never shards."""

    def __init__(self, cfg: AlgoConfig, pol_cfg: PI.PolicyConfig, reward_fn,
                 init_state_fn, *, predict_fn=None, mesh=None,
                 batch_axis=None):
        super().__init__(cfg, pol_cfg, reward_fn, init_state_fn,
                         predict_fn=predict_fn, mesh=mesh,
                         batch_axis=batch_axis)
        self._outer_opt = adam(cfg.ppo_lr)

    def init(self, generator=None, *, policy=None):
        pol = PI.init_policy(self.pol_cfg, generator) if policy is None \
            else policy
        dev = tree_leaves(pol)[0].device
        return {"policy": pol, "opt": self._outer_opt.init(pol),
                "steps": torch.zeros((), dtype=torch.int32, device=dev)}

    def _member_params(self, model_params, m: int):
        if "members" not in model_params:
            # non-ensemble world model (predict_fn swap): every inner
            # loop adapts against the same model
            return model_params
        members = tree_map(lambda x: x[m:m + 1], model_params["members"])
        return {"members": members, "norm": model_params["norm"]}

    def draw(self, model_params, generator):
        """Per member, the inner and then the outer rollout's draws."""
        return [{"inner": self._rollout_draws(member, generator),
                 "outer": self._rollout_draws(member, generator)}
                for member in (self._member_params(model_params, m)
                               for m in range(self.cfg.n_models))]

    def _vpg_loss(self, pol, member, d, generator):
        obs, pre, rew = self._rollout(member, pol, d, generator)
        batch = _flat_batch(obs, pre, rew, self.cfg.gamma)
        lp = PI.log_prob(pol, batch["obs"], batch["act_pre"])
        return -(lp * batch["adv"]).mean(), rew.sum(0).mean()

    def _improve_impl(self, state, model_params, draws, generator):
        cfg = self.cfg
        pol = state["policy"]
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(pol)]
        losses, rets = [], []
        with torch.enable_grad():
            theta = tree_unflatten(pol, leaves)
            for m in range(cfg.n_models):
                member = self._member_params(model_params, m)
                l_in, _ = self._vpg_loss(theta, member, draws[m]["inner"],
                                         generator)
                g = torch.autograd.grad(l_in, leaves, create_graph=True)
                adapted = tree_unflatten(pol, [p - cfg.inner_lr * gg
                                               for p, gg in zip(leaves, g)])
                l_out, ret = self._vpg_loss(adapted, member,
                                            draws[m]["outer"], generator)
                losses.append(l_out)
                rets.append(ret.detach())
            loss = torch.stack(losses).mean()
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            upd, opt = self._outer_opt.update(tree_unflatten(pol, grads),
                                              state["opt"], pol)
            new_pol = apply_updates(pol, upd)
        info = {"meta_loss": loss.detach(),
                "imagined_return": torch.stack(rets).mean()}
        return ({"policy": new_pol, "opt": opt,
                 "steps": state["steps"] + 1}, info)


def make_algo(cfg: AlgoConfig, pol_cfg: PI.PolicyConfig, reward_fn,
              init_state_fn, *, predict_fn=None, mesh=None,
              batch_axis=None):
    """``predict_fn=None`` -> ensemble sample-then-compute fast path (the
    fused step: the kernel on the card, the plain version on the CPU); any
    ``(params, obs, act, generator)`` callable swaps the world model for
    every algorithm (ME-* and MB-MPO alike). ``mesh``: the policy role
    sub-mesh to shard imagination over — usually left None and configured
    by the engine through ``algo.configure_mesh``."""
    if cfg.algo in ("me-trpo", "me-ppo"):
        return MEAlgo(cfg, pol_cfg, reward_fn, init_state_fn,
                      predict_fn=predict_fn, mesh=mesh,
                      batch_axis=batch_axis)
    if cfg.algo == "mb-mpo":
        return MBMPO(cfg, pol_cfg, reward_fn, init_state_fn,
                     predict_fn=predict_fn, mesh=mesh,
                     batch_axis=batch_axis)
    raise ValueError(cfg.algo)
