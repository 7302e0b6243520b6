"""The MBRL modules of the PyTorch port against the JAX reference: the
optimizer, every env, the policy and the dynamics ensemble's
model-learning half, on the CPU at small sizes.

Inputs are made with numpy from a seed; params are built by the JAX
package and carried across with ``repro_torch.testing.parity``; every draw
(reset draws, policy noise, member indices, the ring trainer's index grid)
is made with ``jax.random`` exactly as the reference makes it inside and
injected into the port. Tolerances, f32 throughout:

* 1e-5 (atol and rtol) where the two compute the same function and only
  the order of f32 operations differs (envs, policy, one forward);
* 1e-5 of the value's own scale for gradients (sums over a batch);
* 1e-4 for params after a ring-trainer epoch or N Adam steps: Adam divides
  by sqrt(v), so an f32 rounding difference in a small gradient moves an
  update by up to ~1e-7 per step relative to the learning rate;
* 1e-5 relative for the epoch's loss;
* 1e-4 for a rollout: 12 steps of dynamics compound the per-step 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import arm as jarm
from repro.envs.base import lane_keys
from repro.mbrl import dynamics as JDYN
from repro.mbrl import policy as JPI
from repro.optim import optimizers as jopt
from repro_torch.envs import arm as tarm
from repro_torch.mbrl import dynamics as DYN
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl.early_stop import EMAEarlyStop
from repro_torch.optim import optimizers as topt
from repro_torch.testing.parity import tree_from_jax, tree_to_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
PARAM_TOL = dict(atol=1e-4, rtol=1e-4)
ENV_NAMES = ["pendulum", "cartpole_swingup", "spring_hopper", "reacher2",
             "pr2_reach", "pr2_shape_match", "pr2_lego_stack"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(got, want):
    """Leaf pairs in one order (jax sorts dict keys; the port keeps
    insertion order), after checking the two trees have one structure."""
    g, w = jax.tree.flatten(tree_to_numpy(got)), jax.tree.flatten(_np(want))
    assert g[1] == w[1], (g[1], w[1])
    return zip(g[0], w[0])


def _close(got, want, **tol):
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


def _close_to_scale(got, want, tol=1e-5):
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("make", ["adam", "adam_decay", "sgd",
                                  "sgd_momentum", "clipped_adam"])
def test_optimizer_steps_match_reference(make):
    builders = {
        "adam": lambda m: m.adam(1e-2),
        "adam_decay": lambda m: m.adam(1e-2, weight_decay=0.1),
        "sgd": lambda m: m.sgd(1e-2),
        "sgd_momentum": lambda m: m.sgd(1e-2, momentum=0.9),
        "clipped_adam": lambda m: m.clip_by_global_norm(m.adam(1e-2), 0.5),
    }
    rng = np.random.default_rng(0)
    params = {"w": [rng.standard_normal((4, 3)).astype(np.float32),
                    rng.standard_normal((3, 2)).astype(np.float32)],
              "log_std": np.full((2,), -0.5, np.float32)}
    jo, to = builders[make](jopt), builders[make](topt)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_from_jax(params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(6):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tree_from_jax(grads), ts, tp)
        tp = topt.apply_updates(tp, tu)
    _close(tp, jp, **PARAM_TOL)
    assert int(ts.step) == int(js.step) == 6


# ----------------------------------------------------------------- envs
def _reset_draws(env, key):
    """The draws the reference's ``reset(key)`` makes, in the layout of
    the port env ``env``'s ``reset_from``."""
    if env.name == "pendulum":
        return np.stack([np.asarray(jax.random.uniform(key, ())),
                         np.asarray(jax.random.uniform(
                             jax.random.fold_in(key, 1), ()))])
    if env.reset_dist == "uniform":
        return np.asarray(jax.random.uniform(key, env.reset_shape))
    return np.asarray(jax.random.normal(key, env.reset_shape))


@pytest.mark.parametrize("name", ENV_NAMES)
def test_env_reset_step_reward_match_reference(name):
    jenv, tenv = jarm.make_env(name), tarm.make_env(name)
    assert (tenv.obs_dim, tenv.act_dim, tenv.horizon, tenv.dt) == \
        (jenv.obs_dim, jenv.act_dim, jenv.horizon, jenv.dt)
    rng = np.random.default_rng(1)
    B = 16
    s = rng.standard_normal((B, jenv.obs_dim)).astype(np.float32)
    a = (1.5 * rng.standard_normal((B, jenv.act_dim))).astype(np.float32)
    js2, jr = jax.vmap(jenv.step)(s, a)
    ts2, tr = tenv.step(_t(s), _t(a))
    np.testing.assert_allclose(ts2.numpy(), np.asarray(js2), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    jr2 = jax.vmap(jenv.reward)(s, a, np.asarray(js2))
    np.testing.assert_allclose(tenv.reward(_t(s), _t(a), ts2).numpy(),
                               np.asarray(jr2), **TOL)
    keys = jax.random.split(jax.random.key(2), B)
    draws = np.stack([_reset_draws(tenv, k) for k in keys])
    np.testing.assert_allclose(tenv.reset_from(_t(draws)).numpy(),
                               np.asarray(jax.vmap(jenv.reset)(keys)), **TOL)
    if hasattr(jenv, "distance"):
        np.testing.assert_allclose(tenv.distance(ts2).numpy(),
                                   np.asarray(jax.vmap(jenv.distance)(js2)),
                                   **TOL)


def _jax_rollout_draws(env, key, horizon, act_dim):
    """The reset draw and the per-step policy noise that
    ``Env.rollout(key, PI.sample_action, ...)`` makes inside."""
    k0, key = jax.random.split(key)
    noise = np.stack([np.asarray(jax.random.normal(k, (act_dim,)))
                      for k in jax.random.split(key, horizon)])
    return _reset_draws(env, k0), noise


@pytest.mark.parametrize("name,lanes", [("pendulum", 1),
                                        ("pr2_lego_stack", 1),
                                        ("pr2_lego_stack", 3)])
def test_rollout_under_injected_draws_matches_reference(name, lanes):
    jenv, tenv = jarm.make_env(name), tarm.make_env(name)
    H = 12
    pcfg = JPI.PolicyConfig(jenv.obs_dim, jenv.act_dim, hidden=16)
    jp = JPI.init_policy(pcfg, jax.random.key(3))
    key = jax.random.key(4)
    if lanes == 1:
        want = jenv.rollout(key, JPI.sample_action, jp, horizon=H)
        want = jax.tree.map(lambda x: x[None], want)
    else:
        want = jenv.rollout_batch(key, JPI.sample_action, jp, lanes,
                                  horizon=H)
    draws = [_jax_rollout_draws(tenv, k, H, jenv.act_dim)
             for k in lane_keys(key, lanes)]
    reset = np.stack([d[0] for d in draws])
    noise = np.stack([d[1] for d in draws], axis=1)          # (H, n, act)
    got = tenv.rollout_batch(PI.sample_action, tree_from_jax(_np(jp)),
                             lanes, reset_draws=_t(reset), noise=_t(noise),
                             horizon=H)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    if lanes == 1:
        one = tenv.rollout(PI.sample_action, tree_from_jax(_np(jp)),
                           reset_draw=_t(reset[0]), noise=_t(noise[:, 0]),
                           horizon=H)
        for k in want:
            np.testing.assert_array_equal(one[k].numpy(), got[k][0].numpy())


def test_rollout_needs_draws_or_a_generator():
    env = tarm.make_env("pendulum")
    pp = PI.init_policy(PI.PolicyConfig(3, 1, hidden=8),
                        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        env.rollout_batch(PI.sample_action, pp, 2, horizon=3)
    gen = torch.Generator().manual_seed(1)
    a = env.rollout_batch(PI.sample_action, pp, 2, horizon=3, generator=gen)
    gen = torch.Generator().manual_seed(1)
    b = env.rollout_batch(PI.sample_action, pp, 2, horizon=3, generator=gen)
    assert a["obs"].shape == (2, 3, 3) and a["rew"].shape == (2, 3)
    for k in a:
        assert torch.equal(a[k], b[k])


# --------------------------------------------------------------- policy
def test_policy_functions_match_reference_under_injected_eps():
    cfg = JPI.PolicyConfig(23, 7, hidden=32)
    jp = JPI.init_policy(cfg, jax.random.key(5))
    jp2 = jax.tree.map(lambda x: x * 1.1 + 0.01, jp)
    tp, tp2 = tree_from_jax(_np(jp)), tree_from_jax(_np(jp2))
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((9, 23)).astype(np.float32)
    to = _t(obs)
    key = jax.random.key(7)
    eps = np.asarray(jax.random.normal(key, (9, 7)))
    te = _t(eps)
    _close(PI.mean_action(tp, to), JPI.mean_action(jp, obs))
    _close(PI.sample_from_eps(tp, to, te), JPI.sample_from_eps(jp, obs, eps))
    _close(PI.sample_action(tp, to, te), JPI.sample_action(jp, obs, key))
    _close(PI.sample_action_scaled(tp, to, 1.3, te),
           JPI.sample_action_scaled(jp, obs, key, 1.3))
    _close(PI.deterministic_action(tp, to),
           JPI.deterministic_action(jp, obs))
    pre = JPI.sample_from_eps(jp, obs, eps)[1]
    _close(PI.log_prob(tp, to, _t(pre)), JPI.log_prob(jp, obs, pre))
    _close(PI.sample_with_logp(tp, to, te),
           JPI.sample_with_logp(jp, obs, key))
    _close(PI.kl_divergence(tp, tp2, to), JPI.kl_divergence(jp, jp2, obs))
    _close(PI.entropy(tp), JPI.entropy(jp))
    with pytest.raises(ValueError, match="Generator"):
        PI.sample_action(tp, to)
    gen = torch.Generator().manual_seed(0)
    assert PI.sample_action(tp, to, generator=gen).shape == (9, 7)


# ------------------------------------------------------------- dynamics
CFG = JDYN.EnsembleConfig(obs_dim=5, act_dim=2, hidden=32, n_models=3,
                          train_batch=32)


def _ensemble(seed=8):
    """A JAX ensemble with a non-trivial normaliser, and its port copy."""
    rng = np.random.default_rng(seed)
    jp = JDYN.init_ensemble(CFG, jax.random.key(seed))
    obs = rng.standard_normal((64, CFG.obs_dim)).astype(np.float32)
    act = rng.standard_normal((64, CFG.act_dim)).astype(np.float32)
    nobs = (obs + 0.1 * rng.standard_normal(obs.shape)).astype(np.float32)
    jp = JDYN.update_normalizer(jp, obs * 2 + 1, act, nobs * 2 + 1)
    return jp, tree_from_jax(_np(jp)), rng


def _transitions(rng, n):
    obs = rng.standard_normal((n, CFG.obs_dim)).astype(np.float32)
    act = rng.standard_normal((n, CFG.act_dim)).astype(np.float32)
    nobs = (obs + 0.2 * rng.standard_normal(obs.shape)).astype(np.float32)
    return obs, act, nobs


def test_ensemble_forward_and_assigned_predictions_match_reference():
    jp, tp, rng = _ensemble()
    obs, act, _ = _transitions(rng, 37)
    _close(DYN.ensemble_forward(tp, _t(obs), _t(act)),
           JDYN.ensemble_forward(jp, obs, act))
    key = jax.random.key(9)
    idx = JDYN.sample_members(jp, key, (37,))
    _close(DYN.predict_assigned(tp, _t(obs), _t(act), _t(idx).long()),
           JDYN.predict_assigned(jp, obs, act, idx))
    # predict draws randint(key, (B,), 0, K) inside: the same draw
    _close(DYN.predict(tp, _t(obs), _t(act), _t(idx)),
           JDYN.predict(jp, obs, act, key))
    assert DYN.n_members(tp) == 3
    gen = torch.Generator().manual_seed(0)
    m = DYN.sample_members(tp, (4, 37), gen)
    assert m.shape == (4, 37) and int(m.min()) >= 0 and int(m.max()) < 3


def test_masked_mse_loss_and_gradient_match_reference():
    jp, tp, rng = _ensemble()
    obs, act, nobs = _transitions(rng, 40)
    w = (np.arange(40) < 29).astype(np.float32)
    jl, jg = jax.value_and_grad(JDYN.masked_mse_loss)(jp, obs, act, nobs, w)
    tl, tg = DYN.value_and_grad(DYN.masked_mse_loss, tp, _t(obs), _t(act),
                                _t(nobs), _t(w))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # every leaf, the normaliser's included, as jax.grad differentiates
    _close_to_scale(tg, jg)
    _close(DYN.mse_loss(tp, _t(obs), _t(act), _t(nobs)),
           JDYN.mse_loss(jp, obs, act, nobs))


def test_norm_stats_and_member_forward_match_reference():
    jp, tp, rng = _ensemble()
    obs, act, nobs = _transitions(rng, 50)
    _close(DYN.masked_norm_stats(_t(obs), _t(act), _t(nobs), 31),
           JDYN.masked_norm_stats(obs, act, nobs, 31))
    _close(DYN.update_normalizer(tp, _t(obs), _t(act), _t(nobs)),
           JDYN.update_normalizer(jp, obs, act, nobs))
    member = jax.tree.map(lambda x: x[1], jp["members"])
    xn = rng.standard_normal((7, 7)).astype(np.float32)
    _close(DYN.member_forward(tree_from_jax(_np(member)), _t(xn)),
           JDYN.member_forward(member, xn))


@pytest.mark.parametrize("size", [150, 40, 0])
def test_ring_trainer_epoch_matches_reference(size):
    """One ``train_epoch`` from converted params on the same ring, with
    the reference's own index grid replayed: the draw its jit makes from
    ``key`` (``dynamics.py:274``)."""
    jp, tp, rng = _ensemble()
    capacity = 200
    obs, act, nobs = _transitions(rng, capacity)
    jdata = {"obs": obs, "act": act, "next_obs": nobs}
    tdata = {k: _t(v) for k, v in jdata.items()}
    jopt_, jtrain, jval, jnorm = JDYN.make_ring_trainer(CFG, capacity)
    opt, train, val, norm = DYN.make_ring_trainer(CFG, capacity)
    nb, bs = DYN.ring_grid(CFG, capacity)
    assert (nb, bs) == (6, 32)
    jp = {**jp, "norm": jnorm(jdata, size)}
    tp = {**tp, "norm": norm(tdata, size)}
    _close(tp["norm"], jp["norm"])
    key = jax.random.key(10)
    idx = jax.random.randint(key, (nb, bs), 0, max(size, 1))
    jstate = jopt_.init(jp)
    want = _np(jtrain(jp, jstate, jdata, size, key))
    got_p, got_s, got_loss = train(tp, opt.init(tp), tdata, size,
                                   _t(idx).long())
    _close(got_p, want[0], **PARAM_TOL)
    _close((got_s.mu, got_s.nu), (want[1].mu, want[1].nu), **PARAM_TOL)
    assert int(got_s.step) == int(want[1].step) == min(max(size // bs, 1), nb)
    np.testing.assert_allclose(float(got_loss), float(want[2]), rtol=1e-5)
    np.testing.assert_allclose(float(val(got_p, tdata, size)),
                               float(jval(want[0], jdata, size)), rtol=1e-4)
    assert (train.shape_count, val.shape_count, norm.shape_count) == (1, 1, 1)
    with pytest.raises(ValueError, match="index grid"):
        train(tp, opt.init(tp), tdata, size, _t(idx)[:2].long())


def test_ema_early_stop_matches_reference():
    from repro.mbrl.early_stop import EMAEarlyStop as JStop
    losses = [1.0, 0.8, 0.7, 0.75, 0.6, 0.9]
    for weight, enabled in ((0.9, True), (0.5, True), (0.9, False)):
        a, b = EMAEarlyStop(weight, enabled), JStop(weight, enabled)
        for v in losses:
            assert a.update(v) == b.update(v)
            assert a.ema == b.ema
    with pytest.raises(ValueError):
        EMAEarlyStop(1.5)
