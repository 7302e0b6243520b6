"""Imagination and policy improvement (Alg. 3) of the PyTorch port against
the JAX reference, on the CPU at a small size: ``imagine_rollout`` (fused
and legacy), advantages, conjugate gradient, one TRPO step, PPO, one
``improve()`` of each algorithm, and three steps of the whole
``PolicyImprovementWorker``.

Params are built by the JAX package and carried across with
``repro_torch.testing.parity``. The reference draws inside its jitted
``improve`` from the key it is given; the test makes the same
``jax.random`` calls outside (``_me_draws``, ``_mbmpo_draws``, following
``algos.py:158-161``, ``:57-62`` and ``:241-257``) and injects the draws
into the port. The worker test replays the reference worker's key splits
(``workers.py:433`` and ``:465``) through ``draw_source``.

Tolerances, f32: 1e-5 (atol and rtol) for one step of arithmetic; 1e-4
for a rollout (each step feeds the next, compounding the per-step 1e-6)
and for advantages normalised over it; params after one PPO or MB-MPO
update to 1e-4 of their scale (a rollout, the advantages and Adam, which
divides by sqrt(v); see ``test_torch_mbrl.py``).

TRPO is compared in float64, both packages (``jax.enable_x64`` as a
context, restored on exit), to 1e-6 of the params' scale. Its 10-step
conjugate-gradient solve over a rank-deficient Fisher (more policy params
than rows x actions) amplifies rounding by some 1e7: the reference against
itself, with the batch rows merely permuted, moves the stepped params by
up to 9e-4 in f32 (the same as the port against it) and by 2.4e-9 in
float64, where the port agrees with it to 2.3e-8 or better. The
line-search decisions compared are asserted to sit far from their
thresholds, so rounding cannot flip them.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import servers as JSRV
from repro.core import workers as JW
from repro.envs import arm as jarm
from repro.mbrl import algos as JA
from repro.mbrl import dynamics as JDYN
from repro.mbrl import policy as JPI
from repro.mbrl import ppo as JPPO
from repro.mbrl import trpo as JTRPO
from repro_torch.core import servers as SRV
from repro_torch.core import workers as W
from repro_torch.envs import arm as tarm
from repro_torch.kernels.imag import ops as imag_ops
from repro_torch.mbrl import algos as A
from repro_torch.mbrl import dynamics as DYN
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl import ppo as PPO
from repro_torch.mbrl import trpo as TRPO
from repro_torch.testing.parity import tree_from_jax, tree_to_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
ROLL_TOL = dict(atol=1e-4, rtol=1e-4)
X64_TOL = 1e-6      # float64 params after a TRPO step, of their scale
ENV = "pendulum"
K, HID, PHID = 3, 32, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """numpy/JAX tree -> torch tree; int leaves become int64 indices."""
    def conv(a):
        a = np.array(a)
        return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                                else a)
    return jax.tree.map(conv, _np(tree))


def _pairs(got, want):
    g, w = jax.tree.flatten(tree_to_numpy(got)), jax.tree.flatten(_np(want))
    assert g[1] == w[1], (g[1], w[1])
    return zip(g[0], w[0])


def _close(got, want, **tol):
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


def _close_to_scale(got, want, tol=1e-4):
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))


def _precision(x64: bool):
    """float64 for both packages inside the block when ``x64``: JAX's
    thread-local flag, restored on exit; the port follows its inputs."""
    return jax.enable_x64(True) if x64 else contextlib.nullcontext()


def _setup(env_name=ENV, n_models=K, seed=0):
    """The reference's env, ensemble (with a non-trivial normaliser fitted
    to random transitions) and policy, and the port's env."""
    env = jarm.make_env(env_name)
    cfg = JDYN.EnsembleConfig(env.obs_dim, env.act_dim, hidden=HID,
                              n_models=n_models)
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    model = JDYN.init_ensemble(cfg, k1)
    dt = _float()
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((64, env.obs_dim)).astype(dt)
    act = rng.uniform(-1, 1, (64, env.act_dim)).astype(dt)
    nxt = obs + 0.1 * rng.standard_normal(obs.shape).astype(dt)
    model = JDYN.update_normalizer(model, obs, act, nxt)
    pol_cfg = JPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=PHID)
    return env, tarm.make_env(env_name), model, pol_cfg, _policy(pol_cfg,
                                                                 k3)


def _float():
    """The float dtype of the current JAX precision."""
    return np.asarray(jnp.zeros(())).dtype


def _policy(pol_cfg, key):
    """The reference's init, every leaf in the current float dtype (its
    ``log_std`` is f32 whatever the precision)."""
    return jax.tree.map(lambda x: x.astype(_float()),
                        JPI.init_policy(pol_cfg, key))


def _tpol_cfg(pol_cfg):
    return PI.PolicyConfig(pol_cfg.obs_dim, pol_cfg.act_dim,
                           hidden=pol_cfg.hidden)


def _rollout_draws(env, model, key, B, H, act_dim):
    """The draws of one ``_rollout_with_logp`` on the ensemble fast path
    (``algos.py:57-62``): members from the second half of the key's split,
    the hoisted noise from the first."""
    ka, kp = jax.random.split(key)
    return {"members": JDYN.sample_members(model, kp, (H, B)),
            "eps": JDYN.hoisted_noise(ka, H, B, act_dim)}


def _me_draws(env, cfg, model, key):
    """What ``MEAlgo._improve_impl`` draws from ``key``
    (``algos.py:158-161``)."""
    k0, k1 = jax.random.split(key)
    return {"s0": env.reset_batch(k0, cfg.imagine_batch),
            **_rollout_draws(env, model, k1, cfg.imagine_batch,
                             cfg.imagine_horizon, env.act_dim)}


def _member(model, m):
    return {"members": jax.tree.map(lambda x: x[m:m + 1], model["members"]),
            "norm": model["norm"]}


def _mbmpo_draws(env, cfg, model, key):
    """What ``MBMPO._improve_impl`` draws from ``key``, per member
    (``algos.py:241-257``): its rollouts see a K=1 slice."""
    out = []
    for m, k in enumerate(jax.random.split(key, cfg.n_models)):
        member = _member(model, m)
        k_in, k_out = jax.random.split(k)
        pair = {}
        for name, kk in (("inner", k_in), ("outer", k_out)):
            k_s0, k_roll = jax.random.split(kk)
            pair[name] = {"s0": env.reset_batch(k_s0, cfg.imagine_batch),
                          **_rollout_draws(env, member, k_roll,
                                           cfg.imagine_batch,
                                           cfg.imagine_horizon,
                                           env.act_dim)}
        out.append(pair)
    return out


# ------------------------------------------------------------ imagination
@pytest.mark.parametrize("fused", [True, False])
def test_imagine_rollout_matches_reference(fused):
    jenv, tenv, model, pol_cfg, pol = _setup()
    B, H = 16, 8
    s0 = jenv.reset_batch(jax.random.key(5), B)
    key = jax.random.key(6)
    want = JDYN.imagine_rollout(model, JPI.sample_action, pol, s0, key, H,
                                jax.vmap(jenv.reward), fused=fused)
    d = _t(_rollout_draws(jenv, model, key, B, H, jenv.act_dim))
    got = DYN.imagine_rollout(tree_from_jax(_np(model)), PI.sample_action,
                              tree_from_jax(_np(pol)), _t(s0), H,
                              tenv.reward, fused=fused, members=d["members"],
                              eps=d["eps"])
    _close(got, want, **ROLL_TOL)


def test_rollout_plan_and_draws_on_the_cpu():
    _, _, model, _, pol = _setup()
    tm = tree_from_jax(_np(model))
    gen = torch.Generator().manual_seed(0)
    members, eps = DYN.rollout_draws(tm, 7, 5, 2, gen)
    assert members.shape == (7, 5) and eps.shape == (7, 5, 2)
    assert int(members.min()) >= 0 and int(members.max()) < K
    # the plain version is row-order-blind: no plan unless the kernel runs
    assert DYN.horizon_plan(tm, members) is None
    order, offsets = imag_ops.sort_plan(members, K)
    assert order.shape == (7, 5) and offsets.shape == (7, K + 1)
    with pytest.raises(ValueError, match="Generator"):
        DYN.imagine_rollout(tm, PI.sample_action, tree_from_jax(_np(pol)),
                            torch.zeros(5, 3), 7, None)


@pytest.mark.parametrize("fused", [True, False])
def test_rollout_with_logp_matches_reference(fused):
    jenv, tenv, model, pol_cfg, pol = _setup(seed=1)
    B, H = 12, 6
    s0 = jenv.reset_batch(jax.random.key(7), B)
    key = jax.random.key(8)
    want = JA._rollout_with_logp(model, pol, s0, key, H,
                                 jax.vmap(jenv.reward), fused=fused)
    d = _t(_rollout_draws(jenv, model, key, B, H, jenv.act_dim))
    got = A._rollout_with_logp(tree_from_jax(_np(model)),
                               tree_from_jax(_np(pol)), _t(s0), H,
                               tenv.reward, fused=fused,
                               members=d["members"], eps=d["eps"])
    _close(list(got), list(want), **ROLL_TOL)


# ------------------------------------------------------------ TRPO / PPO
@pytest.mark.parametrize("shape", [(10, 16), (1, 4), (50, 64)])
def test_compute_advantages_matches_reference(shape):
    rews = np.random.default_rng(shape[0]).standard_normal(shape).astype(
        np.float32)
    want = JTRPO.compute_advantages(jnp.asarray(rews), gamma=0.97)
    got = TRPO.compute_advantages(torch.from_numpy(rews), gamma=0.97)
    _close(list(got), list(want), **ROLL_TOL)


@pytest.mark.parametrize("x64", [False, True])
def test_conjugate_gradient_matches_reference(x64):
    """Ten CG steps on a well-conditioned SPD system over a params tree."""
    with _precision(x64):
        dt = _float()
        rng = np.random.default_rng(3)
        n = 12
        m = rng.standard_normal((n, n))
        spd = (m @ m.T / n + np.eye(n)).astype(dt)
        g = {"w": [rng.standard_normal((3, 2)).astype(dt)],
             "log_std": rng.standard_normal(6).astype(dt)}

        def hvp_for(mat, cat):
            def hvp(v):
                out = mat @ cat([v["w"][0].reshape(-1), v["log_std"]])
                return {"w": [out[:6].reshape(3, 2)], "log_std": out[6:]}
            return hvp
        want = JTRPO._cg(hvp_for(jnp.asarray(spd), jnp.concatenate), g,
                         iters=10)
        got = TRPO._cg(hvp_for(torch.from_numpy(spd), torch.cat),
                       tree_from_jax(g), iters=10)
        _close_to_scale(got, want, X64_TOL if x64 else 1e-5)


def _trpo_batch(seed, n, obs_dim, act_dim, nan=False):
    rng = np.random.default_rng(seed)
    dt = _float()
    adv = rng.standard_normal(n).astype(dt)
    if nan:
        adv[:] = np.nan
    return {"obs": rng.standard_normal((n, obs_dim)).astype(dt),
            "act_pre": rng.standard_normal((n, act_dim)).astype(dt),
            "adv": adv}


def _assert_decisive(info, max_kl=0.01):
    """A step was found, and every backtracking candidate's test sat far
    from its threshold (KL at least 1% away from 1.5 max_kl, surrogate at
    least 1e-4 away from 0), so rounding cannot change which candidate
    either package takes."""
    assert bool(info["found"])
    kls = info["candidate_kl"].double().numpy()
    ss = info["candidate_surrogate"].double().numpy()
    assert np.all(np.abs(kls - 1.5 * max_kl) > 0.01 * 1.5 * max_kl), kls
    assert np.all(np.abs(ss) > 1e-4), ss


@pytest.mark.parametrize("n", [300, 600])
def test_trpo_step_matches_reference(n):
    """One TRPO step from the same params and batch, float64: params,
    ``found`` and the full step's KL, surrogate and expected improvement.
    n=600 subsamples the Fisher (stride 2)."""
    with _precision(True):
        _, _, _, pol_cfg, pol = _setup(seed=2)
        batch = _trpo_batch(n, n, pol_cfg.obs_dim, pol_cfg.act_dim)
        want_p, want_i = JTRPO.trpo_step(pol,
                                         jax.tree.map(jnp.asarray, batch))
        got_p, got_i = TRPO.trpo_step(tree_from_jax(_np(pol)),
                                      tree_from_jax(batch))
        _assert_decisive(got_i)
        assert bool(want_i["found"])
        _close_to_scale(got_p, want_p, X64_TOL)
        for k in ("kl", "surrogate", "expected_improve"):
            np.testing.assert_allclose(float(got_i[k]), float(want_i[k]),
                                       rtol=X64_TOL, err_msg=k)


def test_trpo_step_rejects_a_nan_direction_by_select():
    """A diverged batch (NaN advantages): no candidate passes, and the
    params come back untouched, not NaN (select, not scale-by-zero)."""
    _, _, _, pol_cfg, pol = _setup(seed=3)
    batch = _trpo_batch(9, 300, pol_cfg.obs_dim, pol_cfg.act_dim, nan=True)
    want_p, want_i = JTRPO.trpo_step(pol, jax.tree.map(jnp.asarray, batch))
    got_p, got_i = TRPO.trpo_step(tree_from_jax(_np(pol)),
                                  tree_from_jax(batch))
    assert not bool(want_i["found"]) and not bool(got_i["found"])
    for g, w in _pairs(got_p, want_p):
        np.testing.assert_array_equal(g, w)
    for g, w in _pairs(got_p, pol):
        np.testing.assert_array_equal(g, w)


def test_ppo_loss_and_steps_match_reference():
    _, _, _, pol_cfg, pol = _setup(seed=4)
    old = JPI.init_policy(pol_cfg, jax.random.key(44))
    batch = _trpo_batch(10, 200, pol_cfg.obs_dim, pol_cfg.act_dim)
    jb = jax.tree.map(jnp.asarray, batch)
    tb = tree_from_jax(batch)
    for clip, ent in ((0.2, 0.0), (0.1, 0.01)):
        np.testing.assert_allclose(
            float(PPO.ppo_loss(tree_from_jax(_np(pol)),
                               tree_from_jax(_np(old)), tb, clip=clip,
                               ent_coef=ent)),
            float(JPPO.ppo_loss(pol, old, jb, clip=clip, ent_coef=ent)),
            **TOL)
    jopt, jstep = JPPO.make_ppo_step(1e-2)
    topt, tstep = PPO.make_ppo_step(1e-2)
    jp, js = pol, jopt.init(pol)
    tp = tree_from_jax(_np(pol))
    ts = topt.init(tp)
    for _ in range(3):
        jp, js, jl = jstep(jp, js, old, jb)
        tp, ts, tl = tstep(tp, ts, tree_from_jax(_np(old)), tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_to_scale(tp, jp)
    _close_to_scale(ts.mu, js.mu)


# ---------------------------------------------------------------- improve
def _algos(algo, n_models=K, B=16, H=5, predict_fns=(None, None)):
    jenv, tenv, model, pol_cfg, pol = _setup(n_models=n_models, seed=5)
    cfg = JA.AlgoConfig(algo=algo, imagine_batch=B, imagine_horizon=H,
                        n_models=n_models, ppo_lr=1e-2)
    ja = JA.make_algo(cfg, pol_cfg, jax.vmap(jenv.reward), jenv.reset_batch,
                      predict_fn=predict_fns[0])
    ta = A.make_algo(A.AlgoConfig(**vars(cfg)), _tpol_cfg(pol_cfg),
                     tenv.reward, tenv.reset_batch, predict_fn=predict_fns[1])
    return jenv, cfg, model, pol, ja, ta


@pytest.mark.parametrize("algo,x64", [("me-trpo", True), ("me-ppo", False),
                                      ("mb-mpo", False)])
def test_improve_matches_reference(algo, x64):
    """Two ``improve()`` steps of each algorithm from one state, with the
    reference's draws injected (me-trpo in float64, see the header)."""
    with _precision(x64):
        n_models = 2 if algo == "mb-mpo" else K
        jenv, cfg, model, pol, ja, ta = _algos(algo, n_models=n_models)
        jstate = {**ja.init(jax.random.key(0)), "policy": pol}
        if "opt" in jstate:
            jstate["opt"] = ja.init(jax.random.key(0))["opt"]
        tstate = ta.init(policy=tree_from_jax(_np(pol)))
        tmodel = tree_from_jax(_np(model))
        draws = _mbmpo_draws if algo == "mb-mpo" else _me_draws
        tol = X64_TOL if x64 else 1e-4
        for i, key in enumerate(jax.random.split(jax.random.key(11), 2)):
            jstate, jinfo = ja.improve(jstate, model, key)
            tstate, tinfo = ta.improve(tstate, tmodel,
                                       _t(draws(jenv, cfg, model, key)))
            np.testing.assert_allclose(float(tinfo["imagined_return"]),
                                       float(jinfo["imagined_return"]),
                                       rtol=tol)
            if algo == "me-trpo":
                _assert_decisive(tinfo)
                assert bool(jinfo["found"])
            _close_to_scale(tstate["policy"], jstate["policy"], tol)
            assert int(tstate["steps"]) == i + 1
        assert ta.shape_count() == 1


def test_improve_with_a_swapped_world_model_matches_reference():
    """``make_algo(predict_fn=...)``: a deterministic world model in place
    of the ensemble's sampled members, float64; the per-step policy noise
    comes from the reference's per-step key splits (``algos.py:81-86``)."""
    with _precision(True):
        idx = np.arange(16) % K
        jenv, cfg, model, pol, ja, ta = _algos("me-trpo", predict_fns=(
            lambda p, s, a, k: JDYN.predict_assigned(p, s, a,
                                                     jnp.asarray(idx)),
            lambda p, s, a, g: DYN.predict_assigned(p, s, a,
                                                    torch.from_numpy(idx))))
        jstate = {**ja.init(jax.random.key(0)), "policy": pol}
        tstate = ta.init(policy=tree_from_jax(_np(pol)))
        key = jax.random.key(12)
        jstate, jinfo = ja.improve(jstate, model, key)
        k0, k1 = jax.random.split(key)
        eps = jnp.stack([jax.random.normal(jax.random.split(k)[0], (16, 1))
                         for k in jax.random.split(k1, cfg.imagine_horizon)])
        tstate, tinfo = ta.improve(tstate, tree_from_jax(_np(model)), _t(
            {"s0": jenv.reset_batch(k0, 16), "eps": eps}))
        _assert_decisive(tinfo)
        _close_to_scale(tstate["policy"], jstate["policy"], X64_TOL)


def test_improve_draws_from_a_generator_and_keeps_one_shape():
    _, cfg, model, pol, _, ta = _algos("me-trpo")
    tmodel = tree_from_jax(_np(model))
    gen = torch.Generator().manual_seed(3)
    state = ta.init(gen)
    with pytest.raises(ValueError, match="Generator"):
        ta.improve(state, tmodel)
    for _ in range(3):
        state, info = ta.improve(state, tmodel, generator=gen)
        assert np.isfinite(float(info["imagined_return"]))
    assert ta.shape_count() == 1 and int(state["steps"]) == 3


# ----------------------------------------------------------------- worker
def test_policy_improvement_worker_matches_reference():
    """Three ``step()``s of the port's worker against JAX's, float64, a new
    model pushed between the second and the third, with the reference
    worker's key sequence replayed through ``draw_source``. Both start
    from the reference's initial policy cast to float64, so neither
    changes its input dtypes (and shapes) after the first step."""
    with _precision(True):
        jenv, cfg, model, pol, ja, ta = _algos("me-trpo")
        model2 = {**model, "members": jax.tree.map(lambda x: 0.9 * x,
                                                   model["members"])}
        wkey = jax.random.key(21)
        jps, jms = JSRV.ParameterServer(), JSRV.ParameterServer()
        jw = JW.PolicyImprovementWorker(ja, jps, jms, wkey, push_init=False)
        jw.state = {**jw.state, "policy": jax.tree.map(
            lambda x: x.astype(_float()), jw.state["policy"])}
        jps.push(jw.state["policy"])
        # the reference worker's splits: one at construction, one per step
        key, _ = jax.random.split(wkey)
        step_keys = []
        for _ in range(3):
            key, k = jax.random.split(key)
            step_keys.append(k)
        pulled = []

        def draw_source(model_params):
            pulled.append(model_params)
            ref_model = model if len(pulled) < 3 else model2
            return _t(_me_draws(jenv, cfg, ref_model,
                                step_keys[len(pulled) - 1]))

        tps, tms = SRV.ParameterServer(), SRV.ParameterServer()
        tw = W.PolicyImprovementWorker(
            ta, tps, tms, seed=0, policy=tree_from_jax(_np(jw.state[
                "policy"])), draw_source=draw_source, device="cpu")
        assert not tw.step() and not jw.step()        # no model yet
        assert tps.version == jps.version == 1        # the initial policy
        _close(tps.pull()[0], jps.pull()[0])
        launches = imag_ops.launches
        for i in range(3):
            if i in (0, 2):
                m = model if i == 0 else model2
                jms.push(m)
                tms.push(tree_from_jax(_np(m)))
            assert jw.step() and tw.step()
            assert tps.version == jps.version == i + 2
            _close_to_scale(tps.pull()[0], jps.pull()[0], X64_TOL)
            _assert_decisive(tw.last_info)
        assert pulled[0] is pulled[1] and pulled[1] is not pulled[2]
        assert tw.steps == jw.steps == 3
        assert tw.compile_count() == jw.compile_count() == 1
        assert imag_ops.launches == launches      # the CPU route is ref
