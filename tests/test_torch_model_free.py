"""The port's model-free baseline (``mbrl/model_free.py``) and the legacy
dynamic-shape model trainer (``dynamics.make_model_trainer``) against the
JAX reference, on the CPU, from the same params with the reference's draws
replayed into the port.

``ModelFreeTrainer``: one iteration of each algorithm, the reference's
collection draws (each trajectory's reset uniforms and per-step policy
noise, from its split of the iteration key) handed to the port through
``draw_source``. PPO runs in float32 (ten Adam steps, parameters within
``PPO_TOL`` of their scale); TRPO in float64 under ``jax.enable_x64``
(``X64_TOL``), because a TRPO step's conjugate gradient and line search
amplify float32 rounding (see ``tests/test_torch_improve.py``). The trace's
``time``, ``trajs`` and ``env_steps`` columns must be equal exactly.

``make_model_trainer``: a few epochs from the same ensemble on the same
transitions, each epoch's permutation drawn by ``jax.random.permutation``
and injected, against ``TRAIN_TOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime as JR
from repro.envs import make_env as jmake_env
from repro.mbrl import dynamics as JDYN
from repro.mbrl import model_free as JMF
from repro.mbrl import policy as JPI
from repro_torch.core import runtime as TR
from repro_torch.envs import make_env as tmake_env
from repro_torch.mbrl import dynamics as TDYN
from repro_torch.mbrl import model_free as TMF
from repro_torch.mbrl import policy as TPI
from repro_torch.testing.parity import tree_from_jax, tree_to_numpy

PPO_TOL = 1e-4      # of scale: ten f32 Adam steps, sums reordered
X64_TOL = 1e-6      # of scale: one float64 TRPO step
TRAIN_TOL = 1e-4    # of scale: three f32 epochs of Adam on the ensemble
TRAJS_PER_ITER, POLICY_HIDDEN = 4, 16


def _reset_draws(env, key):
    """The draws the reference's pendulum ``reset(key)`` makes, in the
    layout of the port env's ``reset_from``."""
    return np.stack([np.asarray(jax.random.uniform(key, ())),
                     np.asarray(jax.random.uniform(
                         jax.random.fold_in(key, 1), ()))])


def _reference_draws(env, seed, iterations, n):
    """Each iteration's (reset draws (n, 2), noise (H, n, act)) as the
    reference's ``ModelFreeTrainer`` makes them inside its jit."""
    key, _, _ = jax.random.split(jax.random.key(seed), 3)
    out = []
    for _ in range(iterations):
        key, k = jax.random.split(key)
        resets, noises = [], []
        for kk in jax.random.split(k, n):
            k0, kk = jax.random.split(kk)
            resets.append(_reset_draws(env, k0))
            noises.append(np.asarray(jax.vmap(
                lambda kh: jax.random.normal(kh, (env.act_dim,)))(
                    jax.random.split(kk, env.horizon))))
        out.append((np.stack(resets), np.stack(noises, axis=1)))
    return out


def _close_to_scale(got, want, tol):
    for g, w in zip(jax.tree.leaves(tree_to_numpy(got)),
                    jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("algo,x64", [("ppo", False), ("trpo", True)])
def test_one_iteration_matches_reference(algo, x64):
    ctx = jax.enable_x64(True) if x64 else jax.enable_x64(False)
    with ctx:
        jenv, tenv = jmake_env("pendulum"), tmake_env("pendulum")
        pcfg = JPI.PolicyConfig(jenv.obs_dim, jenv.act_dim,
                                hidden=POLICY_HIDDEN)
        rc = dict(total_trajs=TRAJS_PER_ITER, seed=3, eval_rollouts=2)
        jt = JMF.ModelFreeTrainer(jenv, pcfg, JR.RunConfig(**rc), algo=algo,
                                  trajs_per_iter=TRAJS_PER_ITER)
        if x64:
            jt.params = jax.tree.map(lambda x: x.astype(jnp.float64),
                                     jt.params)
        p0 = jax.tree.map(np.asarray, jt.params)
        draws = _reference_draws(tenv, 3, 1, TRAJS_PER_ITER)
        dtype = torch.float64 if x64 else torch.float32
        tt = TMF.ModelFreeTrainer(
            tenv, TPI.PolicyConfig(tenv.obs_dim, tenv.act_dim,
                                   hidden=POLICY_HIDDEN),
            TR.RunConfig(**rc), algo=algo, trajs_per_iter=TRAJS_PER_ITER,
            params=tree_from_jax(p0),
            draw_source=lambda i: tuple(torch.from_numpy(d).to(dtype)
                                        for d in draws[i]),
            device="cpu")
        jtrace, ttrace = jt.run(), tt.run()
        _close_to_scale(tt.params, jax.tree.map(np.asarray, jt.params),
                        X64_TOL if x64 else PPO_TOL)
    cols = ("time", "trajs", "env_steps")
    assert [tuple(r[c] for c in cols) for r in ttrace] == \
        [tuple(r[c] for c in cols) for r in jtrace]
    assert all(np.isfinite(r["eval_return"]) for r in ttrace)
    # the step moved the policy: the comparison is not of two copies of p0
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(jt.params),
                                jax.tree.leaves(p0)))
    assert moved > 1e-4


def test_run_accounts_virtual_time_and_draws_from_its_generator():
    env = tmake_env("pendulum")
    pcfg = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    rc = TR.RunConfig(total_trajs=5, seed=0, eval_rollouts=1)
    runs = []
    for _ in range(2):
        tr = TMF.ModelFreeTrainer(env, pcfg, rc, algo="ppo",
                                  trajs_per_iter=3, ppo_epochs=2,
                                  device="cpu")
        runs.append((tr.run(), tr))
    (trace, tr), (again, _) = runs
    per_iter = 3 * env.horizon * env.dt + 2 * rc.policy_step_time
    assert [r["time"] for r in trace] == [per_iter, 2 * per_iter]
    assert [r["trajs"] for r in trace] == [3, 6] and tr.iterations == 2
    assert trace == again           # seeded: the same run twice


def test_unknown_algo_and_default_device():
    env = tmake_env("pendulum")
    pcfg = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    with pytest.raises(ValueError, match="algo"):
        TMF.ModelFreeTrainer(env, pcfg, algo="sac", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TMF.ModelFreeTrainer(env, pcfg)


# ------------------------------------------------------ make_model_trainer
def test_make_model_trainer_matches_reference():
    """The reference's ``tests/test_mbrl.py`` setting at small widths: the
    same ensemble (normaliser fitted to the data) trained three epochs on
    the same 8 x 50 transitions, each epoch's permutation injected."""
    rng = np.random.default_rng(0)
    n, obs_dim, act_dim = 400, 3, 1
    obs = rng.standard_normal((n, obs_dim)).astype(np.float32)
    act = rng.uniform(-1, 1, (n, act_dim)).astype(np.float32)
    nobs = (obs + 0.1 * np.tanh(obs @ rng.standard_normal((3, 3)))
            + 0.05 * act).astype(np.float32)
    cfg = dict(hidden=32, n_models=2, lr=3e-3, train_batch=64)
    jcfg = JDYN.EnsembleConfig(obs_dim, act_dim, **cfg)
    tcfg = TDYN.EnsembleConfig(obs_dim, act_dim, **cfg)
    jp = JDYN.update_normalizer(JDYN.init_ensemble(jcfg, jax.random.key(1)),
                                obs, act, nobs)
    tp = tree_from_jax(jax.tree.map(np.asarray, jp))
    jopt, jtrain, jval = JDYN.make_model_trainer(jcfg)
    topt, ttrain, tval = TDYN.make_model_trainer(tcfg)
    js, ts = jopt.init(jp), topt.init(tp)
    t_obs, t_act, t_nobs = map(torch.from_numpy, (obs, act, nobs))
    v0 = float(tval(tp, t_obs, t_act, t_nobs))
    np.testing.assert_allclose(v0, float(jval(jp, obs, act, nobs)),
                               rtol=1e-5)
    for e in range(3):
        key = jax.random.fold_in(jax.random.key(2), e)
        jp, js, jl = jtrain(jp, js, obs, act, nobs, key)
        perm = torch.from_numpy(np.asarray(jax.random.permutation(key, n))
                                .astype(np.int64))
        tp, ts, tl = ttrain(tp, ts, t_obs, t_act, t_nobs, perm)
        np.testing.assert_allclose(float(tl), float(jl), rtol=TRAIN_TOL)
    _close_to_scale(tp, jax.tree.map(np.asarray, jp), TRAIN_TOL)
    v1 = float(tval(tp, t_obs, t_act, t_nobs))
    assert v1 < v0 and abs(v1 - float(jval(jp, obs, act, nobs))) <= \
        TRAIN_TOL * v0


def test_make_model_trainer_draws_a_permutation_from_a_generator():
    cfg = TDYN.EnsembleConfig(3, 1, hidden=8, n_models=2, train_batch=16)
    g = torch.Generator().manual_seed(0)
    params = TDYN.init_ensemble(cfg, g)
    opt, train, _ = TDYN.make_model_trainer(cfg)
    obs, act, nobs = torch.randn(40, 3), torch.randn(40, 1), torch.randn(40,
                                                                         3)
    with pytest.raises(ValueError, match="permutation"):
        train(params, opt.init(params), obs, act, nobs)
    out = [train(params, opt.init(params), obs, act, nobs,
                 generator=torch.Generator().manual_seed(5))[2]
           for _ in range(2)]
    assert float(out[0]) == float(out[1]) and np.isfinite(float(out[0]))
