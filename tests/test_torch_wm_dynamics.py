"""The transformer world model of the PyTorch port against the JAX
reference (``repro/mbrl/wm_dynamics.py``).

Both packages' ``WorldModelDynamics`` on pendulum transitions from the
reference's env, at a small width (2 layers, d_model 64, 4 heads: head
dim 16, 21 bins), with the reference's state carried across by
``testing.parity.world_model_from_jax``. In the model's own bf16, at the
reference's ``BF16_TOL`` (1e-2) of each quantity's scale:

* tokenisation, the training batch and ``update_normalizer``: equal;
* one ``train_epoch`` on the reference's permutation: the loss and every
  parameter (in f32 also the Adam moments, at 1e-4);
* ``predict``'s logits at each greedy step, the port teacher-forced on the
  reference's tokens (the decodes' at ``DECODE_BF16_TOL``, and in f32 at
  1e-4); ``predict``'s outputs in the same bins, to an ulp,
  on every row whose top-two logit margin exceeds the tolerance at every
  step (elsewhere bf16 rounding may pick the other bin);
* the ``predict_fn`` contract (shape check, tag, the normaliser captured).

One ME-PPO ``improve`` through ``predict_fn`` with the reference's draws
injected runs both world models in f32 (a bf16 argmax tie would fork the
rollout), at the improve tests' 1e-4 of scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs import make_env as jax_make_env
from repro.mbrl import algos as JA
from repro.mbrl import policy as JPI
from repro.mbrl import wm_dynamics as JWM
from repro.models import lm as JLM
from repro_torch.envs import make_env
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.mbrl import algos as A
from repro_torch.mbrl import policy as PI
from repro_torch.mbrl import wm_dynamics as WM
from repro_torch.models import api
from repro_torch.models import lm as LM
from repro_torch.testing.parity import (state_from_jax, tree_from_jax,
                                        tree_to_numpy, world_model_from_jax)

BF16_TOL = 1e-2
DECODE_BF16_TOL = 2e-2     # 3 bf16 ulps at the logits' scale, see below
TOL = 1e-4
CPU = "cpu"
WIDTH = dict(bins=21, d_model=64, num_layers=2, num_heads=4)
N_ROWS, BATCH = 64, 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, msg=""):
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (msg, err, tol * scale)


@pytest.fixture(scope="module")
def data():
    env = jax_make_env("pendulum")
    key = jax.random.key(0)
    pol = JPI.init_policy(JPI.PolicyConfig(env.obs_dim, env.act_dim,
                                           hidden=8), key)
    trajs = [env.rollout(jax.random.fold_in(key, i), JPI.sample_action, pol)
             for i in range(2)]
    obs, act, nobs = (np.concatenate([np.asarray(t[k]) for t in trajs])
                      for k in ("obs", "act", "next_obs"))
    return env, obs, act, nobs


def _pair(env, seed=0, f32=False):
    """The reference's world model and the port's, carrying its state.
    ``f32`` runs both in float32 (the reference's config swapped before its
    first trace)."""
    jwm = JWM.WorldModelDynamics(JWM.WMConfig(env.obs_dim, env.act_dim,
                                              **WIDTH), jax.random.key(seed))
    twm = WM.WorldModelDynamics(WM.WMConfig(env.obs_dim, env.act_dim,
                                            **WIDTH), device=CPU)
    if f32:
        jwm.mcfg = dataclasses.replace(jwm.mcfg, dtype="float32")
        jwm.params = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  jwm.params)
        twm.mcfg = dataclasses.replace(twm.mcfg, dtype="float32")
    world_model_from_jax(twm, jax.tree.map(np.asarray, jwm.params),
                         jax.tree.map(np.asarray, jwm.norm),
                         jax.tree.map(np.asarray, jwm.opt_state))
    return jwm, twm


def _fit_norm(jwm, twm, obs, nobs):
    both = np.concatenate([obs, nobs])
    jwm.update_normalizer(jnp.asarray(both))
    twm.update_normalizer(torch.from_numpy(both))


def test_world_model_carries_across(data):
    env, *_ = data
    jwm, twm = _pair(env)
    assert (twm.mcfg.vocab_size, twm.mcfg.d_ff, twm.seq) == \
        (jwm.mcfg.vocab_size, jwm.mcfg.d_ff, jwm.seq)
    assert twm.mcfg.hd == 16 and twm.params.embed.table.dtype == torch.bfloat16
    want = state_from_jax(jax.tree.map(np.asarray, jwm.params))
    for name, t in twm.params.state_dict().items():
        assert torch.equal(t, want[name]), name
    assert list(twm.opt_state.mu) == list(LM.trainable(twm.params))
    assert int(twm.opt_state.step) == 0
    fresh = WM.WorldModelDynamics(twm.cfg, 3, device=CPU)
    assert fresh.params.embed.table.shape == twm.params.embed.table.shape


def test_tokens_and_normaliser_match_jax(data):
    env, obs, act, nobs = data
    jwm, twm = _pair(env)
    _fit_norm(jwm, twm, obs, nobs)
    for k in ("lo", "hi"):
        np.testing.assert_array_equal(twm.norm[k].numpy(),
                                      np.asarray(jwm.norm[k]))
    d, a = env.obs_dim, env.act_dim
    x = np.concatenate([obs[:40], obs[:4] * 3.0])      # some out of range
    u = np.concatenate([act[:40], np.array([[-2.0], [2.0], [1.0], [-1.0]],
                                           np.float32)])
    tx, tu = torch.from_numpy(x), torch.from_numpy(u)
    np.testing.assert_array_equal(
        twm.tok_obs(tx, twm.norm, 0).numpy(), np.asarray(jwm._tok_obs(x, 0)))
    np.testing.assert_array_equal(
        twm.tok_obs(tx, twm.norm, d + a).numpy(),
        np.asarray(jwm._tok_obs(x, d + a)))
    np.testing.assert_array_equal(twm.tok_act(tu).numpy(),
                                  np.asarray(jwm._tok_act(u)))
    batch = twm.tokens(tx, tu, torch.from_numpy(x[::-1].copy()))
    want = np.concatenate([np.asarray(jwm._tok_obs(x, 0)),
                           np.asarray(jwm._tok_act(u)),
                           np.asarray(jwm._tok_obs(x[::-1], d + a))], 1)
    np.testing.assert_array_equal(batch["tokens"].numpy(), want)
    labels = np.full_like(want, -1)
    labels[:, d + a - 1:-1] = want[:, d + a:]
    np.testing.assert_array_equal(batch["labels"].numpy(), labels)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_one_train_epoch_matches_jax(data, f32):
    """One epoch (two minibatches) on the reference's permutation: the
    loss and every parameter, at ``BF16_TOL`` in the model's bf16; in f32
    also the Adam moments, at ``TOL``. (In bf16 the moments differ by up
    to 3% of their scale: the two backward passes round their bf16
    cotangents at other places.)"""
    env, obs, act, nobs = data
    jwm, twm = _pair(env, f32=f32)
    tol = TOL if f32 else BF16_TOL
    _fit_norm(jwm, twm, obs, nobs)
    key = jax.random.key(7)
    perm = np.array(jax.random.permutation(key, N_ROWS))
    rows = [a[:N_ROWS] for a in (obs, act, nobs)]
    jloss = jwm.train_epoch(*map(jnp.asarray, rows), key, batch_size=BATCH)
    tloss = twm.train_epoch(*map(torch.from_numpy, rows), perm,
                            batch_size=BATCH)
    _close(tloss, jloss, tol, "loss")
    want = state_from_jax(jax.tree.map(np.asarray, jwm.params))
    for name, t in twm.params.state_dict().items():
        _close(t, want[name], tol, name)
    assert int(twm.opt_state.step) == N_ROWS // BATCH
    if not f32:
        return
    for moment, jm in (("mu", jwm.opt_state.mu), ("nu", jwm.opt_state.nu)):
        want = state_from_jax(jax.tree.map(np.asarray, jm))
        for name, got in getattr(twm.opt_state, moment).items():
            scale = float(np.abs(_np(want[name])).max())
            np.testing.assert_allclose(_np(got), _np(want[name]), rtol=0,
                                       atol=TOL * scale,
                                       err_msg=moment + name)


def _jax_greedy(jwm, obs, act):
    """The reference's ``_predict_impl`` unrolled: each step's logits and
    greedy token."""
    d, a, bins = jwm.cfg.obs_dim, jwm.cfg.act_dim, jwm.cfg.bins
    B = obs.shape[0]
    prompt = jnp.concatenate([jwm._tok_obs(obs, 0), jwm._tok_act(act)], 1)
    logits, cache = JLM.make_prefill(jwm.mcfg, jwm.ctx, B, jwm.seq)(
        jwm.params, {"tokens": prompt.astype(jnp.int32)})
    decode = JLM.make_decode(jwm.mcfg, jwm.ctx, B, jwm.seq)
    steps, toks = [], []
    for j in range(d):
        off = (d + a + j) * bins
        steps.append(np.asarray(logits[:, off:off + bins]))
        tok = jnp.argmax(logits[:, off:off + bins], -1) + off
        toks.append(np.asarray(tok))
        logits, cache = decode(jwm.params, cache,
                               tok[:, None].astype(jnp.int32))
    return steps, toks


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
def test_predict_matches_jax_where_greedy_is_decisive(data, f32):
    """Each greedy step's logits (the port teacher-forced on the
    reference's tokens) within ``tol`` of their scale: ``TOL`` in f32;
    in bf16 ``DECODE_BF16_TOL``, since each decode reads a cache whose
    bf16 values the two frameworks rounded at other places (the prefill's
    logits are within ``BF16_TOL``; the third step's reach 3 bf16 ulps).
    Then ``predict``'s outputs on the rows where every step's top-two
    margin exceeds twice that."""
    env, obs, act, nobs = data
    jwm, twm = _pair(env, f32=f32)
    tol = TOL if f32 else DECODE_BF16_TOL
    _fit_norm(jwm, twm, obs, nobs)
    x, u = obs[:48], act[:48]
    jsteps, jtoks = _jax_greedy(jwm, jnp.asarray(x), jnp.asarray(u))
    want = np.asarray(jwm.predict(jnp.asarray(x), jnp.asarray(u),
                                  jax.random.key(0)))
    d, a, bins = env.obs_dim, env.act_dim, WIDTH["bins"]
    # the unrolled loop is the reference's predict: the same bins
    lo, hi = np.asarray(jwm.norm["lo"]), np.asarray(jwm.norm["hi"])

    def bins_of(v):
        return np.rint((v - lo) / (hi - lo) * (bins - 1))
    np.testing.assert_array_equal(
        bins_of(want), np.stack(jtoks, 1) - (d + a + np.arange(d)) * bins)
    # the port's logits, teacher-forced on the reference's tokens
    prompt = torch.cat([twm.tok_obs(torch.from_numpy(x), twm.norm, 0),
                        twm.tok_act(torch.from_numpy(u))], 1)
    logits, cache = LM.make_prefill(twm.mcfg)(twm.params, {"tokens": prompt})
    cache = api.grow_cache(cache, twm.seq + 1)
    decode = LM.make_decode(twm.mcfg)
    for j in range(d):
        off = (d + a + j) * bins
        _close(logits[:, off:off + bins], jsteps[j],
               BF16_TOL if j == 0 and not f32 else tol, f"step {j}")
        tok = torch.from_numpy(jtoks[j].astype(np.int32))[:, None]
        logits, cache = decode(twm.params, cache, tok)
    # outputs equal wherever every step's top-two margin exceeds the tol
    scale = max(1.0, max(float(np.abs(s).max()) for s in jsteps))
    top2 = [np.sort(s, -1)[:, -2:] for s in jsteps]
    decisive = np.all([t[:, 1] - t[:, 0] > 2 * tol * scale
                       for t in top2], 0)
    assert decisive.sum() >= len(x) // 4      # the check is not vacuous
    before = fa_ops.launches
    got = twm.predict(torch.from_numpy(x), torch.from_numpy(u)).numpy()
    assert fa_ops.launches == before          # the CPU runs the plain path
    assert got.shape == want.shape and got.dtype == np.float32
    # the same bins, and the same values to an ulp: XLA's f32 division on
    # the CPU is not correctly rounded (``lo + b / (bins - 1) * (hi - lo)``)
    np.testing.assert_array_equal(bins_of(got)[decisive],
                                  bins_of(want)[decisive])
    np.testing.assert_allclose(got[decisive], want[decisive], rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_predict_fn_contract(data):
    env, obs, act, nobs = data
    _, twm = _pair(env)
    _fit_norm(_pair(env)[0], twm, obs, nobs)
    fn = twm.predict_fn()
    assert fn.is_predict_fn
    x, u = torch.from_numpy(obs[:8]), torch.from_numpy(act[:8])
    out = fn(twm.params, x, u, None)
    assert out.shape == x.shape
    torch.testing.assert_close(out, twm.predict(x, u), rtol=0, atol=0)
    twm.update_normalizer(torch.from_numpy(obs[:10] * 5))
    # the normaliser captured when predict_fn was made, as the reference's
    torch.testing.assert_close(fn(twm.params, x, u, None), out, rtol=0,
                               atol=0)
    bad = api.as_predict_fn(lambda p, s, a, g: s[:, :2])
    with pytest.raises(ValueError, match="contract"):
        bad(None, x, u, None)


def test_improve_through_the_world_model_matches_jax(data):
    """One ME-PPO ``improve`` with ``predict_fn`` and the reference's draws
    (``algos.py:81-93``: per-step keys, the policy noise from each key's
    first half); both world models in f32. Horizon 1: a predicted state
    lies on a bin's edge, so tokenising it again for a second step turns an
    ulp of XLA's division (see the predict test) into another bin."""
    env, obs, act, nobs = data
    jwm, twm = _pair(env, seed=1, f32=True)
    _fit_norm(jwm, twm, obs, nobs)
    tenv = make_env("pendulum")
    B, H = 16, 1
    cfg = JA.AlgoConfig(algo="me-ppo", imagine_batch=B, imagine_horizon=H,
                        ppo_lr=1e-2)
    pol_cfg = JPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    ja = JA.make_algo(cfg, pol_cfg, jax.vmap(env.reward), env.reset_batch,
                      predict_fn=jwm.predict_fn())
    ta = A.make_algo(A.AlgoConfig(**vars(cfg)),
                     PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8),
                     tenv.reward, tenv.reset_batch,
                     predict_fn=twm.predict_fn())
    jstate = ja.init(jax.random.key(0))
    tstate = ta.init(policy=tree_from_jax(jax.tree.map(np.asarray,
                                                       jstate["policy"])))
    key = jax.random.key(12)
    jstate, jinfo = ja.improve(jstate, jwm.params, key)
    k0, k1 = jax.random.split(key)
    eps = jnp.stack([jax.random.normal(jax.random.split(k)[0],
                                       (B, env.act_dim))
                     for k in jax.random.split(k1, H)])
    draws = {"s0": torch.from_numpy(np.array(env.reset_batch(k0, B))),
             "eps": torch.from_numpy(np.array(eps))}
    tstate, tinfo = ta.improve(tstate, twm.params, draws)
    np.testing.assert_allclose(float(tinfo["imagined_return"]),
                               float(jinfo["imagined_return"]), rtol=TOL)
    got = jax.tree.leaves(tree_to_numpy(tstate["policy"]))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate["policy"]))
    for g, w in zip(got, want):
        _close(g, w, TOL)
    assert int(tstate["steps"]) == 1


def test_me_trpo_improves_on_the_bf16_world_model(data):
    """As the reference's ``test_wm_backed_policy_improvement``: ME-TRPO on
    the port's own bf16 world model, drawing from a generator."""
    env, obs, act, nobs = data
    _, twm = _pair(env)
    twm.update_normalizer(torch.from_numpy(np.concatenate([obs, nobs])))
    tenv = make_env("pendulum")
    algo = A.make_algo(A.AlgoConfig(algo="me-trpo", imagine_batch=8,
                                    imagine_horizon=6),
                       PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8),
                       tenv.reward, tenv.reset_batch,
                       predict_fn=twm.predict_fn())
    gen = torch.Generator().manual_seed(2)
    state, info = algo.improve(algo.init(gen), twm.params, generator=gen)
    assert int(state["steps"]) == 1
    assert np.isfinite(float(info["imagined_return"]))
