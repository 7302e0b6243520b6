"""The role-mesh path of the port's async MBRL engine against the JAX
reference, on the CPU, on stand-in meshes (``launch.mesh.make_mesh(n,
device="cpu")``: n entries of the one CPU device, the counterpart of the
reference's forced host devices).

* The sharded ring trainer (``make_ring_trainer(batch_sharding=)`` over a
  pre-sharded ``ReplayBuffer``) against the reference's ring trainer on
  the same draws (its own ``tests/_mesh_impl.py`` holds its sharded
  trainer to its single-device one), four epochs, at the reference's bound
  there: rtol 2e-5, atol 1e-6 (``tests/_mesh_impl.py:211-225``).
* Sharded imagination (the algorithms' ``_rollout(shard=True)`` after
  ``configure_mesh``, both steps, and each algorithm's sharded
  ``improve``) against the reference's and the port's single-device
  rollout.
* The sharded model learner: its ring stays sharded and FIFO across a
  wrap, and ``train_epoch`` keeps one input shape.
* Pulls: placement on a version change, the stored tensors themselves when
  already placed, zero copies on an unchanged version.
* Event- and threads-mode ``AsyncTrainer`` role splits, and ``--mesh``
  through the launcher; the reference's refusals that stand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime as JR
from repro.core import servers as JSRV
from repro.envs import make_env as jmake_env
from repro.mbrl import dynamics as JDYN
from repro.mbrl import policy as JPI
from repro_torch.core import AsyncTrainer, RunConfig
from repro_torch.core import roles as ROLES
from repro_torch.core import servers as SRV
from repro_torch.core import workers as W
from repro_torch.envs import make_env
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_mesh
from repro_torch.mbrl import algos as A
from repro_torch.mbrl import dynamics as DYN
from repro_torch.mbrl import policy as PI
from repro_torch.testing.parity import tree_from_jax, tree_to_numpy
from repro_torch.utils.tree import tree_leaves

CPU = torch.device("cpu")
MESH_TOL = dict(rtol=2e-5, atol=1e-6)     # tests/_mesh_impl.py:211-225
ROLL_TOL = dict(rtol=1e-4, atol=1e-4)     # a rollout across the packages
# params after one improve step, of their scale: a TRPO step moves by up
# to 9e-4 in f32 when only the batch's rows are reordered (the reference
# against itself, test_torch_improve.py); PPO and MB-MPO step through Adam
STEP_TOL = {"me-trpo": 1e-3, "me-ppo": 1e-4, "mb-mpo": 1e-4}
CFG = dict(obs_dim=3, act_dim=1, hidden=16, n_models=2, train_batch=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i"
                            else a)


def _traj(i, h=8, d=3, a=1):
    """A trajectory of ``tests/_mesh_impl.py``'s sizes, drawn by numpy."""
    rng = np.random.default_rng(i)
    obs = rng.standard_normal((h, d)).astype(np.float32)
    act = rng.standard_normal((h, a)).astype(np.float32)
    return {"obs": obs, "act": act,
            "next_obs": obs + 0.1 * act.sum(-1, keepdims=True)}


def _ensemble(cfg):
    """An ensemble drawn by the port, as numpy for the reference."""
    return tree_to_numpy(DYN.init_ensemble(cfg,
                                           torch.Generator().manual_seed(0)))


def _leaves_close(got, want, **tol):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **tol)


# ------------------------------------------------------ sharded training
def _reference_epochs(init, n_epochs=4):
    """``tests/_mesh_impl.py:_train_n_epochs`` on one device, from
    ``init``, with each epoch's index grid (the draw its jit makes from
    the epoch's key) recorded."""
    cfg = JDYN.EnsembleConfig(**CFG)
    key = jax.random.key(0)
    params = jax.tree.map(jnp.asarray, init)
    rb = JSRV.ReplayBuffer(64, holdout_frac=0.0)
    opt, train, val, norm = JDYN.make_ring_trainer(cfg, rb.capacity)
    state = opt.init(params)
    for i in range(6):
        rb.add_traj(_traj(i))
    grid = DYN.ring_grid(DYN.EnsembleConfig(**CFG), rb.capacity)
    losses, grids = [], []
    for e in range(n_epochs):
        data, size = rb.train_view()
        params = {**params, "norm": norm(data, size)}
        k = jax.random.fold_in(key, e)
        grids.append(_t(jax.random.randint(k, grid, 0, max(size, 1))))
        params, state, loss = train(params, state, data, size, k)
        losses.append(float(loss))
    data, size = rb.train_view()
    return grids, _np(params), losses, float(val(params, data, size))


def _port_epochs(init, grids, sharding):
    cfg = DYN.EnsembleConfig(**CFG)
    params = tree_from_jax(init)
    rb = SRV.ReplayBuffer(64, holdout_frac=0.0, sharding=sharding)
    assert rb.capacity == 64            # already a multiple of 4
    opt, train, val, norm = DYN.make_ring_trainer(
        cfg, rb.capacity, batch_sharding=sharding)
    state = opt.init(params)
    for i in range(6):
        rb.add_traj({k: torch.from_numpy(v) for k, v in _traj(i).items()})
    losses = []
    for idx in grids:
        data, size = rb.train_view()
        params = {**params, "norm": norm(data, size)}
        params, state, loss = train(params, state, data, size, idx)
        losses.append(float(loss))
    data, size = rb.train_view()
    return params, losses, float(val(params, data, size)), (
        train.shape_count, val.shape_count, norm.shape_count), data


def test_sharded_ring_epochs_match_the_reference():
    """Data-parallel over a 4-shard ring: the same epochs as the
    reference's one device (and the port's), same draws."""
    sh = ROLES.batch_sharded(make_mesh(4, device=CPU))
    assert ROLES.num_shards(sh) == 4
    init = _ensemble(DYN.EnsembleConfig(**CFG))
    grids, want_p, want_l, want_v = _reference_epochs(init)
    got_p, got_l, got_v, shapes, data = _port_epochs(init, grids, sh)
    one_p, one_l, one_v, _, _ = _port_epochs(init, grids, None)
    assert all(isinstance(v, ROLES.RowShards) and len(v.shards) == 4
               for v in data.values())
    np.testing.assert_allclose(got_l, want_l, **MESH_TOL)
    np.testing.assert_allclose(got_v, want_v, **MESH_TOL)
    for g, w in zip(jax.tree.leaves(tree_to_numpy(got_p)),
                    jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g, w, **MESH_TOL)
    np.testing.assert_allclose(got_l, one_l, **MESH_TOL)
    np.testing.assert_allclose(got_v, one_v, **MESH_TOL)
    _leaves_close(got_p, one_p, **MESH_TOL)
    assert shapes == (1, 1, 1)


def test_sharded_minibatch_gather_is_the_plain_gather():
    """The fixed-shape gather from a row-sharded ring into batch-sharded
    minibatches gives every row the plain ``ring[idx]`` gives, uneven
    blocks (bs = 6 over 4 shards) included."""
    gen = torch.Generator().manual_seed(0)
    ring = torch.randn(32, 3, generator=gen)
    idx = torch.randint(0, 32, (5, 6), generator=gen)
    data = {"obs": ROLES.RowShards(list(ring.split(8)))}
    parts = DYN._gather_grid(data, idx, [CPU] * 4)
    got = torch.cat([p["obs"] for p in parts if p is not None], dim=1)
    assert torch.equal(got, ring[idx])
    assert [None if p is None else p["obs"].shape[1] for p in parts] == \
        [2, 2, 2, None]


@pytest.mark.parametrize("src,dst", [(s, d) for s in (1, 2, 4)
                                     for d in (1, 3, 4, 7)])
def test_sharded_gather_at_any_shard_counts(src, dst):
    """The gather between any ring sharding (1, 2 or 4 blocks of a
    24-row ring) and any batch sharding (1, 3, 4 or 7 shards of 6-row
    minibatches: blocks of 2, 1 and none): every shard gets
    ``split_bounds``' block of each minibatch at the grid's shape, and
    the blocks joined are the plain ``ring[idx]``."""
    gen = torch.Generator().manual_seed(src * 10 + dst)
    ring = torch.randn(24, 2, 3, generator=gen)
    idx = torch.randint(0, 24, (5, 6), generator=gen)
    data = {"obs": ROLES.RowShards(list(ring.split(24 // src)))}
    parts = DYN._gather_grid(data, idx, [CPU] * dst)
    bounds = ROLES.split_bounds(6, dst)
    assert [None if p is None else tuple(p["obs"].shape) for p in parts] \
        == [None if hi == lo else (5, hi - lo, 2, 3) for lo, hi in bounds]
    got = torch.cat([p["obs"] for p in parts if p is not None], dim=1)
    assert torch.equal(got, ring[idx])


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8])
def test_sharded_ring_holds_what_one_device_holds(n):
    """A ``ReplayBuffer`` sharded n ways: its capacities rounded up to n,
    and after single writes and a burst that wrap the ring, every shard's
    block of the train and val rings is the block of an unsharded buffer
    of those capacities, on that shard's device."""
    sh = ROLES.batch_sharded(make_mesh(n, device=CPU))
    rb = SRV.ReplayBuffer(20, holdout_frac=0.25, sharding=sh)
    assert rb.capacity == ROLES.round_up(20, n)
    assert rb.val_capacity == ROLES.round_up(5, n)
    one = SRV.ReplayBuffer(rb.capacity, val_capacity=rb.val_capacity,
                           holdout_frac=0.25)
    trajs = [{k: torch.from_numpy(v) for k, v in _traj(i).items()}
             for i in range(9)]
    for buf in (rb, one):
        for t in trajs[:4]:
            buf.add_traj(t)
        buf.add_trajs(trajs[4:])
    assert (rb.size, rb.val_size) == (one.size, one.val_size)
    for view in ("train_view", "val_view"):
        got, want = getattr(rb, view)()[0], getattr(one, view)()[0]
        for k, rows in got.items():
            assert isinstance(rows, ROLES.RowShards)
            assert len(rows.shards) == n
            assert torch.equal(rows.full(), want[k])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_sharded_ring_epochs_match_one_device_at_any_shard_count(n):
    """The data-parallel epoch over n shards (16-row minibatches: 3 shards
    take blocks of 6, 6 and 4; 5 take four of 4 and an empty last; 8 take
    2 each) against the port's one device, on the same grids: losses, val
    loss and every leaf within the reference's bound, one input shape."""
    cfg = DYN.EnsembleConfig(**CFG)
    init = tree_from_jax(_ensemble(cfg))
    gen = torch.Generator().manual_seed(n)
    grids = [torch.randint(0, 7 * 8, DYN.ring_grid(cfg, 120), generator=gen)
             for _ in range(3)]
    out = []
    for sharding in (ROLES.batch_sharded(make_mesh(n, device=CPU)), None):
        rb = SRV.ReplayBuffer(120, holdout_frac=0.0, sharding=sharding)
        assert rb.capacity == 120           # a multiple of every n here
        opt, train, val, norm = DYN.make_ring_trainer(
            cfg, rb.capacity, batch_sharding=sharding)
        params, state = init, opt.init(init)
        for i in range(7):
            rb.add_traj({k: torch.from_numpy(v)
                         for k, v in _traj(i).items()})
        losses = []
        for idx in grids:
            data, size = rb.train_view()
            params = {**params, "norm": norm(data, size)}
            params, state, loss = train(params, state, data, size, idx)
            losses.append(float(loss))
        data, size = rb.train_view()
        out.append((params, losses, float(val(params, data, size))))
        assert (train.shape_count, val.shape_count) == (1, 1)
    (got_p, got_l, got_v), (one_p, one_l, one_v) = out
    np.testing.assert_allclose(got_l, one_l, **MESH_TOL)
    np.testing.assert_allclose(got_v, one_v, **MESH_TOL)
    _leaves_close(got_p, one_p, **MESH_TOL)


# --------------------------------------------------- sharded imagination
@pytest.mark.parametrize("fused", [True, False])
def test_sharded_imagination_matches_the_reference(fused):
    """``tests/_mesh_impl.py``'s case: B = 16 starts over 4 shards, H = 12,
    the reference's draws replayed."""
    tenv = make_env("pendulum")
    H, B, key = 12, 16, jax.random.key(2)
    gen = torch.Generator().manual_seed(1)
    tp = DYN.init_ensemble(DYN.EnsembleConfig(tenv.obs_dim, tenv.act_dim,
                                              hidden=16, n_models=3), gen)
    tpol = PI.init_policy(PI.PolicyConfig(tenv.obs_dim, tenv.act_dim,
                                          hidden=8), gen)
    s0 = tenv.reset_batch(gen, B)
    params, pol = (jax.tree.map(jnp.asarray, tree_to_numpy(t))
                   for t in (tp, tpol))
    ka, kp = jax.random.split(key)
    members = _t(JDYN.sample_members(params, kp, (H, B)))
    eps = _t(JDYN.hoisted_noise(ka, H, B, tenv.act_dim))
    cfg = A.AlgoConfig(imagine_batch=B, imagine_horizon=H, n_models=3)
    pol_cfg = PI.PolicyConfig(tenv.obs_dim, tenv.act_dim, hidden=8)
    draws = {"s0": s0, "members": members, "eps": eps}

    def port(mesh):
        a = A.make_algo(cfg, pol_cfg, tenv.reward, tenv.reset_batch,
                        mesh=mesh)
        obs, pre, rew = a._rollout(tp, tpol, draws, None, shard=True,
                                   fused=fused)
        return {"obs": obs, "act": torch.tanh(pre), "rew": rew}
    got, one = port(make_mesh(4, device=CPU)), port(None)
    for k in ("obs", "act", "rew"):
        assert got[k].shape == one[k].shape
        np.testing.assert_allclose(got[k].numpy(), one[k].numpy(),
                                   **MESH_TOL)
    if fused:       # the legacy path draws per-step keys in the reference
        env = jmake_env("pendulum")
        want = JDYN.imagine_rollout(params, JPI.sample_action, pol,
                                    jnp.asarray(s0.numpy()), key, H,
                                    jax.vmap(env.reward))
        for k in ("obs", "act", "rew"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **ROLL_TOL)


@pytest.mark.parametrize("n", [1, 3, 5, 16, 24])
def test_sharded_rollout_matches_one_device_at_any_shard_count(n, monkeypatch):
    """``_rollout(shard=True)`` over n stand-in shards of B = 16 starts:
    uneven blocks (3 shards: 6, 6, 4), an empty last shard (5: 4 rows
    each and none), one row a shard (16) and more shards than rows (24).
    Each non-empty shard rolls its block once; the joined rollout is the
    one-device rollout."""
    env = make_env("pendulum")
    cfg = A.AlgoConfig(imagine_batch=16, imagine_horizon=6, n_models=3)
    pol_cfg = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    gen = torch.Generator().manual_seed(5)
    model = DYN.init_ensemble(DYN.EnsembleConfig(env.obs_dim, env.act_dim,
                                                 hidden=16, n_models=3), gen)
    one = A.make_algo(cfg, pol_cfg, env.reward, env.reset_batch)
    draws = one.draw(model, gen)
    pol = one.init(gen)["policy"]
    want = one._rollout(model, pol, draws, None, shard=True)
    blocks = []
    orig = A._rollout_with_logp

    def counted(model_params, pol_params, s0, *a, **kw):
        blocks.append(s0.shape[0])
        return orig(model_params, pol_params, s0, *a, **kw)
    monkeypatch.setattr(A, "_rollout_with_logp", counted)
    sharded = A.make_algo(cfg, pol_cfg, env.reward, env.reset_batch,
                          mesh=make_mesh(n, device=CPU))
    got = sharded._rollout(model, pol, draws, None, shard=True)
    assert blocks == [hi - lo for lo, hi in ROLES.split_bounds(16, n)
                      if hi > lo]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **MESH_TOL)


@pytest.mark.parametrize("algo", ["me-trpo", "me-ppo", "mb-mpo"])
def test_sharded_improve_matches_one_device(algo):
    """``configure_mesh``: ME-* imagination sharded over 4 shards, the
    statistics on the joined batch; MB-MPO replicated. The same step as
    one device on the same draws, and one ``improve`` shape."""
    env = make_env("pendulum")
    pol_cfg = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    cfg = A.AlgoConfig(algo=algo, imagine_batch=16, imagine_horizon=5,
                       n_models=2)
    gen = torch.Generator().manual_seed(0)
    model = DYN.init_ensemble(DYN.EnsembleConfig(env.obs_dim, env.act_dim,
                                                 hidden=8, n_models=2), gen)
    out = []
    for mesh in (None, make_mesh(4, device=CPU)):
        a = A.make_algo(cfg, pol_cfg, env.reward, env.reset_batch,
                        mesh=mesh)
        state = a.init(torch.Generator().manual_seed(1))
        draws = a.draw(model, torch.Generator().manual_seed(2))
        state, info = a.improve(state, model, draws)
        out.append((state["policy"], info["imagined_return"]))
        assert a.shape_count() == 1
        assert (a._batch_sharding is None) == (mesh is None)
    # the rollout itself at the mesh bound; the stepped params to
    # STEP_TOL of their scale (TRPO's conjugate gradient amplifies the
    # rollout's rounding, test_torch_improve.py)
    np.testing.assert_allclose(float(out[1][1]), float(out[0][1]),
                               **MESH_TOL)
    tol = STEP_TOL[algo]
    for g, w in zip(tree_leaves(out[1][0]), tree_leaves(out[0][0])):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                                   atol=tol * max(1.0, float(w.abs().max())))


# ------------------------------------------------ the sharded model worker
def test_sharded_learner_ring_stays_sharded_across_a_wrap():
    """``tests/_mesh_impl.py``'s no-retrace case: 10 trajectories into a
    ring of 6 (it wraps and evicts). The storage stays 4 blocks, holds
    what the one-device learner's ring holds, and ``train_epoch`` sees one
    input shape after warmup."""
    mesh = make_mesh(4, device=CPU)
    cfg = DYN.EnsembleConfig(**CFG)
    learners = []
    for m in (mesh, None):
        ds, ms = SRV.DataServer(), SRV.ParameterServer()
        w = W.ModelLearningWorker(cfg, ds, ms, seed=0, max_trajs=6,
                                  early_stop=False, min_trajs=2, mesh=m,
                                  device=CPU)
        for i in range(10):
            ds.push({k: torch.from_numpy(v) for k, v in _traj(i).items()})
            w.step()
        learners.append(w)
    sharded, one = learners
    assert sharded.epochs == one.epochs >= 8
    assert sharded.compile_count() == 1 and sharded.val_compile_count() == 1
    assert sharded.buffer.capacity == one.buffer.capacity == 48
    for (got, gs), (want, ws) in ((sharded.buffer.train_view(),
                                   one.buffer.train_view()),
                                  (sharded.buffer.val_view(),
                                   one.buffer.val_view())):
        assert gs == ws
        for k in want:
            assert isinstance(got[k], ROLES.RowShards)
            assert len(got[k].shards) == 4
            assert torch.equal(got[k].full(), want[k])
    # the same draws (one generator on the home device): the same model
    _leaves_close(sharded.params, one.params, rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- the pulls
def test_pull_places_once_and_unchanged_pulls_copy_nothing(monkeypatch):
    """A version change lands on the puller's device (``meta`` stands in
    for another card here: a real device-to-device copy, no data); an
    already-placed pull returns the stored tensors themselves; 32 unchanged
    pulls make no copy and touch no tensor."""
    ps = SRV.ParameterServer()
    ver = ps.push({"w": torch.ones(32, 32), "b": torch.zeros(32)})
    other = ROLES.replicated(ROLES.Mesh([torch.device("meta")], ("data",)))
    here = ROLES.replicated(make_mesh(2, device=CPU))
    val, got = ps.pull_if_newer(0, sharding=other)
    assert got == ver and all(t.device.type == "meta"
                              for t in tree_leaves(val))
    same, _ = ps.pull_if_newer(0, sharding=here)
    stored, _ = ps.pull()
    assert all(a is b for a, b in zip(tree_leaves(same),
                                      tree_leaves(stored)))
    calls = []
    monkeypatch.setattr(SRV, "tree_to",
                        lambda *a: calls.append("tree_to"))
    monkeypatch.setattr(SRV, "_hand_over",
                        lambda *a: calls.append("_hand_over"))
    for _ in range(32):
        none_val, got2 = ps.pull_if_newer(ver, sharding=other)
        assert none_val is None and got2 == ver
    assert calls == []


def test_cross_process_stores_take_a_sharding_for_parity():
    import inspect
    from repro_torch.net.client import TcpParameterServer
    for cls in (SRV.ShmParameterServer, TcpParameterServer):
        assert "sharding" in inspect.signature(
            cls.pull_if_newer).parameters


# ------------------------------------------------------ the engine on a mesh
def _parts(algo="me-trpo"):
    env = make_env("pendulum")
    ens = DYN.EnsembleConfig(env.obs_dim, env.act_dim, hidden=16, n_models=2)
    pol = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8)
    acfg = A.AlgoConfig(algo=algo, imagine_batch=16, imagine_horizon=10,
                        n_models=2)
    return env, ens, A.make_algo(acfg, pol, env.reward, env.reset_batch)


@pytest.mark.parametrize("mode", ["event", "threads"])
def test_role_split_run_completes(mode):
    """``tests/_mesh_impl.py``'s threads case, in both engines: an
    8-entry mesh split (1, 2, 1), three trajectories exactly."""
    env, ens, algo = _parts()
    tr = AsyncTrainer(env, ens, algo,
                      RunConfig(total_trajs=3, seed=0, min_warmup_trajs=2),
                      mode=mode, mesh=make_mesh(8, device=CPU),
                      role_ratios=(1, 2, 1))
    assert tr.roles is not None and not tr.roles.shared
    assert tr.roles.model.size == 4 and tr.roles.describe()["collector"] == [2]
    assert algo._batch_sharding == ROLES.batch_sharded(tr.roles.policy,
                                                       "data")
    assert tr.model_worker._batch_shard == ROLES.batch_sharded(
        tr.roles.model, "data")
    trace = tr.run()
    assert tr.data_server.total_pushed == 3 and trace[-1]["trajs"] == 3
    times = [r["time"] for r in trace]
    assert times == sorted(times)
    assert all(np.isfinite(r["eval_return"]) for r in trace)
    assert tr.model_worker.compile_count() <= 1
    assert tr.policy_worker.compile_count() <= 1
    if tr.model_worker.buffer is not None:
        storage, _ = tr.model_worker.buffer.train_view()
        assert all(len(v.shards) == 4 for v in storage.values())


def test_roles_given_directly_and_split_along_their_axis():
    """A ``RoleSplit`` passed as ``roles=``; on a (2, 4) mesh the workers
    shard along the axis the split was carved on, not axis_names[0]."""
    env, ens, algo = _parts()
    mesh = ROLES.Mesh(np.array([CPU] * 8, dtype=object).reshape(2, 4),
                      ("pod", "data"))
    roles = ROLES.split_roles(mesh, ratios=(1, 2, 1))
    tr = AsyncTrainer(env, ens, algo, RunConfig(total_trajs=1, seed=0),
                      roles=roles)
    assert tr.roles is roles and roles.axis == "data" and not roles.shared
    assert tr.model_worker._batch_shard.spec == ("data",)
    assert algo._batch_sharding.spec == ("data",)
    assert [c._sharding for c in tr.collectors] == [
        ROLES.collector_sharding(roles.collector, 0)]


def test_procs_with_a_mesh_raises_the_reference_error():
    env, ens, algo = _parts()
    with pytest.raises(ValueError) as got:
        AsyncTrainer(env, ens, algo, RunConfig(total_trajs=1), mode="procs",
                     mesh=make_mesh(4, device=CPU))
    jenv = jmake_env("pendulum")
    with pytest.raises(ValueError) as want:
        JR.AsyncTrainer(jenv, None, None, JR.RunConfig(total_trajs=1),
                        mode="procs", algo_cfg=object(), pol_cfg=object(),
                        mesh=object())
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flags", [["--mode", "event", "--mesh", "4"],
                                   ["--mode", "threads", "--mesh", "4"],
                                   ["--mesh", "auto"]])
def test_launcher_mesh_runs(flags, recwarn):
    trace = launch.main(["--env", "pendulum", "--n-models", "2",
                         "--model-hidden", "16", "--policy-hidden", "8",
                         "--imagine-batch", "8", "--imagine-horizon", "5",
                         "--trajs", "3", "--no-early-stop", "--device",
                         "cpu"] + flags)
    assert trace[-1]["trajs"] == 3
    # four entries split (1, 2, 1); the one CPU device falls back shared
    shared = [w for w in recwarn.list if "shared sub-meshes" in
              str(w.message)]
    assert bool(shared) == (flags[-1] == "auto")


def test_launcher_mesh_with_a_synchronous_engine_exits_as_the_reference():
    with pytest.raises(SystemExit, match="--mesh is only supported by "
                       "--engine async"):
        launch.main(["--engine", "sequential", "--mesh", "2", "--device",
                     "cpu"])


# ------------------------------------------------- chip_smoke.py rehearsal
@pytest.fixture
def kernel_stand_ins(monkeypatch):
    """The card's ``gmm_equal``, ``gmm_ragged`` and ``imag_fused`` wrappers
    replaced by their plain versions under ``no_grad``, the dispatchers
    routed to them and the counters from 0; ``torch.cuda.synchronize`` a
    no-op."""
    from repro_torch.kernels.gmm import cuda as gmm_cuda
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm import ref as gmm_ref
    from repro_torch.kernels.imag import cuda as imag_cuda
    from repro_torch.kernels.imag import ops as imag_ops
    from repro_torch.kernels.imag import ref as imag_ref

    def sizes(offsets):
        return (offsets[1:] - offsets[:-1]).long()

    def no_grad(fn):
        def run(*args):
            with torch.no_grad():
                return fn(*args)
        return run

    def fused_step_sorted(members, norm, pol, s, eps, offsets):
        gid = torch.repeat_interleave(torch.arange(sizes(offsets).numel()),
                                      sizes(offsets))
        with torch.no_grad():
            return imag_ref.fused_step(members, norm, pol, s, eps, gid)

    monkeypatch.setattr(gmm_ops, "_use_kernel", lambda t, impl: impl != "ref")
    monkeypatch.setattr(gmm_cuda, "gmm_equal", no_grad(torch.matmul))
    monkeypatch.setattr(gmm_cuda, "gmm_ragged", no_grad(
        lambda a, b, offs: gmm_ref.grouped_matmul(a, b, sizes(offs))))
    monkeypatch.setattr(imag_ops, "uses_kernel",
                        lambda t, impl=None: impl != "ref")
    monkeypatch.setattr(imag_cuda, "fused_step_sorted", fused_step_sorted)
    for name in ("equal_launches", "equal_bwd_launches", "ragged_launches"):
        monkeypatch.setattr(gmm_ops, name, 0)
    monkeypatch.setattr(imag_ops, "launches", 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return gmm_ops, imag_ops


def _chip(monkeypatch):
    """``chip_smoke.py`` as a module, at the small sizes below."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke_mesh",
                                                  root / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    env = make_env("pendulum")
    ens = DYN.EnsembleConfig(env.obs_dim, env.act_dim, hidden=16,
                             n_models=2)
    pol = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=16)
    acfg = A.AlgoConfig(algo="me-trpo", imagine_batch=8,
                        imagine_horizon=10, n_models=2)

    def parts():
        return env, ens, acfg, A.make_algo(acfg, pol, env.reward,
                                           env.reset_batch)
    monkeypatch.setattr(chip, "engine_parts", parts)
    monkeypatch.setattr(chip, "LEARN_ENV", "pendulum")
    monkeypatch.setattr(chip, "POLICY_HIDDEN", 16)
    monkeypatch.setattr(chip, "ROLE_MESH_WRAP_TRAJS", 2)
    # a ring of 4 of its 5 trajectories: capacities that 4 shards divide
    monkeypatch.setattr(chip, "ROLE_MESH_SMALL_TRAJS", 4)
    return chip, env, ens, pol


@pytest.mark.timeout(120)
def test_chip_smoke_role_mesh_checks_pass_on_the_cpu(kernel_stand_ins,
                                                     monkeypatch):
    """A rehearsal of ``role_mesh``'s sharded learner and sharded
    imagination on a 4-entry CPU mesh at small sizes: their checks pass,
    the launches split evenly over the shards, and the records
    serialise."""
    import json
    gmm_ops, imag_ops = kernel_stand_ins
    chip, env, ens, pol = _chip(monkeypatch)
    ds, ms = SRV.DataServer(), SRV.ParameterServer()
    learner = W.ModelLearningWorker(ens, ds, ms, seed=0, max_trajs=4,
                                    early_stop=False, device=CPU)
    gen = torch.Generator().manual_seed(0)
    batch = env.rollout_batch(PI.sample_action, PI.init_policy(pol, gen), 5,
                              generator=gen)
    for i in range(5):
        ds.push({k: v[i] for k, v in batch.items()})
    learner.step()
    mesh = make_mesh(4, device=CPU)
    learned = chip.role_mesh_learner(learner, gmm_ops, mesh)
    assert all(learned.pop("checks").values())
    for part in ("reference_grid", "full_ring"):
        by_shard = learned[part]["gmm_equal_launches_by_shard"]
        assert len(by_shard) == 4 and len({str(s) for s in by_shard}) == 1
    improved = chip.role_mesh_improver(ms.pull()[0], gmm_ops, imag_ops,
                                       mesh)
    assert all(improved.pop("checks").values())
    assert improved["imag_fused_launches_by_shard"] == [100] * 4
    assert improved["legacy"]["launches_by_shard"] == [150] * 4
    assert improved["row_coupling"]["rows"] == [64, [16] * 4]
    json.dumps([learned, improved])


@pytest.mark.timeout(120)
def test_chip_smoke_role_mesh_threads_run_on_the_cpu(kernel_stand_ins,
                                                     monkeypatch):
    """A rehearsal of ``role_mesh``'s threads run: ``threads_run`` on a
    4-entry CPU mesh split (1, 2, 1), its checks (two model shards' epoch
    launches) passing."""
    gmm_ops, imag_ops = kernel_stand_ins
    chip, *_ = _chip(monkeypatch)
    trainer, threads = chip.threads_run(
        "role_mesh_threads", gmm_ops, imag_ops,
        dict(total_trajs=4, min_warmup_trajs=2, pace_collection=True,
             collect_speed=80.0, eval_rollouts=1),
        mesh=make_mesh(4, device=CPU), role_ratios=(1, 2, 1))
    assert threads["trajs"] == 4 and threads["model_epochs"] >= 1
    assert ROLES.num_shards(trainer.model_worker._batch_shard) == 2
