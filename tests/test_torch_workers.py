"""The collect -> learn -> publish slice of the PyTorch port against the JAX
reference, on the CPU at a small size: the ring buffer, the data server's
tickets, the no-retrace invariant in its eager form, the two workers, and
the whole model-learning worker held against the reference's.

Trajectories come from the reference's own env rollouts (numpy-seeded
policy params, ``jax.random`` draws), so both packages learn from the same
data. The reference's randomness is replayed into the port, never
re-derived: its model learner splits its key at construction
(``workers.py:340``) and before each epoch (``workers.py:401``), and its
ring trainer draws the index grid with ``randint`` inside its jit
(``dynamics.py:274``); the test makes the same calls and hands the grids
to the port through ``index_source``.

Tolerances (f32): ring contents are copies, so equal exactly; validation
losses agree to 1e-4 relative and params to 1e-4 after three epochs
(14 Adam steps; see ``test_torch_mbrl.py`` for why Adam needs 1e-4).
"""
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core import servers as JSRV
from repro.core import workers as JW
from repro.envs import arm as jarm
from repro.mbrl import dynamics as JDYN
from repro.mbrl import policy as JPI
from repro_torch.core import servers as SRV
from repro_torch.core import workers as W
from repro_torch.envs import arm as tarm
from repro_torch.mbrl import dynamics as DYN
from repro_torch.mbrl import policy as PI
from repro_torch.testing.parity import tree_from_jax, tree_to_numpy

PARAM_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _trajs(n, horizon=20, seed=0, env_name="pendulum"):
    """``n`` trajectories from the reference's own rollouts."""
    env = jarm.make_env(env_name)
    pp = JPI.init_policy(JPI.PolicyConfig(env.obs_dim, env.act_dim,
                                          hidden=16), jax.random.key(seed))
    keys = jax.random.split(jax.random.key(seed + 1), n)
    return [_np(env.rollout(k, JPI.sample_action, pp, horizon=horizon))
            for k in keys]


def _ring_equal(tbuf, jbuf):
    for view in ("train_view", "val_view"):
        (td, tsize), (jd, jsize) = getattr(tbuf, view)(), getattr(jbuf,
                                                                  view)()
        assert tsize == jsize, view
        assert set(td) == set(jd)
        for k in jd:
            np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]),
                                          err_msg=f"{view} {k}")
    assert tbuf.total_seen == jbuf.total_seen
    assert (tbuf.size, tbuf.val_size) == (jbuf.size, jbuf.val_size)


# ------------------------------------------------------------- servers
@pytest.mark.parametrize("pattern", [
    [1, 1, 1, 1, 1, 1, 1],        # single writes only
    [6, 3, 9, 1, 12],             # bursts over the burst capacity, wraps
    [2, 5, 1, 7, 4, 8],
])
def test_replay_buffer_contents_match_reference(pattern):
    trajs = _trajs(sum(pattern) + 1, horizon=7, seed=3)
    # one trajectory longer than the val ring: FIFO keeps its tail
    long = _trajs(1, horizon=19, seed=4)[0]
    jbuf = JSRV.ReplayBuffer(60, val_capacity=15, burst_capacity=4)
    tbuf = SRV.ReplayBuffer(60, val_capacity=15, burst_capacity=4)
    i = 0
    for n in pattern:
        group = trajs[i:i + n]
        i += n
        jbuf.extend(group)
        tbuf.extend([tree_from_jax(t) for t in group])
        _ring_equal(tbuf, jbuf)
    for _ in range(5):   # land the long one in the val ring, then train
        jbuf.extend([long])
        tbuf.extend([tree_from_jax(long)])
        _ring_equal(tbuf, jbuf)


def test_data_server_grants_land_exactly_with_refunds():
    ds = SRV.DataServer(claim_backoff=0.0)
    traj = {"obs": torch.zeros(4, 3)}
    ds.push(traj)                             # pushes need no claim
    ds.set_target(11)                         # 10 more from here
    assert ds.try_claim(0, 4) == 4
    assert ds.try_claim(1, 4) == 4
    assert ds.try_claim(2, 4) == 2            # min(k, remaining)
    assert ds.try_claim(0, 4) == 0
    batch = {"obs": torch.zeros(4, 4, 3)}
    ds.push_batch(batch, 4, collector_id=0)
    ds.push_batch({"obs": torch.zeros(1, 4, 3)}, 1, collector_id=1)
    assert ds.refund_inflight(1) == 3         # died mid-batch
    assert ds.refund_inflight(1) == 0
    assert ds.try_claim(3, 5) == 3
    ds.push_batch({"obs": torch.zeros(3, 4, 3)}, 3, collector_id=3)
    ds.push_batch({"obs": torch.zeros(2, 4, 3)}, 2, collector_id=2)
    assert ds.total_pushed == 11 and len(ds) == 11
    drained = ds.drain()
    assert len(drained) == 11 and len(ds) == 0
    assert drained[1]["obs"].shape == (4, 3)


def test_data_server_stays_exact_under_racing_collectors():
    """Eight threads with a short switch interval claim farm batches
    toward one target: the total lands exactly, never over."""
    ds = SRV.DataServer(claim_backoff=0.0)
    target, B = 203, 7
    ds.set_target(target)

    def collector(cid):
        while True:
            g = ds.try_claim(cid, B)
            if g == 0:
                return
            ds.push_batch({"x": torch.zeros(g, 2)}, g, collector_id=cid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=collector, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ds.total_pushed == target == len(ds.drain())


def test_parameter_server_snapshots_trees_and_gates_pulls():
    ps = SRV.ParameterServer()
    tree = {"members": {"w": [torch.ones(2, 3)], "b": [torch.zeros(2, 3)]},
            "norm": {"mu_in": torch.zeros(3)}}
    assert ps.push(tree) == 1
    tree["members"]["w"][0].add_(5.0)         # the pusher keeps training
    got, ver = ps.pull_if_newer(0)
    assert ver == 1 and float(got["members"]["w"][0].max()) == 1.0
    assert isinstance(got["members"]["w"], list)
    assert ps.pull_if_newer(1) == (None, 1)


# ------------------------------------------------------------- workers
CFG_J = JDYN.EnsembleConfig(obs_dim=3, act_dim=1, hidden=32, n_models=3,
                            train_batch=32)
CFG_T = DYN.EnsembleConfig(obs_dim=3, act_dim=1, hidden=32, n_models=3,
                           train_batch=32)


def test_model_learner_shape_count_stays_one_as_ring_fills():
    ds, ms = SRV.DataServer(), SRV.ParameterServer()
    w = W.ModelLearningWorker(CFG_T, ds, ms, seed=0, max_trajs=6,
                              device="cpu")
    trajs = _trajs(14, horizon=20, seed=5)
    losses = []
    for i, traj in enumerate(trajs):
        ds.push(tree_from_jax(traj))
        out = w.step()
        if i < 3:
            assert out is None                # below min_trajs
            continue
        losses.append(out)
        assert w.compile_count() == 1 and w.val_compile_count() == 1
    assert w.buffer.size == w.buffer.capacity == 120     # wrapped
    assert ms.version == w.epochs == len(losses) == 11
    assert all(np.isfinite(losses))


def test_collector_farm_lands_exactly_on_the_target():
    env = tarm.make_env("pendulum")
    pp = PI.init_policy(PI.PolicyConfig(3, 1, hidden=8),
                        torch.Generator().manual_seed(0))
    ps, ds = SRV.ParameterServer(), SRV.DataServer(claim_backoff=0.0)
    ds.set_target(7)
    col = W.DataCollectionWorker(env, ps, ds, pp, seed=1, envs_per_step=3,
                                 device="cpu")
    grants = []
    while (g := ds.try_claim(0, col.envs_per_step)) > 0:
        grants.append(g)
        assert col.step(g) == env.horizon * env.dt
        if len(grants) == 1:                  # a new policy mid-run
            ps.push(PI.init_policy(PI.PolicyConfig(3, 1, hidden=8),
                                   torch.Generator().manual_seed(2)))
    assert grants == [3, 3, 1] and ds.total_pushed == 7 == col.collected
    assert col._policy_ver == 1
    trajs = ds.drain()
    assert [t["obs"].shape for t in trajs] == [(200, 3)] * 7
    assert [t["rew"].shape for t in trajs] == [(200,)] * 7
    # lanes draw distinct streams; collector 0 is seeded with the seed
    assert not torch.equal(trajs[0]["obs"][0], trajs[1]["obs"][0])
    g0 = W.collector_generator(1, 0, "cpu")
    assert torch.equal(torch.rand(3, generator=g0),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(1)))
    g1 = W.collector_generator(1, 1, "cpu")
    assert not torch.equal(torch.rand(3, generator=g1),
                           torch.rand(3, generator=torch.Generator()
                                      .manual_seed(1)))


def test_exploration_schedule_matches_reference():
    for n in (1, 2, 4, 5):
        assert W.ExplorationSchedule.ladder(n) == \
            W.ExplorationSchedule(JW.ExplorationSchedule.ladder(n)
                                  .noise_scales)
    s = W.ExplorationSchedule((1.0, 1.3))
    assert [s.scale_for(i) for i in range(3)] == [1.0, 1.3, 1.0]


def test_model_learning_worker_slice_matches_reference():
    """The whole slice: the same reference-collected trajectories pushed
    into both packages' ModelLearningWorkers, the reference's key sequence
    replayed through ``index_source``; three epochs, with pushes between
    them, give the same validation losses, rings and published params."""
    trajs = _trajs(12, horizon=20, seed=6)
    key = jax.random.key(11)
    jds, jms = JSRV.DataServer(), JSRV.ParameterServer()
    jw = JW.ModelLearningWorker(CFG_J, jds, jms, key, max_trajs=10)
    replay = {"key": jax.random.split(key)[0]}    # workers.py:340

    def index_source(nb, bs, size):
        replay["key"], k = jax.random.split(replay["key"])   # :401
        idx = jax.random.randint(k, (nb, bs), 0, max(size, 1))  # :274
        return torch.from_numpy(np.array(idx)).long()

    tds, tms = SRV.DataServer(), SRV.ParameterServer()
    tw = W.ModelLearningWorker(CFG_T, tds, tms, seed=0,
                               params=tree_from_jax(_np(jw.params)),
                               max_trajs=10, index_source=index_source,
                               device="cpu")
    losses = []
    for lo, hi in ((0, 6), (6, 9), (9, 12)):
        for t in trajs[lo:hi]:
            jds.push(t)
            tds.push(tree_from_jax(t))
        jl, tl = jw.step(), tw.step()
        losses.append((jl, tl))
        _ring_equal(tw.buffer, jw.buffer)
    assert jms.version == tms.version == 3
    np.testing.assert_allclose([t for _, t in losses],
                               [j for j, _ in losses], rtol=1e-4)
    jp = _np(jms.pull()[0])
    tp = tree_to_numpy(tms.pull()[0])
    for g, w in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(g, w, **PARAM_TOL)
    assert tw.compile_count() == 1 == jw.compile_count()
