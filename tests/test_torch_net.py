"""The port's socket transport (``repro_torch.net``) on the CPU, held
against the reference's ``repro.net``.

Wire parity: for the same inputs the port's frames, leaf payloads (f32 and
bf16) and tree frames are the reference's bytes, and each package decodes
the other's. Cross-package loopback in one process, both ways: the port's
clients against the reference's ``ControlPlane`` and the reference's
clients against the port's, with templates on both sides (the codec blob
and the JOIN ticket are pickles of each package's own classes, so a
cross-package join is not possible). Then the port counterpart of every
case in ``tests/test_net.py``: the frame layer, version gating and zero
array bytes on an unchanged pull, tickets, refunds, backpressure,
reconnects, pickled handles, JOIN tickets, a producer process killed
mid-batch, threads + tcp landing exactly, procs + tcp exact under a
collector SIGKILL with the invariant monitor, and a joiner contributing
trajectories to a procs run. Nothing here makes a ``/dev/shm`` object:
spawned producers are synchronised through the plane itself.
"""
import os
import pickle
import signal
import socket
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import runtime as TR
from repro_torch.core import servers as TS
from repro_torch.envs import make_env
from repro_torch.mbrl import algos as TA
from repro_torch.mbrl import dynamics as TD
from repro_torch.mbrl import policy as TPI
from repro_torch.net import (ControlPlane, ProtocolError, TcpDataServer,
                             TcpParameterServer, parse_addr)
from repro_torch.net import frame as F

SEED = 0


def small_cfgs(env):
    ens = TD.EnsembleConfig(env.obs_dim, env.act_dim, hidden=32, n_models=2)
    pol = TPI.PolicyConfig(env.obs_dim, env.act_dim, hidden=16)
    acfg = TA.AlgoConfig(algo="me-trpo", imagine_batch=16,
                         imagine_horizon=15, n_models=2)
    return ens, pol, acfg


def _bf16_bits(rng, shape):
    """Seeded bf16 values as (uint16 bits, the torch tensor)."""
    f = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(f).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16), t


# ------------------------------------------------------------ wire parity
def test_frames_equal_the_references_bytes():
    from repro.net import frame as JF
    for op, word, aux, flags, payload in [
            (F.OP_PPUSH, -7, 3, 2, b"hello"), (F.OP_OK, 0, 0, 0, b""),
            (F.OP_DPUSH, 30000, 5, 4, bytes(range(200))),
            (F.OP_JOIN, 2 ** 62, -1, 65535, b"x")]:
        got = F.pack_frame(op, word=word, aux=aux, flags=flags,
                           payload=payload)
        assert got == JF.pack_frame(op, word=word, aux=aux, flags=flags,
                                    payload=payload)
        assert len(got) == F.HEADER_SIZE + len(payload) == 32 + len(payload)
    for name in [n for n in dir(JF) if n.startswith("OP_")] + ["MAGIC"]:
        assert getattr(F, name) == getattr(JF, name), name


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_leaf_payloads_equal_the_references_and_cross_decode(bf16):
    import ml_dtypes

    from repro.checkpoint.io import LeafCodec as JCodec
    from repro.net import frame as JF
    from repro_torch.checkpoint.io import LeafCodec as TCodec
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    n = np.asarray([7, 9], np.int32)
    jtree = {"w": w, "n": n, "b": {"c": rng.standard_normal(5).astype(
        np.float32)}}
    ttree = {"w": torch.from_numpy(w), "n": torch.from_numpy(n),
             "b": {"c": torch.from_numpy(jtree["b"]["c"])}}
    if bf16:
        bits, t = _bf16_bits(rng, (2, 3))
        jtree["h"] = bits.view(ml_dtypes.bfloat16)
        ttree["h"] = t
    jcodec, tcodec = JCodec(jtree), TCodec(ttree)
    jpay = JF.encode_leaves(jcodec, jtree)
    tpay = F.encode_leaves(tcodec, ttree)
    assert tpay == jpay
    # each package decodes the other's bytes
    back = F.decode_leaves(tcodec, jpay)
    jback = JF.decode_leaves(jcodec, tpay)
    for k in ("w", "n"):
        np.testing.assert_array_equal(back[k].numpy(), jtree[k])
        np.testing.assert_array_equal(jback[k], jtree[k])
    if bf16:
        assert back["h"].dtype == torch.bfloat16
        assert torch.equal(back["h"].view(torch.int16), ttree["h"].view(
            torch.int16))
        assert jback["h"].dtype == np.dtype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(jback["h"].view(np.uint16), bits)
    with pytest.raises(ProtocolError):
        F.decode_leaves(tcodec, tpay[:-1])


def test_tree_frames_equal_the_references_and_cross_decode():
    import ml_dtypes

    from repro.net import frame as JF
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((5, 3)).astype(np.float32)
    bits, act = _bf16_bits(rng, (5, 1))
    done = np.asarray([0, 0, 0, 0, 1], np.bool_)
    jtree = {"obs": obs, "act": bits.view(ml_dtypes.bfloat16),
             "done": done}
    ttree = {"obs": torch.from_numpy(obs), "act": act,
             "done": torch.from_numpy(done)}
    jpay, tpay = JF.encode_tree(jtree), F.encode_tree(ttree)
    assert tpay == jpay
    # numpy leaves give the same bytes too
    assert F.encode_tree({"obs": obs, "done": done}) == \
        JF.encode_tree({"obs": obs, "done": done})
    back, jback = F.decode_tree(jpay), JF.decode_tree(tpay)
    assert back["act"].dtype == torch.bfloat16
    assert torch.equal(back["act"].view(torch.int16), act.view(torch.int16))
    np.testing.assert_array_equal(back["obs"].numpy(), obs)
    assert back["done"].dtype == torch.bool
    assert jback["act"].dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(jback["act"].view(np.uint16), bits)
    np.testing.assert_array_equal(jback["done"], done)
    items = [(1, tpay), (3, b"abc")]
    assert F.pack_drain_items(items) == JF.pack_drain_items(items)
    assert F.unpack_drain_items(JF.pack_drain_items(items), 2) == items


# ------------------------------------------- cross-package loopback
def _loopback_checks(plane_ps, client_ps, plane_ds, client_ds,
                     backpressure_ds):
    """One sequence over a plane of one package, through its own clients
    and the other package's: version gating, zero array bytes on an
    unchanged pull, tickets, refunds, drains and the backpressure text.
    Returns the backpressure error."""
    to_np = np.asarray
    params = {"w": np.arange(12, dtype=np.float32).reshape(4, 3)}
    assert client_ps.pull_if_newer(0) == (None, 0)
    assert plane_ps.push(params) == 1
    got, ver = client_ps.pull_if_newer(0)
    assert ver == 1
    np.testing.assert_array_equal(to_np(got["w"]), params["w"])
    nbytes = client_ps.array_bytes_received
    assert nbytes == 12 * 4
    for _ in range(20):
        assert client_ps.pull_if_newer(1) == (None, 1)
    assert client_ps.array_bytes_received == nbytes
    assert client_ps.push({"w": params["w"] * 2}) == 2
    got, ver = plane_ps.pull_if_newer(1)
    assert ver == 2
    np.testing.assert_array_equal(to_np(got["w"]), params["w"] * 2)
    assert client_ds.try_claim(0, k=3) == 3
    assert plane_ds.try_claim(1, k=3) == 2
    assert client_ds.try_claim(0, k=1) == 0
    assert client_ds.refund_inflight(1) == 2
    assert client_ds.refund_inflight(1) == 0
    client_ds.push({"x": np.full((2,), 5.0, np.float32)}, collector_id=0)
    client_ds.push_batch({"x": np.ones((2, 2), np.float32)}, 2,
                         collector_id=0)
    assert plane_ds.total_pushed == 3 and len(plane_ds) == 2
    assert plane_ds.refund_inflight(0) == 0
    drained = plane_ds.drain()
    assert len(drained) == 3
    np.testing.assert_array_equal(to_np(drained[0]["x"]), [5.0, 5.0])
    backpressure_ds.push({"x": np.zeros(1, np.float32)})
    with pytest.raises(Exception) as ei:
        backpressure_ds.push({"x": np.zeros(1, np.float32)})
    msg = str(ei.value)
    assert "1 (maxsize)" in msg and "model worker" in msg
    assert "push_timeout_s" in msg
    return ei.value


def test_port_clients_against_the_references_plane():
    from repro.net import ControlPlane as JPlane
    tmpl = {"w": np.zeros((4, 3), np.float32)}
    with JPlane() as plane:
        jps = plane.parameter_server("model", template=tmpl)
        jds = plane.data_server(n_collectors=2, target=5)
        tps = TcpParameterServer(plane.connect_addr, jps.store_id, "model",
                                 template=tmpl)
        tds = TcpDataServer(plane.connect_addr, n_collectors=2)
        with JPlane() as small:
            tbp = TcpDataServer(small.connect_addr, push_timeout=0.2)
            small.data_server(maxsize=1).close()
            err = _loopback_checks(jps, tps, jds, tds, tbp)
            assert isinstance(err, TS.BackpressureError)
            tbp.close()
        for h in (jps, jds, tps, tds):
            h.close()


def test_reference_clients_against_the_port_plane():
    from repro.core.servers import BackpressureError as JBE
    from repro.net.client import TcpDataServer as JData
    from repro.net.client import TcpParameterServer as JParams
    tmpl = {"w": np.zeros((4, 3), np.float32)}
    with ControlPlane() as plane:
        tps = plane.parameter_server("model", template=tmpl)
        tds = plane.data_server(n_collectors=2, target=5)
        jps = JParams(plane.connect_addr, tps.store_id, "model",
                      template=tmpl)
        jds = JData(plane.connect_addr, n_collectors=2)
        with ControlPlane() as small:
            jbp = JData(small.connect_addr, push_timeout=0.2)
            small.data_server(maxsize=1).close()
            err = _loopback_checks(tps, jps, tds, jds, jbp)
            assert isinstance(err, JBE)
            jbp.close()
        for h in (jps, jds, tps, tds):
            h.close()


# ------------------------------------------------------------ frame layer
def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        F.send_frame(a, F.OP_PPUSH, word=-7, aux=3, flags=2,
                     payload=b"hello")
        op, word, aux, flags, payload = F.recv_frame(b)
        assert (op, word, aux, flags, payload) == \
            (F.OP_PPUSH, -7, 3, 2, b"hello")
        F.send_frame(b, F.OP_OK)        # header-only reply: 32 bytes
        assert F.recv_frame(a) == (F.OP_OK, 0, 0, 0, b"")
    finally:
        a.close()
        b.close()


def test_frame_rejects_bad_magic_and_truncation():
    a, b = socket.socketpair()
    try:
        a.sendall(b"XXXX" + b"\0" * 28)     # full header, wrong magic
        with pytest.raises(ProtocolError):
            F.recv_frame(b)
        a.close()                           # now: truncated header
        with pytest.raises(ProtocolError):
            F.recv_frame(b)
    finally:
        b.close()


def test_leaf_payload_roundtrip_incl_bf16():
    from repro_torch.checkpoint.io import LeafCodec
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)},
            "n": torch.tensor([7, 9], dtype=torch.int32)}
    codec = LeafCodec(tree)
    payload = F.encode_leaves(codec, tree)
    assert len(payload) == sum(int(n) for n in codec.nbytes)
    got = F.decode_leaves(codec, payload)
    assert torch.equal(got["w"], tree["w"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert got["b"]["c"].float().tolist() == [1.5, -2.0]
    assert got["n"].tolist() == [7, 9]
    # a codec pickles to its layout and decodes into CPU tensors
    again = F.decode_leaves(pickle.loads(pickle.dumps(codec)), payload)
    assert torch.equal(again["w"], tree["w"])
    with pytest.raises(ProtocolError):
        F.decode_leaves(codec, payload[:-1])    # truncated payload


def test_tree_frame_roundtrip_and_truncation():
    tree = {"obs": torch.ones((5, 3)),
            "act": torch.full((5, 1), 0.5, dtype=torch.bfloat16),
            "done": torch.tensor([0, 0, 0, 0, 1], dtype=torch.bool)}
    payload = F.encode_tree(tree)
    got = F.decode_tree(payload)
    assert set(got) == set(tree)
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])
    for cut in (2, len(payload) // 2, len(payload) - 1):
        with pytest.raises(ProtocolError):
            F.decode_tree(payload[:cut])


def test_parse_addr():
    assert parse_addr("10.0.0.5:7447") == ("10.0.0.5", 7447)
    assert parse_addr(":7447") == ("0.0.0.0", 7447)


# ------------------------------------------------------- parameter stores
def test_param_push_pull_version_gating():
    with ControlPlane() as plane:
        ps = plane.parameter_server(
            "model", template={"w": torch.zeros((4, 3))})
        assert ps.pull_if_newer(0) == (None, 0)     # nothing pushed yet
        params = {"w": torch.arange(12, dtype=torch.float32).reshape(4, 3)}
        assert ps.push(params) == 1
        got, ver = ps.pull_if_newer(0)
        assert ver == 1 and torch.equal(got["w"], params["w"])
        assert ps.push(params) == 2
        got, ver = ps.pull_if_newer(1)
        assert got is not None and ver == 2
        assert ps.pull_if_newer(2) == (None, 2)
        assert ps.version == 2
        got, ver = ps.pull()
        assert got is not None and ver == 2
        host, ver = ps.pull_host()
        assert isinstance(host["w"], np.ndarray) and ver == 2
        assert isinstance(ps, TS.ParameterTransport)
        ps.close()


def test_param_unchanged_pull_moves_zero_array_bytes():
    """The version word rides the frame header, so 100 unchanged gated
    pulls transfer ZERO array payload bytes (counter-asserted)."""
    with ControlPlane() as plane:
        ps = plane.parameter_server(
            "model", template={"w": torch.zeros((128, 64))})
        ps.push({"w": torch.ones((128, 64))})
        got, ver = ps.pull_if_newer(0)
        assert got is not None
        bytes_after_real_pull = ps.array_bytes_received
        assert bytes_after_real_pull == 128 * 64 * 4
        copies_after_real_pull = ps.copies
        for _ in range(100):
            v, _ = ps.pull_if_newer(ver)
            assert v is None
        assert ps.array_bytes_received == bytes_after_real_pull, \
            "unchanged tcp pull moved array bytes over the wire"
        assert ps.copies == copies_after_real_pull
        ps.close()


def test_param_codec_published_lazily():
    """A template-less client fetches the codec from the plane after
    someone else's first push."""
    with ControlPlane() as plane:
        writer = plane.parameter_server("policy")       # no template
        reader = plane.parameter_server("policy")       # same store id
        assert writer.store_id == reader.store_id
        writer.push({"w": torch.full((3,), 2.5)})
        got, ver = reader.pull_if_newer(0)
        assert ver == 1 and got["w"].tolist() == [2.5, 2.5, 2.5]
        writer.close()
        reader.close()


def test_torn_reply_degrades_to_cache():
    """A server that tears the reply mid-frame must not corrupt or crash a
    gated pull: the client keeps its cached value."""
    lst = socket.create_server(("127.0.0.1", 0))
    addr = lst.getsockname()[:2]

    def serve_one_torn_reply():
        conn, _ = lst.accept()
        try:
            F.recv_frame(conn)              # the pull request
            conn.sendall(F.MAGIC + b"\0")   # torn 5-byte header
        finally:
            conn.close()

    th = threading.Thread(target=serve_one_torn_reply, daemon=True)
    th.start()
    ps = TcpParameterServer(addr, 0, "model",
                            template={"w": torch.zeros((2,))})
    try:
        assert ps.pull_if_newer(5) == (None, 5)     # degraded, not raised
        th.join(10)
    finally:
        ps.close()
        lst.close()


def test_push_is_loud_on_dead_plane():
    plane = ControlPlane()
    ps = plane.parameter_server("model", template={"w": torch.zeros((2,))})
    ps.push({"w": torch.ones((2,))})
    plane.close()
    with pytest.raises((ProtocolError, OSError)):
        ps.push({"w": torch.ones((2,))})
    ps.close()


def test_reconnect_resumes_global_state():
    """All state lives on the plane: a client that drops its connection
    redials on the next call and sees the same versions and count."""
    with ControlPlane() as plane:
        ps = plane.parameter_server("model",
                                    template={"w": torch.zeros((2,))})
        ds = plane.data_server(n_collectors=2, target=6)
        ps.push({"w": torch.ones((2,))})
        assert ds.try_claim(0, k=2) == 2
        ds.push({"x": torch.ones((3,))}, collector_id=0)
        ds.push({"x": torch.ones((3,))}, collector_id=0)
        ps.close()      # drop both sockets: the next call must redial
        ds.close()
        assert ps.version == 1
        assert ds.total_pushed == 2
        assert ds.try_claim(0, k=10) == 4   # remaining toward target 6
        assert ds.refund_inflight(0) == 4
        ps.close()
        ds.close()


# ------------------------------------------------------------ data plane
def test_data_tickets_exact_and_refund():
    with ControlPlane() as plane:
        ds = plane.data_server(n_collectors=2, target=5)
        assert isinstance(ds, TS.DataTransport)
        assert ds.try_claim(0, k=3) == 3
        assert ds.try_claim(1, k=3) == 2        # min(k, remaining)
        assert ds.try_claim(0, k=1) == 0        # fully claimed
        assert ds.refund_inflight(1) == 2       # died before pushing
        assert ds.refund_inflight(1) == 0       # idempotent
        assert ds.try_claim(1, k=5) == 2        # refund reopened them
        ds.push({"x": torch.zeros((2,))}, collector_id=0)
        assert ds.total_pushed == 1
        assert ds.refund_inflight(0) == 2       # 3 claimed, 1 delivered
        assert len(ds.drain()) == 1
        ds.close()


def test_data_backpressure_diagnosis():
    with ControlPlane() as plane:
        ds = plane.data_server(n_collectors=1, maxsize=2,
                               push_timeout=0.2)
        traj = {"x": torch.zeros((3,))}
        ds.push(traj)
        ds.push(traj)
        with pytest.raises(TS.BackpressureError) as ei:
            ds.push(traj)
        msg = str(ei.value)
        assert "2 (maxsize)" in msg
        assert "model worker" in msg
        assert "push_timeout_s" in msg
        assert len(ds.drain()) == 2             # queue intact after that
        ds.close()


def test_data_batch_push_drain_unstacks():
    with ControlPlane() as plane:
        ds = plane.data_server(n_collectors=1)
        batch = {"obs": torch.stack([torch.full((4, 3), float(i))
                                     for i in range(3)]),
                 "rew": torch.ones((3, 4))}
        assert ds.push_batch(batch, 3) == 3
        ds.push({"obs": torch.full((4, 3), 9.0), "rew": torch.ones((4,))})
        items = ds.drain()
        assert len(items) == 4
        for i in range(3):
            assert items[i]["obs"].shape == (4, 3)
            assert torch.equal(items[i]["obs"], torch.full((4, 3), float(i)))
        assert torch.equal(items[3]["obs"], torch.full((4, 3), 9.0))
        assert ds.total_pushed == 4 and len(ds) == 0
        ds.close()


def test_handles_pickle_roundtrip():
    """Handles ride ProcChannels through spawn: sockets and locks are
    dropped when pickled, the copy redials lazily, and no tensor rides
    along (the codec pickles to its layout)."""
    with ControlPlane() as plane:
        ps = plane.parameter_server("model",
                                    template={"w": torch.zeros((2,))})
        ds = plane.data_server(n_collectors=1, target=3)
        ps.push({"w": torch.ones((2,))})
        blob = pickle.dumps(ps)
        assert b"torch._utils" not in blob and b"_rebuild" not in blob
        ps2 = pickle.loads(blob)
        ds2 = pickle.loads(pickle.dumps(ds))
        assert ps2.version == 1
        got, ver = ps2.pull_if_newer(0)
        assert ver == 1 and got is not None
        assert ds2.try_claim(0, k=5) == 3
        assert ds2.refund_inflight(0) == 3
        for h in (ps, ds, ps2, ds2):
            h.close()


def test_join_tickets_allocate_fresh_ids():
    from repro_torch.net.join import request_join_ticket
    with ControlPlane() as plane:
        plane.parameter_server("model", template={"w": torch.zeros((2,))})
        plane.parameter_server("policy", template={"w": torch.zeros((2,))})
        ds = plane.data_server(n_collectors=2, target=8,
                               push_timeout=12.5)
        plane.set_join_spec(pickle.dumps({"fake": "spec"}))
        t1 = request_join_ticket(plane.connect_addr)
        t2 = request_join_ticket(plane.connect_addr)
        # joiner ids start past the local fleet and increment
        assert (t1["collector_id"], t2["collector_id"]) == (2, 3)
        assert t1["stores"] == {"model": 0, "policy": 1}
        assert t1["n_collectors"] == 2
        assert t1["push_timeout"] == 12.5
        assert pickle.loads(t1["spec"]) == {"fake": "spec"}
        # joiner ids claim from the SAME ticket counters
        assert ds.try_claim(t1["collector_id"], k=3) == 3
        assert ds.refund_inflight(t1["collector_id"]) == 3
        ds.close()


def test_event_mode_rejects_tcp():
    env = make_env("pendulum")
    ens, pol, acfg = small_cfgs(env)
    algo = TA.make_algo(acfg, pol, env.reward, env.reset_batch)
    with pytest.raises(ValueError, match="real engine"):
        TR.AsyncTrainer(env, ens, algo,
                        TR.RunConfig(total_trajs=4, seed=SEED,
                                     transport="tcp"), device="cpu")


def test_a_bind_that_fails_is_loud():
    with ControlPlane() as plane:
        with pytest.raises(OSError):
            ControlPlane("%s:%d" % plane.addr)


# --------------------------------------------- crash exactness (spawn)
def _tcp_farm_producer(ds, cid, batch, hang=False):
    """Module-level so that spawn can pickle it: claims up to ``batch``
    tickets a step and pushes the grant whole; with ``hang`` it delivers
    ONE lane, then sleeps holding the rest (the mid-batch crash shape).
    The test sees the hang point on the plane's count, not through a
    multiprocessing event."""
    while True:
        g = ds.try_claim(cid, k=batch)
        if not g:
            break
        if hang:
            ds.push({"x": torch.full((3,), float(cid))}, collector_id=cid)
            time.sleep(300)      # SIGKILLed here, holding g - 1 tickets
        ds.push_batch({"x": torch.full((g, 3), float(cid))}, g,
                      collector_id=cid)


def _wait(cond, seconds):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


@pytest.mark.slow
@pytest.mark.timeout(120)
def test_tcp_multi_producer_exact_under_mid_batch_kill():
    """A producer process SIGKILLed mid-batch (1 of 3 claimed lanes
    delivered) leaves exactly its unfilled lanes refundable, and
    replacements land the global criterion EXACTLY."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    target = 10
    procs = []
    with ControlPlane() as plane:
        ds = plane.data_server(n_collectors=3, target=target)
        try:
            victim = ctx.Process(target=_tcp_farm_producer,
                                 args=(ds, 2, 3, True), daemon=True)
            victim.start()
            procs.append(victim)
            assert _wait(lambda: ds.total_pushed == 1, 60), \
                "victim never reached its hang point"
            os.kill(victim.pid, signal.SIGKILL)
            victim.join(30)
            assert victim.exitcode != 0
            assert ds.total_pushed == 1
            assert ds.refund_inflight(2) == 2, \
                "mid-batch kill must leave exactly the unfilled lanes"
            procs += [ctx.Process(target=_tcp_farm_producer,
                                  args=(ds, cid, 3), daemon=True)
                      for cid in range(3)]
            for p in procs[1:]:
                p.start()
            for p in procs[1:]:
                p.join(60)
                assert p.exitcode == 0, "producer crashed"
            assert ds.total_pushed == target
            drained = []
            assert _wait(lambda: drained.extend(ds.drain())
                         or len(drained) == target, 30)
            assert ds.try_claim(0) == 0, "tickets must stay exhausted"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            ds.close()


# --------------------------------------------------------- end to end
@pytest.mark.slow
@pytest.mark.timeout(120)
def test_threads_tcp_fleet_lands_criterion_exact():
    """threads + tcp: two collectors share the one global criterion
    through the control plane and land it EXACTLY; the trainer records
    net_info before closing its plane, and the plane is closed after."""
    env = make_env("pendulum")
    ens, pol, acfg = small_cfgs(env)
    algo = TA.make_algo(acfg, pol, env.reward, env.reset_batch)
    rc = TR.RunConfig(total_trajs=6, seed=SEED, min_warmup_trajs=2,
                      n_collectors=2, transport="tcp",
                      collect_speed=50.0, pace_collection=True)
    tr = TR.AsyncTrainer(env, ens, algo, rc, mode="threads", device="cpu")
    assert isinstance(tr.model_server, TcpParameterServer)
    trace = tr.run()
    assert tr.net_info["trajs"] == rc.total_trajs, tr.net_info
    assert tr.net_info["model_version"] >= 0
    assert trace and trace[-1]["trajs"] >= rc.total_trajs
    assert sum(c.collected for c in tr.collectors) == rc.total_trajs
    assert tr._plane is None
    with pytest.raises(OSError):
        socket.create_connection(parse_addr(tr.net_info["addr"]), 2)


def _procs_tcp_trainer(tmp_path, supervisor=None, **rc_kw):
    env = make_env("pendulum")
    ens, pol, acfg = small_cfgs(env)
    rc = TR.RunConfig(seed=SEED, min_warmup_trajs=2, snapshot_every_s=1.0,
                      eval_every_policy_steps=2, eval_rollouts=2,
                      ckpt_dir=str(tmp_path / "ckpt"), transport="tcp",
                      **rc_kw)
    return TR.AsyncTrainer(env, ens, None, rc, mode="procs", algo_cfg=acfg,
                           pol_cfg=pol, supervisor=supervisor, device="cpu")


def _run_in_thread(tr):
    done = {}

    def body():
        try:
            done["trace"] = tr.run()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            done["error"] = e
    th = threading.Thread(target=body, daemon=True)
    th.start()
    return th, done


def _kill_children(tr):
    for p in getattr(tr, "_procs", {}).values():
        if p.is_alive():
            p.kill()
            p.join(timeout=10)


@pytest.mark.slow
@pytest.mark.timeout(150)
def test_procs_tcp_collector_sigkill_exact_with_monitor(tmp_path):
    """procs + tcp with two collectors, one SIGKILLed mid-run: the parent
    refunds exactly its unfilled lanes and restarts it; the run lands the
    criterion EXACTLY, and a live InvariantMonitor sees monotone versions,
    the exact criterion and bounded restarts across the reconnect."""
    from repro_torch.chaos.monitor import InvariantMonitor
    monitor = InvariantMonitor()
    tr = _procs_tcp_trainer(tmp_path, monitor, total_trajs=9,
                            pace_collection=True, collect_speed=2.0,
                            n_collectors=2, min_final_model_version=1,
                            min_final_policy_version=1)
    th, done = _run_in_thread(tr)
    killed = False
    try:
        deadline = time.monotonic() + 100
        while th.is_alive() and not killed and time.monotonic() < deadline:
            srv = getattr(tr, "_proc_servers", None)
            procs = getattr(tr, "_procs", None)
            if srv and procs and "collector:1" in procs:
                try:
                    pushed = srv["data"].total_pushed
                except (ProtocolError, OSError):
                    pushed = 0
                p = procs["collector:1"]
                if pushed >= 2 and p.is_alive():
                    os.kill(p.pid, signal.SIGKILL)
                    killed = True
            time.sleep(0.02)
        assert killed, "never got a live collector to kill"
        th.join(120)
        assert not th.is_alive(), "procs+tcp run wedged after the kill"
    finally:
        _kill_children(tr)
    assert "error" not in done, done.get("error")
    assert tr.proc_info["trajs"] == 9, tr.proc_info
    assert tr.proc_info["restarts"]["collector:1"] >= 1
    assert monitor.report()["violations"] == []
    assert not os.path.exists(tr._run_dir)


@pytest.mark.slow
@pytest.mark.timeout(150)
def test_joiner_contributes_to_a_procs_tcp_run(tmp_path):
    """A collector thread joins a live procs + tcp run through
    ``join_as_collectors``: it gets an id past the fleet's, contributes at
    least one trajectory, and the total stays exact."""
    from repro_torch.net.join import join_as_collectors
    tr = _procs_tcp_trainer(tmp_path, total_trajs=8, pace_collection=True,
                            collect_speed=4.0, min_final_model_version=1,
                            min_final_policy_version=1)
    th, done = _run_in_thread(tr)
    got = {}
    try:
        assert _wait(lambda: "addr" in getattr(tr, "net_info", {}), 60)
        got["n"] = join_as_collectors(tr.net_info["addr"], device="cpu")
        th.join(120)
        assert not th.is_alive()
    finally:
        _kill_children(tr)
    assert "error" not in done, done.get("error")
    info = tr.proc_info
    fleet = info["children"]["collector:0"]["work"]
    assert 1 <= got["n"] and fleet + got["n"] == 8 == info["trajs"]
    assert not any(info["restarts"].values())
    assert done["trace"][-1]["trajs"] == 8


def test_launcher_connect_joins_and_tcp_needs_the_async_engine(monkeypatch,
                                                                capsys):
    import repro_torch.net as N
    from repro_torch.launch import train as launch
    calls = []
    monkeypatch.setattr(N, "join_as_collectors",
                        lambda addr, **kw: calls.append((addr, kw)) or 3)
    assert launch.main(["--connect", "127.0.0.1:7447", "--n-collectors",
                        "2", "--device", "cpu"]) == 3
    assert calls == [("127.0.0.1:7447", {"n_collectors": 2,
                                          "device": "cpu"})]
    assert '"trajs_contributed": 3' in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--engine async"):
        launch.main(["--transport", "tcp", "--engine", "sequential",
                     "--device", "cpu", "--trajs", "1"])
