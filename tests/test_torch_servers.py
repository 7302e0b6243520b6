"""The port's ``core/servers.py`` beyond the worker paths: ``LocalBuffer``
against the reference's, ``pull_host``, the transport protocols, exact totals
under concurrent pushers, and the cross-stream handoff's wiring.

The handoff itself needs a card (``chip_smoke.py``'s ``stream_handoff``
phase holds it there); here a stand-in event and stream show where the
servers record and wait: one event per push, one wait per changed pull or
drain, and nothing at all on an unchanged pull.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import servers as JS
from repro_torch.core import servers as S

# (max_trajs, holdout_frac, number of trajectories, extend sizes)
LOCAL_CASES = [(4, 0.2, 13, (1,)), (3, 0.5, 9, (2, 3)), (10, 0.0, 12, (5,)),
               (1, 0.25, 7, (1, 4)), (6, 0.34, 20, (3, 1, 4))]


def _trajs(n, seed, horizon=3):
    rng = np.random.default_rng(seed)
    return [{"obs": rng.standard_normal((horizon, 2)).astype(np.float32),
             "act": rng.standard_normal((horizon, 1)).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("max_trajs,frac,n,sizes", LOCAL_CASES)
def test_local_buffer_fifo_bound_and_order_match_reference(max_trajs, frac,
                                                           n, sizes):
    trajs = _trajs(n, seed=max_trajs + n)
    ref, port = JS.LocalBuffer(max_trajs, frac), S.LocalBuffer(max_trajs,
                                                               frac)
    i, k = 0, 0
    while i < n:
        chunk = trajs[i:i + sizes[k % len(sizes)]]
        assert port.extend([{kk: torch.from_numpy(v) for kk, v in t.items()}
                            for t in chunk]) == ref.extend(chunk)
        i, k = i + len(chunk), k + 1
        assert (port.n_train, port.total_seen) == (ref.n_train,
                                                   ref.total_seen)
        assert port.n_train <= max_trajs
        for got, want in ((port.train_arrays(), ref.train_arrays()),
                          (port.val_arrays(), ref.val_arrays())):
            assert (got is None) == (want is None)
            if want is not None:
                assert sorted(got) == sorted(want)
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key])


def test_pull_host_gives_numpy_and_the_version():
    srv = S.ParameterServer()
    assert srv.pull_host() == (None, 0)
    tree = {"w": [torch.ones(2, 3)], "b": [torch.zeros(3)],
            "log_std": torch.full((3,), -0.5)}
    srv.push(tree)
    srv.push({**tree, "log_std": torch.full((3,), -1.0)})
    host, version = srv.pull_host()
    assert version == 2
    assert isinstance(host["w"][0], np.ndarray)
    np.testing.assert_array_equal(host["log_std"], np.full(3, -1.0,
                                                           np.float32))
    host["w"][0][:] = 7.0           # the host copy is the caller's own
    assert float(srv.pull()[0]["w"][0].sum()) == 6.0
    srv.push({"h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)})
    host, version = srv.pull_host()
    assert version == 3 and host["h"].dtype == np.float32
    np.testing.assert_array_equal(host["h"], [1.5, -2.25])


@pytest.mark.parametrize("server,protocol", [
    (S.ParameterServer, S.ParameterTransport),
    (S.DataServer, S.DataTransport)])
def test_servers_satisfy_the_transport_protocols(server, protocol):
    assert isinstance(server(), protocol)
    # the reference's in-process servers satisfy the same seams
    ref = {S.ParameterServer: JS.ParameterServer,
           S.DataServer: JS.DataServer}[server]
    ref_protocol = {S.ParameterTransport: JS.ParameterTransport,
                    S.DataTransport: JS.DataTransport}[protocol]
    assert isinstance(ref(), ref_protocol)


@pytest.mark.timeout(60)
@pytest.mark.parametrize("lanes", [1, 3])
def test_concurrent_pushers_keep_exact_totals(lanes):
    """Sixteen collectors (more than the cores) racing on a target that
    ``lanes`` does not divide, with a short switch interval: every grant is
    pushed, the total lands exactly, and the drain hands back every
    trajectory once."""
    target, n_threads = 101, 16
    srv = S.DataServer(claim_backoff=0.0)
    srv.set_target(target)
    pushed = [0] * n_threads

    def collector(cid):
        while True:
            g = srv.try_claim(cid, k=lanes)
            if not g:
                return
            if g == 1:
                srv.push({"id": torch.tensor([cid])}, collector_id=cid)
            else:
                srv.push_batch({"id": torch.full((g, 1), cid)}, g,
                               collector_id=cid)
            pushed[cid] += g

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=collector, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert srv.total_pushed == sum(pushed) == target
    items = srv.drain()
    assert len(items) == target and len(srv) == 0
    counts = np.bincount([int(t["id"][0]) for t in items],
                         minlength=n_threads)
    assert counts.tolist() == pushed


class _FakeEvent:
    def __init__(self, log):
        self.log = log
        log.append("record")


class _FakeStream:
    def __init__(self, log):
        self.log = log

    def wait_event(self, ev):
        self.log.append(("wait", ev))


@pytest.fixture
def fake_cuda_events(monkeypatch):
    """Each push records a stand-in event (as it would for CUDA tensors),
    and the current stream logs its waits."""
    log = []
    monkeypatch.setattr(S, "_ready_event", lambda value: _FakeEvent(log))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream(log))
    return log


def test_parameter_handoff_waits_once_per_changed_pull(fake_cuda_events):
    log = fake_cuda_events
    srv = S.ParameterServer()
    srv.push({"w": torch.ones(2)})
    assert log == ["record"]
    ev = srv._ready
    value, ver = srv.pull_if_newer(0)
    assert ver == 1 and log == ["record", ("wait", ev)]
    # the unchanged path: a lock and a compare, no event, no stream
    for _ in range(5):
        assert srv.pull_if_newer(1) == (None, 1)
    assert len(log) == 2
    srv.push({"w": torch.zeros(2)})
    value2, _ = srv.pull_if_newer(1)
    assert log[-1] == ("wait", srv._ready) and len(log) == 4
    assert float(value2["w"].sum()) == 0.0


def test_data_handoff_waits_on_every_push_of_a_drain(fake_cuda_events):
    log = fake_cuda_events
    srv = S.DataServer()
    srv.push({"obs": torch.ones(3, 2)})
    srv.push_batch({"obs": torch.zeros(4, 3, 2)}, 4)
    events = list(srv._events)
    assert len(events) == 2 and log == ["record", "record"]
    items = srv.drain()
    assert len(items) == 5
    assert log[2:] == [("wait", ev) for ev in events]
    assert srv.drain() == [] and len(log) == 4


def test_cpu_push_records_no_event_and_pull_hands_the_snapshot():
    srv = S.ParameterServer()
    src = {"w": torch.arange(4.0)}
    srv.push(src)
    assert srv._ready is None
    src["w"].add_(1.0)              # the pusher updates in place
    value, _ = srv.pull_if_newer(0)
    np.testing.assert_array_equal(value["w"].numpy(), np.arange(4.0))
    assert srv.pull()[0]["w"] is value["w"]
    data = S.DataServer()
    data.push({"obs": torch.ones(2)})
    assert data._events == [None]
