"""Remote collector entry (``--connect host:port``): the port of
``repro/net/join.py``.

A joining process asks the run's ControlPlane for a JOIN ticket (the
pickled :class:`~repro_torch.core.workers.ProcSpec` the trainer published,
a fresh collector id past the trainer's own fleet, and the store-name -> id
map), rebuilds a :class:`~repro_torch.core.workers.DataCollectionWorker`
from it as a spawned procs child does, and runs the claim -> collect ->
push loop against the plane until the global criterion is fully claimed.

Exactness across the boundary: joiners claim from the SAME ticket counters
as the local fleet, so they cannot overshoot the criterion. A joiner that
fails between claim and push refunds its own tickets; the tickets of one
that is killed stay in flight on the plane until an operator or the
trainer refunds them (the plane never refunds on a disconnect).

Seeds: the joiner's collector seed is ``runtime.run_seeds(spec.seed)[0]``,
and the worker derives its stream from it and its id, so a joiner draws
what a local fleet member with that id would.

Trust: the JOIN ticket is a pickle, and so is the spec in it. Connect only
to planes you run (docs/WIRE_PROTOCOL.md, 'Security model'). The ticket
holds this package's classes, so a joiner and the plane's trainer must both
be ``repro_torch`` (or both the reference).
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import List

from repro_torch.net import frame as F
from repro_torch.net.client import TcpDataServer, TcpParameterServer, _TcpHandle
from repro_torch.net.control import parse_addr


def request_join_ticket(addr) -> dict:
    """One JOIN RPC -> {spec, collector_id, stores, n_collectors,
    push_timeout, claim_backoff}. Each call allocates a fresh id."""
    with _TcpHandle(tuple(addr)) as h:
        _, cid, _, _, payload = h._rpc(F.OP_JOIN)
    ticket = pickle.loads(payload)
    ticket["collector_id"] = int(cid)
    return ticket


def _run_joined_collector(addr, ticket, counts: List[int], idx: int,
                          device, errors: List[BaseException]) -> None:
    from repro_torch.core.runtime import run_seeds
    from repro_torch.core.workers import (DataCollectionWorker,
                                          ExplorationSchedule)
    spec = pickle.loads(ticket["spec"])
    rc = spec.run_cfg
    cid = int(ticket["collector_id"])
    sched = spec.exploration or ExplorationSchedule()
    policy_srv = TcpParameterServer(addr, ticket["stores"]["policy"],
                                    "policy")
    data = TcpDataServer(addr,
                         n_collectors=ticket.get("n_collectors", 1),
                         push_timeout=ticket.get("push_timeout", 30.0),
                         claim_backoff=ticket.get("claim_backoff", 0.002))
    w = None
    try:
        w = DataCollectionWorker(spec.env, policy_srv, data, None,
                                 run_seeds(spec.seed)[0],
                                 speed=rc.collect_speed, collector_id=cid,
                                 noise_scale=sched.scale_for(cid),
                                 envs_per_step=rc.envs_per_collector,
                                 device=device)
        # claim nothing until a policy exists: a claimed ticket is always
        # fulfilled by the very next step
        while not w.poll_policy():
            time.sleep(0.005)
        while True:
            g = data.try_claim(cid, k=w.envs_per_step)
            if not g:
                break               # the global target is fully claimed
            t_step = time.monotonic()
            dur = w.step(g)
            if rc.pace_collection and dur is not None:
                time.sleep(max(dur - (time.monotonic() - t_step), 0.0))
    except (F.ProtocolError, OSError):
        # the plane is unreachable: refund our in-flight tickets, so the
        # criterion does not stall on this joiner, then stop
        try:
            data.refund_inflight(cid)
        except (F.ProtocolError, OSError):
            pass
    except BaseException as e:      # noqa: BLE001 — raised by the caller
        errors.append(e)
        try:
            data.refund_inflight(cid)
        except (F.ProtocolError, OSError):
            pass
    finally:
        counts[idx] = 0 if w is None else w.collected
        policy_srv.close()
        data.close()


def join_as_collectors(addr: str, *, n_collectors: int = 1,
                       device=None, per_collector=None) -> int:
    """Join a live run at ``addr`` ('host:port') as ``n_collectors`` more
    collectors (one thread each, one JOIN ticket and one collector id
    each). Blocks until the run's global criterion is fully claimed and
    returns the trajectories THIS process contributed; a dict given as
    ``per_collector`` receives them by collector id. The collectors run on
    ``device`` (None: the card). A joined collector that fails raises here
    once the others are done."""
    from repro_torch import resolve_device
    device = resolve_device(device)
    target = parse_addr(addr)
    counts = [0] * int(n_collectors)
    errors: List[BaseException] = []
    threads, ids = [], []
    for i in range(int(n_collectors)):
        ticket = request_join_ticket(target)
        ids.append(ticket["collector_id"])
        th = threading.Thread(
            target=_run_joined_collector,
            args=(target, ticket, counts, i, device, errors),
            name=f"join-collector:{ticket['collector_id']}", daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    if per_collector is not None:
        per_collector.update(zip(ids, counts))
    if errors:
        raise RuntimeError("a joined collector failed") from errors[0]
    return sum(counts)
