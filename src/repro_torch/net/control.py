"""ControlPlane: the socket transport's server side, the port of
``repro/net/control.py`` (stdlib only, no tensor ever reaches it).

One plane hosts the whole control surface of a run (every parameter store
and THE data server) behind one TCP listener, so ``--bind host:port``
publishes a single address that collectors anywhere can reach. Its state
is threaded-Python mirrors of the procs stores of ``core/servers.py``:

* each parameter store is (lock, payload bytes, version int): a push swaps
  the payload and bumps the version under the lock; a pull compares the
  client's version word first, and an unchanged reply carries ZERO payload
  bytes. The plane never decodes parameters, it moves bytes;
* the data plane is (condition, bounded deque of encoded items, the ticket
  counters): ``total`` / ``tickets`` / per-collector in-flight counts move
  under ONE lock, so ``ProcDataServer``'s exact-criterion contract (claims
  stop at the target, a crashed collector's stranded tickets come back in
  one refund) holds over TCP.

Crash semantics: a client killed mid-frame drops its connection; its
handler thread exits and the plane's state is untouched. Tickets stay in
flight until someone calls ``refund_inflight`` for that collector, as the
supervising parent does; the plane never refunds on a disconnect (a live
collector reconnecting after a network blip must keep its tickets).

Threads only: the plane uses no ``multiprocessing`` primitive. ``close``
shuts the listener and every connection down before closing them, so its
accept and handler threads wake and exit.
"""
from __future__ import annotations

import pickle
import socket
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from repro_torch.net import frame as F


def parse_addr(addr: str) -> Tuple[str, int]:
    """'host:port' -> (host, port). Accepts ':port' as all-interfaces."""
    host, _, port = addr.rpartition(":")
    return (host or "0.0.0.0", int(port))


class _ParamStore:
    """Server-side versioned blob: payload bytes + version word under one
    lock."""

    def __init__(self, codec_blob: Optional[bytes] = None):
        self.lock = threading.Lock()
        self.payload = b""
        self.version = 0
        self.codec_blob = codec_blob

    def push(self, payload: bytes) -> int:
        with self.lock:
            self.payload = payload
            self.version += 1
            return self.version

    def pull(self, version: int) -> Tuple[Optional[bytes], int]:
        with self.lock:
            if self.version == version or self.version == 0:
                return None, self.version
            return self.payload, self.version


class _DataPlane:
    """Server-side trajectory queue + the exact-criterion ticket counters,
    all under one condition variable."""

    def __init__(self, *, n_collectors: int = 1, maxsize: int = 512,
                 target: Optional[int] = None):
        self.cond = threading.Condition()
        self.items: deque = deque()          # of (n_lanes, tree-frame bytes)
        self.maxsize = int(maxsize)
        self.n_collectors = max(int(n_collectors), 1)
        self.total = 0
        self.target = None if target is None else int(target)
        self.tickets = 0
        self.inflight: Dict[int, int] = {}

    def push(self, collector_id: int, n: int, blob: bytes,
             timeout: float) -> Optional[int]:
        """Enqueue ``n`` lanes as one item; waits up to ``timeout`` for
        queue space, returns the new total or None (full: the client raises
        BackpressureError)."""
        with self.cond:
            if not self.cond.wait_for(
                    lambda: len(self.items) < self.maxsize, timeout):
                return None
            self.items.append((int(n), blob))
            self.total += int(n)
            left = self.inflight.get(collector_id, 0) - int(n)
            if left > 0:
                self.inflight[collector_id] = left
            else:
                self.inflight.pop(collector_id, None)
            self.cond.notify_all()
            return self.total

    def claim(self, collector_id: int, k: int) -> int:
        with self.cond:
            g = k if self.target is None else \
                min(k, max(self.target - self.tickets, 0))
            if g > 0:
                self.tickets += g
                self.inflight[collector_id] = \
                    self.inflight.get(collector_id, 0) + g
            return g

    def refund(self, collector_id: int) -> int:
        with self.cond:
            g = self.inflight.pop(collector_id, 0)
            self.tickets -= g
            return g

    def drain(self) -> List[Tuple[int, bytes]]:
        with self.cond:
            items = list(self.items)
            self.items.clear()
            self.cond.notify_all()
            return items

    def set_target(self, total: int) -> None:
        with self.cond:
            self.target = int(total)
            self.tickets = self.total


class ControlPlane:
    """The socket transport's server: one TCP listener, N parameter stores,
    one data plane, one thread per connection (daemon threads).

    ``parameter_server(name, template)`` / ``data_server(...)`` register the
    server-side state AND return the matching client, so the trainer talks
    to its own plane through the same TCP path as remote collectors. A
    bind that fails raises (``OSError``); nothing falls back.
    """

    def __init__(self, bind: str = "127.0.0.1:0"):
        host, port = parse_addr(bind)
        self._srv = socket.create_server((host, port))
        self.addr: Tuple[str, int] = self._srv.getsockname()[:2]
        self._stores: List[_ParamStore] = []
        self._store_ids: Dict[str, int] = {}
        self.data: Optional[_DataPlane] = None
        self._join_blob: Optional[bytes] = None
        self._join_meta: Dict[str, object] = {}
        self._next_join_id = 1
        self._lock = threading.Lock()
        self._conns: set = set()
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="control-plane-accept",
            daemon=True)
        self._accept_thread.start()

    # -- registration / client factories --------------------------------
    @property
    def connect_addr(self) -> Tuple[str, int]:
        """The address clients dial: a 0.0.0.0 bind is reachable locally
        on loopback."""
        host, port = self.addr
        return ("127.0.0.1" if host in ("0.0.0.0", "::") else host, port)

    def parameter_server(self, name: str, template=None):
        """Register a named parameter store and return its client.
        ``template`` fixes the codec now (procs mode: the parent knows the
        params); without it the codec comes from the first push (threads
        mode: the workers are built after the servers)."""
        from repro_torch.checkpoint.io import LeafCodec
        from repro_torch.net.client import TcpParameterServer
        codec_blob = None
        if template is not None:
            codec_blob = pickle.dumps(LeafCodec(template))  # its layout
        with self._lock:
            sid = self._store_ids.setdefault(name, len(self._stores))
            if sid == len(self._stores):
                self._stores.append(_ParamStore(codec_blob))
            elif codec_blob is not None:
                self._stores[sid].codec_blob = codec_blob
        return TcpParameterServer(self.connect_addr, sid, name,
                                  template=template)

    def data_server(self, *, n_collectors: int = 1, maxsize: int = 512,
                    push_timeout: float = 30.0,
                    target: Optional[int] = None,
                    claim_backoff: float = 0.002):
        """Arm the (single) data plane and return its client."""
        from repro_torch.net.client import TcpDataServer
        self.data = _DataPlane(n_collectors=n_collectors, maxsize=maxsize,
                               target=target)
        self._join_meta.update(n_collectors=int(n_collectors),
                               push_timeout=float(push_timeout),
                               claim_backoff=float(claim_backoff))
        self._next_join_id = max(self._next_join_id, int(n_collectors))
        return TcpDataServer(self.connect_addr,
                             n_collectors=n_collectors,
                             push_timeout=push_timeout,
                             claim_backoff=claim_backoff)

    def set_join_spec(self, blob: bytes) -> None:
        """Publish the pickled worker spec that ``--connect`` joiners
        rebuild a collector from. Pickle over a TRUSTED link only (see
        docs/WIRE_PROTOCOL.md)."""
        self._join_blob = blob

    # -- server loop -----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return                      # listener shut down
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="control-plane-conn",
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        try:
            while True:
                try:
                    op, word, aux, flags, payload = F.recv_frame(conn)
                except (F.ProtocolError, OSError):
                    return                  # peer died / torn frame
                try:
                    self._dispatch(conn, op, word, aux, flags, payload)
                except (BrokenPipeError, ConnectionError, OSError):
                    return
                except Exception as e:      # noqa: BLE001 — reply, don't die
                    try:
                        F.send_frame(conn, F.OP_ERR,
                                     payload=str(e).encode())
                    except OSError:
                        return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _store(self, sid: int) -> _ParamStore:
        with self._lock:
            return self._stores[sid]

    def _dispatch(self, conn, op, word, aux, flags, payload) -> None:
        if op == F.OP_PPUSH:
            F.send_frame(conn, F.OP_OK,
                         word=self._store(aux).push(payload))
        elif op == F.OP_PPULL:
            blob, ver = self._store(aux).pull(word)
            F.send_frame(conn, F.OP_OK, word=ver, payload=blob or b"")
        elif op == F.OP_PVER:
            F.send_frame(conn, F.OP_OK, word=self._store(aux).version)
        elif op == F.OP_PMETA:
            blob = self._store(aux).codec_blob
            if blob is None:
                raise RuntimeError(f"store {aux} has no codec yet "
                                   "(nothing pushed)")
            F.send_frame(conn, F.OP_OK, payload=blob)
        elif op == F.OP_PINIT:
            store = self._store(aux)
            if store.codec_blob is None:
                store.codec_blob = payload
            F.send_frame(conn, F.OP_OK)
        elif op == F.OP_DPUSH:
            total = self.data.push(aux, flags, payload, word / 1000.0)
            if total is None:
                F.send_frame(conn, F.OP_FULL, word=self.data.maxsize)
            else:
                F.send_frame(conn, F.OP_OK, word=total)
        elif op == F.OP_DCLAIM:
            F.send_frame(conn, F.OP_OK, word=self.data.claim(aux, word))
        elif op == F.OP_DREFUND:
            F.send_frame(conn, F.OP_OK, word=self.data.refund(aux))
        elif op == F.OP_DDRAIN:
            items = self.data.drain()
            F.send_frame(conn, F.OP_OK, word=len(items),
                         payload=F.pack_drain_items(items))
        elif op == F.OP_DTOTAL:
            with self.data.cond:
                total = self.data.total
            F.send_frame(conn, F.OP_OK, word=total)
        elif op == F.OP_DTARGET:
            self.data.set_target(word)
            F.send_frame(conn, F.OP_OK)
        elif op == F.OP_DLEN:
            with self.data.cond:
                n = len(self.data.items)
            F.send_frame(conn, F.OP_OK, word=n)
        elif op == F.OP_JOIN:
            if self._join_blob is None:
                raise RuntimeError("no join spec published on this plane")
            with self._lock:
                cid = self._next_join_id
                self._next_join_id += 1
                stores = dict(self._store_ids)
            ticket = dict(self._join_meta)
            ticket.update(spec=self._join_blob, collector_id=cid,
                          stores=stores)
            F.send_frame(conn, F.OP_OK, word=cid,
                         payload=pickle.dumps(ticket))
        else:
            raise RuntimeError(f"unknown opcode {op}")

    # -- lifecycle -------------------------------------------------------
    def close(self) -> None:
        """Shut the listener and every live connection down and close them;
        the accept thread is joined, handler threads exit on their next
        read. Idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)    # wakes the blocked accept
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)    # wakes a blocked recv
            except OSError:
                pass
        self._accept_thread.join(timeout=5)
        try:
            self._srv.close()
        except OSError:
            pass

    def __enter__(self) -> "ControlPlane":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
