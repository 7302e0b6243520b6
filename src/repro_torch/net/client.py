"""Socket-transport clients: the port of ``repro/net/client.py``.

``TcpParameterServer`` and ``TcpDataServer`` have the method surface of
``ShmParameterServer`` / ``ProcDataServer`` (``pull_if_newer``,
``try_claim`` / ``refund_inflight``, ``push`` / ``push_batch`` / ``drain``
and the counters the supervisor and the ``InvariantMonitor`` read) and
satisfy the ``ParameterTransport`` / ``DataTransport`` protocols, so
``ProcChannels``, the worker loops and the supervision code do not know
which transport they hold.

Each handle owns ONE lazily dialled TCP connection guarded by a thread
lock; a handle pickles without its socket and lock (they are made anew),
so it rides ``ProcChannels`` into a spawned child like the file-backed
handles do and dials from there. A connection error closes the socket and
the next call redials: every counter lives on the plane, so a reconnecting
collector resumes the GLOBAL count.

Tensors never cross the wire: a push takes one host copy of each leaf; a
pull decodes into CPU tensors, which the worker moves onto its device once
per version change (``tree_to``). An unchanged pull is one header-only
round trip: no payload byte, no device copy, no host sync.
"""
from __future__ import annotations

import pickle
import socket
import threading
import time
from typing import Any, List, Optional, Tuple

from repro_torch.checkpoint.io import LeafCodec, layout_codec
from repro_torch.core.servers import BackpressureError, _host_copy
from repro_torch.net import frame as F
from repro_torch.utils.tree import tree_map


class _TcpHandle:
    """One RPC connection: lazy dial, serialised request/reply, redial
    after any failure. Picklable (socket and lock dropped)."""

    def __init__(self, addr: Tuple[str, int], *, timeout: float = 60.0):
        self._addr = tuple(addr)
        self._timeout = float(timeout)
        self._sock = None
        self._lock = threading.Lock()

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_sock"] = None
        state["_lock"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _conn(self):
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rpc(self, op: int, *, word: int = 0, aux: int = 0, flags: int = 0,
             payload: bytes = b"") -> Tuple[int, int, int, int, bytes]:
        """Send one frame, read one reply. On ANY transport failure the
        socket is dropped (the next call redials) and the error propagates:
        gated pulls degrade, pushes and claims stay loud."""
        with self._lock:
            try:
                sock = self._conn()
                F.send_frame(sock, op, word=word, aux=aux, flags=flags,
                             payload=payload)
                rop, rword, raux, rflags, rpayload = F.recv_frame(sock)
            except (F.ProtocolError, OSError):
                self._drop()
                raise
        if rop == F.OP_ERR:
            raise RuntimeError("control plane error: "
                               + rpayload.decode(errors="replace"))
        return rop, rword, raux, rflags, rpayload

    def close(self) -> None:
        with self._lock:
            self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _cpu_codec(tree) -> LeafCodec:
    """The codec of ``tree``'s structure, decoding into CPU tensors (built
    from the leaves' dtypes and shapes, no copy)."""
    return layout_codec(*LeafCodec(tree).layout())


class TcpParameterServer(_TcpHandle):
    """Versioned parameter store over the socket transport.

    The version word rides the FRAME HEADER: an unchanged
    ``pull_if_newer`` is one 32-byte request and one 32-byte reply with no
    payload, so ``array_bytes_received`` (every parameter payload byte this
    handle ever read) does not move. A transport failure during a gated
    pull degrades to the cached value ((None, version), redialled on the
    next call), as a seqlock reader seeing a crashed writer; pushes stay
    loud. With no template the codec comes from the first push, which
    publishes it on the plane for template-less peers, or from the plane
    on the first changed pull.
    """

    def __init__(self, addr, store_id: int, name: str = "",
                 template=None, *, timeout: float = 60.0):
        super().__init__(addr, timeout=timeout)
        self.store_id = int(store_id)
        self.name = name
        self.codec = None if template is None else _cpu_codec(template)
        self.copies = 0                 # leaves copied out
        self.pushes = 0
        self.array_bytes_received = 0   # parameter payload bytes pulled

    def _ensure_codec(self, value=None) -> LeafCodec:
        if self.codec is None:
            if value is not None:
                self.codec = _cpu_codec(value)
                self._rpc(F.OP_PINIT, aux=self.store_id,
                          payload=pickle.dumps(self.codec))
            else:
                _, _, _, _, blob = self._rpc(F.OP_PMETA, aux=self.store_id)
                self.codec = pickle.loads(blob)
        return self.codec

    def push(self, value) -> int:
        """One host copy of each leaf through the codec, the plane's blob
        swapped and its version bumped. Loud on failure. Returns the new
        version."""
        codec = self._ensure_codec(value)
        _, ver, _, _, _ = self._rpc(F.OP_PPUSH, aux=self.store_id,
                                    payload=F.encode_leaves(codec, value))
        self.pushes += 1
        return ver

    def pull_if_newer(self, version: int, *, sharding=None):
        """(value, current_version) when newer than ``version``, else
        (None, version as seen). The value is a tree of CPU tensors, the
        caller's own. Unchanged: one header-only round trip. A transport
        failure degrades to (None, version). ``sharding`` is accepted for
        interface parity and ignored: the caller moves the host tensors
        onto its own device."""
        try:
            _, ver, _, _, payload = self._rpc(F.OP_PPULL, word=version,
                                              aux=self.store_id)
            if not payload:
                return None, ver
            value = F.decode_leaves(self._ensure_codec(), payload)
        except (F.ProtocolError, OSError):
            return None, version
        self.array_bytes_received += len(payload)
        self.copies += self.codec.n_leaves
        return value, ver

    def pull(self):
        """Unconditional pull -> (value or None, version)."""
        value, ver = self.pull_if_newer(-1)
        return value, (ver if value is not None else self.version)

    def pull_host(self):
        """(host numpy tree, version), or (None, version); bf16 leaves
        widened to float32, as ``ParameterServer.pull_host``."""
        value, ver = self.pull()
        if value is None:
            return None, ver
        return tree_map(_host_copy, value), ver

    @property
    def version(self) -> int:
        """The plane's current version: one header-only RPC, loud on
        failure."""
        _, ver, _, _, _ = self._rpc(F.OP_PVER, aux=self.store_id)
        return ver


class TcpDataServer(_TcpHandle):
    """The trajectory data server over the socket transport, with
    ``ProcDataServer``'s ticket semantics as RPCs: ``try_claim(i, k)``
    grants ``min(k, remaining)`` under the plane's one lock (a denied claim
    sleeps ``claim_backoff`` here), ``refund_inflight`` returns exactly the
    stranded count of a collector that died between claim and push, and a
    push that times out on a full queue raises
    :class:`~repro_torch.core.servers.BackpressureError` with the same
    diagnosis. All counters live on the plane, so a collector killed and
    replaced resumes the GLOBAL count."""

    def __init__(self, addr, *, n_collectors: int = 1,
                 push_timeout: float = 30.0, claim_backoff: float = 0.002,
                 timeout: float = 60.0):
        # the RPC timeout must exceed the plane's full-queue wait
        super().__init__(addr, timeout=max(timeout, push_timeout + 30.0))
        self.n_collectors = max(int(n_collectors), 1)
        self.push_timeout = float(push_timeout)
        self.claim_backoff = float(claim_backoff)

    def _raise_backpressure(self, collector_id, timeout, maxsize):
        raise BackpressureError(
            f"trajectory queue full: collector {collector_id} waited "
            f"{timeout:.1f}s to push and the queue still holds "
            f"{maxsize} (maxsize) undrained items. The slowest "
            "consumer is the model worker's drain->ring-write path "
            "(ModelLearningWorker._refresh_data); raise "
            "RunConfig.push_timeout_s, enlarge the queue, or check "
            "whether the model process is wedged/compiling."
        ) from None

    def _push_blob(self, blob: bytes, n: int, collector_id: int,
                   timeout: Optional[float]) -> int:
        timeout = self.push_timeout if timeout is None else timeout
        op, total, _, _, _ = self._rpc(
            F.OP_DPUSH, word=int(timeout * 1000), aux=int(collector_id),
            flags=int(n), payload=blob)
        if op == F.OP_FULL:
            self._raise_backpressure(collector_id, timeout, total or 512)
        return total

    def push(self, traj, *, collector_id: int = 0,
             timeout: Optional[float] = None) -> int:
        """One trajectory as a tree frame (one host copy of each leaf),
        settling one in-flight ticket on the plane."""
        return self._push_blob(F.encode_tree(traj), 1, collector_id,
                               timeout)

    def push_batch(self, batch, n: int, *, collector_id: int = 0,
                   timeout: Optional[float] = None) -> int:
        """``n`` stacked trajectories as ONE queue item (one frame, one
        settlement of n); ``drain`` unstacks the lanes."""
        return self._push_blob(F.encode_tree(batch), int(n), collector_id,
                               timeout)

    def try_claim(self, collector_id: int = 0, k: int = 1) -> int:
        """Reserve up to ``k`` slots toward the global target (one RPC);
        0 once the target is fully claimed, after ``claim_backoff``."""
        _, g, _, _, _ = self._rpc(F.OP_DCLAIM, word=int(k),
                                  aux=int(collector_id))
        if g == 0:
            time.sleep(self.claim_backoff)
        return g

    def refund_inflight(self, collector_id: int) -> int:
        """Return exactly the tickets ``collector_id`` claimed but never
        pushed; a second refund is 0."""
        _, g, _, _, _ = self._rpc(F.OP_DREFUND, aux=int(collector_id))
        return g

    def drain(self) -> List[Any]:
        """Everything queued, in push order, as per-trajectory dicts of CPU
        tensors; a batch item is unstacked into views along its lane
        axis."""
        _, count, _, _, payload = self._rpc(F.OP_DDRAIN)
        out: List[Any] = []
        for n, blob in F.unpack_drain_items(payload, count):
            tree = F.decode_tree(blob)
            if n > 1:
                out.extend({k: v[i] for k, v in tree.items()}
                           for i in range(n))
            else:
                out.append(tree)
        return out

    def set_target(self, total: int) -> None:
        """Arm the stopping criterion: from now on claims grant exactly
        ``total - total_pushed`` more slots."""
        self._rpc(F.OP_DTARGET, word=int(total))

    @property
    def total_pushed(self) -> int:
        """The exact global trajectory count (one RPC)."""
        _, total, _, _, _ = self._rpc(F.OP_DTOTAL)
        return total

    def __len__(self) -> int:
        _, n, _, _, _ = self._rpc(F.OP_DLEN)
        return n
