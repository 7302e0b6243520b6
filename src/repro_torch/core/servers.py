"""Servers of the paper's Fig. 1a: the port of the in-process
``ParameterServer``, ``DataServer``, ``ReplayBuffer``, ``LocalBuffer``, the
``ParameterTransport`` / ``DataTransport`` protocols and
``BackpressureError`` in ``repro/core/servers.py``.

Values stay on the device. ``ParameterServer.push`` snapshots every tensor
of a tree (a serving state dict, or an MBRL tree of lists and dicts) with a
device copy (``clone``), so a published version is isolated from buffers
the pusher goes on to update in place. ``pull_if_newer`` on an unchanged
version is a lock and an integer compare: no copy, no tree traversal, no
host sync. ``pull_host`` is the one device->host hop, for checkpoints.

Across CUDA streams. The threads engine runs each worker on a stream of its
own, so a value pushed from one stream is read from another. A push records
a ``torch.cuda.Event`` on the pusher's current stream after its copy (the
data server: after the pusher's last write); a pull that hands the value out
makes the puller's current stream wait on that event and marks every CUDA
tensor it hands out as used by that stream (``record_stream``), so the
caching allocator does not give the memory of a superseded version back to
the pusher's stream while the puller's kernels may still read it. Neither
step waits on the host. On the CPU there is no event and nothing to do.
"""
from __future__ import annotations

import threading
import time
from typing import (Any, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@runtime_checkable
class ParameterTransport(Protocol):
    """What every parameter store guarantees (the reference's seam):

    * ``push(value) -> version``: publish atomically; each push bumps the
      version by 1.
    * ``pull_if_newer(version) -> (value|None, version)``: the unchanged
      path transfers nothing.
    * ``pull() -> (value|None, version)``: unconditional latest.
    * ``pull_host() -> (host value|None, version)``: the only device->host
      boundary (checkpoints).
    * ``version -> int``: 0 means nothing pushed yet.
    """

    def push(self, value) -> int: ...
    def pull(self): ...
    def pull_if_newer(self, version: int): ...
    def pull_host(self): ...
    @property
    def version(self) -> int: ...


@runtime_checkable
class DataTransport(Protocol):
    """What every trajectory data server guarantees (the reference's seam):
    multi-producer ``push`` / ``push_batch`` with an exact ``total_pushed``;
    ``try_claim`` grants ``min(k, remaining)`` toward the armed target;
    ``refund_inflight`` returns a dead collector's unpushed tickets;
    ``drain`` moves everything queued to the caller."""

    def push(self, traj, *, collector_id: int = 0) -> int: ...
    def push_batch(self, batch, n: int, *, collector_id: int = 0) -> int: ...
    def set_target(self, total: int) -> None: ...
    def try_claim(self, collector_id: int = 0, k: int = 1) -> int: ...
    def refund_inflight(self, collector_id: int) -> int: ...
    def drain(self) -> List[Any]: ...
    @property
    def total_pushed(self) -> int: ...
    def __len__(self) -> int: ...


def _ready_event(value) -> Optional["torch.cuda.Event"]:
    """An event recorded on the current stream of the first CUDA tensor's
    device, once the work queued so far (the pusher's writes) is done; None
    for a tree with no CUDA tensor."""
    for leaf in tree_leaves(value):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(leaf.device))
            return ev
    return None


def _hand_over(values, events) -> None:
    """Make the caller's current stream wait on each event, and mark every
    CUDA tensor of ``values`` as used by that stream."""
    if not events:
        return
    stream = torch.cuda.current_stream()
    for ev in events:
        stream.wait_event(ev)
    for leaf in tree_leaves(values):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().to("cpu", copy=True).numpy()


class ParameterServer:
    """Versioned store of tensor trees, Alg. 1/2/3 'Pull/Push
    parameters'."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._ready = None
        self._version = 0

    @staticmethod
    def _snapshot(value):
        # device->device copy; never a host transfer
        return tree_map(lambda t: t.detach().clone(), value)

    def push(self, value) -> int:
        snap = self._snapshot(value)    # copy outside the lock
        ready = _ready_event(snap)
        with self._lock:
            self._value = snap
            self._ready = ready
            self._version += 1
            return self._version

    def pull(self):
        """Returns (value, version); value is None until the first push."""
        with self._lock:
            value, ready, version = self._value, self._ready, self._version
        if value is not None and ready is not None:
            _hand_over(value, (ready,))
        return value, version

    def pull_if_newer(self, version: int):
        """(value, current_version) when the store holds something newer
        than ``version``, else (None, current_version). The unchanged path
        is one lock + int compare."""
        with self._lock:
            if self._version == version or self._value is None:
                return None, self._version
            value, ready, version = self._value, self._ready, self._version
        if ready is not None:
            _hand_over(value, (ready,))
        return value, version

    def pull_host(self):
        """(host numpy tree, version), or (None, version) before the first
        push: the one device->host copy of the store, for checkpoints. The
        arrays are the caller's own copies; bf16 leaves, which numpy cannot
        hold, come back widened to float32 (exactly)."""
        with self._lock:
            value, version = self._value, self._version
        if value is None:
            return None, version
        return tree_map(_host_copy, value), version

    @property
    def version(self) -> int:
        with self._lock:
            return self._version


class BackpressureError(RuntimeError):
    """A bounded queue stayed full past its timeout: the consumer is not
    keeping up with its producers."""


class DataServer:
    """FIFO trajectory buffer server (Alg. 1 'Push data', Alg. 2 line 3:
    'move all trajectories from the remote buffer').

    Multi-producer: any number of collectors push concurrently; one lock
    keeps ``total_pushed`` exact under interleaved pushes. The global
    stopping criterion is a ticket counter: ``set_target(n)`` arms it and
    ``try_claim(collector_id, k)`` grants ``min(k, remaining)`` collection
    slots under the lock, so a fleet of farms lands on ``total_pushed ==
    n`` EXACTLY. A denied claim sleeps ``claim_backoff`` seconds before
    returning. Pushed trajectories are stored by reference (device
    tensors, no host copy), each with the event of its push; a pushed batch
    is unstacked into per-lane views. ``drain`` hands them to the caller's
    stream (see the module docstring)."""

    def __init__(self, *, claim_backoff: float = 0.002):
        self.claim_backoff = float(claim_backoff)
        self._lock = threading.Lock()
        self._items: List[Any] = []
        self._events: List[Any] = []     # one per push, or None
        self._total = 0
        self._target: Optional[int] = None
        self._tickets = 0
        self._inflight: Dict[int, int] = {}

    def push(self, traj, *, collector_id: int = 0) -> int:
        ready = _ready_event(traj)
        with self._lock:
            self._items.append(traj)
            self._events.append(ready)
            self._total += 1
            self._dec_inflight(collector_id, 1)
            return self._total

    def push_batch(self, batch, n: int, *, collector_id: int = 0) -> int:
        """Push ``n`` trajectories stacked as one batch (dict of
        (n, H, ...) tensors — a farm step's output). Consumers see
        per-trajectory dicts; ``total_pushed`` moves by n in one step."""
        lanes = [{k: v[i] for k, v in batch.items()} for i in range(n)]
        ready = _ready_event(batch)
        with self._lock:
            self._items.extend(lanes)
            self._events.append(ready)
            self._total += n
            self._dec_inflight(collector_id, n)
            return self._total

    def set_target(self, total: int) -> None:
        """Arm the stopping criterion: from now on ``try_claim`` grants
        exactly ``total - total_pushed`` more collection slots."""
        with self._lock:
            self._target = int(total)
            self._tickets = self._total

    def try_claim(self, collector_id: int = 0, k: int = 1) -> int:
        """Reserve up to ``k`` collection slots toward the armed target,
        in flight for ``collector_id`` until the matching push lands.
        Returns ``min(k, remaining)``, 0 once the target is fully claimed;
        with no target, ``k``."""
        k = int(k)
        with self._lock:
            g = k if self._target is None else \
                min(k, max(self._target - self._tickets, 0))
            if g > 0:
                self._tickets += g
                self._inflight[collector_id] = \
                    self._inflight.get(collector_id, 0) + g
                return g
        time.sleep(self.claim_backoff)
        return 0

    def refund_inflight(self, collector_id: int) -> int:
        """Return every ticket ``collector_id`` claimed but never pushed
        (its collector died mid-batch). Returns the number refunded."""
        with self._lock:
            g = self._inflight.pop(collector_id, 0)
            self._tickets -= g
            return g

    def _dec_inflight(self, collector_id: int, n: int) -> None:
        # already holding self._lock; pushes need no claim, so clamp at 0
        left = self._inflight.get(collector_id, 0) - n
        if left > 0:
            self._inflight[collector_id] = left
        else:
            self._inflight.pop(collector_id, None)

    def drain(self) -> List[Any]:
        """Move ALL pending trajectories to the caller (empties server)."""
        with self._lock:
            items, self._items = self._items, []
            events, self._events = self._events, []
        _hand_over(items, [ev for ev in events if ev is not None])
        return items

    @property
    def total_pushed(self) -> int:
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class ReplayBuffer:
    """Preallocated fixed-capacity transition ring on the device, with a
    held-out validation ring (Alg. 2: the model learner trains on its LOCAL
    buffer; §4 'The local buffer is of fixed size and first-in-first-out').

    Every ``round(1 / holdout_frac)``-th trajectory goes to the validation
    ring. ``train_view``/``val_view`` return the full-capacity tensors plus
    the count of valid rows, so a consumer's shapes never change as data
    accumulates. A drain of M trajectories lands in bursts: one scatter per
    chunk of up to ``burst_capacity`` equal-horizon trajectories whose
    target rows are distinct, and a later chunk overwrites an earlier one
    exactly as sequential FIFO writes would — the same ring contents as the
    reference's ``_ring_write_burst``. Writes are in place (``index_copy_``):
    a view is a borrow, to re-fetch after every insert.
    """

    def __init__(self, capacity: int, *, val_capacity: Optional[int] = None,
                 holdout_frac: float = 0.2, burst_capacity: int = 8,
                 device=None):
        self.burst_capacity = max(int(burst_capacity), 1)
        self.capacity = int(capacity)
        self.val_capacity = int(val_capacity if val_capacity is not None
                                else max(self.capacity // 4, 1))
        self.holdout_frac = holdout_frac
        self._every = (max(int(round(1 / holdout_frac)), 2)
                       if holdout_frac > 0 else 0)
        self._device = device
        self._train: Optional[Dict[str, torch.Tensor]] = None
        self._val: Optional[Dict[str, torch.Tensor]] = None
        self._cursor = 0          # next train write position (transitions)
        self._written = 0         # total train transitions ever written
        self._val_cursor = 0
        self._val_written = 0
        self._trajs = 0           # total trajectories ever seen

    def _alloc(self, traj) -> None:
        dev = self._device
        if dev is None:
            dev = next(iter(traj.values())).device

        def zeros(t, cap):
            return torch.zeros((cap,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=dev)
        self._train = {k: zeros(v, self.capacity) for k, v in traj.items()}
        if self._every:     # holdout_frac == 0 never writes the val ring
            self._val = {k: zeros(v, self.val_capacity)
                         for k, v in traj.items()}

    def _scatter(self, flat, rows: int, val: bool) -> None:
        """Write ``rows`` flattened transitions at the ring's cursor
        (wrapping); ``rows`` never exceeds the ring's capacity."""
        ring = self._val if val else self._train
        cap = self.val_capacity if val else self.capacity
        cursor = self._val_cursor if val else self._cursor
        dev = next(iter(ring.values())).device
        idx = (cursor + torch.arange(rows, device=dev)) % cap
        for k, buf in ring.items():
            buf.index_copy_(0, idx, flat[k].to(device=dev, dtype=buf.dtype))
        if val:
            self._val_cursor = (cursor + rows) % cap
            self._val_written += rows
        else:
            self._cursor = (cursor + rows) % cap
            self._written += rows

    def _write_one(self, traj, val: bool) -> None:
        """One trajectory into one ring. FIFO semantics for a trajectory
        longer than its ring: keep the last ``cap`` transitions."""
        cap = self.val_capacity if val else self.capacity
        h = int(next(iter(traj.values())).shape[0])
        if h > cap:
            traj, h = {k: v[-cap:] for k, v in traj.items()}, cap
        self._scatter(traj, h, val)

    def _write_chunk(self, chunk, h: int, val: bool) -> None:
        flat = {k: torch.cat([t[k] for t in chunk]) for k in chunk[0]}
        self._scatter(flat, len(chunk) * h, val)

    def _burst_to_ring(self, group, val: bool) -> None:
        """Write a group of trajectories destined for ONE ring in chunks
        capped at ``burst_capacity`` trajectories AND at the ring's
        capacity in rows, so every target index in a chunk is distinct."""
        cap = self.val_capacity if val else self.capacity
        i = 0
        while i < len(group):
            h0 = int(next(iter(group[i].values())).shape[0])
            chunk, rows = [group[i]], h0
            i += 1
            while i < len(group) and len(chunk) < self.burst_capacity:
                h = int(next(iter(group[i].values())).shape[0])
                if h != h0 or rows + h > cap:
                    break
                chunk.append(group[i])
                rows += h
                i += 1
            if len(chunk) == 1:
                self._write_one(chunk[0], val)
            else:
                self._write_chunk(chunk, h0, val)

    def _is_val(self) -> bool:
        return bool(self._every and self._trajs % self._every == 0)

    def add_traj(self, traj) -> None:
        """Insert one trajectory (dict of (H, ...) tensors)."""
        if self._train is None:
            self._alloc(traj)
        self._trajs += 1
        self._write_one(traj, val=self._is_val())

    def add_trajs(self, trajs) -> None:
        """Insert a BURST of trajectories (a fleet drain). The train/val
        interleave advances per trajectory in arrival order, exactly as
        repeated ``add_traj`` calls would."""
        trajs = list(trajs)
        if not trajs:
            return
        if self._train is None:
            self._alloc(trajs[0])
        groups = {False: [], True: []}
        for traj in trajs:
            self._trajs += 1
            groups[self._is_val()].append(traj)
        self._burst_to_ring(groups[False], val=False)
        self._burst_to_ring(groups[True], val=True)

    def extend(self, trajs) -> int:
        trajs = list(trajs)
        if len(trajs) == 1:
            self.add_traj(trajs[0])
        elif trajs:
            self.add_trajs(trajs)
        return len(trajs)

    def train_view(self) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        """(full-capacity storage, number of valid rows)."""
        return self._train, self.size

    def val_view(self) -> Tuple[Optional[Dict[str, torch.Tensor]], int]:
        return self._val, self.val_size

    @property
    def size(self) -> int:
        return min(self._written, self.capacity)

    @property
    def val_size(self) -> int:
        return min(self._val_written, self.val_capacity)

    @property
    def total_seen(self) -> int:
        """Total trajectories ever inserted (incl. evicted ones)."""
        return self._trajs


class LocalBuffer:
    """Legacy fixed-size FIFO list buffer with a held-out validation split.

    Superseded on the hot path by :class:`ReplayBuffer` (static shapes, no
    per-epoch concatenate); kept for tooling that wants host-side
    trajectory lists. Every ``round(1 / holdout_frac)``-th trajectory goes
    to the validation list (at most ``max(max_trajs // 4, 1)``), the rest
    to the training list (at most ``max_trajs``), oldest evicted first."""

    def __init__(self, max_trajs: int = 200, holdout_frac: float = 0.2):
        self.max_trajs = max_trajs
        self.holdout_frac = holdout_frac
        self._train: List[Any] = []
        self._val: List[Any] = []
        self._count = 0

    def extend(self, trajs) -> int:
        trajs = list(trajs)
        for t in trajs:
            self._count += 1
            # deterministic interleave keeps val non-empty and ~frac
            if self.holdout_frac > 0 and self._count % max(
                    int(round(1 / self.holdout_frac)), 2) == 0:
                self._val.append(t)
                if len(self._val) > max(self.max_trajs // 4, 1):
                    self._val.pop(0)
            else:
                self._train.append(t)
                if len(self._train) > self.max_trajs:
                    self._train.pop(0)
        return len(trajs)

    @staticmethod
    def _stack(items):
        if not items:
            return None
        return {k: np.concatenate([np.asarray(
            t[k].detach().cpu() if isinstance(t[k], torch.Tensor) else t[k])
            for t in items], axis=0) for k in items[0]}

    def train_arrays(self):
        return self._stack(self._train)

    def val_arrays(self):
        return self._stack(self._val if self._val else self._train[-1:])

    @property
    def n_train(self):
        return len(self._train)

    @property
    def total_seen(self):
        return self._count
