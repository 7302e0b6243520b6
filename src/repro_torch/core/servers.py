"""Servers of the paper's Fig. 1a: the port of the in-process
``ParameterServer``, ``DataServer``, ``ReplayBuffer``, ``LocalBuffer``, the
``ParameterTransport`` / ``DataTransport`` protocols and
``BackpressureError`` in ``repro/core/servers.py``, and of its procs half
(``ShmParameterServer``, ``ProcDataServer``, the lifetime registries) over
mapped files, with the procs engine's control block ``ProcControl``: see
the "procs IPC" section below.

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

import contextlib
import fcntl
import mmap
import os
import shutil
import struct
import tempfile
import threading
import time
from typing import (Any, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.checkpoint.io import (LeafCodec, flatten, layout_codec,
                                       unflatten)
from repro_torch.core.roles import (RowShards, home_device, num_shards,
                                    round_up, shard_devices)
from repro_torch.kernels import LAUNCH_COUNTERS
from repro_torch.utils.tree import tree_leaves, tree_map, tree_to


@runtime_checkable
class ParameterTransport(Protocol):
    """What every parameter store guarantees (the reference's seam):

    * ``push(value) -> version``: publish atomically; each push bumps the
      version by 1.
    * ``pull_if_newer(version, *, sharding=None) -> (value|None,
      version)``: the unchanged path transfers nothing; ``sharding`` is
      the puller's placement (the in-process store honours it, the
      cross-process ones return host tensors and ignore it).
    * ``pull() -> (value|None, version)``: unconditional latest.
    * ``pull_host() -> (host value|None, version)``: the only device->host
      boundary (checkpoints).
    * ``version -> int``: 0 means nothing pushed yet.
    """

    def push(self, value) -> int: ...
    def pull(self): ...
    def pull_if_newer(self, version: int, *, sharding=None): ...
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
    """Make the caller's current stream wait on each event, and so the
    caller's current stream on every other card that holds a CUDA tensor
    of ``values`` (an event recorded on one card can be waited on from
    another); mark every such tensor as used by the current stream of its
    own card."""
    if not events:
        return
    here = torch.cuda.current_stream()
    for ev in events:
        here.wait_event(ev)
    streams = {}
    for leaf in tree_leaves(values):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            stream = streams.get(leaf.device)
            if stream is None:
                stream = streams[leaf.device] = \
                    torch.cuda.current_stream(leaf.device)
                if stream != here:
                    for ev in events:
                        stream.wait_event(ev)
            leaf.record_stream(stream)


def _device_of(value) -> Optional[torch.device]:
    """The device of a tree's first tensor (one tree holds one role's
    params, so its leaves share a placement); None for a tree without."""
    for leaf in tree_leaves(value):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return None


def _host_copy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().to("cpu", copy=True).numpy()


class ParameterServer:
    """Versioned store of tensor trees, Alg. 1/2/3 'Pull/Push
    parameters'.

    Placement-aware (role meshes, core/roles.py): ``push`` records the
    device the value lives on; ``pull_if_newer(version, sharding=...)``
    copies it device to device onto the puller's placement, only on a
    version change and only when the placement differs. The unchanged path
    stays one lock + int compare."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._ready = None
        self._src = None
        self._version = 0

    @staticmethod
    def _snapshot(value):
        # device->device copy; never a host transfer
        return tree_map(lambda t: t.detach().clone(), value)

    def push(self, value) -> int:
        snap = self._snapshot(value)    # copy outside the lock
        ready = _ready_event(snap)
        src = _device_of(snap)
        with self._lock:
            self._value = snap
            self._ready = ready
            self._src = src
            self._version += 1
            return self._version

    def pull(self):
        """Returns (value, version); value is None until the first push."""
        with self._lock:
            value, ready, version = self._value, self._ready, self._version
        if value is not None and ready is not None:
            _hand_over(value, (ready,))
        return value, version

    def pull_if_newer(self, version: int, *, sharding=None):
        """(value, current_version) when the store holds something newer
        than ``version``, else (None, current_version). The unchanged path
        is one lock + int compare: no copy, no tree traversal, no host
        sync.

        ``sharding``: the puller's placement (``roles.replicated(mesh)``
        or a ``SingleDeviceSharding``). On a version change the value is
        copied device to device onto its device (``roles.home_device``),
        after the source card's stream waits on the push; when it already
        lives there, the stored tensors come back as they are."""
        with self._lock:
            if self._version == version or self._value is None:
                return None, self._version
            value, ready, version = self._value, self._ready, self._version
            src = self._src
        if ready is not None:
            _hand_over(value, (ready,))
        if sharding is not None:
            dst = home_device(sharding)
            if src is not None and dst != src:
                value = tree_to(value, dst)
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

    ``sharding`` (role meshes, core/roles.py): a ``batch_sharded``
    placement over the owning worker's sub-mesh. Storage is allocated
    PRE-SHARDED: each ring is a dict of ``roles.RowShards``, shard i's block
    of rows on shard i's device. Capacities are rounded up to the shard
    count. A write reaches every shard's device once (the trajectory, or a
    burst's rows, copied there before the write, as the reference
    replicates it onto the sub-mesh), then each shard copies the rows that
    land in its block: slices of host-known bounds, so no shape depends on
    the data and nothing waits on the device.
    """

    def __init__(self, capacity: int, *, val_capacity: Optional[int] = None,
                 holdout_frac: float = 0.2, burst_capacity: int = 8,
                 device=None, sharding=None):
        self.burst_capacity = max(int(burst_capacity), 1)
        self._shard_devices = None
        if sharding is not None:
            nsh = num_shards(sharding)
            capacity = round_up(capacity, nsh)
            val_capacity = round_up(
                max(int(capacity) // 4, 1) if val_capacity is None
                else val_capacity, nsh)
            self._shard_devices = shard_devices(sharding)
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
            if self._shard_devices is None:
                return torch.zeros((cap,) + tuple(t.shape[1:]),
                                   dtype=t.dtype, device=dev)
            per = cap // len(self._shard_devices)
            return RowShards([torch.zeros((per,) + tuple(t.shape[1:]),
                                          dtype=t.dtype, device=d)
                              for d in self._shard_devices])
        self._train = {k: zeros(v, self.capacity) for k, v in traj.items()}
        if self._every:     # holdout_frac == 0 never writes the val ring
            self._val = {k: zeros(v, self.val_capacity)
                         for k, v in traj.items()}

    def _scatter_sharded(self, ring, flat, rows: int, cursor: int,
                         cap: int) -> None:
        """The rows of a write go to each shard's device once, then each
        shard copies the runs of rows that land in its block. The target
        rows ``(cursor + r) % cap`` are at most two runs, known on the
        host."""
        per = cap // len(self._shard_devices)
        runs = [(cursor, min(rows, cap - cursor), 0)]
        if runs[0][1] < rows:
            runs.append((0, rows - runs[0][1], runs[0][1]))
        placed = {dev: {k: v.to(dev) for k, v in flat.items()}
                  for dev in dict.fromkeys(self._shard_devices)}
        for i, dev in enumerate(self._shard_devices):
            lo, hi = i * per, (i + 1) * per
            here = placed[dev]
            for start, n, src in runs:
                a, b = max(start, lo), min(start + n, hi)
                if a >= b:
                    continue
                for k, shards in ring.items():
                    shards.shards[i][a - lo:b - lo].copy_(
                        here[k][src + a - start:src + b - start])

    def _scatter(self, flat, rows: int, val: bool) -> None:
        """Write ``rows`` flattened transitions at the ring's cursor
        (wrapping); ``rows`` never exceeds the ring's capacity."""
        ring = self._val if val else self._train
        cap = self.val_capacity if val else self.capacity
        cursor = self._val_cursor if val else self._cursor
        if self._shard_devices is not None:
            self._scatter_sharded(ring, flat, rows, cursor, cap)
        else:
            dev = next(iter(ring.values())).device
            idx = (cursor + torch.arange(rows, device=dev)) % cap
            for k, buf in ring.items():
                buf.index_copy_(0, idx,
                                flat[k].to(device=dev, dtype=buf.dtype))
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
        """(full-capacity storage, number of valid rows); with a
        ``sharding``, each value is a ``roles.RowShards``."""
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


# ----------------------------------------------------------------- procs IPC
#
# The cross-process stores of ``AsyncTrainer(mode="procs")``: the port of
# the reference's ``ShmParameterServer`` and ``ProcDataServer``. Each lives
# in files under the run's own temporary directory, mapped with ``mmap``,
# so a run makes no ``/dev/shm`` entry and uses no ``multiprocessing``
# lock, event, queue, value or array (each of which makes one there). The
# parent creates them before it spawns the workers; their handles pickle
# to a path and a layout of plain values, never a tensor, and re-attach
# lazily in each child. Cross-process locking is ``fcntl.flock``, which the
# kernel releases when its holder dies, so a killed worker cannot wedge the
# others.

_SHM_HEADER = 64            # [0:8) seqlock, [8:16) version, rest reserved
_SHM_ALIGN = 64             # leaf payloads start cache-line aligned
_WRITER_WAIT_S = 30.0       # a restarted writer waits this long for the
#                             dead one's file lock before it raises

# ---- auditable lifetime registries ---------------------------------------
# Every IPC resource this PROCESS creates is registered at birth and
# unregistered by its close(), so an auditor can prove that nothing leaked
# and a last-resort cleanup can reclaim stragglers.
_REGISTRY_LOCK = threading.Lock()
_SHM_REGISTRY: Dict[str, "ShmParameterServer"] = {}
_DATA_REGISTRY: Dict[int, "ProcDataServer"] = {}


def live_shm_segments() -> Tuple[str, ...]:
    """Paths of the parameter-store files created by this process and not
    yet closed (and removed). Empty after every clean or chaotic
    shutdown."""
    with _REGISTRY_LOCK:
        return tuple(sorted(_SHM_REGISTRY))


def live_data_servers() -> int:
    """Count of ProcDataServers constructed by this process whose
    ``close()`` has not run yet."""
    with _REGISTRY_LOCK:
        return len(_DATA_REGISTRY)


def reclaim_ipc_resources() -> int:
    """Close every still-registered parameter store and data server created
    by this process; returns how many were reclaimed. Safe to call
    repeatedly; a normal shutdown leaves nothing for it to do."""
    with _REGISTRY_LOCK:
        stragglers = list(_SHM_REGISTRY.values()) + \
            list(_DATA_REGISTRY.values())
    for res in stragglers:
        try:
            res.close()
        except OSError:
            pass
    return len(stragglers)


def _numpy(x) -> np.ndarray:
    """One host copy of a tensor or array (bf16 widened to f32)."""
    return _host_copy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


class _MappedFile:
    """A file of fixed size mapped shared into every process that touches
    it. The creating process owns the file and removes it on ``close``;
    a handle pickles to its path and re-opens it lazily, so every process
    holds its own descriptor (and so its own ``flock`` state)."""

    def __init__(self, path: str, size: int):
        self._path = str(path)
        self._size = int(size)
        self._owner = True
        self._fd: Optional[int] = None
        self._mm = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state.update(_fd=None, _mm=None, _owner=False)
        return state

    def _map(self):
        if self._mm is None:
            self._fd = os.open(self._path, os.O_RDWR)
            self._mm = mmap.mmap(self._fd, self._size)
        return self._mm

    def _word(self, off: int) -> int:
        return struct.unpack_from("<q", self._map(), off)[0]

    def _set_word(self, off: int, value: int) -> None:
        struct.pack_into("<q", self._map(), off, int(value))

    def _unmap(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._fd is not None:
            os.close(self._fd)      # releases any flock this handle held
            self._fd = None


def _create_file(dir, prefix: str, size: int) -> str:
    """A new zero-filled file of ``size`` bytes under ``dir``."""
    fd, path = tempfile.mkstemp(prefix=prefix, dir=dir)
    try:
        os.ftruncate(fd, size)
    finally:
        os.close(fd)
    return path


class ShmParameterServer(_MappedFile):
    """Versioned parameter store in ONE mapped file, the reference's layout:
    a 64-byte header (``[0:8)`` the seqlock word, ``[8:16)`` the version
    word), then each leaf's bytes in ``checkpoint/io.LeafCodec`` order,
    each starting on a 64-byte boundary. The tree's structure is fixed at
    construction from a template; a push is one copy per leaf, never a
    pickle.

    Concurrency is a single-writer seqlock (each store is written by one
    role, the model or the policy worker):

    * ``push``: bump the sequence word to odd, copy the payload, bump it to
      even, then bump the version word (one aligned 8-byte store), so the
      version never points at a torn payload.
    * ``pull_if_newer(version)``: ONE aligned 8-byte read when unchanged,
      no copy and no lock (``copies`` counts the leaves copied out). On a
      change the payload is copied out inside a stable even-sequence
      window, retrying while a writer overlaps, into tensors on the CPU;
      the worker moves them onto its device once.
    * A writer killed mid-push leaves the sequence odd: readers keep their
      cache and the restarted writer's next push re-synchronises it.

    The writer takes an exclusive ``flock`` on the file at its first push
    and keeps it for its life, so a restarted writer waits until the dead
    one's lock is gone (the kernel drops it with the process). Readers
    never lock.

    Benign race, as the reference's: the version is bumped after the
    payload settles, so a reader can get a fresher payload under the
    previous version; the next gated pull copies again, never torn data.
    """

    _READ_RETRIES = 64

    def __init__(self, template, *, dir: Optional[str] = None):
        codec = LeafCodec(template)
        offsets, off = [], _SHM_HEADER
        for n in codec.nbytes:
            offsets.append(off)
            off += max(int(n), 1)
            off += (-off) % _SHM_ALIGN
        super().__init__(_create_file(dir, "params-", off), off)
        # the layout as plain values: a handle sent to a child carries no
        # tensor (torch would move a pickled tensor into /dev/shm)
        self._skeleton = unflatten(template, [0] * len(flatten(template)))
        self._leaves = list(zip(codec.dtypes, codec.shapes))
        self._offsets = offsets
        self._codec = None
        self._views = None
        self._writer = False
        self.copies = 0             # this handle: leaves copied OUT
        self.pushes = 0             # this handle: pushes issued
        with _REGISTRY_LOCK:
            _SHM_REGISTRY[self._path] = self

    def __getstate__(self):
        state = super().__getstate__()
        state.update(_codec=None, _views=None, _writer=False)
        return state

    @property
    def path(self) -> str:
        return self._path

    def _leaf_codec(self):
        """The codec of a CPU template rebuilt from the layout: pulls
        decode into CPU tensors of the template's dtypes and shapes."""
        if self._codec is None:
            self._codec = layout_codec(self._skeleton,
                                       *zip(*self._leaves))
        return self._codec

    def _leaf_views(self):
        if self._views is None:
            mm = self._map()
            codec = self._leaf_codec()
            self._views = [
                np.frombuffer(mm, dtype=sd,
                              count=int(np.prod(sh, dtype=np.int64)),
                              offset=off).reshape(sh)
                for sd, sh, off in zip(codec.storable_dtypes, codec.shapes,
                                       self._offsets)]
        return self._views

    def _take_writer_lock(self) -> None:
        self._map()
        deadline = time.monotonic() + _WRITER_WAIT_S
        while True:
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"another live writer holds {self._path} after "
                        f"{_WRITER_WAIT_S:.0f} s: a parameter store has "
                        "one writer") from None
                time.sleep(0.01)
        self._writer = True

    def push(self, value) -> int:
        host = self._leaf_codec().encode(value)   # the one device->host hop
        if not self._writer:
            self._take_writer_lock()
        views = self._leaf_views()
        seq = self._word(0)
        begin = seq + 1 + (seq % 2)         # next odd > seq, even if a
        self._set_word(0, begin)            # killed writer left it odd
        for view, arr in zip(views, host):
            np.copyto(view, arr, casting="no")
        self._set_word(0, begin + 1)        # payload settled (even)
        ver = self._word(8) + 1             # single writer: RMW is safe
        self._set_word(8, ver)
        self.pushes += 1
        return ver

    def pull_if_newer(self, version: int, *, sharding=None):
        """(value, current_version) when newer than ``version``, else
        (None, version as seen). Unchanged: ONE aligned 8-byte read. The
        value is a tree of CPU tensors, the caller's own. ``sharding`` is
        accepted for interface parity with :class:`ParameterServer` and
        ignored: each process moves the host tensors onto its own
        device."""
        ver = self._word(8)
        if ver == version or ver == 0:
            return None, ver
        views = self._leaf_views()
        for _ in range(self._READ_RETRIES):
            s1 = self._word(0)
            if s1 % 2:                      # writer mid-copy
                time.sleep(0.0005)
                continue
            value = self._leaf_codec().decode(views)    # copies each leaf
            if self._word(0) == s1:         # no writer overlapped
                self.copies += len(views)
                # the version read at ENTRY: the payload is at least that
                # fresh, and a version that completed during the copy
                # must not let the next gated pull skip it
                return value, ver
        # a writer killed mid-push (sequence stuck odd) or pathological
        # contention: degrade, the caller keeps its cache and retries
        return None, version

    def pull(self):
        value, ver = self.pull_if_newer(-1)
        return value, (ver if value is not None else self.version)

    def pull_host(self):
        """(host numpy tree, version), or (None, version) before the first
        push or while a writer is stuck mid-push; bf16 leaves widened to
        float32, as ``ParameterServer.pull_host``."""
        value, ver = self.pull()
        if value is None:
            return None, ver
        return tree_map(_host_copy, value), ver

    @property
    def version(self) -> int:
        return self._word(8)

    def close(self) -> None:
        """Drop this process's mapping (and remove the file if this process
        created it). Idempotent."""
        self._views = None          # np views pin the mapping: drop first
        self._unmap()
        self._writer = False
        if self._owner:
            try:
                os.unlink(self._path)
            except FileNotFoundError:
                pass
            with _REGISTRY_LOCK:
                _SHM_REGISTRY.pop(self._path, None)

    def __enter__(self) -> "ShmParameterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProcDataServer(_MappedFile):
    """Cross-process DataServer: a bounded trajectory spool. Collectors
    push host copies of their trajectories; the model worker drains them
    into its ring (Alg. 2 'move all trajectories from the remote buffer').

    Trajectories travel as files in a spool directory: each push writes
    ``*.tmp``, then, under the counter lock, renames it to the next
    sequence number's ``<seq>.npz`` and moves the counters, so ``drain``
    reads whole items in push order and a writer killed mid-write leaves a
    ``.tmp`` that nobody reads. Payloads are numpy arrays (``np.savez``,
    read back without pickle), never torch tensors; a farm's batch is one
    item, unstacked on drain.

    Counters (``total_pushed``, the tickets, the target, the next sequence
    number and each collector's in-flight count) live in a small mapped
    file under one ``flock``, which the kernel releases when its holder
    dies, so a killed collector cannot wedge the fleet. ``try_claim(i, k)``
    grants ``min(k, remaining)`` toward the target and adds the grant to
    collector ``i``'s in-flight count; ``push`` / ``push_batch`` subtract
    what they deliver; the supervising parent calls ``refund_inflight(i)``
    when it respawns a dead collector. One residual window, the
    reference's: a kill between the rename and the counter update lands a
    trajectory the counters do not show, so the refund lets the fleet
    collect one more; ``total_pushed`` (the stopping criterion) stays
    exact and the model trains on an extra trajectory.

    Backpressure: a push finds the spool holding ``maxsize`` undrained
    items, retries for ``push_timeout`` seconds, then raises
    :class:`BackpressureError` naming the queue size and the slowest
    consumer."""

    _TOTAL, _TICKETS, _TARGET, _SEQ, _INFLIGHT = 0, 8, 16, 24, 32

    def __init__(self, *, n_collectors: int = 1, maxsize: int = 512,
                 push_timeout: float = 30.0, target: Optional[int] = None,
                 claim_backoff: float = 0.002, dir: Optional[str] = None):
        self.n_collectors = max(int(n_collectors), 1)
        self.maxsize = int(maxsize)
        self.push_timeout = float(push_timeout)
        self.claim_backoff = float(claim_backoff)
        self._spool = tempfile.mkdtemp(prefix="spool-", dir=dir)
        size = self._INFLIGHT + 8 * self.n_collectors
        super().__init__(_create_file(self._spool, "counters-", size), size)
        self._set_word(self._TARGET, -1 if target is None else int(target))
        self._tlock = threading.Lock()
        self._closed = False
        with _REGISTRY_LOCK:
            _DATA_REGISTRY[id(self)] = self

    def __getstate__(self):
        state = super().__getstate__()
        state.update(_tlock=None, _closed=False)
        return state

    @property
    def spool(self) -> str:
        return self._spool

    @contextlib.contextmanager
    def _locked(self):
        """The counter lock: a thread lock for this process's threads (one
        descriptor's ``flock`` does not exclude them), then the file's."""
        if self._tlock is None:
            self._tlock = threading.Lock()
        with self._tlock:
            self._map()
            fcntl.flock(self._fd, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(self._fd, fcntl.LOCK_UN)

    def _ready(self) -> List[str]:
        return sorted(e.name for e in os.scandir(self._spool)
                      if e.name.endswith(".npz"))

    def _raise_backpressure(self, collector_id, timeout):
        raise BackpressureError(
            f"trajectory queue full: collector {collector_id} waited "
            f"{timeout:.1f}s to push and the queue still holds "
            f"{self.maxsize} (maxsize) undrained items. The slowest "
            "consumer is the model worker's drain->ring-write path "
            "(ModelLearningWorker._refresh_data); raise "
            "RunConfig.push_timeout_s (push_timeout_s="
            f"{self.push_timeout}), enlarge the queue, or check whether "
            "the model process is wedged."
        ) from None

    def _put(self, arrays: Dict[str, np.ndarray], n: int, collector_id: int,
             timeout: Optional[float]) -> int:
        timeout = self.push_timeout if timeout is None else float(timeout)
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self._spool)
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __n__=np.int64(n), **arrays)
        deadline = time.monotonic() + timeout
        while True:
            with self._locked():
                if len(self._ready()) < self.maxsize:
                    seq = self._word(self._SEQ)
                    self._set_word(self._SEQ, seq + 1)
                    os.replace(tmp, os.path.join(self._spool,
                                                 f"{seq:012d}.npz"))
                    total = self._word(self._TOTAL) + max(n, 1)
                    self._set_word(self._TOTAL, total)
                    self._settle_inflight(collector_id, max(n, 1))
                    return total
            if time.monotonic() >= deadline:
                os.unlink(tmp)
                self._raise_backpressure(collector_id, timeout)
            time.sleep(0.005)

    def push(self, traj, *, collector_id: int = 0,
             timeout: Optional[float] = None) -> int:
        return self._put({k: _numpy(v) for k, v in traj.items()}, 0,
                         collector_id, timeout)

    def push_batch(self, batch, n: int, *, collector_id: int = 0,
                   timeout: Optional[float] = None) -> int:
        """Push ``n`` trajectories stacked as one batch (dict of
        (n, H, ...) arrays, a farm step's output) as ONE spool item;
        ``drain`` unstacks it into per-trajectory views."""
        return self._put({k: _numpy(v) for k, v in batch.items()},
                         int(n), collector_id, timeout)

    def _inflight_off(self, collector_id: int) -> int:
        return self._INFLIGHT + 8 * (collector_id % self.n_collectors)

    def _settle_inflight(self, collector_id: int, n: int) -> None:
        # under the lock; pushes need no claim, so clamp at zero
        off = self._inflight_off(collector_id)
        self._set_word(off, max(self._word(off) - n, 0))

    def set_target(self, total: int) -> None:
        """Arm the stopping criterion: from now on ``try_claim`` grants
        exactly ``total - total_pushed`` more collection slots."""
        with self._locked():
            self._set_word(self._TARGET, int(total))
            self._set_word(self._TICKETS, self._word(self._TOTAL))

    def try_claim(self, collector_id: int = 0, k: int = 1) -> int:
        """Reserve up to ``k`` collection slots toward the target, in flight
        for ``collector_id`` until its pushes land. Returns ``min(k,
        remaining)``, 0 once the target is fully claimed (no target:
        ``k``); a denied claim sleeps ``claim_backoff`` outside the lock."""
        k = int(k)
        with self._locked():
            target, tickets = self._word(self._TARGET), \
                self._word(self._TICKETS)
            g = k if target < 0 else min(k, max(target - tickets, 0))
            if g > 0:
                self._set_word(self._TICKETS, tickets + g)
                off = self._inflight_off(collector_id)
                self._set_word(off, self._word(off) + g)
                return g
        time.sleep(self.claim_backoff)
        return 0

    def refund_inflight(self, collector_id: int) -> int:
        """Return every ticket of a collector that died between claim and
        push; returns how many."""
        with self._locked():
            off = self._inflight_off(collector_id)
            g = self._word(off)
            if g > 0:
                self._set_word(off, 0)
                self._set_word(self._TICKETS, self._word(self._TICKETS) - g)
            return g

    def drain(self) -> List[Any]:
        """Move everything spooled to the caller, in push order, as a flat
        list of per-trajectory dicts of CPU tensors; a batch item is
        unstacked into views along its lane axis. One consumer."""
        items: List[Any] = []
        for name in self._ready():
            path = os.path.join(self._spool, name)
            with np.load(path, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
            os.unlink(path)
            n = int(arrays.pop("__n__"))
            tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
            if n == 0:
                items.append(tensors)
            else:
                items.extend({k: v[i] for k, v in tensors.items()}
                             for i in range(n))
        return items

    @property
    def total_pushed(self) -> int:
        """One aligned 8-byte read, no lock: the supervising parent reads it
        every tick, and a collector stopped (SIGSTOP) while it holds the
        counter lock must not stall the parent, which resumes it. After the
        creator's ``close`` it is the count at the close."""
        if self._closed and self._owner:
            return self._final_total
        return self._word(self._TOTAL)

    def __len__(self) -> int:
        return len(self._ready())

    def close(self) -> None:
        """Drop this process's mapping; the creator also removes the spool
        (undrained items included) and its audit entry, and keeps the final
        ``total_pushed``. Idempotent. A child's handle stays usable after
        close: it maps again on use."""
        if self._closed:
            return
        if self._owner:
            self._final_total = self._word(self._TOTAL)
        self._closed = True
        self._unmap()
        if self._owner:
            shutil.rmtree(self._spool, ignore_errors=True)
            with _REGISTRY_LOCK:
                _DATA_REGISTRY.pop(id(self), None)

    def __enter__(self) -> "ProcDataServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ProcControl(_MappedFile):
    """The procs engine's control block, one mapped file: ``[0:8)`` the
    stop word (written by the parent), then one slot of ``FIELDS`` doubles
    per worker role (written by that role's child, one writer a slot,
    aligned 8-byte stores): its last heartbeat on ``CLOCK_MONOTONIC``, its
    ``compile_count``, its work (trajectories, epochs or policy steps), the
    host seconds of the steps that did it, of the first of them, of its
    evals and of a warm-up before its first step, whether it runs on the
    card, the snapshot step it resumed from (+1; 0 for a fresh start), and
    for each of ``kernels.LAUNCH_COUNTERS`` its launches (``launches:<name>``)
    and those of its warm-up (``warmup:<name>``)."""

    FIELDS = (("beat", "compiles", "work", "work_s", "first_s", "eval_s",
               "warmup_s", "cuda", "resumed")
              + tuple(f"launches:{k}" for k in LAUNCH_COUNTERS)
              + tuple(f"warmup:{k}" for k in LAUNCH_COUNTERS))

    def __init__(self, n_slots: int, *, dir: Optional[str] = None):
        size = 8 + 8 * len(self.FIELDS) * int(n_slots)
        super().__init__(_create_file(dir, "control-", size), size)
        self.n_slots = int(n_slots)

    def request_stop(self) -> None:
        self._set_word(0, 1)

    def stop_requested(self) -> bool:
        return self._word(0) != 0

    def write(self, slot: int, values) -> None:
        base = 8 + 8 * len(self.FIELDS) * slot
        for i, v in enumerate(values):
            struct.pack_into("<d", self._map(), base + 8 * i, float(v))

    def read(self, slot: int) -> Dict[str, float]:
        base = 8 + 8 * len(self.FIELDS) * slot
        vals = struct.unpack_from(f"<{len(self.FIELDS)}d", self._map(), base)
        return dict(zip(self.FIELDS, vals))

    def close(self) -> None:
        self._unmap()
        if self._owner:
            try:
                os.unlink(self._path)
            except FileNotFoundError:
                pass
