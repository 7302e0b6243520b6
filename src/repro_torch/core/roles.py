"""Role partitioning of a device mesh for async MBRL: the port of
``repro/core/roles.py``.

The paper runs three workers on three machines; on a host with several
cards the analogue is three groups of cards carved out of one mesh.
``split_roles`` slices one axis of the mesh into collector / model /
policy sub-meshes in a configurable ratio; each worker then runs on its
own sub-mesh while the servers (core/servers.py) carry the pulls and
pushes between them.

The port keeps its own small ``Mesh``: a numpy object array of
``torch.device``s with axis names, the shape ``jax.sharding.Mesh`` has.
It needs no process group (``torch.distributed``'s ``DeviceMesh`` does):
the roles are threads of one process. A mesh may name one device several
times (``launch.mesh.make_mesh(n, device=...)``): every shard then lives
on that device, the counterpart of the reference's forced host devices.

Placement conventions, as in the reference:

* parameters are REPLICATED over their role's sub-mesh (``replicated``).
  The port holds one copy, on the sub-mesh's first device
  (``home_device``); a computation that runs per shard copies the
  parameters to each shard's device for that call, and a shard on the
  home device uses them as they are;
* batch-like data (ring storage, imagined starts) is sharded along the
  sub-mesh's split axis (``batch_sharded``): rows in equal contiguous
  blocks, block i on shard i's device (``shard_devices``; a
  ``RowShards`` holds them);
* cross-role movement happens only through
  ``ParameterServer.pull_if_newer(sharding=...)`` / ``ReplayBuffer``
  ingestion: explicit device-to-device copies, never a host round-trip.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_to


class Mesh:
    """An n-d array of devices with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.size, dtype=object)
        arr[:] = [torch.device(d) for d in src.flat]
        self.devices = arr.reshape(src.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh)
                and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and list(self.devices.flat) == list(other.devices.flat))

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape,
                     tuple(str(d) for d in self.devices.flat)))

    def __repr__(self) -> str:
        axes = ", ".join(f"'{a}': {n}" for a, n in self.shape.items())
        return f"Mesh({axes})"


@dataclasses.dataclass(frozen=True, eq=True)
class NamedSharding:
    """A placement over ``mesh``: ``spec`` names, for each leading dim,
    the mesh axis (or tuple of axes) it is split along, or None; an empty
    spec replicates."""
    mesh: Mesh
    spec: Tuple = ()

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh!r}, spec={self.spec!r})"


@dataclasses.dataclass(frozen=True, eq=True)
class SingleDeviceSharding:
    device: torch.device


@dataclasses.dataclass(frozen=True)
class RoleSplit:
    collector: Mesh
    model: Mesh
    policy: Mesh
    shared: bool = False   # True: degenerate fallback, roles overlap
    axis: str | None = None    # the mesh axis the split was carved along;
    #                            also the batch axis workers shard over

    def describe(self) -> dict:
        return {
            "collector": list(self.collector.devices.shape),
            "model": list(self.model.devices.shape),
            "policy": list(self.policy.devices.shape),
            "shared": self.shared,
            "axis": self.axis,
        }


def replicated(mesh: Mesh) -> NamedSharding:
    """Params replicated over every device of a role sub-mesh."""
    return NamedSharding(mesh, ())


def batch_sharded(mesh: Mesh, axis: str | None = None) -> NamedSharding:
    """Leading (batch) dim sharded along one mesh axis, rest replicated."""
    axis = axis or mesh.axis_names[0]
    return NamedSharding(mesh, (axis,))


def collector_sharding(mesh: Mesh, collector_id: int = 0):
    """Placement of the ``collector_id``-th fleet member on the collector
    sub-mesh: collectors are sequential control loops (one robot each),
    so a fleet of N splits the sub-mesh one DEVICE per collector,
    round-robin when N exceeds the device count."""
    return SingleDeviceSharding(
        mesh.devices.flat[collector_id % mesh.devices.size])


def num_shards(sharding) -> int:
    """Number of shards along the leading dim of ``batch_sharded`` output
    (capacities and batches are rounded to a multiple of this)."""
    spec = getattr(sharding, "spec", ())
    if not spec or spec[0] is None:
        return 1
    axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    return int(np.prod([sharding.mesh.shape[a] for a in axes]))


def round_up(n: int, multiple: int) -> int:
    return -(-int(n) // int(multiple)) * int(multiple)


def shard_devices(sharding) -> List[torch.device]:
    """The device of each shard along the leading dim, in shard order: for
    a sharded spec, the first device (in mesh order) of each block along
    its axes, for a replicated one the mesh's first device, for a single
    device that device."""
    if isinstance(sharding, SingleDeviceSharding):
        return [sharding.device]
    mesh = sharding.mesh
    spec = sharding.spec
    if not spec or spec[0] is None:
        return [mesh.devices.flat[0]]
    axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
    idx = [mesh.axis_names.index(a) for a in axes]
    arr = np.moveaxis(mesh.devices, idx, list(range(len(idx))))
    return list(arr.reshape(num_shards(sharding), -1)[:, 0])


def home_device(placement) -> torch.device:
    """Where the port keeps the one copy of a tree placed by ``placement``
    (a sharding or a mesh): its first shard's device."""
    if isinstance(placement, Mesh):
        return placement.devices.flat[0]
    return shard_devices(placement)[0]


def split_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of each of ``parts`` blocks of ``n`` rows, blocks of
    ``ceil(n / parts)`` rows and the last ones shorter (XLA's layout of an
    uneven shard)."""
    c = -(-int(n) // int(parts))
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(parts)]


def shard_slices(placement, rows: int) -> List[Tuple[torch.device, int,
                                                    int]]:
    """``(device, lo, hi)`` of each non-empty shard of ``rows`` batch rows
    under a ``batch_sharded`` placement (``split_bounds``' blocks)."""
    devs = shard_devices(placement)
    return [(d, lo, hi) for d, (lo, hi) in zip(devs, split_bounds(
        rows, len(devs))) if hi > lo]


def replicas(tree, devices) -> dict:
    """``tree`` on each distinct device of ``devices``, by device: a copy
    where it does not live, the tree itself where it does."""
    return {d: tree_to(tree, d) for d in dict.fromkeys(devices)}


class RowShards:
    """One logical tensor's rows in equal contiguous blocks, block i on
    shard i's device: the port's form of an array placed by
    ``batch_sharded`` (``ReplayBuffer`` storage). ``shards`` are the
    blocks themselves, so a write into a block is a write into the
    storage."""

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = list(shards)

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> Tuple[int, ...]:
        s = self.shards[0].shape
        return (len(self.shards) * int(s[0]),) + tuple(s[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first shard's),
        one copy of each block that lives elsewhere."""
        dev = self.shards[0].device if device is None else device
        return torch.cat([s.to(dev) for s in self.shards])

    def head(self, n: int) -> "RowShards":
        """The first ``n`` rows (a multiple of the shard count), laid out
        in equal blocks over the same devices; blocks that fall inside
        one shard are views of it, the others are copies."""
        k = len(self.shards)
        if n % k:
            raise ValueError(f"{n} rows do not split over {k} shards")
        b, per = n // k, self.rows_per_shard
        out = []
        for i, dev in enumerate(self.devices):
            lo, hi = i * b, (i + 1) * b
            pieces = [self.shards[s][max(lo - s * per, 0):
                                     min(hi - s * per, per)].to(dev)
                      for s in range(lo // per, -(-hi // per))]
            out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
        return RowShards(out)

    def __repr__(self) -> str:
        return (f"RowShards(shape={self.shape}, dtype={self.dtype}, "
                f"devices={[str(d) for d in self.devices]})")


def split_roles(mesh: Mesh, *, ratios: Tuple[int, int, int] = (1, 2, 1),
                axis: str | None = None) -> RoleSplit:
    """Carve the mesh along one axis into three role sub-meshes.

    ratios: relative share of the split axis per (collector, model, policy).
    The split axis defaults to the FIRST axis with enough devices for all
    roles ("pod" on a mesh with >= 3 pods, otherwise "data").

    Degenerate meshes (no axis with as many devices as roles, or an
    explicitly requested axis that is too small, or a ratio rounding that
    would starve a role) fall back to OVERLAPPING sub-meshes — every role
    gets the full mesh — with a warning, so small hosts (one card) run the
    same code path with trivial cross-role transfers."""
    names = list(mesh.axis_names)
    if axis is None:
        axis = next((a for a in names
                     if mesh.devices.shape[names.index(a)] >= len(ratios)),
                    names[0])
    ai = names.index(axis)
    n = int(mesh.devices.shape[ai])
    if n < len(ratios):
        warnings.warn(
            f"split_roles: axis {axis!r} has {n} device(s) for "
            f"{len(ratios)} roles; falling back to shared sub-meshes "
            "(all roles use the full mesh)", stacklevel=2)
        return RoleSplit(mesh, mesh, mesh, shared=True, axis=axis)
    total = sum(ratios)
    sizes = [max(1, n * r // total) for r in ratios]
    # fix rounding so sizes sum to n — never shrinking a role below 1
    while sum(sizes) > n:
        shrinkable = [i for i, s in enumerate(sizes) if s > 1]
        if not shrinkable:     # unreachable for n >= len(ratios); be safe
            warnings.warn("split_roles: ratio rounding starved a role; "
                          "falling back to shared sub-meshes", stacklevel=2)
            return RoleSplit(mesh, mesh, mesh, shared=True, axis=axis)
        i = max(shrinkable, key=sizes.__getitem__)
        sizes[i] -= 1
    while sum(sizes) < n:
        sizes[int(np.argmin(sizes))] += 1
    meshes = []
    start = 0
    for s in sizes:
        idx = [slice(None)] * mesh.devices.ndim
        idx[ai] = slice(start, start + s)
        meshes.append(Mesh(mesh.devices[tuple(idx)], mesh.axis_names))
        start += s
    return RoleSplit(*meshes, axis=axis)
