"""The port's role partitioning (``repro_torch/core/roles.py``) and mesh
construction (``repro_torch/launch/mesh.py``) against the JAX reference,
on the CPU.

The reference's ``split_roles`` runs here in-process on a
``jax.sharding.Mesh`` of this host's one CPU device repeated, the same
shapes and ratios as ``tests/_mesh_impl.py`` (which needs 8 forced host
devices and a process of its own); the port's on a ``Mesh`` of stand-in
entries. Where a test needs to tell entries apart (a collector fleet's
round robin, a shard's device), the port's mesh holds ``cuda:i`` labels:
device objects only, nothing is allocated on them.
"""
import itertools
import warnings

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.core import roles as JROLES
from repro_torch.core import roles as ROLES
from repro_torch.launch import mesh as LMESH

AXES = {1: ("data",), 2: ("pod", "data")}
# tests/_mesh_impl.py:76-127: the ratio permutations and mesh sizes
RATIOS = (sorted(set(itertools.permutations((1, 2, 1))))
          + [(1, 1, 1), (5, 1, 1), (1, 6, 1)])


def _jmesh(shape, axes):
    devs = np.array([jax.devices()[0]] * int(np.prod(shape)), dtype=object)
    return JMesh(devs.reshape(shape), axes)


def _labels(shape, axes):
    """A port mesh of distinct ``cuda:i`` labels, in mesh order."""
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device("cuda", i) for i in range(devs.size)]
    return ROLES.Mesh(devs.reshape(shape), axes)


def _split_both(shape, axes, **kw):
    """Both packages' split of a mesh of ``shape``, with the warnings each
    raised."""
    out = []
    for split, mesh in ((JROLES.split_roles, _jmesh(shape, axes)),
                        (ROLES.split_roles, _labels(shape, axes))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            roles = split(mesh, **kw)
        out.append((roles, [str(w.message) for w in caught
                            if issubclass(w.category, UserWarning)]))
    return out


@pytest.mark.parametrize("n,ratios", [(8, (1, 2, 1))]
                         + [(n, r) for n in (3, 4, 8) for r in RATIOS])
def test_split_roles_matches_reference(n, ratios):
    (jr, jw), (tr, tw) = _split_both((n,), AXES[1], ratios=ratios)
    assert tr.describe() == jr.describe()
    assert tw == jw == []
    sizes = [m.size for m in (tr.collector, tr.model, tr.policy)]
    assert all(s >= 1 for s in sizes) and sum(sizes) == n
    # disjoint, in mesh order: the sub-meshes tile the axis
    flat = [d.index for m in (tr.collector, tr.model, tr.policy)
            for d in m.devices.flat]
    assert flat == list(range(n))


@pytest.mark.parametrize("n,ratios", [
    (n, r) for n in (5, 6, 7, 9, 12)
    for r in ((3, 2, 1), (1, 3, 1), (2, 1, 2), (7, 1, 1))])
def test_split_roles_rounds_uneven_ratios_as_the_reference(n, ratios):
    """Ratios that do not divide the axis: the reference floors each
    share (at least 1), shrinks the largest role while the sizes
    overshoot and grows the smallest while they fall short. The port's
    sizes, order and warnings are the reference's."""
    (jr, jw), (tr, tw) = _split_both((n,), AXES[1], ratios=ratios)
    assert tr.describe() == jr.describe()
    assert tw == jw
    assert sum(m.size for m in (tr.collector, tr.model, tr.policy)) == n


@pytest.mark.parametrize("n", [1, 2])
def test_degenerate_mesh_falls_back_shared_with_the_reference_warning(n):
    (jr, jw), (tr, tw) = _split_both((n,), AXES[1], ratios=(1, 2, 1))
    assert tr.describe() == jr.describe() and tr.shared
    assert tw == jw and len(tw) == 1 and "shared sub-meshes" in tw[0]
    for m in (tr.collector, tr.model, tr.policy):
        assert m == _labels((n,), AXES[1])


@pytest.mark.parametrize("shape,ratios", [
    (shape, r) for shape in ((3, 2), (2, 3), (4, 4), (1, 5), (6, 1), (2, 2))
    for r in ((1, 2, 1), (2, 1, 1))])
def test_two_axis_meshes_split_as_the_reference(shape, ratios):
    """("pod", "data") meshes: the first axis with a device a role is
    split ((3, 2), (4, 4) and (6, 1) split "pod", (2, 3) and (1, 5)
    "data"), whole rows or columns to each role; (2, 2) has no such axis
    and falls back shared with the warning. Sizes, axis and warnings are
    the reference's."""
    want_axis = {(3, 2): "pod", (4, 4): "pod", (6, 1): "pod",
                 (2, 3): "data", (1, 5): "data", (2, 2): "pod"}[shape]
    (jr, jw), (tr, tw) = _split_both(shape, AXES[2], ratios=ratios)
    assert tr.describe() == jr.describe()
    assert tw == jw and tr.axis == want_axis
    assert tr.shared == (shape == (2, 2)) == bool(tw)
    if not tr.shared:
        ai = AXES[2].index(tr.axis)
        subs = (tr.collector, tr.model, tr.policy)
        assert sum(m.devices.shape[ai] for m in subs) == shape[ai]
        assert all(m.devices.shape[1 - ai] == shape[1 - ai] for m in subs)


def test_split_skips_too_small_leading_axis_as_the_reference():
    """A (2, 4) ("pod", "data") mesh splits its 4-wide data axis; an
    explicit "pod" split falls back shared, with the warning."""
    (jr, jw), (tr, tw) = _split_both((2, 4), AXES[2], ratios=(1, 2, 1))
    assert tr.describe() == jr.describe()
    assert tr.axis == "data" and not tr.shared and tw == jw == []
    assert [tuple(m.devices.shape) for m in
            (tr.collector, tr.model, tr.policy)] == [(2, 1), (2, 2), (2, 1)]
    (jr, jw), (tr, tw) = _split_both((2, 4), AXES[2], ratios=(1, 2, 1),
                                     axis="pod")
    assert tr.describe() == jr.describe() and tr.shared and tw == jw


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16),
                                         ("pod", "data", "model"))])
def test_production_shapes_split_as_the_reference(shape, axes):
    """The reference's production meshes (``make_production_mesh``), as
    its dry run's ``--roles`` splits them."""
    (jr, _), (tr, _) = _split_both(shape, axes, ratios=(1, 2, 1))
    assert tr.describe() == jr.describe()


def test_placements_match_reference():
    mesh = _labels((2, 4), AXES[2])
    jmesh = _jmesh((2, 4), AXES[2])
    for axis in (None, "data", "pod"):
        got, want = (ROLES.batch_sharded(mesh, axis),
                     JROLES.batch_sharded(jmesh, axis))
        assert got.spec == tuple(want.spec)
        assert ROLES.num_shards(got) == JROLES.num_shards(want)
    assert ROLES.replicated(mesh).spec == tuple(JROLES.replicated(jmesh).spec)
    assert ROLES.num_shards(ROLES.replicated(mesh)) == 1
    for n, m in ((10, 4), (64, 4), (0, 3), (7, 1)):
        assert ROLES.round_up(n, m) == JROLES.round_up(n, m)
    # each shard's device: the first of its block along the split axis
    assert [d.index for d in ROLES.shard_devices(
        ROLES.batch_sharded(mesh, "data"))] == [0, 1, 2, 3]
    assert [d.index for d in ROLES.shard_devices(
        ROLES.batch_sharded(mesh, "pod"))] == [0, 4]
    assert ROLES.home_device(ROLES.replicated(mesh)).index == 0
    assert ROLES.home_device(mesh).index == 0


def test_collector_fleet_round_robins_over_the_collector_sub_mesh():
    """``tests/_mesh_impl.py``'s fleet case: (2, 1, 1) of 8 devices gives
    a 4-device collector sub-mesh, and 6 collectors wrap round-robin."""
    roles = ROLES.split_roles(_labels((8,), AXES[1]), ratios=(2, 1, 1))
    placed = [ROLES.collector_sharding(roles.collector, i).device.index
              for i in range(6)]
    assert placed == [0, 1, 2, 3, 0, 1]
    jroles = JROLES.split_roles(_jmesh((8,), AXES[1]), ratios=(2, 1, 1))
    assert roles.describe() == jroles.describe()


def test_split_bounds_and_row_shards():
    assert ROLES.split_bounds(16, 4) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert ROLES.split_bounds(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    assert ROLES.shard_slices(ROLES.batch_sharded(
        _labels((4,), AXES[1])), 3)[-1][1:] == (2, 3)
    full = torch.arange(24.0).reshape(12, 2)
    rows = ROLES.RowShards(list(full.split(3)))
    assert rows.shape == (12, 2) and rows.rows_per_shard == 3
    assert torch.equal(rows.full(), full)
    head = rows.head(8)
    assert [tuple(s.shape) for s in head.shards] == [(2, 2)] * 4
    assert torch.equal(head.full(), full[:8])
    with pytest.raises(ValueError, match="do not split"):
        rows.head(6)


def test_make_mesh_refuses_more_cards_than_the_host_has():
    """As the reference's ``--mesh N`` errors for an unavailable count;
    stand-ins only when a device is named."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="available"):
        LMESH.make_mesh(have + 1)
    mesh = LMESH.make_mesh(4, device="cpu")
    assert mesh.shape == {"data": 4}
    assert set(mesh.devices.flat) == {torch.device("cpu")}
    assert LMESH.make_local_mesh(device="cpu").size == 1
    smoke = LMESH.make_smoke_mesh(device="cpu")
    assert smoke.axis_names == ("data", "model") and smoke.size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LMESH.make_local_mesh()
    with pytest.raises(ValueError):
        LMESH.make_mesh(0, device="cpu")
