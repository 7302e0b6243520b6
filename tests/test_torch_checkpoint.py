"""The port's ``checkpoint/io.py`` against the JAX reference's, on the CPU.

A snapshot is positional (leaves ``a0..an`` in ``jax.tree.flatten`` order,
dict keys sorted) with the dtype names in ``tree.json``, so the two packages
must read each other's files bit for bit: MBRL params (the ensemble and the
policy), their versions and a bf16 leaf, both ways. The reference's own
cases (``tests/test_checkpoint.py``) are ported: round trip, retention,
shape mismatch, torn-snapshot fallback, nothing complete, ``.tmp`` sweep.
Every comparison is exact (``np.testing.assert_array_equal`` on the bits).
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.mbrl import dynamics as JDYN
from repro.mbrl import policy as JPI
from repro_torch.checkpoint import io as tio
from repro_torch.mbrl import dynamics as TDYN
from repro_torch.mbrl import policy as TPI
from repro_torch.testing.parity import to_tensor, tree_from_jax
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def _mbrl_tree(seed=0):
    """JAX MBRL params as numpy: an ensemble, a policy, the policy in bf16
    and two version scalars, in the reference's own dict orders."""
    k1, k2 = jax.random.split(jax.random.key(seed))
    cfg = JDYN.EnsembleConfig(3, 1, hidden=8, n_models=2)
    model = JDYN.init_ensemble(cfg, k1)
    model = {**model, "norm": jax.tree.map(lambda x: x + 0.5,
                                           model["norm"])}
    pol = JPI.init_policy(JPI.PolicyConfig(3, 1, hidden=8), k2)
    pol = {**pol, "b": [b + 0.25 for b in pol["b"]]}
    tree = {"model": model, "model_version": np.int64(3), "policy": pol,
            "policy_version": np.int64(5),
            "policy_bf16": jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                        pol)}
    return jax.tree.map(np.asarray, tree)


def _port_order(tree_np):
    """The same values as a tree of tensors in the port's own key orders:
    those of ``init_ensemble`` / ``init_policy`` (``w`` before ``b``).
    ``jax.tree.map`` hands its dicts back with sorted keys, so a tree
    converted leaf by leaf would hide the order the codec must restore."""
    g = torch.Generator().manual_seed(0)
    pol = TPI.init_policy(TPI.PolicyConfig(3, 1, hidden=8), g)
    like = {"model": TDYN.init_ensemble(TDYN.EnsembleConfig(
        3, 1, hidden=8, n_models=2), g), "model_version": None,
        "policy": pol, "policy_version": None, "policy_bf16": pol}
    assert list(like["policy"])[:2] == ["w", "b"]

    def fill(t, v):
        if isinstance(t, dict):
            return {k: fill(t[k], v[k]) for k in t}
        if isinstance(t, list):
            return [fill(a, b) for a, b in zip(t, v)]
        return to_tensor(v)
    return fill(like, tree_np)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t):
    """(dtype name, bits as numpy) of a tensor; bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
    a = t.numpy()
    return a.dtype.name, a


def _assert_same(got_torch, want_np):
    """Leaf for leaf in the reference's order: equal bits and dtype."""
    got = tio.flatten(got_torch)
    want = jax.tree.leaves(want_np)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        name, bits = _torch_bits(g)
        assert name == np.asarray(w).dtype.name
        np.testing.assert_array_equal(bits, _bits(w))


def test_port_restores_a_jax_snapshot_bit_equal(tmp_path):
    tree = _mbrl_tree()
    jio.save_pytree(tmp_path / "run", tree, step=2)
    like = _port_order(tree)
    out, step = tio.restore(tmp_path / "run", like)
    assert step == 2
    _assert_same(out, tree)
    assert out["policy_bf16"]["w"][0].dtype == torch.bfloat16
    # the port's dicts keep the template's key order
    assert list(out["policy"]) == list(like["policy"])


def test_jax_restores_a_port_snapshot_bit_equal(tmp_path):
    tree = _mbrl_tree(1)
    tio.save_pytree(tmp_path / "run", _port_order(tree), step=7)
    out, step = jio.restore(tmp_path / "run", tree)
    assert step == 7
    got = jax.tree.leaves(out)
    for g, w in zip(got, jax.tree.leaves(tree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_both_packages_write_the_same_arrays_and_metadata(tmp_path):
    tree = _mbrl_tree(2)
    jio.save_pytree(tmp_path / "jax", tree)
    tio.save_pytree(tmp_path / "torch", _port_order(tree))
    jm = json.loads((tmp_path / "jax" / "tree.json").read_text())
    tm = json.loads((tmp_path / "torch" / "tree.json").read_text())
    assert (tm["n"], tm["dtypes"], tm["shapes"]) == \
        (jm["n"], jm["dtypes"], jm["shapes"])
    assert "bfloat16" in tm["dtypes"]
    with np.load(tmp_path / "jax" / "arrays.npz") as ja, \
            np.load(tmp_path / "torch" / "arrays.npz") as ta:
        assert sorted(ja.files) == sorted(ta.files)
        for k in ja.files:
            assert ja[k].dtype == ta[k].dtype
            np.testing.assert_array_equal(ja[k], ta[k])


def test_w_before_b_of_equal_shapes_lands_in_place(tmp_path):
    """``{"w": ..., "b": ...}`` with equal shapes: JAX numbers ``b`` first.
    The port's restore puts each array back under its own key, where the
    insertion-order flattening of ``utils.tree`` would swap them."""
    w = np.arange(9, dtype=np.float32).reshape(3, 3)
    b = -np.arange(9, dtype=np.float32).reshape(3, 3)
    tree = {"w": [w], "b": [b]}
    jio.save_pytree(tmp_path / "ck", tree)
    like = tree_from_jax(tree)
    out = tio.load_pytree(tmp_path / "ck", like)
    np.testing.assert_array_equal(out["w"][0].numpy(), w)
    np.testing.assert_array_equal(out["b"][0].numpy(), b)
    # the trap this guards against: the file's leaves in insertion order
    with np.load(tmp_path / "ck" / "arrays.npz") as data:
        swapped = tree_unflatten(like, [torch.from_numpy(data[f"a{i}"])
                                        for i in range(2)])
    np.testing.assert_array_equal(swapped["w"][0].numpy(), b)
    assert [x is y for x, y in zip(tio.flatten(like),
                                   tree_leaves(like))] == [False, False]


def test_leaf_codec_matches_the_reference_codec():
    tree = _mbrl_tree(3)
    jc, tc = jio.LeafCodec(tree), tio.LeafCodec(_port_order(tree))
    assert tc.n_leaves == jc.n_leaves and tc.shapes == jc.shapes
    assert tc.nbytes == jc.nbytes
    assert [str(d) for d in tc.storable_dtypes] == \
        [str(np.dtype(d)) for d in jc.storable_dtypes]
    got = tc.encode(_port_order(tree))
    want = jc.encode(tree)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    _assert_same(tc.decode(want), tree)


def test_restore_lands_on_the_templates_device(tmp_path):
    tree = _port_order(_mbrl_tree(4))
    tio.save_pytree(tmp_path / "run", tree, step=0)
    out, _ = tio.restore(tmp_path / "run", tree)
    assert {t.device.type for t in tio.flatten(out)} == {"cpu"}
    assert all(isinstance(t, torch.Tensor) for t in tio.flatten(out))


# -------------------------- the reference's tests/test_checkpoint.py, ported
def _make_tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"w": [torch.randn((4, 3), generator=g),
                  torch.zeros((3,), dtype=torch.bfloat16)],
            "step": torch.tensor(7, dtype=torch.int32),
            "nested": {"a": torch.ones((2, 2))}}


def _assert_trees_equal(a, b):
    for x, y in zip(tio.flatten(a), tio.flatten(b)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_roundtrip(tmp_path):
    tree = _make_tree(0)
    tio.save_pytree(tmp_path / "ck", tree)
    _assert_trees_equal(tio.load_pytree(tmp_path / "ck", tree), tree)


def test_steps_and_retention(tmp_path):
    tree = _make_tree(1)
    for s in (10, 20, 30, 40):
        tio.save_pytree(tmp_path / "run", tree, step=s, keep=2)
    assert tio.latest_step(tmp_path / "run") == 40
    _, step = tio.restore(tmp_path / "run", tree)
    assert step == 40
    assert len(list((tmp_path / "run").glob("step_*"))) == 2


def test_shape_mismatch_raises(tmp_path):
    tree = _make_tree(2)
    tio.save_pytree(tmp_path / "ck", tree)
    bad = dict(tree)
    bad["w"] = [torch.zeros((5, 3)), tree["w"][1]]
    with pytest.raises(ValueError, match="shape"):
        tio.load_pytree(tmp_path / "ck", bad)


def test_leaf_count_mismatch_raises(tmp_path):
    tree = _make_tree(2)
    tio.save_pytree(tmp_path / "ck", tree)
    with pytest.raises(ValueError, match="leaves"):
        tio.load_pytree(tmp_path / "ck", {**tree, "extra": torch.ones(1)})


def test_restore_skips_truncated_snapshot(tmp_path):
    tree = _make_tree(3)
    tio.save_pytree(tmp_path / "run", tree, step=1)
    tio.save_pytree(tmp_path / "run", tree, step=2)
    npz = tmp_path / "run" / "step_000000002" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:10])          # truncate
    out, step = tio.restore(tmp_path / "run", tree)
    assert step == 1
    _assert_trees_equal(out, tree)


def test_restore_raises_when_nothing_complete(tmp_path):
    tree = _make_tree(4)
    tio.save_pytree(tmp_path / "run", tree, step=1)
    npz = tmp_path / "run" / "step_000000001" / "arrays.npz"
    npz.write_bytes(b"not a checkpoint")
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        tio.restore(tmp_path / "run", tree)


def test_tmp_leftovers_are_invisible_and_swept(tmp_path):
    tree = _make_tree(5)
    tio.save_pytree(tmp_path / "run", tree, step=1)
    orphan = tmp_path / "run" / "step_000000002.tmp"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"partial")
    assert tio.latest_step(tmp_path / "run") == 1
    _, step = tio.restore(tmp_path / "run", tree)
    assert step == 1
    tio.save_pytree(tmp_path / "run", tree, step=3)
    assert not orphan.exists()                      # swept
    assert tio.latest_step(tmp_path / "run") == 3


def test_named_tuple_optimizer_state_round_trips(tmp_path):
    """An Adam state (a named tuple of step, mu, nu) survives the trip with
    its type and the template's structure."""
    from repro_torch.optim.optimizers import adam
    params = {"w": [torch.randn(3, 2)], "b": [torch.zeros(2)]}
    state = adam(1e-3).init(params)
    tio.save_pytree(tmp_path / "opt", state)
    out = tio.load_pytree(tmp_path / "opt", state)
    assert type(out) is type(state)
    _assert_trees_equal(out, state)


def test_bf16_bits_survive_without_ml_dtypes_on_the_writer(tmp_path):
    """The bf16 leaf is written from torch's own view, as uint16 bits the
    reference reads through ml_dtypes."""
    x = torch.tensor([1.0, -2.5, 3.140625, 1e-3], dtype=torch.bfloat16)
    tio.save_pytree(tmp_path / "ck", {"x": x})
    back = jio.load_pytree(tmp_path / "ck",
                           {"x": np.zeros(4, ml_dtypes.bfloat16)})
    np.testing.assert_array_equal(np.asarray(back["x"]).view(np.uint16),
                                  x.view(torch.int16).numpy()
                                  .view(np.uint16))
