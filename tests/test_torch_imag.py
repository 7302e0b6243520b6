"""The fused imagination step of the PyTorch port against the JAX reference,
on the CPU.

The same numpy-seeded inputs go through the reference's oracle
(``repro.kernels.imag.ref``), its Pallas kernel in interpret mode (as
``test_kernels_interpret.py`` runs it on the CPU), and the port's plain
version and dispatcher, at ``test_kernels_interpret.py``'s ``IMAG_CASES``
(empty groups, one group owning the batch, groups straddling tiles, K=1,
B not a tile multiple) and at the trainer's widths with a small batch.
The hand-written CUDA kernel runs only on a card
(``test_torch_kernels_gpu.py``); here ``FusedStep`` runs the kernel
route's wiring (sort, Function, unsort) with the plain sorted forward.

Tolerances, f32: 1e-5 (atol and rtol) where the port and the oracle
compute the same function and only the order of f32 sums differs; 1e-4
against the interpret-mode kernel, as ``test_kernels_interpret.py``
grants it; gradients to 1e-5 of the gradient's own scale (each entry sums
products over the batch), second-order ones to 1e-4 of it (two nested
backward passes compound the rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.imag import ops as jimag_ops
from repro.kernels.imag import ref as jimag_ref
from repro_torch.kernels.imag import cuda as imag_cuda
from repro_torch.kernels.imag import ops as imag_ops
from repro_torch.kernels.imag import ref as imag_ref
from repro_torch.testing.parity import tree_from_jax

TOL = dict(atol=1e-5, rtol=1e-5)
INTERPRET_TOL = dict(atol=1e-4, rtol=1e-4)

IMAG_CASES = [
    # K, B, obs, act, hid, phid, block_b, midx mode (test_kernels_interpret)
    (3, 48, 3, 1, 96, 48, 128, "rand"),    # bench shape, single tile
    (3, 48, 3, 1, 96, 48, 16, "one"),      # full group + empties, tiled
    (3, 48, 3, 1, 96, 48, 16, "rand"),     # groups straddle tiles
    (1, 20, 5, 2, 32, 16, 8, "rand"),      # K=1, B not tile multiple
    (5, 37, 4, 2, 24, 12, 8, "rand"),
]
# the trainer's widths (pr2_lego_stack: obs 23, act 7; ensemble hidden 256,
# depth 2, 5 members; examples/pr2_arm.py's policy, two hidden layers of 64)
# with a small batch
PATH_CASE = (5, 12, 23, 7, 256, (64, 64), 128, "rand")


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs(K, B, obs, act, hid, phid, mode, seed=0):
    """numpy trees: members, norm, pol, s, eps, member_idx. ``phid``: the
    policy's hidden width, or a tuple of widths for several hidden
    layers."""
    rng = np.random.default_rng(seed)
    din = obs + act
    dims = [din, hid, hid, obs]
    members = {"w": [_rand(rng, (K, a, b), 0.3)
                     for a, b in zip(dims[:-1], dims[1:])],
               "b": [_rand(rng, (K, b), 0.1) for b in dims[1:]]}
    norm = {"mu_in": _rand(rng, (din,), 0.1),
            "sig_in": np.abs(_rand(rng, (din,))) + 0.5,
            "mu_out": _rand(rng, (obs,), 0.05),
            "sig_out": np.abs(_rand(rng, (obs,))) + 0.5}
    pdims = [obs, *(phid if isinstance(phid, tuple) else (phid,)), act]
    pol = {"w": [_rand(rng, (a, b), 0.3)
                 for a, b in zip(pdims[:-1], pdims[1:])],
           "b": [_rand(rng, (b,), 0.1) for b in pdims[1:]],
           "log_std": np.full((act,), -0.5, np.float32)}
    s = _rand(rng, (B, obs))
    eps = _rand(rng, (B, act))
    if mode == "one":
        midx = np.full((B,), min(1, K - 1), np.int32)
    else:
        midx = rng.integers(0, K, B).astype(np.int32)
    return members, norm, pol, s, eps, midx


def _port(args):
    members, norm, pol, s, eps, midx = args
    return (tree_from_jax(members), tree_from_jax(norm), tree_from_jax(pol),
            torch.from_numpy(s), torch.from_numpy(eps),
            torch.from_numpy(midx.astype(np.int64)))


def _jax(args):
    return jax.tree.map(jnp.asarray, args)


def _assert_outputs(got, want, tol):
    for g, w, name in zip(got, want, ("s2", "a", "pre")):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("case", IMAG_CASES + [PATH_CASE])
def test_ref_fused_step_matches_oracle_and_interpret_kernel(case):
    K, B, obs, act, hid, phid, bb, mode = case
    args = _inputs(K, B, obs, act, hid, phid, mode)
    ja = _jax(args)
    want = jimag_ref.fused_step(*ja)
    interp = jimag_ops.fused_step(*ja, impl="pallas", interpret=True,
                                  block_b=bb)
    got = imag_ref.fused_step(*_port(args))
    _assert_outputs(got, want, TOL)
    _assert_outputs(got, interp, INTERPRET_TOL)
    # the CPU route of the dispatcher is the plain version, launching nothing
    before = imag_ops.launches
    _assert_outputs(imag_ops.fused_step(*_port(args)), want, TOL)
    assert imag_ops.launches == before


@pytest.mark.parametrize("case", IMAG_CASES + [PATH_CASE])
def test_kernel_route_wiring_matches_oracle(case):
    """Sort, ``FusedStep`` over the sorted rows with the plain sorted
    forward, unsort: the card's route with the kernel swapped out."""
    K, B, obs, act, hid, phid, bb, mode = case
    args = _inputs(K, B, obs, act, hid, phid, mode, seed=1)
    want = jimag_ref.fused_step(*_jax(args))
    got = imag_ops.sorted_step(*_port(args), forward=imag_ops.ref_sorted)
    _assert_outputs(got, want, TOL)


@pytest.mark.parametrize("case", IMAG_CASES + [(4, 64, 3, 1, 8, 8, 8, "h")])
def test_sort_plan_matches_reference(case):
    K, B = case[0], case[1]
    rng = np.random.default_rng(2)
    if case[-1] == "one":
        midx = np.full((B,), min(1, K - 1), np.int32)
    elif case[-1] == "h":              # a horizon of plans in one call
        midx = rng.integers(0, K - 1, (6, B)).astype(np.int32)  # K-1 empty
    else:
        midx = rng.integers(0, K, B).astype(np.int32)
    j_order, j_offs = jimag_ops.sort_plan(jnp.asarray(midx), K)
    order, offs = imag_ops.sort_plan(torch.from_numpy(midx.astype(np.int64)),
                                     K)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(j_offs))
    assert offs.dtype == torch.int32


def _close_to_scale(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _leaves(*trees):
    return [x for t in trees for x in jax.tree.leaves(t)]


def _torch_leaves(*trees):
    """Leaves in jax's order (sorted dict keys) of torch trees."""
    return jax.tree.leaves(tuple(trees))


GRAD_CASES = [
    (3, 20, 3, 1, 16, 8, 8, "rand"),      # test_imag_pallas_grad_matches_ref
    (5, 37, 4, 2, 24, 12, 8, "rand"),
    (1, 20, 5, 2, 32, 16, 8, "rand"),
    (3, 48, 3, 1, 96, 48, 16, "one"),
    (5, 12, 6, 2, 16, (8, 8), 8, "rand"),  # two hidden policy layers
]


def _loss_parts(s2, a, pre):
    return (s2 ** 2).sum() + (a * pre).sum()


@pytest.mark.parametrize("case", GRAD_CASES)
def test_fused_step_function_grads_match_jax_grad(case):
    """MB-MPO differentiates THROUGH the fused step: ``FusedStep``'s
    backward (autograd of the plain version on the sorted rows) against
    ``jax.grad`` of the oracle, w.r.t. members, norm, policy and states."""
    K, B, obs, act, hid, phid, bb, mode = case
    args = _inputs(K, B, obs, act, hid, phid, mode, seed=3)
    members, norm, pol, s, eps, midx = _jax(args)

    def f(mem, nrm, po, ss):
        return _loss_parts(*jimag_ref.fused_step(mem, nrm, po, ss, eps,
                                                 midx))
    want = jax.grad(f, argnums=(0, 1, 2, 3))(members, norm, pol, s)

    tm, tn, tp, ts, teps, tidx = _port(args)
    leaves = _torch_leaves(tm, tn, tp, ts)
    for x in leaves:
        x.requires_grad_(True)
    got = torch.autograd.grad(_loss_parts(*imag_ops.sorted_step(
        tm, tn, tp, ts, teps, tidx, forward=imag_ops.ref_sorted)), leaves)
    want_leaves = _leaves(*want)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        _close_to_scale(g.detach().numpy(), w, 1e-5)


@pytest.mark.parametrize("case", GRAD_CASES[:2] + GRAD_CASES[-1:])
def test_fused_step_second_order_matches_nested_jax_grad(case):
    """The gradient of a function of an inner gradient, as MB-MPO takes it:
    adapt the policy by one gradient step of one fused step's loss, then
    differentiate a second step's loss at the adapted policy w.r.t. the
    original policy and states."""
    K, B, obs, act, hid, phid, bb, mode = case
    args = _inputs(K, B, obs, act, hid, phid, mode, seed=4)
    members, norm, pol, s, eps, midx = _jax(args)
    lr = 0.05

    def outer(po, ss):
        g = jax.grad(lambda p: _loss_parts(*jimag_ref.fused_step(
            members, norm, p, ss, eps, midx)))(po)
        adapted = jax.tree.map(lambda p, gg: p - lr * gg, po, g)
        s2, a, pre = jimag_ref.fused_step(members, norm, adapted, ss,
                                          eps[::-1], midx[::-1])
        return (s2 ** 2).sum() + (pre ** 2).sum()
    want = jax.grad(outer, argnums=(0, 1))(pol, s)

    def run(forward):
        tm, tn, tp, ts, teps, tidx = _port(args)
        leaves = _torch_leaves(tp, ts)
        for x in leaves:
            x.requires_grad_(True)
        pol_leaves = jax.tree.leaves(tp)
        g = torch.autograd.grad(_loss_parts(*forward(tm, tn, tp, ts, teps,
                                                     tidx)),
                                pol_leaves, create_graph=True)
        adapted = jax.tree.unflatten(jax.tree.structure(tp),
                                     [p - lr * gg
                                      for p, gg in zip(pol_leaves, g)])
        s2, a, pre = forward(tm, tn, adapted, ts, teps.flip(0),
                             tidx.flip(0))
        return torch.autograd.grad((s2 ** 2).sum() + (pre ** 2).sum(),
                                   leaves)

    def through_function(*a):
        return imag_ops.sorted_step(*a, forward=imag_ops.ref_sorted)
    got = run(through_function)
    plain = run(imag_ref.fused_step)
    for g, p, w in zip(got, plain, _leaves(want)):
        _close_to_scale(g.detach().numpy(), w, 1e-4)
        _close_to_scale(g.detach().numpy(), p.detach().numpy(), 1e-5)


def test_fused_step_function_chained_over_a_rollout(monkeypatch):
    """A rollout chains ``FusedStep``s: each step's input state is the last
    step's output. Gradients through the chain equal the plain chain's,
    first and second order, and a first-order backward recomputes each step
    once: the backward must stop at its own step's inputs, not walk on into
    the steps that made them (which would re-enter itself, exponentially in
    the horizon)."""
    H, lr = 10, 0.05
    tm, tn, tp, ts, teps, tidx = _port(_inputs(3, 16, 3, 1, 16, 8, "rand",
                                               seed=5))
    calls = []
    plain_step = imag_ref.fused_step

    def counted(*a):
        calls.append(1)
        return plain_step(*a)
    monkeypatch.setattr(imag_ref, "fused_step", counted)

    def rollout(forward, pol):
        s, total = ts, 0.0
        for h in range(H):
            s, a, pre = forward(tm, tn, pol, s, teps.roll(h, 0),
                                tidx.roll(h, 0))
            total = total + (s ** 2).mean() + (a * pre).mean()
        return total

    def through_function(*a):
        return imag_ops.sorted_step(*a, forward=imag_ops.ref_sorted)

    def grads(forward):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in jax.tree.leaves(tp)]
        pol = jax.tree.unflatten(jax.tree.structure(tp), leaves)
        loss = rollout(forward, pol)
        calls.clear()
        inner = torch.autograd.grad(loss, leaves, create_graph=True)
        n_first = len(calls)
        adapted = jax.tree.unflatten(jax.tree.structure(tp), [
            x - lr * g for x, g in zip(leaves, inner)])
        outer = torch.autograd.grad(rollout(forward, adapted), leaves)
        return inner, outer, n_first

    got_in, got_out, n_first = grads(through_function)
    want_in, want_out, _ = grads(plain_step)
    assert n_first == H
    for got, want in ((got_in, want_in), (got_out, want_out)):
        for g, w in zip(got, want):
            _close_to_scale(g.detach().numpy(), w.detach().numpy(), 1e-5)


def test_dispatch_routes_and_refusals():
    args = _port(_inputs(3, 10, 3, 1, 8, 8, "rand"))
    with pytest.raises(ValueError, match="impl"):
        imag_ops.fused_step(*args, impl="pallas")
    assert not imag_ops.uses_kernel(args[3])
    assert imag_ops.uses_kernel(args[3], "cuda")
    assert not imag_ops.uses_kernel(args[3], "ref")
    # the kernel never falls back to the plain version for a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        imag_ops.fused_step(*args, impl="cuda")
    members, norm, pol, s, eps, _ = args
    offsets = torch.tensor([0, 4, 7, 10], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        imag_cuda.fused_step_sorted(members, norm, pol, s, eps, offsets)


# The kernel's launch plan (imag/cuda.py's plan_step) at chip_smoke.py's
# IMAG_CASES shapes: K, B, obs, act, hidden, policy hidden, policy depth,
# group sizes (None: members drawn uniformly, as imagination draws them).
PLAN_CASES = [
    (5, 64, 23, 7, 256, 64, 2, None),
    (5, 4096, 23, 7, 256, 64, 2, None),
    (1, 64, 23, 7, 256, 64, 2, None),
    (4, 64, 3, 1, 96, 48, 1, (10, 0, 54, 0)),
    (3, 48, 3, 1, 96, 48, 1, (0, 48, 0)),
    (5, 37, 4, 2, 24, 12, 1, (5, 8, 0, 20, 4)),
    (1, 20, 5, 2, 32, 16, 1, (20,)),
    (3, 70, 6, 3, 300, 20, 1, None),
]


def _plan_work(plan, offsets, dyn_dims):
    """What every block of ``plan`` computes, decoded as imag.cu decodes
    it: grid (row_clusters x cluster, K); cluster q of member g takes the
    member's tiles q, q + row_clusters, ...; block `rank` runs the policy
    on the tile rows i with i % cluster == rank and, in member layer l,
    columns [rank x ld, rank x ld + ld) of dout. Yields ("policy", row) and
    (l, row, column)."""
    c = plan.cluster
    for g in range(len(offsets) - 1):
        start, end = int(offsets[g]), int(offsets[g + 1])
        tiles = -(-(end - start) // plan.rows)
        for q in range(plan.row_clusters):
            for tile in range(q, tiles, plan.row_clusters):
                lo = start + tile * plan.rows
                cnt = min(plan.rows, end - lo)
                for rank in range(c):
                    for i in range(rank, cnt, c):
                        yield ("policy", lo + i)
                    for l, dout in enumerate(dyn_dims[1:]):
                        ld = imag_cuda.slice_width(dout, c)
                        for col in range(rank * ld, min(dout, rank * ld + ld)):
                            for i in range(cnt):
                                yield (l, lo + i, col)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_step_plan_computes_every_output_once(case):
    K, B, obs, act, hid, phid, pdepth, sizes = case
    dyn_dims = (obs + act, hid, hid, obs)
    pol_dims = (obs,) + (phid,) * pdepth + (act,)
    plan = imag_cuda.plan_step(B, K, dyn_dims, pol_dims)
    assert plan.rows in (16, 32)
    assert 1 <= plan.cluster <= 8 and plan.row_clusters >= 1
    # the grid's x extent is whole clusters
    assert plan.blocks == K * plan.row_clusters * plan.cluster
    assert plan.smem == imag_cuda.smem_bytes(plan.rows, plan.cluster,
                                             dyn_dims, pol_dims)
    assert plan.smem <= 227 * 1024
    if sizes is None:
        rng = np.random.default_rng(13)
        sizes = np.bincount(rng.integers(0, K, B), minlength=K)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    counts = {}
    for key in _plan_work(plan, offsets, dyn_dims):
        counts[key] = counts.get(key, 0) + 1
    want = {("policy", r) for r in range(B)} | {
        (l, r, col) for l, dout in enumerate(dyn_dims[1:])
        for r in range(B) for col in range(dout)}
    assert set(counts) == want
    assert set(counts.values()) == {1}


def test_step_plan_refuses_what_no_cluster_fits():
    with pytest.raises(ValueError, match="shared memory"):
        imag_cuda.plan_step(64, 5, (30, 4096, 4096, 23), (23, 64, 7))
    with pytest.raises(ValueError, match="members"):
        imag_cuda.plan_step(64, 70000, (30, 256, 23), (23, 64, 7))
