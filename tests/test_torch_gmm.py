"""Grouped matmul in the PyTorch port against the JAX reference.

The same numpy-seeded inputs go through the reference's oracle
(``repro.kernels.gmm.ref``), its Pallas kernels in interpret mode (as
``test_kernels_interpret.py`` runs them on the CPU), and the port's plain
versions and dispatcher, in f32 at atol/rtol 1e-5 (the interpret-mode
kernels at the 1e-4 that ``test_kernels_interpret.py`` grants them): the
functions are equal, only the order of f32 sums differs. Gradients go
through the port's ``autograd.Function`` with the plain product injected
and are held against ``jax.grad`` of ``ref.ensemble_mlp`` at 1e-5 of the
gradient's own scale (each entry sums products over the batch). The
hand-written CUDA kernels run only on a card: their tests are in
``test_torch_kernels_gpu.py``.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm import pallas as jgmm_pallas
from repro.kernels.gmm import ref as jgmm_ref
from repro_torch.kernels.gmm import cuda as gmm_cuda
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref

TOL = dict(atol=1e-5, rtol=1e-5)
INTERPRET_TOL = dict(atol=1e-4, rtol=1e-4)

RAGGED_CASES = [
    # n_groups, M, K_dim, N, group sizes (sum = M)  (test_kernels_interpret)
    (4, 64, 32, 48, (10, 0, 54, 0)),      # empty groups
    (3, 200, 130, 70, (200, 0, 0)),       # one group owns the full batch
    (5, 37, 16, 16, (5, 8, 0, 20, 4)),    # straddling odd-size tiles
    (1, 128, 128, 128, (128,)),           # G=1
    (3, 300, 96, 40, (1, 298, 1)),
]
EQUAL_CASES = [
    # G, M, K_dim, N
    (5, 64, 30, 32),        # the ensemble's first layer: K_dim=30
    (5, 37, 32, 23),        # M not a tile multiple, N=23 (obs_dim)
    (1, 128, 64, 64),       # G=1
    (3, 200, 130, 70),
]


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_to_scale(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _members(rng, K, dims, scale=0.3):
    return {"w": [_rand(rng, (K, a, b), scale)
                  for a, b in zip(dims[:-1], dims[1:])],
            "b": [_rand(rng, (K, b), 0.1) for b in dims[1:]]}


def _tmembers(m):
    return {k: [_t(x) for x in v] for k, v in m.items()}


@pytest.mark.parametrize("case", EQUAL_CASES)
def test_equal_grouped_matmul_matches_oracle_and_interpret(case):
    G, M, Kd, N = case
    rng = np.random.default_rng(0)
    lhs, rhs = _rand(rng, (G, M, Kd), 0.3), _rand(rng, (G, Kd, N), 0.3)
    want = np.asarray(jgmm_ref.grouped_matmul(lhs, rhs))
    interp = np.asarray(jgmm_pallas.grouped_matmul(lhs, rhs, interpret=True))
    np.testing.assert_allclose(
        gmm_ref.grouped_matmul(_t(lhs), _t(rhs)).numpy(), want, **TOL)
    got = gmm_ops.grouped_matmul(_t(lhs), _t(rhs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), interp, **INTERPRET_TOL)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_grouped_matmul_matches_oracle_and_interpret(case):
    G, M, Kd, N, sizes = case
    rng = np.random.default_rng(1)
    lhs, rhs = _rand(rng, (M, Kd), 0.3), _rand(rng, (G, Kd, N), 0.3)
    gs = np.array(sizes, np.int32)
    want = np.asarray(jgmm_ref.grouped_matmul(lhs, rhs, jnp.asarray(gs)))
    interp = np.asarray(jgmm_pallas.grouped_matmul(
        lhs, rhs, jnp.asarray(gs), interpret=True))
    np.testing.assert_allclose(
        gmm_ref.grouped_matmul(_t(lhs), _t(rhs), _t(gs)).numpy(), want,
        **TOL)
    got = gmm_ops.grouped_matmul(_t(lhs), _t(rhs), _t(gs))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), interp, **INTERPRET_TOL)


@pytest.mark.parametrize("K,B,dims", [
    (5, 48, (30, 32, 32, 23)),      # the ensemble's layout, hidden 32
    (3, 37, (12, 32, 12)),
    (1, 16, (8, 16, 8)),
])
def test_ensemble_mlp_and_select_match_oracle(K, B, dims):
    rng = np.random.default_rng(2)
    members = _members(rng, K, dims)
    x = _rand(rng, (B, dims[0]))
    idx = rng.integers(0, K, B).astype(np.int32)
    jm = jax.tree.map(jnp.asarray, members)
    want_all = np.asarray(jgmm_ref.ensemble_mlp(jm, x))
    want_sel = np.asarray(jgmm_ref.ensemble_mlp_select(jm, x,
                                                       jnp.asarray(idx)))
    interp_sel = np.asarray(jgmm_pallas.ensemble_mlp_select(
        jm, x, jnp.asarray(idx), interpret=True))
    tm = _tmembers(members)
    for got in (gmm_ref.ensemble_mlp(tm, _t(x)),
                gmm_ops.ensemble_mlp(tm, _t(x))):
        np.testing.assert_allclose(got.numpy(), want_all, **TOL)
    for got in (gmm_ref.ensemble_mlp_select(tm, _t(x), _t(idx).long()),
                gmm_ops.ensemble_mlp_select(tm, _t(x), _t(idx).long())):
        np.testing.assert_allclose(got.numpy(), want_sel, **TOL)
        np.testing.assert_allclose(got.numpy(), interp_sel, **INTERPRET_TOL)
        # the select contract: row b is ensemble_mlp(...)[idx[b], b]
        np.testing.assert_allclose(got.numpy(),
                                   want_all[idx, np.arange(B)], **TOL)


@pytest.mark.parametrize("K,B,dims", [
    (5, 40, (30, 32, 32, 23)),
    (2, 33, (6, 16, 5)),
])
def test_equal_function_gradients_match_jax_grad(K, B, dims):
    """Backward wiring of the equal Function (dX = dY W^T, dW = X^T dY,
    the broadcast first-layer input summed over members) with the plain
    product injected, against jax.grad of the oracle's ensemble MLP."""
    rng = np.random.default_rng(3)
    members = _members(rng, K, dims)
    x = _rand(rng, (B, dims[0]))
    target = _rand(rng, (K, B, dims[-1]))

    def jloss(m, xx):
        return jnp.sum((jgmm_ref.ensemble_mlp(m, xx) - target) ** 2)

    jg_m, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, members), jnp.asarray(x))

    tm = {k: [_t(a).requires_grad_(True) for a in v]
          for k, v in members.items()}
    tx = _t(x).requires_grad_(True)
    out = gmm_ops.ensemble_mlp(tm, tx, impl="ref")
    torch.sum((out - _t(target)) ** 2).backward()
    _close_to_scale(tx.grad.numpy(), jg_x)
    for key in ("w", "b"):
        for got, want in zip(tm[key], jg_m[key]):
            _close_to_scale(got.grad.numpy(), want)


def test_equal_function_backward_calls_the_injected_product():
    """The backward runs the injected product on transposed views (never
    copies) and only for the operands autograd asks for."""
    calls = []

    def product(a, b, backward=False):
        calls.append((backward, tuple(a.shape), tuple(b.shape),
                      a.is_contiguous(), b.is_contiguous()))
        return torch.matmul(a, b)

    rng = np.random.default_rng(4)
    x = _t(_rand(rng, (7, 5)))
    lhs = x[None].expand(3, 7, 5)           # broadcast, stride 0
    w = _t(_rand(rng, (3, 5, 4))).requires_grad_(True)
    out = gmm_ops.EqualGroupedMatmul.apply(lhs, w, product)
    out.sum().backward()
    # forward, then dW only: the input needs no gradient
    assert calls == [(False, (3, 7, 5), (3, 5, 4), False, True),
                     (True, (3, 5, 7), (3, 7, 4), False, True)]
    np.testing.assert_allclose(
        w.grad.numpy(), np.broadcast_to(x.sum(0).numpy()[None, :, None],
                                        (3, 5, 4)), **TOL)


def test_ragged_function_backward_raises():
    """The ragged product's gradient equals ``jax.grad`` of the reference's
    ``ref`` route, on both of the port's wirings: the plain route (autograd
    through ``ref.grouped_matmul``) and the kernel's ``autograd.Function``
    with the plain product injected, whose backward recomputes the plain
    product. (The name is kept from when the backward raised.)"""
    rng = np.random.default_rng(5)
    lhs_np, rhs_np = _rand(rng, (9, 4)), _rand(rng, (3, 4, 2))
    dy_np = _rand(rng, (9, 2))
    sizes = np.asarray([4, 0, 5], np.int32)

    def jloss(lhs, rhs):
        out = jgmm_ref.grouped_matmul(lhs, rhs, jnp.asarray(sizes))
        return (out * dy_np).sum()
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lhs_np),
                                           jnp.asarray(rhs_np))

    def product(lhs, rhs, group_sizes):
        return gmm_ref.grouped_matmul(lhs, rhs, group_sizes)
    routes = {
        "plain": lambda a, b, gs: gmm_ops.grouped_matmul(a, b, gs),
        "function": lambda a, b, gs: gmm_ops.RaggedGroupedMatmul.apply(
            a, b, gs, product)}
    for name, route in routes.items():
        lhs = _t(lhs_np).requires_grad_(True)
        rhs = _t(rhs_np).requires_grad_(True)
        out = route(lhs, rhs, torch.from_numpy(sizes))
        (out * _t(dy_np)).sum().backward()
        for got, w in zip((lhs.grad, rhs.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)


def test_group_sizes_of_counts_without_bincount():
    idx = torch.tensor([2, 0, 2, 4, 2])
    assert gmm_ref.group_sizes_of(idx, 5).tolist() == [1, 0, 3, 0, 1]
    assert gmm_ref.group_sizes_of(idx, 5).dtype == torch.int32


def test_dispatch_keeps_cpu_tensors_off_the_kernel():
    before = (gmm_ops.equal_launches, gmm_ops.equal_bwd_launches,
              gmm_ops.ragged_launches)
    a = torch.ones(2, 3, 4)
    b = torch.ones(2, 4, 5)
    gmm_ops.grouped_matmul(a, b)
    gmm_ops.grouped_matmul(a[0], b, torch.tensor([1, 2]))
    assert (gmm_ops.equal_launches, gmm_ops.equal_bwd_launches,
            gmm_ops.ragged_launches) == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        gmm_ops.grouped_matmul(a, b, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        gmm_cuda.gmm_ragged(a[0], b, torch.tensor([0, 1, 3],
                                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown"):
        gmm_ops.grouped_matmul(a, b, impl="triton")


# ---------------------------------------------------------------------------
# gmm_equal on the tensor cores: the 3xTF32 arithmetic and the launch plan

def _chip_smoke():
    """chip_smoke.py at the repo root, whose cases and tolerances the card
    is held to (it imports only torch and numpy at the top)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP = _chip_smoke()


def _tf32_rna(x):
    """``cvt.rna.tf32.f32`` by bit arithmetic: round the f32 mantissa to
    its top 10 bits, to nearest with ties away from zero (adding half an
    ulp to the magnitude bits, then clearing the low 13)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product_operands(rng, G, M, K, N, layout):
    """The logical operands of one ``GMM_EQUAL_CASES`` product, as
    ``chip_smoke.gmm_equal_operands`` lays them out (values only)."""
    def rnd(*shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)
    if layout == "fwd":
        return rnd(G, M, K), rnd(G, K, N)
    if layout == "fwd_bcast":
        return np.broadcast_to(rnd(M, K), (G, M, K)), rnd(G, K, N)
    if layout == "dx":
        return rnd(G, M, N), rnd(G, K, N).transpose(0, 2, 1)
    if layout == "dw":
        return rnd(G, M, K).transpose(0, 2, 1), rnd(G, M, N)
    if layout == "dw_bcast":
        return (np.broadcast_to(rnd(M, K), (G, M, K)).transpose(0, 2, 1),
                rnd(G, M, N))
    raise ValueError(layout)


def test_tf32_rounding_model_is_round_to_nearest_ties_away():
    x = np.array([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                  -(1 + 2 ** -11), 1 + 2 ** -12, 3.0], np.float32)
    want = np.array([1.0, 1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                     3.0], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), want)


@pytest.mark.parametrize("case", CHIP.GMM_EQUAL_CASES,
                         ids=[c[0] for c in CHIP.GMM_EQUAL_CASES])
def test_three_tf32_passes_reach_gmm_tol_and_one_pass_does_not(case):
    """The kernel's arithmetic: each operand split as big = tf32(x), small
    = tf32(x - big), and small*big + big*small + big*big summed in f32 is
    within ``GMM_TOL`` of the f64 product, relative to max(1, |C|), at
    every shape the card checks. One TF32 pass (big*big) is not, so the
    kernel takes three."""
    name, G, M, K, N, layout = case
    rng = np.random.default_rng(6)
    a, b = _product_operands(rng, G, M, K, N, layout)
    want = np.matmul(a.astype(np.float64), b.astype(np.float64))
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    three = (np.matmul(a_small, b_big) + np.matmul(a_big, b_small)
             + np.matmul(a_big, b_big))
    one = np.matmul(a_big, b_big)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(three - want).max() <= CHIP.GMM_TOL * scale
    assert np.abs(one - want).max() > CHIP.GMM_TOL * scale


def _product_shape(G, M, K, N, layout):
    """(G, M, N, K) of the product the kernel runs for one case."""
    if layout in ("fwd", "fwd_bcast"):
        return G, M, N, K
    if layout == "dx":
        return G, M, K, N
    return G, K, N, M       # dw, dw_bcast: X^T (K, M) x dY (M, N)


def _plan_blocks(plan, G, M, N, K):
    """``(g, m0, n0, k_begin, k_end)`` of every block of ``plan``, decoded
    from the block index as ``gmm.cu``'s ``gmm_equal_tc`` does: grid
    (split * tiles, G); block x is rank ``x % split`` of the cluster that
    owns output tile ``x // split`` (row-major over the tiles) and sums
    contraction tiles [rank * nk // split, (rank + 1) * nk // split)."""
    tiles_n = -(-N // plan.bn)
    tiles = -(-M // plan.bm) * tiles_n
    nk = -(-K // gmm_cuda.BK)
    for g in range(G):
        for x in range(tiles * plan.split):
            rank, tile = x % plan.split, x // plan.split
            kt0, kt1 = rank * nk // plan.split, (rank + 1) * nk // plan.split
            yield (g, (tile // tiles_n) * plan.bm, (tile % tiles_n) * plan.bn,
                   kt0 * gmm_cuda.BK, min(kt1 * gmm_cuda.BK, K))


@pytest.mark.parametrize("case", CHIP.GMM_EQUAL_CASES,
                         ids=[c[0] for c in CHIP.GMM_EQUAL_CASES])
def test_equal_plan_covers_every_tile_once_and_splits_k(case):
    """Every output element is owned by exactly one cluster; a cluster's
    ranks split the contraction into contiguous, non-empty ranges that
    cover it; the cluster stays within a portable size (<= 8)."""
    G, M, N, K = _product_shape(*case[1:])
    plan = gmm_cuda.plan_equal(G, M, N, K)
    assert (plan.bm, plan.bn) in ((64, 64), (64, 32), (32, 64), (32, 32))
    assert 1 <= plan.split <= min(gmm_cuda.MAX_SPLIT, 8)
    owned = np.zeros((G, M, N), np.int32)
    ranges = {}
    blocks = list(_plan_blocks(plan, G, M, N, K))
    assert len(blocks) == plan.blocks
    for g, m0, n0, k0, k1 in blocks:
        assert 0 <= m0 < M and 0 <= n0 < N and 0 <= k0 < k1 <= K
        ranges.setdefault((g, m0, n0), []).append((k0, k1))
    for (g, m0, n0), rs in ranges.items():
        assert len(rs) == plan.split
        assert rs[0][0] == 0 and rs[-1][1] == K
        assert all(rs[i][1] == rs[i + 1][0] for i in range(len(rs) - 1))
        owned[g, m0:m0 + plan.bm, n0:n0 + plan.bn] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("case", [c for c in CHIP.GMM_EQUAL_CASES
                                  if c[0].startswith(("train", "val"))],
                         ids=lambda c: c[0])
def test_equal_plan_fills_the_card_at_the_learners_shapes(case):
    """At least one block per SM of the H100 (132) at every product the
    model learner and its validation run."""
    plan = gmm_cuda.plan_equal(*_product_shape(*case[1:]))
    assert plan.blocks >= gmm_cuda.NUM_SMS


def test_equal_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="groups"):
        gmm_cuda.plan_equal(70000, 8, 8, 8)
    with pytest.raises(ValueError, match="negative"):
        gmm_cuda.plan_equal(1, -1, 8, 8)
    # K = 0 (an empty contraction) still plans one range per output tile
    assert gmm_cuda.plan_equal(2, 40, 40, 0).split == 1
