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
    with the plain products injected. That Function's backward runs the
    injected products as ``dx = R(dy, W^T)``, W read through a transposed
    view (never a copy), and ``dW = T(x, dy)``, each only when autograd
    asks for it. (The name is kept from when the backward raised.)"""
    rng = np.random.default_rng(5)
    lhs_np, rhs_np = _rand(rng, (9, 4)), _rand(rng, (3, 4, 2))
    dy_np = _rand(rng, (9, 2))
    sizes = np.asarray([4, 0, 5], np.int32)

    def jloss(lhs, rhs):
        out = jgmm_ref.grouped_matmul(lhs, rhs, jnp.asarray(sizes))
        return (out * dy_np).sum()
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lhs_np),
                                           jnp.asarray(rhs_np))
    routes = {
        "plain": lambda a, b, gs: gmm_ops.grouped_matmul(a, b, gs),
        "function": lambda a, b, gs: gmm_ops.RaggedGroupedMatmul.apply(
            a, b, gs, gmm_ops.PLAIN_RAGGED)}
    for name, route in routes.items():
        lhs = _t(lhs_np).requires_grad_(True)
        rhs = _t(rhs_np).requires_grad_(True)
        out = route(lhs, rhs, torch.from_numpy(sizes))
        (out * _t(dy_np)).sum().backward()
        for got, w in zip((lhs.grad, rhs.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)

    calls = []

    def matmul(a, b, groups, backward=False):
        calls.append(("R", backward, tuple(b.shape), b.is_contiguous()))
        return gmm_ref.grouped_matmul(a, b, groups)

    def matmul_t(a, b, groups):
        calls.append(("T", tuple(a.shape), tuple(b.shape)))
        return gmm_ref.ragged_transposed_matmul(a, b, groups)
    logged = gmm_ops.RaggedProducts(matmul, matmul_t)
    gs = torch.from_numpy(sizes)
    for need_lhs, need_rhs, want_calls in (
            (False, True, [("R", False, (3, 4, 2), True),
                           ("T", (9, 4), (9, 2))]),
            (True, False, [("R", False, (3, 4, 2), True),
                           ("R", True, (3, 2, 4), False)])):
        calls.clear()
        lhs = _t(lhs_np).requires_grad_(need_lhs)
        rhs = _t(rhs_np).requires_grad_(need_rhs)
        out = gmm_ops.RaggedGroupedMatmul.apply(lhs, rhs, gs, logged)
        (out * _t(dy_np)).sum().backward()
        assert calls == want_calls
        got = lhs.grad if need_lhs else rhs.grad
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(want[0 if need_lhs else 1]),
                                   **TOL)


def test_group_sizes_of_counts_without_bincount():
    idx = torch.tensor([2, 0, 2, 4, 2])
    assert gmm_ref.group_sizes_of(idx, 5).tolist() == [1, 0, 3, 0, 1]
    assert gmm_ref.group_sizes_of(idx, 5).dtype == torch.int32


def _launch_counts():
    return (gmm_ops.equal_launches, gmm_ops.equal_bwd_launches,
            gmm_ops.ragged_launches, gmm_ops.ragged_bwd_launches,
            gmm_ops.ragged_dw_launches)


def test_dispatch_keeps_cpu_tensors_off_the_kernel():
    before = _launch_counts()
    a = torch.ones(2, 3, 4)
    b = torch.ones(2, 4, 5).requires_grad_(True)
    gmm_ops.grouped_matmul(a, b).sum().backward()
    gmm_ops.grouped_matmul(a[0], b, torch.tensor([1, 2])).sum().backward()
    assert _launch_counts() == before
    with pytest.raises(ValueError, match="not a CUDA device"):
        gmm_ops.grouped_matmul(a, b, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        gmm_cuda.gmm_ragged(a[0], b, torch.tensor([0, 1, 3],
                                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="not a CUDA device"):
        gmm_cuda.gmm_ragged_dw(a[0], a[0], torch.tensor([0, 1, 3],
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


def _tf32_trunc(x):
    """The TF32 part of f32 bits, the low 13 mantissa bits dropped: how
    the ragged kernels' ``small`` reaches the tensor core."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


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
    """The kernel's arithmetic: each operand split as big = tf32(x)
    rounded to nearest, small = x - big as the tensor core reads it
    (truncated to TF32), and small*big + big*small + big*big summed in f32
    is within ``GMM_TOL`` of the f64 product, relative to max(1, |C|), at
    every shape the card checks. One TF32 pass (big*big) is not, so the
    kernel takes three."""
    name, G, M, K, N, layout = case
    rng = np.random.default_rng(6)
    a, b = _product_operands(rng, G, M, K, N, layout)
    want = np.matmul(a.astype(np.float64), b.astype(np.float64))
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_trunc(a - a_big), _tf32_trunc(b - b_big)
    three = (np.matmul(a_small, b_big) + np.matmul(a_big, b_small)
             + np.matmul(a_big, b_big))
    one = np.matmul(a_big, b_big)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(three - want).max() <= CHIP.GMM_TOL * scale
    assert np.abs(one - want).max() > CHIP.GMM_TOL * scale


@pytest.mark.parametrize("case", CHIP.GMM_RAGGED_CASES,
                         ids=[c[0] for c in CHIP.GMM_RAGGED_CASES])
def test_ragged_kernels_three_tf32_passes_reach_gmm_tol(case):
    """The same arithmetic (``split_tf32``) on the ragged kernels'
    products: small*big + big*small + big*big in f32 is within
    ``GMM_TOL`` of the f64 product for the forward, dx and dW of every
    case the card checks; one TF32 pass is not, at the assigned shapes."""
    name, G, M, Kd, N, sizes = case
    rng = np.random.default_rng(26)
    gs = _ragged_sizes(rng, G, M, sizes)
    offsets = np.concatenate([[0], np.cumsum(gs)])
    x = (rng.standard_normal((M, Kd)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((G, Kd, N)) * 0.5).astype(np.float32)
    dy = (rng.standard_normal((M, N)) * 0.5).astype(np.float32)

    def split(v):
        big = _tf32_rna(v)
        return big, _tf32_trunc(v - big)

    def passes(a, b):
        (ab, as_), (bb, bs) = split(a), split(b)
        return (as_ @ bb + ab @ bs + ab @ bb, ab @ bb,
                a.astype(np.float64) @ b.astype(np.float64))
    products = {"fwd": [], "dx": [], "dw": []}
    for g in range(G):
        rows = slice(offsets[g], offsets[g + 1])
        products["fwd"].append(passes(x[rows], w[g]))
        products["dx"].append(passes(dy[rows], w[g].T))
        products["dw"].append(passes(x[rows].T, dy[rows]))
    for product, parts in products.items():
        axis = 0 if product != "dw" else None
        three, one, want = (np.concatenate([p[i] for p in parts], 0)
                            if axis == 0 else np.stack([p[i] for p in parts])
                            for i in range(3))
        scale = max(1.0, np.abs(want).max())
        assert np.abs(three - want).max() <= CHIP.GMM_TOL * scale, product
        if name.startswith("assign"):
            assert np.abs(one - want).max() > CHIP.GMM_TOL * scale, product


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


# ---------------------------------------------------------------------------
# Gradients through the grouped products, to second order, on the kernel
# route's wiring

SECOND_ORDER_RAGGED = [
    # G, M, K_dim, N, group sizes
    (4, 64, 32, 48, (10, 0, 54, 0)),      # empty groups
    (3, 40, 13, 7, (40, 0, 0)),           # one group owns all rows
    (1, 24, 8, 8, (24,)),                 # one group (a K = 1 member slice)
    (5, 37, 16, 16, (5, 8, 0, 20, 4)),    # a tile straddles three groups
]
INNER_STEP = 0.05   # MB-MPO's inner_lr


@pytest.fixture
def no_graph_kernels(monkeypatch):
    """The card's wrappers replaced by the plain products computed under
    ``no_grad``: like a ctypes launch, each returns a tensor that carries
    no graph, so the dispatcher's kernel route (``impl="cuda"``) runs its
    Functions' wiring on the CPU with nothing else to differentiate."""
    def sizes(offsets):
        return offsets[1:] - offsets[:-1]

    def no_grad(fn):
        def run(*args):
            with torch.no_grad():
                return fn(*args)
        return run
    monkeypatch.setattr(gmm_cuda, "gmm_equal", no_grad(torch.matmul))
    monkeypatch.setattr(gmm_cuda, "gmm_ragged", no_grad(
        lambda a, b, offs: gmm_ref.grouped_matmul(a, b, sizes(offs))))
    # raising=False: a tree without the dW kernel is tested all the same
    monkeypatch.setattr(gmm_cuda, "gmm_ragged_dw", no_grad(
        lambda a, b, offs: gmm_ref.ragged_transposed_matmul(
            a, b, sizes(offs))), raising=False)


def _jax_second_order(product, step, x, w, c1, c2):
    def inner(xx, ww):
        return jnp.sum(c1 * jnp.tanh(product(xx, ww)))

    def outer(xx, ww):
        if step == "x":
            xx = xx - INNER_STEP * jax.grad(inner, 0)(xx, ww)
        else:
            ww = ww - INNER_STEP * jax.grad(inner, 1)(xx, ww)
        return jnp.sum(c2 * jnp.tanh(product(xx, ww)))
    return jax.grad(outer, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))


def _torch_second_order(product, step, x, w, c1, c2):
    x = _t(x).requires_grad_(True)
    w = _t(w).requires_grad_(True)
    inner = (_t(c1) * torch.tanh(product(x, w))).sum()
    if step == "x":
        (g,) = torch.autograd.grad(inner, (x,), create_graph=True)
        x2, w2 = x - INNER_STEP * g, w
    else:
        (g,) = torch.autograd.grad(inner, (w,), create_graph=True)
        x2, w2 = x, w - INNER_STEP * g
    outer = (_t(c2) * torch.tanh(product(x2, w2))).sum()
    return torch.autograd.grad(outer, (x, w))


@pytest.mark.parametrize("step", ["x", "w"])
@pytest.mark.parametrize("case", SECOND_ORDER_RAGGED,
                         ids=["empty", "one_owns_all", "g1", "straddle3"])
def test_ragged_second_order_gradient_on_the_kernel_route(
        no_graph_kernels, case, step):
    """The fault: with a product that returns no graph, as the kernel's
    does, the Function's backward must itself be differentiable, or the
    gradient through an inner step loses its second-order term. In float64
    against ``jax.grad`` of ``jax.grad`` through the reference's ``ref``
    route, whose products accumulate in f32 (``preferred_element_type``):
    1e-5 of the gradient's scale."""
    G, M, Kd, N, sizes = case
    rng = np.random.default_rng(20)
    x = rng.standard_normal((M, Kd)) * 0.5
    w = rng.standard_normal((G, Kd, N)) * 0.5
    c1, c2 = rng.standard_normal((M, N)), rng.standard_normal((M, N))
    gs = np.asarray(sizes, np.int32)
    with jax.enable_x64(True):
        want = _jax_second_order(
            lambda a, b: jgmm_ref.grouped_matmul(a, b, jnp.asarray(gs)),
            step, x, w, c1, c2)
    got = _torch_second_order(
        lambda a, b: gmm_ops.grouped_matmul(a, b, _t(gs), impl="cuda"),
        step, x, w, c1, c2)
    for g, wa in zip(got, want):
        assert g.dtype == torch.float64
        _close_to_scale(g.numpy(), np.asarray(wa))


@pytest.mark.parametrize("step", ["x", "w"])
def test_equal_second_order_gradient_on_the_kernel_route(no_graph_kernels,
                                                         step):
    """The same for ``EqualGroupedMatmul``, whose backward now applies the
    Function again instead of calling the product directly."""
    rng = np.random.default_rng(21)
    G, M, Kd, N = 3, 20, 12, 7
    x = rng.standard_normal((G, M, Kd)) * 0.5
    w = rng.standard_normal((G, Kd, N)) * 0.5
    c1, c2 = rng.standard_normal((G, M, N)), rng.standard_normal((G, M, N))
    with jax.enable_x64(True):
        want = _jax_second_order(jgmm_ref.grouped_matmul, step, x, w, c1, c2)
    got = _torch_second_order(
        lambda a, b: gmm_ops.grouped_matmul(a, b, impl="cuda"),
        step, x, w, c1, c2)
    for g, wa in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(wa))


def test_equal_backward_keeps_the_backward_count(no_graph_kernels):
    """Products applied by the backward, at any order, count as backward
    launches; the forward as forward ones."""
    rng = np.random.default_rng(22)
    x = _t(_rand(rng, (2, 5, 4))).requires_grad_(True)
    w = _t(_rand(rng, (2, 4, 3))).requires_grad_(True)
    before = _launch_counts()
    out = gmm_ops.grouped_matmul(x, w, impl="cuda")
    (g,) = torch.autograd.grad((out ** 2).sum(), (x,), create_graph=True)
    torch.autograd.grad((g ** 2).sum(), (w,))
    delta = tuple(a - b for a, b in zip(_launch_counts(), before))
    # forward 1; first backward dX and dW (2); the second backward runs
    # through dX = dY W^T (its two operands) and through the forward's
    # dY = 2 * out (the forward's dX and dW): 4
    assert delta == (1, 6, 0, 0, 0)


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_transposed_matmul_and_its_gradients_match_jax(case):
    """T(a, b)[g] = a[rows of g]^T b[rows of g] is ``jax.grad`` of the
    reference's ragged product with respect to its weights; T's own
    gradients (plain autograd, and the Function, whose backward is two
    ragged products) are the reference's second derivative."""
    G, M, Kd, N, sizes = case
    rng = np.random.default_rng(23)
    a, b = _rand(rng, (M, Kd), 0.3), _rand(rng, (M, N), 0.3)
    c = _rand(rng, (G, Kd, N))
    gs = np.asarray(sizes, np.int32)
    w0 = jnp.zeros((G, Kd, N), jnp.float32)

    def jt(aa, bb):
        return jax.grad(lambda w: jnp.sum(
            bb * jgmm_ref.grouped_matmul(aa, w, jnp.asarray(gs))))(w0)
    want = np.asarray(jt(jnp.asarray(a), jnp.asarray(b)))
    want_da, want_db = jax.grad(lambda aa, bb: jnp.sum(c * jt(aa, bb)),
                                argnums=(0, 1))(jnp.asarray(a),
                                                jnp.asarray(b))
    routes = {
        "plain": gmm_ref.ragged_transposed_matmul,
        "function": lambda aa, bb, g: gmm_ops.RaggedTransposedMatmul.apply(
            aa, bb, g, gmm_ops.PLAIN_RAGGED)}
    for name, route in routes.items():
        ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
        out = route(ta, tb, _t(gs))
        _close_to_scale(out.detach().numpy(), want)
        for empty in np.flatnonzero(gs == 0):
            assert not out[empty].any()
        (_t(c) * out).sum().backward()
        _close_to_scale(ta.grad.numpy(), np.asarray(want_da))
        _close_to_scale(tb.grad.numpy(), np.asarray(want_db))


# ---------------------------------------------------------------------------
# gmm_ragged and gmm_ragged_dw: their launch plans, decoded as the kernels
# decode them

def _ragged_sizes(rng, G, M, sizes):
    """A case's group sizes; None draws members as imagination does."""
    if sizes is None:
        return np.bincount(rng.integers(0, G, M), minlength=G)
    return np.asarray(sizes)


def _ragged_passes(plan, offsets, M, N):
    """``(m0, n0, [(g, lo, hi), ...])`` of every block of ``gmm_ragged``,
    as ``gmm_ragged_tc`` walks the groups: block x owns output tile x
    (row-major over ceil(M / bm) x tiles_n) and runs one pass for each
    non-empty group whose rows overlap it, over rows [lo, hi)."""
    tiles_n = -(-N // plan.bn)
    G = len(offsets) - 1
    for x in range(-(-M // plan.bm) * tiles_n):
        m0, n0 = (x // tiles_n) * plan.bm, (x % tiles_n) * plan.bn
        passes = []
        for g in range(G):
            start, end = max(offsets[g], 0), min(offsets[g + 1], M)
            if start >= m0 + plan.bm:
                break
            if end <= max(start, m0):
                continue
            passes.append((g, max(start, m0), min(end, m0 + plan.bm)))
        yield m0, n0, passes


def _ragged_dw_ranks(plan, offsets, M, K, N):
    """``(g, k0, n0, rank, lo, hi)`` of every block of ``gmm_ragged_dw``,
    as ``gmm_ragged_dw_tc`` decodes its index: grid (split * tiles, G);
    block x is rank x % split of the cluster owning tile x // split of
    dW[g], and sums the group's 32-row tiles [rank * nt // split,
    (rank + 1) * nt // split) from ``offsets[g]``."""
    tiles_n = -(-N // plan.bn)
    tiles = -(-K // plan.bm) * tiles_n
    for g in range(len(offsets) - 1):
        start, end = max(offsets[g], 0), min(offsets[g + 1], M)
        nt = -(-(end - start) // gmm_cuda.BK) if end > start else 0
        for x in range(tiles * plan.split):
            rank, tile = x % plan.split, x // plan.split
            t0, t1 = rank * nt // plan.split, (rank + 1) * nt // plan.split
            yield (g, (tile // tiles_n) * plan.bm, (tile % tiles_n) * plan.bn,
                   rank, start + t0 * gmm_cuda.BK,
                   min(start + t1 * gmm_cuda.BK, end))


@pytest.mark.parametrize("case", CHIP.GMM_RAGGED_CASES,
                         ids=[c[0] for c in CHIP.GMM_RAGGED_CASES])
def test_ragged_plan_multiplies_each_row_by_its_own_group_once(case):
    """For the forward and for dx (rhs transposed: output width K):
    every output element is owned by one block, and inside a block every
    row is in exactly one pass, that of its own group; a pass per
    non-empty group the tile touches, no more. The numpy model of the
    passes reproduces the plain product."""
    name, G, M, Kd, N, sizes = case
    rng = np.random.default_rng(24)
    gs = _ragged_sizes(rng, G, M, sizes)
    offsets = np.concatenate([[0], np.cumsum(gs)])
    gid = np.repeat(np.arange(G), gs)
    lhs = rng.standard_normal((M, Kd)).astype(np.float32)
    rhs = rng.standard_normal((G, Kd, N)).astype(np.float32)
    for width in (N, Kd):
        plan = gmm_cuda.plan_ragged(M, width, N if width == Kd else Kd)
        assert (plan.bm, plan.bn) in gmm_cuda.TILES
        owned = np.zeros((M, width), np.int32)
        blocks = list(_ragged_passes(plan, offsets, M, width))
        assert len(blocks) == plan.blocks
        for m0, n0, passes in blocks:
            owned[m0:m0 + plan.bm, n0:n0 + plan.bn] += 1
            rows = np.zeros(M, np.int32)
            for g, lo, hi in passes:
                assert (gid[lo:hi] == g).all()
                rows[lo:hi] += 1
            tile = slice(m0, min(m0 + plan.bm, M))
            assert (rows[tile] == 1).all()
            assert len(passes) == len(set(gid[tile]))
        assert (owned == 1).all()
    if name == "edge_straddling":
        plan = gmm_cuda.plan_ragged(M, N, Kd)
        assert max(len(p) for *_, p in
                   _ragged_passes(plan, offsets, M, N)) == 3
    plan = gmm_cuda.plan_ragged(M, N, Kd)
    out = np.zeros((M, N), np.float64)
    for m0, n0, passes in _ragged_passes(plan, offsets, M, N):
        for g, lo, hi in passes:
            out[lo:hi, n0:n0 + plan.bn] += (
                lhs[lo:hi].astype(np.float64) @ rhs[g, :, n0:n0 + plan.bn])
    want = np.einsum("mk,mkn->mn", lhs.astype(np.float64), rhs[gid])
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", CHIP.GMM_RAGGED_CASES,
                         ids=[c[0] for c in CHIP.GMM_RAGGED_CASES])
def test_ragged_dw_plan_covers_every_row_once_in_rank_order(case):
    """Every tile of every group's gradient is owned by one cluster of
    ``split`` ≤ 8 blocks whose ranks take contiguous, ordered runs of the
    group's rows that cover them once (empty runs allowed: such a rank,
    and every rank of an empty group, adds a zero partial). A numpy model
    of the kernel's sum (each rank's partial in f32, added in rank order)
    is within ``GMM_TOL`` of T in f64, and an empty group's slice is
    zeros. At the assigned shapes the launch fills the 132 SMs."""
    name, G, M, Kd, N, sizes = case
    rng = np.random.default_rng(25)
    gs = _ragged_sizes(rng, G, M, sizes)
    offsets = np.concatenate([[0], np.cumsum(gs)])
    plan = gmm_cuda.plan_ragged_dw(G, M, Kd, N)
    assert (plan.bm, plan.bn) in gmm_cuda.TILES
    assert 1 <= plan.split <= gmm_cuda.MAX_DW_SPLIT <= 8
    if name.startswith("assign"):
        assert plan.blocks >= gmm_cuda.NUM_SMS
    x = (rng.standard_normal((M, Kd)) * 0.5).astype(np.float32)
    dy = (rng.standard_normal((M, N)) * 0.5).astype(np.float32)
    clusters = {}
    blocks = list(_ragged_dw_ranks(plan, offsets, M, Kd, N))
    assert len(blocks) == plan.blocks
    for g, k0, n0, rank, lo, hi in blocks:
        clusters.setdefault((g, k0, n0), []).append((rank, lo, hi))
    owned = np.zeros((G, Kd, N), np.int32)
    got = np.zeros((G, Kd, N), np.float32)
    for (g, k0, n0), ranks in clusters.items():
        assert [r for r, _, _ in ranks] == list(range(plan.split))
        start, end = offsets[g], offsets[g + 1]
        cover = [(lo, hi) for _, lo, hi in ranks if hi > lo]
        assert sum(hi - lo for lo, hi in cover) == end - start
        assert all(a[1] == b[0] for a, b in zip(cover, cover[1:]))
        if cover:
            assert cover[0][0] == start and cover[-1][1] == end
        owned[g, k0:k0 + plan.bm, n0:n0 + plan.bn] += 1
        tile = (slice(k0, k0 + plan.bm), slice(n0, n0 + plan.bn))
        acc = np.zeros((min(plan.bm, Kd - k0), min(plan.bn, N - n0)),
                       np.float32)
        for _, lo, hi in ranks:          # rank order, as rank 0 adds them
            acc += x[lo:hi, tile[0]].T @ dy[lo:hi, tile[1]]
        got[g][tile] = acc
    assert (owned == 1).all()
    gid = np.repeat(np.arange(G), gs)
    onehot = (gid[:, None] == np.arange(G)).astype(np.float64)
    want = np.einsum("mg,mk,mn->gkn", onehot, x.astype(np.float64), dy)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= CHIP.GMM_TOL * scale
    for empty in np.flatnonzero(gs == 0):
        assert not got[empty].any()


@pytest.mark.parametrize("case", [c for c in CHIP.GMM_RAGGED_CASES
                                  if c[0].startswith("assign")],
                         ids=lambda c: c[0])
def test_ragged_plans_at_the_assigned_shapes(case):
    """At the assigned predictor's layers: 64 x 32 tiles where the output
    is 256 wide (four blocks per SM), 32 x 32 where it is 23 or 30; the
    dW split gives at least two blocks per SM."""
    _, G, M, Kd, N, _ = case
    for width, depth in ((N, Kd), (Kd, N)):
        plan = gmm_cuda.plan_ragged(M, width, depth)
        assert (plan.bm, plan.bn) == ((64, 32) if width > 32 else (32, 32))
        assert plan.blocks >= gmm_cuda.NUM_SMS
    dw = gmm_cuda.plan_ragged_dw(G, M, Kd, N)
    assert dw.blocks >= 2 * gmm_cuda.NUM_SMS
    assert dw.split <= -(-M // (G * gmm_cuda.BK))


def test_ragged_plans_refuse_what_the_kernels_cannot_launch():
    with pytest.raises(ValueError, match="negative"):
        gmm_cuda.plan_ragged(-1, 8, 8)
    with pytest.raises(ValueError, match="negative"):
        gmm_cuda.plan_ragged_dw(2, 8, -8, 8)
    with pytest.raises(ValueError, match="groups"):
        gmm_cuda.plan_ragged_dw(70000, 8, 8, 8)
    # no rows: one 32-row tile a group at most, so no split
    assert gmm_cuda.plan_ragged_dw(3, 0, 64, 64).split == 1


def test_chip_smoke_assigned_grad_counts_and_matches_on_the_cpu(
        no_graph_kernels, monkeypatch):
    """A rehearsal of ``chip_smoke.py``'s ``assigned_grad`` at a small
    ensemble: the user's ``predict_assigned`` on the kernel route (every
    ragged product a no-graph stand-in) against the plain route, first
    order and through the inner step, within the phase's tolerance, with
    the (forward, dx, dW) launches its ``expected_ragged_launches``
    states."""
    from repro_torch.mbrl import dynamics as DYN
    monkeypatch.setattr(gmm_ops, "_use_kernel",
                        lambda t, impl: impl != "ref")
    gen = torch.Generator().manual_seed(0)
    cfg = DYN.EnsembleConfig(5, 2, hidden=16, depth=2, n_models=3)
    params = DYN.init_ensemble(cfg, gen)
    params["norm"] = {k: v + 0.1 for k, v in params["norm"].items()}
    rows = 40
    obs = torch.randn((rows, 5), generator=gen)
    act = torch.randn((rows, 2), generator=gen)
    target = torch.randn((rows, 5), generator=gen)
    idx = torch.tensor([0] * 15 + [2] * 25)[torch.randperm(rows,
                                                           generator=gen)]
    depth = len(params["members"]["w"])
    want_launches = CHIP.expected_ragged_launches(depth)
    for key, second in (("first_order", False), ("second_order", True)):
        grads = {}
        for impl in ("cuda", "ref"):
            leaves = [t.clone().requires_grad_(True) for t in
                      [obs, act] + params["members"]["w"]
                      + params["members"]["b"]]
            predict = CHIP.assigned_predictor(DYN, gmm_ops, params, idx,
                                              impl)
            grads[impl], launches = CHIP.ragged_grads(
                gmm_ops, predict, leaves, target, second)
            assert launches == (want_launches[key] if impl == "cuda"
                                else (0, 0, 0))
        for got, want in zip(grads["cuda"], grads["ref"]):
            _close_to_scale(got.numpy(), want.numpy())
