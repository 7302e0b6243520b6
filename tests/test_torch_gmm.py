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
