"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. A CUDA kernel has no CPU mode, so every test here
is marked ``gpu`` and skips without a card. The file imports no JAX, so it
also runs on a card machine that has none:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \\
        tests/test_torch_kernels_gpu.py
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import cuda as fa_cuda
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.gmm import cuda as gmm_cuda
from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.imag import cuda as imag_cuda
from repro_torch.kernels.imag import ops as imag_ops
from repro_torch.kernels.imag import ref as imag_ref
from repro_torch.kernels.ssd import cuda as ssd_cuda
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

# kernel vs plain version, both rounding one f32 result to the output dtype:
# f32 outputs differ only by the order of f32 sums; bf16 outputs by up to
# a bf16 ulp or two (7.8e-3 at |o| < 2)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

ATTN_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, window
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 64, 192, 4, 1, 64, True, 64),     # prefix cache + sliding window
    (1, 64, 64, 2, 2, 64, False, 0),
    (1, 100, 100, 32, 2, 128, True, 0),   # GQA G=16, S not a tile multiple
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_ref(card, case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, win = case
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, dtype) for shape in
        ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    before = fa_ops.launches
    got = fa_ops.attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa_ref.chunked_attention(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=ATOL[dtype], rtol=ATOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [16, 64, 1024])
def test_flash_attention_bf16_tensor_core_route_at_serving_lengths(card, S):
    """The bf16 route (tensor-core tiles, P rounded to bf16) at two
    serving buckets and a long prompt, GLM-4-9B's heads (32 q, 2 kv, D =
    128), against the plain version. Rows past S in the 64-row q tile are
    not written: the output here is the head of a larger buffer whose
    tail must keep its fill."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, torch.bfloat16) for shape in
        ((1, S, 32, 128), (1, S, 2, 128), (1, S, 2, 128)))
    got = fa_ops.attention(q, k, v)
    buf = torch.full((1, S + 64, 32, 128), 7.0, device=card,
                     dtype=torch.bfloat16)
    assert fa_cuda._library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), 1, 1, S, S,
        32, 2, 128, 128 ** -0.5, 1, 0,
        torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    want = fa_ref.chunked_attention(q, k, v)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               atol=ATOL[torch.bfloat16],
                               rtol=ATOL[torch.bfloat16])
    assert torch.equal(buf[:, :S], got)
    assert bool((buf[:, S:] == 7.0).all())


@pytest.mark.gpu
def test_flash_attention_f32_route_matches_ref(card):
    """f32 inputs keep the CUDA-core kernel: equal to the plain version up
    to the order of f32 sums, at a serving bucket and a long prompt."""
    rng = np.random.default_rng(13)
    for S in (64, 1024):
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(card) for shape in
            ((1, S, 8, 128), (1, S, 2, 128), (1, S, 2, 128)))
        got = fa_ops.attention(q, k, v)
        torch.cuda.synchronize()
        want = fa_ref.chunked_attention(q, k, v)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=ATOL[torch.float32],
                                   rtol=ATOL[torch.float32])


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_unsupported_head_dim(card):
    q = torch.zeros((1, 8, 2, 32), device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.attention(q, q, q)


@pytest.mark.gpu
def test_flash_attention_refuses_without_falling_back(card):
    """Inputs the kernel does not take raise, and nothing runs in the
    kernel's place: the launch count stays."""
    q = torch.zeros((1, 64, 4, 64), device=card, dtype=torch.bfloat16)
    # contiguous, but 8 bytes past a 16-byte boundary
    shifted = torch.zeros(q.numel() + 4, device=card,
                          dtype=torch.bfloat16)[4:].view(q.shape)
    before = fa_ops.launches
    for args in ((q, q[:, :32], q[:, :32]),                  # Sq > Sk
                 (q, q.float(), q),                          # mixed dtypes
                 (q.half(), q.half(), q.half()),             # float16
                 (q.transpose(1, 2).contiguous().transpose(1, 2), q, q),
                 (shifted, q, q)):
        with pytest.raises(ValueError):
            fa_ops.attention(*args, impl="cuda")
    assert fa_ops.launches == before


# gmm kernels vs plain products, f32 both (no TF32): sums in another order,
# relative to the result's scale
GMM_TOL = 1e-4

GMM_EQUAL_CASES = [
    # G, M, K, N
    (5, 256, 30, 256),      # the ensemble's first layer
    (5, 256, 256, 23),      # its last
    (5, 37, 32, 23),        # M not a tile multiple
    (1, 128, 64, 64),       # G=1
    (3, 70, 1, 33),         # K=1
    (3, 200, 130, 70),
]
GMM_RAGGED_CASES = [
    # G, M, K, N, group sizes (test_kernels_interpret.py's edge shapes)
    (4, 64, 32, 48, (10, 0, 54, 0)),      # empty groups
    (3, 200, 130, 70, (200, 0, 0)),       # one group owns the full batch
    (5, 37, 16, 16, (5, 8, 0, 20, 4)),    # straddling odd-size tiles
    (1, 128, 128, 128, (128,)),           # G=1
    (3, 300, 96, 40, (1, 298, 1)),
    (5, 5000, 256, 23, (1000, 990, 1010, 1003, 997)),
]


def _gmm_close(got, want):
    scale = max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= GMM_TOL * scale, (err, scale)


def _randn(rng, shape, card):
    return torch.from_numpy(
        (0.5 * rng.standard_normal(shape)).astype(np.float32)).to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_EQUAL_CASES)
@pytest.mark.parametrize("bcast", [False, True])
def test_gmm_equal_forward_and_backward_products_match_ref(card, case,
                                                           bcast):
    """Forward, dX = dY W^T and dW = X^T dY, each read in place from
    transposed or broadcast (group stride 0) operands."""
    G, M, K, N = case
    rng = np.random.default_rng(1)
    x = (_randn(rng, (M, K), card)[None].expand(G, M, K) if bcast
         else _randn(rng, (G, M, K), card))
    w = _randn(rng, (G, K, N), card)
    dy = _randn(rng, (G, M, N), card)
    for a, b in ((x, w), (dy, w.transpose(1, 2)), (x.transpose(1, 2), dy)):
        got = gmm_cuda.gmm_equal(a, b)
        torch.cuda.synchronize()
        _gmm_close(got, gmm_ref.grouped_matmul(a, b))


@pytest.mark.gpu
def test_gmm_equal_function_gradients_match_ref_autograd(card):
    """The ensemble MLP's gradients through the kernel's Function equal
    autograd of the plain version, and each launch is counted."""
    rng = np.random.default_rng(2)
    K, B, dims = 5, 300, (30, 64, 64, 23)

    def leaves():
        return ([_randn(rng, (K, a, b), card).requires_grad_(True)
                 for a, b in zip(dims[:-1], dims[1:])],
                [_randn(rng, (K, b), card).requires_grad_(True)
                 for b in dims[1:]],
                _randn(rng, (B, dims[0]), card).requires_grad_(True))
    ws, bs, x = leaves()
    target = _randn(rng, (K, B, dims[-1]), card)
    grads = {}
    for impl in ("cuda", "ref"):
        f0, b0 = gmm_ops.equal_launches, gmm_ops.equal_bwd_launches
        out = gmm_ops.ensemble_mlp({"w": ws, "b": bs}, x, impl=impl)
        loss = ((out - target) ** 2).mean()
        grads[impl] = torch.autograd.grad(loss, ws + bs + [x])
        torch.cuda.synchronize()
        if impl == "cuda":
            assert gmm_ops.equal_launches - f0 == 3
            assert gmm_ops.equal_bwd_launches - b0 == 6
    for got, want in zip(grads["cuda"], grads["ref"]):
        _gmm_close(got, want)


# the model learner's products at its widest ensemble (hidden 256, 5
# members, batch 256; obs 23 + act 7 = 30 inputs) and the validation ring's
# forward (5,000 rows): G, M, K, N of the forward layer, and which product
LEARNER_PRODUCTS = [
    (5, 256, 30, 256, "fwd_bcast"), (5, 256, 256, 256, "fwd"),
    (5, 256, 256, 23, "fwd"), (5, 256, 30, 256, "dx"),
    (5, 256, 30, 256, "dw_bcast"), (5, 256, 256, 256, "dx"),
    (5, 256, 256, 256, "dw"), (5, 256, 256, 23, "dx"),
    (5, 256, 256, 23, "dw"), (5, 5000, 30, 256, "fwd_bcast"),
    (5, 5000, 256, 256, "fwd"), (5, 5000, 256, 23, "fwd"),
]


def _learner_operands(rng, card, G, M, K, N, product):
    x = (_randn(rng, (M, K), card)[None].expand(G, M, K)
         if product.endswith("bcast") else _randn(rng, (G, M, K), card))
    w, dy = _randn(rng, (G, K, N), card), _randn(rng, (G, M, N), card)
    if product.startswith("fwd"):
        return x, w
    if product == "dx":
        return dy, w.transpose(1, 2)
    return x.transpose(1, 2), dy


@pytest.mark.gpu
@pytest.mark.parametrize("case", LEARNER_PRODUCTS)
def test_gmm_equal_learner_products_on_their_plans(card, case):
    """Every product the learner launches, on the tile and contraction
    split the planner gives it (split-K clusters at M = 256), read in
    place (transposed, broadcast) and held to GMM_TOL."""
    rng = np.random.default_rng(14)
    a, b = _learner_operands(rng, card, *case)
    plan = gmm_cuda.plan_equal(a.shape[0], a.shape[1], b.shape[2],
                               a.shape[2])
    assert plan.blocks >= gmm_cuda.NUM_SMS
    got = gmm_cuda.gmm_equal(a, b)
    torch.cuda.synchronize()
    _gmm_close(got, gmm_ref.grouped_matmul(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("split", [1, 2, 3, 4])
def test_gmm_equal_every_split_gives_one_result(card, split):
    """The cluster's fixed-order reduction: any split of the contraction
    agrees with the plain product, and a launch repeated gives the same
    bits."""
    rng = np.random.default_rng(15)
    a, b = _learner_operands(rng, card, 5, 256, 256, 256, "dw")
    lib = gmm_cuda._library()
    ta, ags = gmm_cuda._layout("a", a)
    tb, bgs = gmm_cuda._layout("b", b)
    outs = []
    for _ in range(2):
        c = torch.empty((5, 256, 256), device=card)
        assert lib.gmm_equal(a.data_ptr(), b.data_ptr(), c.data_ptr(), 5,
                             256, 256, 256, ta, tb, ags, bgs, 32, 32, split,
                             torch.cuda.current_stream().cuda_stream) == 0
        outs.append(c)
    torch.cuda.synchronize()
    _gmm_close(outs[0], gmm_ref.grouped_matmul(a, b))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_gmm_equal_function_gradients_at_the_learners_widths(card):
    """EqualGroupedMatmul's forward and both backward products on the
    planner's split-K tiles: the ensemble MLP's gradients at hidden 256
    equal autograd of the plain route."""
    rng = np.random.default_rng(16)
    K, B, dims = 5, 256, (30, 256, 256, 23)
    ws = [_randn(rng, (K, a, b), card).mul_(a ** -0.5).requires_grad_(True)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [_randn(rng, (K, b), card).requires_grad_(True) for b in dims[1:]]
    x = _randn(rng, (B, dims[0]), card).requires_grad_(True)
    target = _randn(rng, (K, B, dims[-1]), card)
    grads = {}
    for impl in ("cuda", "ref"):
        out = gmm_ops.ensemble_mlp({"w": ws, "b": bs}, x, impl=impl)
        grads[impl] = torch.autograd.grad(((out - target) ** 2).mean(),
                                          ws + bs + [x])
    torch.cuda.synchronize()
    for got, want in zip(grads["cuda"], grads["ref"]):
        _gmm_close(got, want)


@pytest.mark.gpu
def test_gmm_equal_refuses_without_falling_back(card):
    """A plan or a launch the kernel cannot take raises; no other product
    runs in its place and no launch is counted."""
    before = (gmm_ops.equal_launches, gmm_ops.equal_bwd_launches)
    a = torch.zeros((70000, 2, 3), device=card)
    with pytest.raises(ValueError, match="groups"):
        gmm_ops.grouped_matmul(a, torch.zeros((70000, 3, 2), device=card),
                               impl="cuda")
    with pytest.raises(ValueError, match="float32"):
        gmm_ops.grouped_matmul(a[:2].half(), a[:2].half().transpose(1, 2),
                               impl="cuda")
    assert (gmm_ops.equal_launches, gmm_ops.equal_bwd_launches) == before
    lib = gmm_cuda._library()
    x = torch.zeros((1, 64, 64), device=card)
    stream = torch.cuda.current_stream().cuda_stream
    for bm, bn, split in ((48, 64, 1), (64, 64, 5), (64, 64, 3)):
        # a tile gmm.cu does not instantiate; a split past the cluster
        # limit; more ranges than the 2 contraction tiles of K = 64
        assert lib.gmm_equal(x.data_ptr(), x.data_ptr(), x.data_ptr(), 1, 64,
                             64, 64, 0, 0, 0, 0, bm, bn, split, stream) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_RAGGED_CASES)
def test_gmm_ragged_matches_ref(card, case):
    G, M, K, N, sizes = case
    rng = np.random.default_rng(3)
    lhs, rhs = _randn(rng, (M, K), card), _randn(rng, (G, K, N), card)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    before = gmm_ops.ragged_launches
    got = gmm_ops.grouped_matmul(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert gmm_ops.ragged_launches == before + 1
    _gmm_close(got, gmm_ref.grouped_matmul(lhs, rhs, gs))


@pytest.mark.gpu
def test_gmm_ragged_select_matches_ref(card):
    rng = np.random.default_rng(4)
    K, B, dims = 5, 777, (30, 64, 23)
    members = {"w": [_randn(rng, (K, a, b), card)
                     for a, b in zip(dims[:-1], dims[1:])],
               "b": [_randn(rng, (K, b), card) for b in dims[1:]]}
    x = _randn(rng, (B, dims[0]), card)
    idx = torch.from_numpy(rng.integers(0, K - 1, B)).to(card)  # one empty
    got = gmm_ops.ensemble_mlp_select(members, x, idx)
    want = gmm_ops.ensemble_mlp(members, x, impl="ref")[
        idx, torch.arange(B, device=card)]
    _gmm_close(got, want)


@pytest.mark.gpu
def test_gmm_ragged_function_gradients_match_ref_autograd(card):
    """Gradients through the ragged kernel's Function (its backward is the
    dx kernel and gmm_ragged_dw) equal autograd of the plain route, and
    each product is one counted kernel launch: per layer one forward, one
    dx and one dW."""
    rng = np.random.default_rng(8)
    K, B, dims = 5, 777, (30, 64, 23)
    ws = [_randn(rng, (K, a, b), card).requires_grad_(True)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [_randn(rng, (K, b), card).requires_grad_(True) for b in dims[1:]]
    x = _randn(rng, (B, dims[0]), card).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, K - 1, B)).to(card)  # one empty
    target = _randn(rng, (B, dims[-1]), card)
    grads = {}
    for impl in ("cuda", "ref"):
        before = _ragged_counts()
        out = gmm_ops.ensemble_mlp_select({"w": ws, "b": bs}, x, idx,
                                          impl=impl)
        grads[impl] = torch.autograd.grad(((out - target) ** 2).mean(),
                                          ws + bs + [x])
        torch.cuda.synchronize()
        n = len(ws) if impl == "cuda" else 0
        assert _ragged_delta(before) == (n, n, n)
    for got, want in zip(grads["cuda"], grads["ref"]):
        _gmm_close(got, want)


def _ragged_counts():
    return (gmm_ops.ragged_launches, gmm_ops.ragged_bwd_launches,
            gmm_ops.ragged_dw_launches)


def _ragged_delta(before):
    return tuple(a - b for a, b in zip(_ragged_counts(), before))


# the assigned predictor's layers at the val ring's 5,000 rows, then the
# edge shapes: G, M, K, N, group sizes
GMM_RAGGED_PRODUCT_CASES = [
    (5, 5000, 30, 256, (1013, 987, 1002, 995, 1003)),
    (5, 5000, 256, 256, (1013, 987, 1002, 995, 1003)),
    (5, 5000, 256, 23, (1013, 987, 1002, 995, 1003)),
    (5, 5000, 256, 256, (0, 2500, 0, 2500, 0)),       # empty groups
] + GMM_RAGGED_CASES[:5]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GMM_RAGGED_PRODUCT_CASES)
def test_gmm_ragged_forward_dx_and_dw_match_ref(card, case):
    """The three products of the ragged layer on their plans: the forward,
    dx = dy x W^T (W read transposed in place) and dW = T(x, dy), each
    against its plain version; an empty group's dW is zeros. The edge
    cases hold a 32 x 32 tile that straddles three groups (5, 8, 0, 20)."""
    G, M, K, N, sizes = case
    rng = np.random.default_rng(17)
    x, w = _randn(rng, (M, K), card), _randn(rng, (G, K, N), card)
    dy = _randn(rng, (M, N), card)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    offsets = gmm_ref.group_offsets(gs)
    out = gmm_cuda.gmm_ragged(x, w, offsets)
    dx = gmm_cuda.gmm_ragged(dy, w.transpose(1, 2), offsets)
    dw = gmm_cuda.gmm_ragged_dw(x, dy, offsets)
    torch.cuda.synchronize()
    _gmm_close(out, gmm_ref.grouped_matmul(x, w, gs))
    _gmm_close(dx, gmm_ref.grouped_matmul(dy, w.transpose(1, 2), gs))
    _gmm_close(dw, gmm_ref.ragged_transposed_matmul(x, dy, gs))
    for g in np.flatnonzero(np.asarray(sizes) == 0):
        assert not dw[g].any()


@pytest.mark.gpu
@pytest.mark.parametrize("split", list(range(1, 9)))
def test_gmm_ragged_dw_every_split_repeats_bit_equal(card, split):
    """The cluster's rank-order sum of gmm_ragged_dw: at every split, on
    each tile, the gradient agrees with the plain T, and a launch repeated
    gives the same bits; an empty group and ranks with no rows add
    zeros."""
    rng = np.random.default_rng(18)
    G, M, K, N = 5, 5000, 256, 256
    sizes = (1013, 0, 1989, 995, 1003)
    x, dy = _randn(rng, (M, K), card), _randn(rng, (M, N), card)
    gs = torch.tensor(sizes, dtype=torch.int32, device=card)
    offsets = gmm_ref.group_offsets(gs)
    want = gmm_ref.ragged_transposed_matmul(x, dy, gs)
    lib = gmm_cuda._library()
    for bm, bn in gmm_cuda.TILES:
        outs = []
        for _ in range(2):
            c = torch.full((G, K, N), float("nan"), device=card)
            assert lib.gmm_ragged_dw(
                x.data_ptr(), dy.data_ptr(), offsets.data_ptr(),
                c.data_ptr(), G, M, K, N, bm, bn, split,
                torch.cuda.current_stream().cuda_stream) == 0
            outs.append(c)
        torch.cuda.synchronize()
        _gmm_close(outs[0], want)
        assert torch.equal(outs[0], outs[1])
        assert not outs[0][1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("step", ["x", "w"])
def test_gmm_ragged_second_order_grads_match_ref_autograd(card, step):
    """An inner gradient step, on the inputs (MB-MPO's) or on the member
    weights, then the gradient of a loss at the stepped point w.r.t. both:
    through the kernels' Functions (every product a kernel, its output
    carrying no graph) against autograd of the plain route, at the
    assigned predictor's widths."""
    rng = np.random.default_rng(19)
    K, B, dims = 5, 1000, (30, 256, 256, 23)
    ws = [_randn(rng, (K, a, b), card).mul_(a ** -0.5).requires_grad_(True)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [_randn(rng, (K, b), card).requires_grad_(True) for b in dims[1:]]
    x = _randn(rng, (B, dims[0]), card).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, K - 1, B)).to(card)  # one empty
    target = _randn(rng, (B, dims[-1]), card)
    leaves = ws + bs + [x]

    def loss(ws_, x_, impl):
        out = gmm_ops.ensemble_mlp_select({"w": ws_, "b": bs}, x_, idx,
                                          impl=impl)
        return ((out - target) ** 2).mean()
    grads = {}
    for impl in ("cuda", "ref"):
        before = _ragged_counts()
        if step == "x":
            (g,) = torch.autograd.grad(loss(ws, x, impl), (x,),
                                       create_graph=True)
            outer = loss(ws, x - 0.05 * g, impl)
        else:
            g = torch.autograd.grad(loss(ws, x, impl), ws, create_graph=True)
            outer = loss([w - 0.05 * gw for w, gw in zip(ws, g)], x, impl)
        grads[impl] = torch.autograd.grad(outer, leaves)
        torch.cuda.synchronize()
        if impl == "cuda":
            fwd, bwd, dw = _ragged_delta(before)
            assert fwd == 2 * len(ws) and bwd > 0 and dw > 0
    for got, want in zip(grads["cuda"], grads["ref"]):
        _gmm_close(got, want)


@pytest.mark.gpu
def test_gmm_ragged_kernels_refuse_without_falling_back(card):
    """A wrong dtype, a non-contiguous operand, offsets on the CPU or of
    the wrong type raise; no plain product runs in the kernel's place and
    no launch is counted."""
    before = _ragged_counts()
    x = torch.zeros((8, 4), device=card)
    w = torch.zeros((2, 4, 6), device=card)
    dy = torch.zeros((8, 6), device=card)
    offs = torch.tensor([0, 3, 8], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="float32"):
        gmm_cuda.gmm_ragged(x.double(), w.double(), offs)
    with pytest.raises(ValueError, match="float32"):
        gmm_cuda.gmm_ragged_dw(x.half(), dy.half(), offs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_cuda.gmm_ragged(torch.zeros((4, 8), device=card).t(), w, offs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_cuda.gmm_ragged_dw(x, torch.zeros((6, 8), device=card).t(), offs)
    with pytest.raises(ValueError, match="dense"):
        gmm_cuda.gmm_ragged(x, torch.zeros((2, 4, 12), device=card)[..., ::2],
                            offs)
    for bad in (offs.cpu(), offs.long()):
        with pytest.raises(ValueError, match="offsets"):
            gmm_cuda.gmm_ragged(x, w, bad)
        with pytest.raises(ValueError, match="offsets"):
            gmm_cuda.gmm_ragged_dw(x, dy, bad)
    with pytest.raises(ValueError, match="float32"):
        gmm_ops.grouped_matmul(x.double(), w.double(),
                               torch.tensor([3, 5], device=card))
    assert _ragged_counts() == before
    lib = gmm_cuda._library()
    stream = torch.cuda.current_stream().cuda_stream
    for bm, bn, split in ((48, 64, 1), (64, 64, 9), (64, 64, 0)):
        assert lib.gmm_ragged_dw(x.data_ptr(), dy.data_ptr(), offs.data_ptr(),
                                 w.data_ptr(), 2, 8, 4, 6, bm, bn, split,
                                 stream) != 0
    assert lib.gmm_ragged(x.data_ptr(), w.data_ptr(), offs.data_ptr(),
                          dy.data_ptr(), 2, 8, 6, 4, 0, 24, 16, 64,
                          stream) != 0


@pytest.mark.gpu
def test_gmm_kernels_refuse_what_they_cannot_run(card):
    a = torch.zeros((2, 8, 4), device=card)
    with pytest.raises(ValueError, match="float32"):
        gmm_cuda.gmm_equal(a.double(), a.transpose(1, 2).double())
    with pytest.raises(ValueError, match="dense"):
        gmm_cuda.gmm_equal(a[:, ::2], torch.zeros((2, 4, 3), device=card))
    with pytest.raises(ValueError, match="offsets"):
        gmm_cuda.gmm_ragged(a[0], torch.zeros((3, 4, 5), device=card),
                            torch.tensor([0, 8], dtype=torch.int32,
                                         device=card))


# imag_fused vs the plain fused step, f32 both (no TF32): three MLP layers
# summed in another order and CUDA's tanhf/expf against torch's, relative to
# the outputs' scale
IMAG_TOL = 1e-4

IMAG_CASES = [
    # K, B, obs, act, hidden, policy hidden, policy depth, group sizes
    # (None: sampled). The trainer's policy is examples/pr2_arm.py's,
    # 23 -> 64 -> 64 -> 7; the edge shapes keep test_kernels_interpret.py's
    # one hidden layer.
    (5, 64, 23, 7, 256, 64, 2, None),     # the trainer's imagination step
    (5, 4096, 23, 7, 256, 64, 2, None),
    (1, 64, 23, 7, 256, 64, 2, None),     # MB-MPO's K=1 member slice
    (4, 64, 3, 1, 96, 48, 1, (10, 0, 54, 0)),     # empty groups
    (3, 48, 3, 1, 96, 48, 1, (0, 48, 0)),         # one group owns the batch
    (5, 37, 4, 2, 24, 12, 1, (5, 8, 0, 20, 4)),   # straddling, B not a tile
    (1, 20, 5, 2, 32, 16, 1, (20,)),              # K=1
    (3, 70, 6, 3, 300, 20, 1, None),      # a layer wider than a column pass
]


def _imag_inputs(rng, card, K, B, obs, act, hid, phid, pdepth, sizes):
    din = obs + act
    dims = [din, hid, hid, obs]
    members = {"w": [_randn(rng, (K, a, b), card) * a ** -0.5 * 2
                     for a, b in zip(dims[:-1], dims[1:])],
               "b": [_randn(rng, (K, b), card) * 0.2 for b in dims[1:]]}
    norm = {"mu_in": _randn(rng, (din,), card) * 0.2,
            "sig_in": _randn(rng, (din,), card).abs() + 0.5,
            "mu_out": _randn(rng, (obs,), card) * 0.1,
            "sig_out": _randn(rng, (obs,), card).abs() + 0.5}
    pdims = [obs] + [phid] * pdepth + [act]
    pol = {"w": [_randn(rng, (a, b), card)
                 for a, b in zip(pdims[:-1], pdims[1:])],
           "b": [_randn(rng, (b,), card) * 0.2 for b in pdims[1:]],
           "log_std": torch.full((act,), -0.5, device=card)}
    s, eps = _randn(rng, (B, obs), card) * 2, _randn(rng, (B, act), card) * 2
    if sizes is None:
        idx = rng.integers(0, K, B)
    else:
        idx = rng.permutation(np.repeat(np.arange(K), sizes))
    return members, norm, pol, s, eps, torch.from_numpy(idx).to(card)


@pytest.mark.gpu
@pytest.mark.parametrize("case", IMAG_CASES)
def test_imag_kernel_matches_ref(card, case):
    rng = np.random.default_rng(5)
    args = _imag_inputs(rng, card, *case)
    before = imag_ops.launches
    got = imag_ops.fused_step(*args)
    torch.cuda.synchronize()
    assert imag_ops.launches == before + 1
    for g, w in zip(got, imag_ops.fused_step(*args, impl="ref")):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        scale = max(1.0, w.abs().max().item())
        err = (g - w).abs().max().item()
        assert err <= IMAG_TOL * scale, (err, scale)


@pytest.mark.gpu
def test_imag_function_first_and_second_order_grads_match_ref(card):
    """MB-MPO's meta-gradient through the kernel's Function: the gradient
    of a loss at a policy adapted by one inner gradient step, against the
    same through the plain version's autograd."""
    rng = np.random.default_rng(6)
    members, norm, pol, s, eps, idx = _imag_inputs(rng, card,
                                                   *IMAG_CASES[0])
    n = len(pol["w"])

    def tree(leaves):
        return {"w": leaves[:n], "b": leaves[n:2 * n], "log_std": leaves[-1]}
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in pol["w"] + pol["b"] + [pol["log_std"]]]
        s2, a, pre = imag_ops.fused_step(members, norm, tree(leaves), s, eps,
                                         idx, impl=impl)
        inner = torch.autograd.grad((s2 ** 2).mean() + (a * pre).mean(),
                                    leaves, create_graph=True)
        adapted = [x - 0.05 * g for x, g in zip(leaves, inner)]
        s2, a, pre = imag_ops.fused_step(members, norm, tree(adapted), s,
                                         eps.flip(0), idx.flip(0), impl=impl)
        grads[impl] = (inner, torch.autograd.grad(
            (s2 ** 2).mean() + (pre ** 2).mean(), leaves))
    for order in (0, 1):
        for got, want in zip(grads["cuda"][order], grads["ref"][order]):
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            assert err <= IMAG_TOL * scale, (order, err, scale)


@pytest.mark.gpu
def test_imag_kernel_refuses_what_it_cannot_run(card):
    rng = np.random.default_rng(7)
    members, norm, pol, s, eps, idx = _imag_inputs(rng, card, 3, 16, 3, 1, 8,
                                                   8, 1, None)
    order, offs = imag_ops.sort_plan(idx, 3)
    with pytest.raises(ValueError, match="float32"):
        imag_cuda.fused_step_sorted(members, norm, pol, s.double(), eps, offs)
    with pytest.raises(ValueError, match="contiguous"):
        imag_cuda.fused_step_sorted(members, norm, pol, s.t().contiguous().t(),
                                    eps, offs)
    with pytest.raises(ValueError, match="int32"):
        imag_cuda.fused_step_sorted(members, norm, pol, s, eps, offs.long())
    with pytest.raises(ValueError, match="fit"):
        imag_cuda.fused_step_sorted(members, norm, pol, s[:, :2], eps, offs)


# ssd_chunked vs the plain scan, relative to the output's scale: f32 sums in
# another order; a bf16 output may round to the neighbouring bf16 value
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}

SSD_CASES = [
    # B, L, H, P, N, G, chunk, dtype (test_kernels_interpret.py's and
    # test_kernels.py's cases, L < chunk, and the Mamba2-2.7B prefill)
    (2, 256, 4, 32, 16, 1, 64, torch.float32),
    (1, 100, 8, 16, 32, 2, 32, torch.float32),   # L not a chunk multiple
    (2, 64, 4, 64, 64, 1, 64, torch.bfloat16),
    (1, 128, 2, 32, 8, 1, 128, torch.float32),
    (1, 20, 4, 16, 8, 1, 32, torch.float32),     # L < chunk
    (4, 1024, 80, 64, 128, 1, 128, torch.bfloat16),
    # the bf16 tensor-core route at the edges: G = 2 with L not a chunk
    # multiple, L < chunk, and P, N not multiples of 8 (element loads)
    (1, 100, 8, 16, 32, 2, 32, torch.bfloat16),
    (1, 20, 4, 16, 8, 1, 32, torch.bfloat16),
    (1, 50, 4, 20, 24, 1, 32, torch.bfloat16),
]


def _ssd_inputs(rng, card, B, L, H, P, N, G, dtype, dt_scale=1.0):
    x = (_randn(rng, (B, L, H, P), card)).to(dtype)
    dt = torch.nn.functional.softplus(_randn(rng, (B, L, H), card) * 2)
    A = -torch.exp(_randn(rng, (H,), card) * 0.6)
    Bm = (_randn(rng, (B, L, G, N), card) * 0.6).to(dtype)
    C = (_randn(rng, (B, L, G, N), card) * 0.6).to(dtype)
    return x, dt * dt_scale, A, Bm, C


def _ssd_close(got, want, dtype):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= SSD_TOL[dtype] * scale, \
        (err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_kernel_matches_ref(card, case, with_state):
    """The kernel against the plain scan, stateless and with a state in and
    out (dt scaled down so the carried state reaches y), each launch
    counted."""
    B, L, H, P, N, G, chunk, dtype = case
    rng = np.random.default_rng(9)
    x, dt, A, Bm, C = _ssd_inputs(rng, card, B, L, H, P, N, G, dtype,
                                  0.05 if with_state else 1.0)
    kw = {"chunk": chunk}
    if with_state:
        kw.update(initial_state=_randn(rng, (B, H, P, N), card),
                  return_final_state=True)
    before = ssd_ops.launches
    got = ssd_ops.ssd(x, dt, A, Bm, C, **kw)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    want = ssd_ref.ssd_chunked(x, dt, A, Bm, C, **kw)
    if not with_state:
        got, want = (got,), (want,)
    assert got[0].dtype == dtype and got[0].shape == x.shape
    for g, w in zip(got, want):
        _ssd_close(g, w, dtype)


@pytest.mark.gpu
def test_ssd_kernel_is_forward_only(card):
    rng = np.random.default_rng(10)
    x, dt, A, Bm, C = _ssd_inputs(rng, card, 1, 64, 4, 32, 16, 1,
                                  torch.float32)
    x.requires_grad_(True)
    y = ssd_ops.ssd(x, dt, A, Bm, C, chunk=32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        y.sum().backward()
    y = ssd_ops.ssd(x, dt, A, Bm, C, chunk=32, impl="ref")
    y.sum().backward()      # the plain version differentiates
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.gpu
def test_ssd_kernel_refuses_what_it_cannot_run(card):
    rng = np.random.default_rng(11)
    x, dt, A, Bm, C = _ssd_inputs(rng, card, 1, 64, 4, 32, 16, 1,
                                  torch.float32)
    with pytest.raises(ValueError, match="chunks"):
        ssd_cuda.ssd_chunked(x, dt, A, Bm, C, chunk=256)
    with pytest.raises(ValueError, match="head dims"):
        ssd_cuda.ssd_chunked(torch.zeros((1, 64, 4, 128), device=card), dt,
                             A, Bm, C, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda.ssd_chunked(x.transpose(1, 2).contiguous().transpose(1, 2),
                             dt, A, Bm, C, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ssd_cuda.ssd_chunked(x, dt.double(), A, Bm, C, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd_cuda.ssd_chunked(x, dt, A, Bm, C[:, :32], chunk=32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_repeats_bit_equal(card, dtype):
    """Each block owns one (batch, head) and sums in a fixed order: two runs
    on the same inputs give the same bits."""
    rng = np.random.default_rng(12)
    x, dt, A, Bm, C = _ssd_inputs(rng, card, 2, 300, 8, 64, 128, 1, dtype,
                                  0.05)
    s0 = _randn(rng, (2, 8, 64, 128), card)
    kw = dict(chunk=128, initial_state=s0, return_final_state=True)
    y1, f1 = ssd_cuda.ssd_chunked(x, dt, A, Bm, C, **kw)
    y2, f2 = ssd_cuda.ssd_chunked(x, dt, A, Bm, C, **kw)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(f1, f2)


@pytest.mark.gpu
def test_ssd_bf16_route_fits_two_blocks_an_sm(card):
    plan = ssd_cuda.plan(torch.bfloat16)
    assert plan["blocks_per_sm"] >= 2 and plan["smem"] <= 113 * 1024
    assert plan["registers"] <= 128 and plan["threads"] == 256
    assert ssd_cuda.plan(torch.float32)["blocks_per_sm"] >= 1


@pytest.mark.gpu
def test_ssd_bf16_kernel_refuses_what_it_cannot_run(card):
    rng = np.random.default_rng(13)
    x, dt, A, Bm, C = _ssd_inputs(rng, card, 1, 64, 4, 32, 16, 1,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="states up to"):
        ssd_cuda.ssd_chunked(x, dt, A, Bm.new_zeros((1, 64, 1, 256)),
                             C.new_zeros((1, 64, 1, 256)), chunk=32)
    with pytest.raises(ValueError, match="chunks"):
        ssd_cuda.ssd_chunked(x, dt, A, Bm, C, chunk=0)
    with pytest.raises(ValueError, match="bfloat16"):
        ssd_cuda.ssd_chunked(x, dt, A, Bm.float(), C, chunk=32)


def _imag_widths(members, pol):
    return (tuple([members["w"][0].shape[1]]
                  + [w.shape[2] for w in members["w"]]),
            tuple([pol["w"][0].shape[0]] + [w.shape[1] for w in pol["w"]]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", IMAG_CASES)
def test_imag_plan_shared_memory_is_the_kernels(card, case):
    """The planner computes the kernel's shared memory in Python; the
    kernel's own layout must give the same bytes."""
    rng = np.random.default_rng(14)
    members, norm, pol, s, eps, idx = _imag_inputs(rng, card, *case)
    dims, pdims = _imag_widths(members, pol)
    plan = imag_cuda.plan_step(case[1], case[0], dims, pdims)
    assert imag_cuda.kernel_smem_bytes(plan.rows, plan.cluster, dims,
                                       pdims) == plan.smem


@pytest.mark.gpu
@pytest.mark.parametrize("case", [IMAG_CASES[0], IMAG_CASES[1]])
def test_imag_kernel_repeats_bit_equal(card, case):
    rng = np.random.default_rng(15)
    members, norm, pol, s, eps, idx = _imag_inputs(rng, card, *case)
    order, offs = imag_ops.sort_plan(idx, case[0])
    ss, es = s[order].contiguous(), eps[order].contiguous()
    first = imag_cuda.fused_step_sorted(members, norm, pol, ss, es, offs)
    again = imag_cuda.fused_step_sorted(members, norm, pol, ss, es, offs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_imag_kernel_refuses_widths_no_cluster_fits(card):
    rng = np.random.default_rng(16)
    members, norm, pol, s, eps, idx = _imag_inputs(rng, card, 2, 16, 3, 1,
                                                   4096, 8, 1, None)
    order, offs = imag_ops.sort_plan(idx, 2)
    with pytest.raises(ValueError, match="shared memory"):
        imag_cuda.fused_step_sorted(members, norm, pol, s[order].contiguous(),
                                    eps[order].contiguous(), offs)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("K,B,one_cluster", [(5, 64, False), (2, 200, True)])
def test_imag_kernel_at_other_member_depths(card, monkeypatch, depth, K, B,
                                            one_cluster):
    """Member MLPs of one and two layers (the other cases have three), at
    the path's widths: one layer has no cluster barrier between layers.
    With one cluster a member (the planner's choice replaced), each
    cluster takes all of its member's tiles in turn."""
    rng = np.random.default_rng(17)
    members, norm, pol, s, eps, idx = _imag_inputs(rng, card, K, B, 23, 7,
                                                   256, 64, 2, None)
    dims = [30] + [256] * depth + [23]
    members = {"w": [_randn(rng, (K, a, b), card) * a ** -0.5 * 2
                     for a, b in zip(dims[:-1], dims[1:])],
               "b": [_randn(rng, (K, b), card) * 0.2 for b in dims[1:]]}
    if one_cluster:
        plan = imag_cuda.plan_step(B, K, tuple(dims), (23, 64, 64, 7))
        assert -(-B // K // plan.rows) > 1
        monkeypatch.setattr(imag_cuda, "plan_step", lambda *a: replace(
            plan, row_clusters=1, blocks=K * plan.cluster))
    got = imag_ops.fused_step(members, norm, pol, s, eps, idx)
    torch.cuda.synchronize()
    for g, w in zip(got, imag_ops.fused_step(members, norm, pol, s, eps, idx,
                                             impl="ref")):
        scale = max(1.0, w.abs().max().item())
        assert bool(torch.isfinite(g).all())
        assert (g - w).abs().max().item() <= IMAG_TOL * scale
