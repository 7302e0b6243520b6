"""The Mamba-2 SSD scan in the PyTorch port against the JAX reference.

The same numpy-seeded inputs go through the reference's oracle
(``repro.kernels.ssd.ref``), its Pallas kernel in interpret mode (as
``test_kernels_interpret.py`` runs it on the CPU) and the port's plain
version and dispatcher, in f32. The chunked scans are one function summed
in another order, so they agree to ``TOL`` (1e-5 of the output's scale);
the interpret-mode kernel and the token-by-token recurrence, which sums
each step's state in another order again, to ``INTERPRET_TOL`` and
``SEQ_TOL``. The hand-written CUDA kernel runs only on a card: its tests
are in ``test_torch_kernels_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jssd_ops
from repro.kernels.ssd import ref as jssd_ref
from repro_torch.kernels.ssd import cuda as ssd_cuda
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ref as ssd_ref

TOL = 1e-5
INTERPRET_TOL = 1e-4
SEQ_TOL = 1e-4

CASES = [
    # B, L, H, P, N, G, chunk (test_kernels_interpret.py, test_kernels.py)
    (2, 256, 4, 32, 16, 1, 64),
    (1, 100, 8, 16, 32, 2, 32),           # L not a chunk multiple, G = 2
    (2, 64, 4, 64, 64, 1, 64),
    (1, 128, 2, 32, 8, 1, 128),
    (1, 20, 4, 16, 8, 1, 32),             # L < chunk
]


def _inputs(case, seed=0):
    B, L, H, P, N, G, _ = case
    rng = np.random.default_rng(seed)

    def rnd(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x = rnd((B, L, H, P), 0.5)
    dt = np.log1p(np.exp(rnd((B, L, H)))).astype(np.float32)   # softplus
    A = (-np.exp(rnd((H,), 0.3))).astype(np.float32)
    Bm, C = rnd((B, L, G, N), 0.3), rnd((B, L, G, N), 0.3)
    return x, dt, A, Bm, C


def _state(case, seed=1):
    B, _, H, P, N, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=msg)


@pytest.mark.parametrize("case", CASES)
def test_ref_matches_jax_oracle(case):
    chunk = case[-1]
    arrays = _inputs(case)
    got = ssd_ref.ssd_chunked(*_t(arrays), chunk=chunk)
    want = jssd_ref.ssd_chunked(*_j(arrays), chunk=chunk)
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, TOL)


@pytest.mark.parametrize("case", CASES)
def test_ref_matches_pallas_interpret(case):
    chunk = case[-1]
    arrays = _inputs(case, seed=2)
    got = ssd_ops.ssd(*_t(arrays), chunk=chunk)
    want = jssd_ops.ssd(*_j(arrays), chunk=chunk, impl="pallas",
                        interpret=True)
    _close(got, want, INTERPRET_TOL)


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_state_in_and_out_match_jax_oracle(case):
    chunk = case[-1]
    arrays = _inputs(case, seed=3)
    s0 = _state(case)
    y, s = ssd_ref.ssd_chunked(*_t(arrays), chunk=chunk,
                               initial_state=torch.from_numpy(s0),
                               return_final_state=True)
    jy, js = jssd_ref.ssd_chunked(*_j(arrays), chunk=chunk,
                                  initial_state=jnp.asarray(s0),
                                  return_final_state=True)
    _close(y, jy, TOL, "y")
    _close(s, js, TOL, "final state")


def test_decode_steps_continue_the_chunked_state():
    """Prefill L0 steps with the chunked scan, then step the recurrence over
    the tail: the outputs and final state equal one chunked scan over
    all L steps."""
    case = CASES[1]
    chunk, L0 = case[-1], 70
    x, dt, A, Bm, C = _t(_inputs(case, seed=4))
    y_all, s_all = ssd_ref.ssd_chunked(x, dt, A, Bm, C, chunk=chunk,
                                       return_final_state=True)
    _, s = ssd_ref.ssd_chunked(x[:, :L0], dt[:, :L0], A, Bm[:, :L0],
                               C[:, :L0], chunk=chunk,
                               return_final_state=True)
    for t in range(L0, x.shape[1]):
        y_t, s = ssd_ops.ssd_decode_step(s, x[:, t], dt[:, t], A, Bm[:, t],
                                         C[:, t])
        _close(y_t, y_all[:, t].numpy(), SEQ_TOL, f"step {t}")
    _close(s, s_all.numpy(), SEQ_TOL, "final state")


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_sequential_matches_jax_and_the_chunked_scan(case):
    arrays = _inputs(case, seed=5)
    s0 = _state(case, seed=6)
    y, s = ssd_ops.ssd_sequential(*_t(arrays),
                                  initial_state=torch.from_numpy(s0),
                                  return_final_state=True)
    jy, js = jssd_ref.ssd_sequential(*_j(arrays),
                                     initial_state=jnp.asarray(s0),
                                     return_final_state=True)
    _close(y, jy, TOL, "y")
    _close(s, js, TOL, "final state")
    yc, sc = ssd_ref.ssd_chunked(*_t(arrays), chunk=case[-1],
                                 initial_state=torch.from_numpy(s0),
                                 return_final_state=True)
    _close(yc, y.numpy(), SEQ_TOL, "chunked vs sequential y")
    _close(sc, s.numpy(), SEQ_TOL, "chunked vs sequential state")


def test_gradient_through_the_cpu_route_matches_jax_grad():
    case = CASES[1]
    chunk = case[-1]
    arrays = _inputs(case, seed=7)
    s0 = _state(case, seed=8)
    rng = np.random.default_rng(9)
    wy = rng.standard_normal(arrays[0].shape).astype(np.float32)
    ws = rng.standard_normal(s0.shape).astype(np.float32)

    def jloss(x, dt, A, Bm, C, s0):
        y, s = jssd_ref.ssd_chunked(x, dt, A, Bm, C, chunk=chunk,
                                    initial_state=s0,
                                    return_final_state=True)
        return (y * wy).sum() + (s * ws).sum()
    want = jax.grad(jloss, argnums=tuple(range(6)))(*_j(arrays + (s0,)))
    leaves = [t.requires_grad_(True) for t in _t(arrays + (s0,))]
    y, s = ssd_ops.ssd(*leaves[:5], chunk=chunk, initial_state=leaves[5],
                       return_final_state=True)
    ((y * torch.from_numpy(wy)).sum()
     + (s * torch.from_numpy(ws)).sum()).backward()
    for name, t, w in zip(("x", "dt", "A", "B", "C", "s0"), leaves, want):
        _close(t.grad, w, 1e-4, name)


def test_dispatch_keeps_cpu_tensors_off_the_kernel():
    x, dt, A, Bm, C = _t(_inputs(CASES[4]))
    before = ssd_ops.launches
    y = ssd_ops.ssd(x, dt, A, Bm, C, chunk=32)
    assert ssd_ops.launches == before
    torch.testing.assert_close(y, ssd_ref.ssd_chunked(x, dt, A, Bm, C,
                                                      chunk=32),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssd_ops.ssd(x, dt, A, Bm, C, chunk=32, impl="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        ssd_cuda.ssd_chunked(x, dt, A, Bm, C, chunk=32)
    with pytest.raises(ValueError, match="unknown"):
        ssd_ops.ssd(x, dt, A, Bm, C, chunk=32, impl="pallas")
    assert ssd_ops.launches == before


def test_kernel_route_counts_launches_and_refuses_a_backward(monkeypatch):
    """The kernel's wiring with the plain version injected for the kernel:
    one launch counted per scan, the state carried through, and a gradient
    request raises with a pointer to the roadmap instead of falling back."""
    monkeypatch.setattr(ssd_ops.cuda, "ssd_chunked", ssd_ref.ssd_chunked)
    monkeypatch.setattr(ssd_ops, "launches", 0)
    case = CASES[1]
    x, dt, A, Bm, C = _t(_inputs(case))
    s0 = torch.from_numpy(_state(case))
    y, s = ssd_ops.ssd(x, dt, A, Bm, C, chunk=32, initial_state=s0,
                       return_final_state=True, impl="cuda")
    assert ssd_ops.launches == 1
    wy, ws = ssd_ref.ssd_chunked(x, dt, A, Bm, C, chunk=32, initial_state=s0,
                                 return_final_state=True)
    torch.testing.assert_close(y, wy, rtol=0, atol=0)
    torch.testing.assert_close(s, ws, rtol=0, atol=0)
    x.requires_grad_(True)
    y = ssd_ops.ssd(x, dt, A, Bm, C, chunk=32, impl="cuda")
    assert ssd_ops.launches == 2
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        y.sum().backward()


# The bf16 route of the kernel (csrc/ssd.cu, ssd_chunked_bf16) rounds the f32
# operands of its tensor-core products to bf16 at four points and keeps
# everything else in f32. This CPU model repeats those points with f32 sums
# and is held against the JAX oracle within chip_smoke.py's SSD_TOL[bf16],
# 1.6e-2 of the output's scale, the tolerance the card holds the kernel to.
# Observed on these inputs (f32 CPU sums): 3.3e-3 to 3.7e-3 of scale for y,
# 2.5e-4 to 2.7e-3 for the final state.
SSD_BF16_TOL = 1.6e-2
BF16_CASES = [
    # B, L, H, P, N, G, chunk, dt scale, with a state in and out
    (2, 256, 4, 64, 128, 1, 128, 1.0, False),   # Mamba2-2.7B's P, N, chunk
    (1, 300, 4, 64, 128, 2, 128, 0.05, True),   # L not a chunk multiple
    (2, 64, 4, 64, 64, 1, 64, 1.0, True),
]


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _bf16_route_model(x, dt, A, Bm, C, chunk, s0):
    """The kernel's bf16 arithmetic: x, B, C enter exact (bf16 values); the
    masked, decayed C·Bᵀ block with dt folded in, the decay-weighted x of
    the state update and the state's copy for C·stateᵀ are rounded to bf16;
    prefix sums, exponentials, the state and every sum stay f32; y is
    rounded to bf16 once."""
    Bsz, L, H, P = x.shape
    rep = H // Bm.shape[2]
    S = s0.clone()
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        xc, dtc = x[:, sl], dt[:, sl]                         # (B,Q,H,P)
        Bc = Bm[:, sl].repeat_interleave(rep, 2)             # (B,Q,H,N)
        Cc = C[:, sl].repeat_interleave(rep, 2)
        cum = torch.cumsum(dtc * A, 1)                       # (B,Q,H)
        Q = cum.shape[1]
        cb = torch.einsum("bihn,bjhn->bhij", Cc, Bc)
        cum_h = cum.permute(0, 2, 1)                         # (B,H,Q)
        mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
        diff = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill(
            ~mask, float("-inf"))
        M = _bf16(cb * torch.exp(diff) * dtc.permute(0, 2, 1)[:, :, None, :])
        y_diag = torch.einsum("bhij,bjhp->bihp", M, xc)
        y_off = (torch.einsum("bihn,bhpn->bihp", Cc, _bf16(S))
                 * torch.exp(cum)[..., None])
        ys.append(_bf16(y_diag + y_off))
        w = dtc * torch.exp(cum[:, -1:] - cum)               # (B,Q,H)
        S = (S * torch.exp(cum[:, -1])[..., None, None]
             + torch.einsum("bjhp,bjhn->bhpn", _bf16(xc * w[..., None]), Bc))
    return torch.cat(ys, 1), S


def _scaled_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_route_model_matches_jax_oracle(case):
    *shape, chunk, dt_scale, with_state = case
    x, dt, A, Bm, C = _inputs((*shape, chunk), seed=11)
    dt = dt * np.float32(dt_scale)
    # the kernel's operands are bf16: both sides see the same values
    x, Bm, C = (_bf16(torch.from_numpy(a)).numpy() for a in (x, Bm, C))
    s0 = (_state((*shape, chunk), seed=12) if with_state
          else np.zeros((shape[0], shape[2], shape[3], shape[4]),
                        np.float32))
    y, s = _bf16_route_model(*_t((x, dt, A, Bm, C)), chunk,
                             torch.from_numpy(s0))
    jy, js = jssd_ref.ssd_chunked(*_j((x, dt, A, Bm, C)), chunk=chunk,
                                  initial_state=jnp.asarray(s0),
                                  return_final_state=True)
    err_y, err_s = _scaled_err(y, jy), _scaled_err(s, js)
    assert err_y <= SSD_BF16_TOL and err_s <= SSD_BF16_TOL, (err_y, err_s)
    # the model does round: the f32 scan of the same inputs differs from it
    fy = ssd_ref.ssd_chunked(*_t((x, dt, A, Bm, C)), chunk=chunk,
                             initial_state=torch.from_numpy(s0))
    assert _scaled_err(y, fy.numpy()) > 1e-4
