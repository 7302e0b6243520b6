"""Plain PyTorch Mamba-2 SSD (state-space duality) scan: the port of
``repro/kernels/ssd/ref.py``.

The chunked algorithm of arXiv:2405.21060 (ssd_minimal): a quadratic,
attention-like product inside fixed-size chunks plus a linear recurrence
over the chunks' states. Shapes follow the paper::

  x : (B, L, H, P)   inputs per head (P = head dim)
  dt: (B, L, H)      softplus-discretised step sizes (already positive)
  A : (H,)           negative scalar decay per head
  B_: (B, L, G, N)   input projection (G groups broadcast over H)
  C : (B, L, G, N)   output projection
  returns y: (B, L, H, P) and, on request, the final states (B, H, P, N)

Everything is computed in f32 and is differentiable. The inter-chunk
recurrence is a Python loop where the reference scans. This is the
kernel's plain version: the CPU runs it, the tests hold it against the JAX
oracle, and ``chip_smoke.py`` holds the kernel against it on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] (i>=j),
    -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B_, C, *, chunk: int = 128, initial_state=None,
                return_final_state: bool = False):
    B, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    assert H % G == 0
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = x.shape[1]
    nc = Lp // chunk
    f32 = torch.float32
    dtf = dt.to(f32)
    xs = (x.to(f32) * dtf[..., None]).reshape(B, nc, chunk, H, P)
    dA = (dtf * A.to(f32)).reshape(B, nc, chunk, H)
    rep = H // G
    Bh = B_.to(f32).reshape(B, nc, chunk, G, N).repeat_interleave(rep, 3)
    Ch = C.to(f32).reshape(B, nc, chunk, G, N).repeat_interleave(rep, 3)

    dA_cum = torch.cumsum(dA, dim=2)                        # (B, nc, Q, H)
    # 1. intra-chunk (diagonal blocks)
    Ltri = torch.exp(segsum(dA.movedim(2, -1)))             # (B, nc, H, Q, Q)
    CB = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", CB * Ltri, xs)
    # 2. per-chunk final states
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B, nc, Q, H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          Bh * decay_states[..., None], xs)
    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])            # (B, nc, H)
    s = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    states_prev = []
    for c in range(nc):
        states_prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    states_prev = torch.stack(states_prev, 1)               # (B, nc, H, P, N)
    # 4. inter-chunk output
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch, states_prev) \
        * torch.exp(dA_cum)[..., None]
    y = (y_diag + y_off).reshape(B, Lp, H, P)[:, :L].to(x.dtype)
    if return_final_state:
        return y, s
    return y


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """Single-token recurrent update.

    state: (B, H, P, N); x_t: (B, H, P); dt_t: (B, H); B_t/C_t: (B, G, N).
    Returns (y_t, new_state)."""
    H = state.shape[1]
    rep = H // B_t.shape[1]
    f32 = torch.float32
    dtf = dt_t.to(f32)
    dA = torch.exp(dtf * A.to(f32))                           # (B, H)
    Bh = B_t.to(f32).repeat_interleave(rep, 1)                # (B, H, N)
    Ch = C_t.to(f32).repeat_interleave(rep, 1)
    dBx = torch.einsum("bh,bhp,bhn->bhpn", dtf, x_t.to(f32), Bh)
    new_state = state.to(f32) * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x_t.dtype), new_state


def ssd_sequential(x, dt, A, B_, C, *, initial_state=None,
                   return_final_state: bool = False):
    """Token-by-token oracle (slow; ground truth for tests)."""
    B, L, H, P = x.shape
    N = B_.shape[-1]
    s = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(L):
        y, s = ssd_decode_step(s, x[:, t], dt[:, t], A, B_[:, t], C[:, t])
        ys.append(y)
    y = torch.stack(ys, 1)
    if return_final_state:
        return y, s
    return y
