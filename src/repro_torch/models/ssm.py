"""Mamba-2 (SSD) block: the port of ``repro/models/ssm.py`` on one card.

The reference shards heads over a tensor-parallel axis; the port runs at
tp = 1, so its collectives (``psum_tp``, ``reduce_tp``) are identities and
every head is local (``H_loc = ssm_heads``). The gated RMSNorm normalises
over the whole d_inner, as the reference's does after its scalar psum.

The full-sequence scan goes through ``kernels.ssd.ops.ssd``, which
launches the Hopper kernel on CUDA tensors, with or without the state.
Single-token decode runs the plain recurrence (``ssd_decode_step``), as in
the reference, which has no kernel for it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, dtype_of, matmul

# conv channels = [x (d_inner)] + [B, C (2*G*N)]


def init_mamba(cfg: ModelConfig, generator, device) -> Dict[str, Any]:
    """Random weights drawn by ``generator`` (N(0, 1/fan_in) matrices), and
    the reference's constants: A = -exp(0) = -1, D = 1, zero biases. The
    tree has the reference's keys and shapes."""
    d, di = cfg.d_model, cfg.d_inner
    H, G, N, w = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    dt = dtype_of(cfg)

    def dense(shape, fan_in):
        return _dense_init(generator, shape, fan_in, dt, device)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)
    return {
        "ln": full((d,), 1.0),
        "wz": dense((d, di), d),
        "wx": dense((d, di), d),
        "wbc": dense((d, 2 * G * N), d),
        "wdt": dense((d, H), d),
        "conv_x": dense((w, di), w),
        "conv_bc": dense((w, 2 * G * N), w),
        "conv_bx": full((di,), 0.0),
        "conv_bbc": full((2 * G * N,), 0.0),
        "A_log": full((H,), 0.0, torch.float32),
        "D": full((H,), 1.0, torch.float32),
        "dt_bias": full((H,), 0.0, torch.float32),
        "gn": full((di,), 1.0),
        "wo": dense((di, d), di),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C); w: (W, C); b: (C,)."""
    W = w.shape[0]
    xf = x.float()
    y = xf * w[-1].float()
    for i in range(W - 1):
        shift = W - 1 - i
        y = y + F.pad(xf, (0, 0, shift, 0))[:, :-shift] * w[i].float()
    return (y + b.float()).to(x.dtype)


def _gated_norm(y, z, w, di_global: int, eps: float = 1e-5):
    yf = y.float() * F.silu(z.float())
    ss = (yf * yf).sum(-1) / di_global
    return (yf * torch.rsqrt(ss + eps)[..., None] * w.float()).to(y.dtype)


def _project(cfg, p, h):
    z = matmul(h, p["wz"])
    xin = matmul(h, p["wx"])
    bc = matmul(h, p["wbc"])
    dt = matmul(h, p["wdt"]).float()
    return z, xin, bc, dt


def mamba_forward(cfg: ModelConfig, p, x, *, return_state: bool = False,
                  initial_state=None, ssd_impl: str | None = None):
    """x: (B, S, d). With ``return_state`` also returns ``(ssm_state,
    tail_x, tail_bc)``: the scan's final state and the pre-conv tails that
    become the decode-time conv state. ``ssd_impl`` is passed to
    ``ops.ssd`` (None: the kernel on CUDA tensors)."""
    B, S, d = x.shape
    G, N, Pd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    H = cfg.ssm_heads
    hn = _rms(x, p["ln"])
    z, xin, bc, dt = _project(cfg, p, hn)
    W = cfg.ssm_conv - 1
    pad_s = max(W - S, 0)
    tail_x = F.pad(xin, (0, 0, pad_s, 0))[:, -W:]
    tail_bc = F.pad(bc, (0, 0, pad_s, 0))[:, -W:]
    xin = F.silu(_causal_conv(xin, p["conv_x"], p["conv_bx"]).float()
                 ).to(x.dtype)
    bc = F.silu(_causal_conv(bc, p["conv_bc"], p["conv_bbc"]).float()
                ).to(x.dtype)
    B_ = bc[..., :G * N].reshape(B, S, G, N)
    C_ = bc[..., G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, H, Pd)
    res = ssd_ops.ssd(xh, dt, A, B_, C_, chunk=cfg.ssm_chunk,
                      initial_state=initial_state,
                      return_final_state=return_state, impl=ssd_impl)
    y, final_state = res if return_state else (res, None)
    y = (y.float() + p["D"].float()[None, None, :, None] * xh.float()
         ).to(x.dtype)
    y = _gated_norm(y.reshape(B, S, -1), z, p["gn"], cfg.d_inner)
    out = x + matmul(y, p["wo"])
    if return_state:
        return out, (final_state, tail_x, tail_bc)
    return out


def mamba_decode(cfg: ModelConfig, p, x, ssm_state, conv_x_state,
                 conv_bc_state):
    """x: (B, 1, d); ssm_state: (B, H, P, N); conv_x_state: (B, W-1, di);
    conv_bc_state: (B, W-1, 2GN). Returns ``(out, ssm_state', conv_x',
    conv_bc')`` as new tensors."""
    B = x.shape[0]
    G, N, Pd = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    H = cfg.ssm_heads
    hn = _rms(x, p["ln"])
    z, xin, bc, dt = _project(cfg, p, hn)
    win_x = torch.cat([conv_x_state, xin], dim=1)        # (B, W, di)
    win_bc = torch.cat([conv_bc_state, bc], dim=1)       # (B, W, 2GN)
    new_conv_x, new_conv_bc = win_x[:, 1:], win_bc[:, 1:]
    cx = (win_x.float() * p["conv_x"].float()).sum(1) + p["conv_bx"].float()
    cbc = (win_bc.float() * p["conv_bc"].float()).sum(1) \
        + p["conv_bbc"].float()
    xin1 = F.silu(cx).to(x.dtype)                        # (B, di)
    bc1 = F.silu(cbc).to(x.dtype)                        # (B, 2GN)
    B_t = bc1[:, :G * N].reshape(B, G, N)
    C_t = bc1[:, G * N:].reshape(B, G, N)
    dt1 = F.softplus(dt[:, 0] + p["dt_bias"])            # (B, H)
    A = -torch.exp(p["A_log"])
    xh1 = xin1.reshape(B, H, Pd)
    y, new_ssm = ssd_ops.ssd_decode_step(ssm_state, xh1, dt1, A, B_t, C_t)
    y = (y.float() + p["D"].float()[None, :, None] * xh1.float()
         ).to(x.dtype)
    y = _gated_norm(y.reshape(B, 1, -1), z, p["gn"], cfg.d_inner)
    out = matmul(y, p["wo"])
    return x + out, new_ssm, new_conv_x, new_conv_bc


def _rms(x, w, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
