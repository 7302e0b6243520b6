"""Mixture-of-Experts FFN: the one-card part of ``repro/models/moe.py``.

Two dispatches, as the reference picks them on one device
(``moe_forward``):

* DROPLESS (``moe_forward_dropless``), on CUDA tensors: every (token,
  choice) pair is a row, rows sorted by expert, each expert FFN one ragged
  ``grouped_matmul`` over exactly its rows, through the ``gmm_ragged``
  kernel (bf16 in the LM). This is the reference's path on its
  accelerator; no capacity buffer, no dropped token.
* CAPACITY buffers (the reference's ``ep`` strategy with one shard), on
  CPU tensors, as the reference runs off-TPU: its ragged product there is
  the plain gather, which materialises per-row expert weights.

The two agree whenever nothing overflows a buffer, as at the REDUCED
configs' ``capacity_factor=8.0``, and so do their gradients (the router's
and the load-balance loss's too: the routed counts carry none). In bf16
they round differently: the dropless path rounds each expert's output to
bf16 before the combine, the capacity path keeps it in f32. Neither gives
way to the other: a CUDA tensor the kernel refuses raises.

Training keeps the same split. The train step names ``gmm_impl="ref"``: on
the card the dropless dispatch then runs its products through
``gmm/ref.grouped_matmul_looped``, a loop over the experts whose autograd
writes each operand's gradient once (the gather of ``ref.grouped_matmul``
would hold (rows, d, f) weights: 17.7 GB at Moonlight's prefill); on the
CPU the capacity buffers' batched products, as the reference trains
off-TPU. The bf16 kernel route has no backward, as the reference's has
none.

Not ported yet (the LM's multi-card sharding, ROADMAP.md §1 item 10):
``moe_forward_ws``, the ``tp`` strategy, ``_fsdp_gather`` and
``spec_moe``.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.gmm import ops as gmm_ops
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, dot_f32, dtype_of, rmsnorm


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = math.ceil(cfg.top_k * tokens / cfg.num_experts * cfg.capacity_factor)
    return max(8, math.ceil(c / 8) * 8)


def _expert_ff(cfg: ModelConfig) -> int:
    return cfg.d_ff  # per-expert hidden size (already per-expert in configs)


def _route(cfg: ModelConfig, router, h):
    """Router logits -> (full probs (T, E), normalised combine weights
    (T, k), expert choices (T, k)): the router cast to ``h.dtype``, its
    product summed in f32, softmax and top-k in f32."""
    logits = dot_f32(h, router.to(h.dtype))
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return probs, w, idx


def init_moe(cfg: ModelConfig, generator, device) -> Dict[str, Any]:
    """Random weights drawn by ``generator``, in the reference's tree: the
    router in f32, the experts' (E, d, f) / (E, f, d) in ``cfg.dtype``."""
    d, f, e = cfg.d_model, _expert_ff(cfg), cfg.num_experts
    dt = dtype_of(cfg)
    return {
        "ln": torch.ones((d,), dtype=dt, device=device),
        "router": _dense_init(generator, (d, e), d, torch.float32, device),
        "we1": _dense_init(generator, (e, d, f), d, dt, device),
        "we3": _dense_init(generator, (e, d, f), d, dt, device),
        "we2": _dense_init(generator, (e, f, d), f, dt, device),
    }


def _dispatch(cfg: ModelConfig, xt, idx, cap: int):
    """Scatter tokens into per-expert capacity buffers.

    xt: (T, d); idx: (T, k) expert choices. Returns (buf (E, cap + 1, d),
    whose slot ``cap`` is the overflow bin, slots (T, k), counts (E,))."""
    T, d = xt.shape
    E, k = cfg.num_experts, cfg.top_k
    buf = xt.new_zeros((E, cap + 1, d))
    counts = torch.zeros((E,), dtype=torch.int32, device=xt.device)
    eye = torch.arange(E, device=xt.device)
    slots = []
    for j in range(k):
        ej = idx[:, j]
        oh = (ej[:, None] == eye[None, :]).to(torch.int32)       # (T, E)
        within = (torch.cumsum(oh, 0) * oh).sum(-1) - 1           # (T,)
        pos = counts[ej] + within
        counts = counts + oh.sum(0, dtype=torch.int32)
        slot = torch.where(pos < cap, pos, torch.full_like(pos, cap))
        buf[ej, slot] = xt
        slots.append(slot)
    return buf, torch.stack(slots, 1), counts


def _aux_loss(cfg: ModelConfig, counts, probs, rows: int):
    """The Switch load-balance loss: E * sum(routed fraction * mean prob)."""
    frac = counts.to(torch.float32) / max(rows, 1)
    return cfg.num_experts * torch.sum(frac * probs.mean(0))


def _bmm_f32(a, b):
    """Batched a @ b summed in f32, f32 out (the reference's einsum with
    ``preferred_element_type=f32``); bf16 operands widen exactly."""
    return torch.bmm(a.float(), b.float())


def moe_forward_capacity(cfg: ModelConfig, p, x):
    """The capacity-buffer dispatch at one shard: tokens scattered into
    ``capacity(cfg, T)`` slots an expert (overflow dropped), the experts'
    products batched, the weighted combine in f32 then ``x.dtype``.
    Returns ``(x + moe(x), aux)``."""
    B, S, d = x.shape
    T = B * S
    h = rmsnorm(x, p["ln"]).reshape(T, d)
    k = cfg.top_k
    probs, w, idx = _route(cfg, p["router"], h)
    cap = capacity(cfg, T)
    buf, slots, counts = _dispatch(cfg, h, idx, cap)
    a = _bmm_f32(buf, p["we1"])
    g = _bmm_f32(buf, p["we3"])
    hh = (F.silu(a) * g).to(x.dtype)
    out_full = _bmm_f32(hh, p["we2"])                         # (E, cap+1, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(k):
        yj = out_full[idx[:, j], slots[:, j]]                     # (T, d)
        keep = (slots[:, j] < cap).to(torch.float32)
        y = y + w[:, j, None] * keep[:, None] * yj
    return (x + y.to(x.dtype).reshape(B, S, d),
            _aux_loss(cfg, counts, probs, T * k))


def moe_forward_dropless(cfg: ModelConfig, p, x, *,
                         gmm_impl: str | None = None):
    """Dropless MoE on the ragged grouped matmul: the (token, choice) pairs
    sorted by expert (stably), the group sizes counted on the device (no
    host sync), three ragged products, SiLU·gate in f32 then ``x.dtype``,
    the unsort and the weighted combine in f32. ``gmm_impl`` is
    ``gmm_ops.grouped_matmul``'s ``impl``: None runs the kernel on CUDA
    tensors, ``"ref"`` the plain product, for the on-card comparison.
    Returns ``(x + moe(x), aux)``."""
    B, S, d = x.shape
    T = B * S
    h = rmsnorm(x, p["ln"]).reshape(T, d)
    E, k = cfg.num_experts, cfg.top_k
    probs, w, idx = _route(cfg, p["router"], h)                  # (T, k)

    eflat = idx.reshape(-1)                                      # (T*k,)
    order = torch.argsort(eflat, stable=True)
    rows = h[order // k]                   # token row of each sorted pair
    counts = gmm_ref.group_sizes_of(eflat, E)

    def gmm(lhs, rhs):
        return gmm_ops.grouped_matmul(lhs, rhs, counts, impl=gmm_impl)
    a = gmm(rows, p["we1"])
    g = gmm(rows, p["we3"])
    hh = (F.silu(a.float()) * g.float()).to(x.dtype)
    out = gmm(hh, p["we2"])                                      # (T*k, d)

    y = torch.empty_like(out)
    y[order] = out
    y = (w[..., None] * y.reshape(T, k, d).float()).sum(1)
    return (x + y.reshape(B, S, d).to(x.dtype),
            _aux_loss(cfg, counts, probs, T * k))


def moe_forward(cfg: ModelConfig, p, x, *, gmm_impl: str | None = None):
    """x: (B, S, d) -> ``(x + moe(x), aux)``: the dropless dispatch on CUDA
    tensors (``gmm_impl`` as there), the capacity buffers on CPU ones, as
    the reference picks them on one device."""
    if x.is_cuda:
        return moe_forward_dropless(cfg, p, x, gmm_impl=gmm_impl)
    return moe_forward_capacity(cfg, p, x)
