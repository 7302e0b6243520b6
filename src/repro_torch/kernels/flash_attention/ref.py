"""Plain PyTorch attention: the oracle of the flash-attention kernel.

Port of ``repro/kernels/flash_attention/ref.py`` (``naive_attention`` and
``chunked_attention``) with the same contract: q ``(B, Sq, Hq, D)``, k/v
``(B, Sk, Hkv, D)``, GQA with q head ``h`` reading kv head ``h // G``,
causal masking aligned at the ends (query ``i`` sits at position
``i + Sk - Sq``), an optional sliding window, softmax in f32 and the output
in ``q.dtype``. ``naive`` materialises the whole score matrix;
``chunked`` runs the online softmax over kv blocks, as the kernel does.
``masked_decode`` is the single-token decode attention of the lock-step and
slot caches; ``decode_attention_partial`` and ``combine_partials`` are the
reference's decode over a slice of a KV cache and the logsumexp merge of
such slices. They have no kernel there or here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _mask(q_idx, k_idx, causal: bool, window: int):
    """True where attention is allowed."""
    m = torch.ones((q_idx.shape[0], k_idx.shape[0]), dtype=torch.bool,
                   device=q_idx.device)
    if causal:
        m &= k_idx[None, :] <= q_idx[:, None]
    if window and window > 0:
        m &= k_idx[None, :] > (q_idx[:, None] - window)
    return m


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D). Returns (B, Sq, Hq, D)."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    dev = q.device
    q_idx = torch.arange(Sq, device=dev) + (Sk - Sq)
    m = _mask(q_idx, torch.arange(Sk, device=dev), causal, window)
    s = torch.where(m, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      scale: float | None = None, block_q: int = 512,
                      block_k: int = 512):
    """Online-softmax attention; same contract as :func:`naive_attention`."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    pq = (-Sq) % block_q
    pk = (-Sk) % block_k
    qf = F.pad(q.float(), (0, 0, 0, 0, 0, pq))
    kf = F.pad(k.float(), (0, 0, 0, 0, 0, pk))
    vf = F.pad(v.float(), (0, 0, 0, 0, 0, pk))
    nq, nk = qf.shape[1] // block_q, kf.shape[1] // block_k
    qf = qf.reshape(B, nq, block_q, Hkv, G, D)
    kb = kf.reshape(B, nk, block_k, Hkv, D)
    vb = vf.reshape(B, nk, block_k, Hkv, D)
    offset = Sk - Sq  # query i has absolute position i + offset
    dev = q.device
    outs = []
    for qi in range(nq):
        q_idx = qi * block_q + torch.arange(block_q, device=dev) + offset
        m_run = torch.full((B, Hkv, G, block_q), NEG_INF, device=dev)
        d_run = torch.zeros((B, Hkv, G, block_q), device=dev)
        o_run = torch.zeros((B, Hkv, G, block_q, D), device=dev)
        for ki in range(nk):
            k_idx = ki * block_k + torch.arange(block_k, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, qi], kb[:, ki]) * scale
            mask = _mask(q_idx, k_idx, causal, window) & (k_idx[None, :] < Sk)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            d_run = d_run * alpha + p.sum(-1)
            o_run = o_run * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vb[:, ki])
            m_run = m_new
        o = o_run / torch.clamp(d_run[..., None], min=1e-30)
        outs.append(torch.einsum("bhgqd->bqhgd", o))
    out = torch.stack(outs, 1).reshape(B, nq * block_q, Hq, D)
    return out[:, :Sq].to(q.dtype)


def masked_decode(q, k_cache, v_cache, valid, *, scale: float | None = None):
    """Single-token decode attention under a mask of the cache's slots.

    q: (B, Hq, D); k_cache/v_cache: (B, S, Hkv, D); valid: (S,) bool shared
    by the batch (lock-step decode) or (B, S) per row (slot decode).
    Returns ``(o, lse)``: ``o`` (B, Hq, D) normalised over the valid slots
    and ``lse`` (B, Hq) their log-sum-exp, both f32."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * scale
    mask = valid[None, None, None] if valid.dim() == 1 \
        else valid[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    d = p.sum(-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    lse = m + torch.log(torch.clamp(d, min=1e-30))
    o = o / torch.clamp(d[..., None], min=1e-30)
    return o.reshape(B, Hq, D), lse.reshape(B, Hq)


def decode_attention_partial(q, k_cache, v_cache, length, *, start: int = 0,
                             scale: float | None = None):
    """Single-token decode attention over a (possibly sharded) KV cache
    slice. The reference has no Pallas kernel for it, so it is plain torch
    on every device.

    q: (B, Hq, D); k_cache/v_cache: (B, S_loc, Hkv, D); ``length`` is the
    number of valid GLOBAL positions; ``start`` is this slice's global
    offset. Returns :func:`masked_decode`'s ``(o, lse)`` over this slice,
    for a logsumexp combination across slices."""
    pos = start + torch.arange(k_cache.shape[1], device=q.device)
    return masked_decode(q, k_cache, v_cache, pos < length, scale=scale)


def combine_partials(outs, lses):
    """Merge per-slice ``(o, lse)`` partials by their softmax weights.

    outs: (N, B, Hq, D); lses: (N, B, Hq) -> (B, Hq, D)."""
    m = lses.amax(0)
    w = torch.exp(lses - m)  # (N, B, Hq)
    w = w / torch.clamp(w.sum(0), min=1e-30)
    return torch.einsum("nbh,nbhd->bhd", w, outs)
