"""Transformer building blocks: the serving and loss subset of
``repro/models/layers.py``.

Same numerics as the reference on one device (its tensor-parallel
collectives are no-ops at tp=1 and are not ported): norms, rope and softmax
in f32; bf16 products accumulate in f32 and round once to bf16, as
``torch.matmul`` does on the card (the reference leaves these products to
XLA, so they are plain ``torch.matmul`` here too). Full-sequence attention
goes through ``kernels.flash_attention.ops``, which launches the Hopper
kernel on CUDA tensors. Single-token decode attention is plain torch, as in
the reference, which computes it outside any Pallas kernel.

``init_*`` return dicts of tensors shaped like the reference's pytrees;
``p`` arguments are any mapping with those keys (a dict, or the
``lm.Params`` module that holds them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def rmsnorm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(float(theta), exps)  # f32; a scalar base needs no copy
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _dense_init(generator, shape, scale_dim, dtype, device):
    """N(0, 1/scale_dim) drawn in f32 and cast, like the reference."""
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (w * scale_dim ** -0.5).to(dtype)


def matmul(x, w):
    """x @ w over the last axis of x; bf16 products accumulate in f32."""
    return torch.matmul(x, w)


def dot_f32(x, w):
    """(B, d) @ (d, n) -> f32, accumulated in f32: the reference's
    ``jnp.dot(..., preferred_element_type=f32)``."""
    if x.dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


# --------------------------------------------------------------------------
# attention block


def init_attn(cfg: ModelConfig, generator, device):
    hd, d = cfg.hd, cfg.d_model
    dt = dtype_of(cfg)
    hq, kv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "ln": torch.ones((d,), dtype=dt, device=device),
        "wq": _dense_init(generator, (d, hq * hd), d, dt, device),
        "wk": _dense_init(generator, (d, kv * hd), d, dt, device),
        "wv": _dense_init(generator, (d, kv * hd), d, dt, device),
        "wo": _dense_init(generator, (hq * hd, d), hq * hd, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return p


def _qkv(cfg: ModelConfig, p, h, positions):
    """h: (B, S, d) -> q (B,S,Hq,hd), k/v (B,S,Hkv,hd), roped."""
    hd = cfg.hd
    B, S, _ = h.shape
    q = matmul(h, p["wq"]).reshape(B, S, -1, hd)
    k = matmul(h, p["wk"]).reshape(B, S, -1, hd)
    v = matmul(h, p["wv"]).reshape(B, S, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(cfg: ModelConfig, p, x, positions, *,
                 return_kv: bool = False, attn_impl: str | None = None):
    """Causal full-sequence attention (prefill). x: (B, S, d).
    ``attn_impl`` is passed to ``ops.attention`` (None: the kernel on CUDA
    tensors)."""
    h = rmsnorm(x, p["ln"])
    q, k, v = _qkv(cfg, p, h, positions)
    o = attn_ops.attention(q, k, v, causal=True, window=cfg.attn_window,
                           impl=attn_impl)
    B, S = x.shape[:2]
    out = x + matmul(o.reshape(B, S, -1), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def _masked_decode(q, k_cache, v_cache, valid):
    """q: (B, Hq, hd); caches (B, S, KV, hd); valid: (B, S) bool per row.
    Returns the softmax-normalised output (B, Hq, hd) in f32."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.float()) * (D ** -0.5)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    pexp = torch.exp(s - s.amax(-1, keepdim=True))
    den = pexp.sum(-1)
    o = torch.einsum("bhgk,bkhd->bhgd", pexp, v_cache.float())
    o = o / torch.clamp(den[..., None], min=1e-30)
    return o.reshape(B, Hq, D)


def attn_decode_slots(cfg: ModelConfig, p, x, k_cache, v_cache, cache_pos,
                      index, active):
    """Per-slot single-token decode for the continuous-batching serve tier.

    x: (B, 1, d); caches (B, S, KV, hd); cache_pos (B, S) position per
    cache slot (-1 empty); index (B,) per-row token counts; active (B,)
    bool. Writes the new k/v/pos of ACTIVE rows into the caches in place
    (the reference returns new arrays from a donated buffer) and returns
    ``(out, k_cache, v_cache, cache_pos)``. An inactive row never changes
    its cache: its write puts back the value already there, the in-place
    form of the reference's drop-mode scatter, and needs no host sync.
    """
    B = x.shape[0]
    h = rmsnorm(x, p["ln"])
    hd = cfg.hd
    q = matmul(h, p["wq"]).reshape(B, 1, -1, hd)
    k = matmul(h, p["wk"]).reshape(B, 1, -1, hd)
    v = matmul(h, p["wv"]).reshape(B, 1, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    pos_b = index[:, None]  # (B, 1): each row rotates at its own position
    q = rope(q, pos_b, cfg.rope_theta)
    k = rope(k, pos_b, cfg.rope_theta)

    S = k_cache.shape[1]
    row = torch.arange(B, device=x.device)
    tgt = torch.clamp(index, max=S - 1)
    keep = active[:, None, None]
    k_cache[row, tgt] = torch.where(keep, k[:, 0], k_cache[row, tgt])
    v_cache[row, tgt] = torch.where(keep, v[:, 0], v_cache[row, tgt])
    cache_pos[row, tgt] = torch.where(active, index.to(cache_pos.dtype),
                                      cache_pos[row, tgt])

    valid = (cache_pos >= 0) & (cache_pos <= index[:, None])  # (B, S)
    o = _masked_decode(q[:, 0], k_cache, v_cache, valid)
    o = matmul(o.reshape(B, 1, -1).to(x.dtype), p["wo"])
    return x + o, k_cache, v_cache, cache_pos


# --------------------------------------------------------------------------
# dense MLP (SwiGLU / GELU)


def init_mlp(cfg: ModelConfig, generator, device):
    d, f = cfg.d_model, cfg.padded_ff(1)
    dt = dtype_of(cfg)
    p = {"ln": torch.ones((d,), dtype=dt, device=device),
         "w1": _dense_init(generator, (d, f), d, dt, device),
         "w2": _dense_init(generator, (f, d), f, dt, device)}
    if cfg.mlp_type == "swiglu":
        p["w3"] = _dense_init(generator, (d, f), d, dt, device)
    return p


def mlp_forward(cfg: ModelConfig, p, x):
    h = rmsnorm(x, p["ln"])
    a = matmul(h, p["w1"])
    if cfg.mlp_type == "swiglu":
        a = F.silu(a.float()).to(x.dtype) * matmul(h, p["w3"])
    else:
        a = F.gelu(a.float(), approximate="tanh").to(x.dtype)
    return x + matmul(a, p["w2"])


# --------------------------------------------------------------------------
# embedding / unembedding


def init_embed(cfg: ModelConfig, generator, device):
    vp, d = cfg.padded_vocab(1), cfg.d_model
    dt = dtype_of(cfg)
    return {"table": _dense_init(generator, (vp, d), d, dt, device),
            "head": _dense_init(generator, (d, vp), d, dt, device),
            "ln_f": torch.ones((d,), dtype=dt, device=device)}


def embed_tokens(cfg: ModelConfig, p, tokens):
    """tokens: (B, S) int. Ids outside the table embed to zeros."""
    table = p["table"]
    ok = (tokens >= 0) & (tokens < table.shape[0])
    e = table[torch.clamp(tokens, 0, table.shape[0] - 1)]
    return torch.where(ok[..., None], e, torch.zeros_like(e))


def lm_loss(cfg: ModelConfig, p, h, labels, *, chunk_tokens: int = 2048):
    """Softmax cross-entropy over the padded vocab, chunked over tokens.

    h: (B, S, d); labels: (B, S) int (-1 = ignore). The padding columns of
    the vocab are masked out of the softmax (``col_valid``). Returns
    ``(sum_loss, count)``: f32 and int64 scalars."""
    d = h.shape[-1]
    h = rmsnorm(h, p["ln_f"])
    hf = h.reshape(-1, d)
    lf = labels.reshape(-1)
    V = p["head"].shape[1]
    col_valid = torch.arange(V, device=h.device) < cfg.vocab_size
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int64, device=h.device)
    for s0 in range(0, hf.shape[0], chunk_tokens):
        hc, lc = hf[s0:s0 + chunk_tokens], lf[s0:s0 + chunk_tokens]
        logits = dot_f32(hc, p["head"])
        logits = torch.where(col_valid[None, :], logits,
                             torch.full_like(logits, NEG_INF))
        m = logits.max(-1).values.detach()
        se = torch.exp(logits - m[:, None]).sum(-1)
        lse = m + torch.log(torch.clamp(se, min=1e-30))
        hit = (lc >= 0) & (lc < V)
        lab_logit = torch.gather(logits, 1,
                                 torch.clamp(lc, 0, V - 1)[:, None].long())
        lab_logit = torch.where(hit, lab_logit[:, 0],
                                torch.zeros_like(lse))
        keep = lc >= 0
        total = total + torch.where(keep, lse - lab_logit,
                                    torch.zeros_like(lse)).sum()
        count = count + keep.sum()
    return total, count


def lm_logits_last(cfg: ModelConfig, p, h_last):
    """h_last: (B, d) -> full-vocab f32 logits (B, V_pad)."""
    return dot_f32(rmsnorm(h_last, p["ln_f"]), p["head"])
