"""Transformer building blocks: the one-device subset of
``repro/models/layers.py``.

Same numerics as the reference on one device (its tensor-parallel
collectives are no-ops at tp=1 and are not ported): norms, rope and softmax
in f32; bf16 products accumulate in f32 and round once to bf16, as
``torch.matmul`` does on the card (the reference leaves these products to
XLA, so they are plain ``torch.matmul`` here too). Full-sequence attention
goes through ``kernels.flash_attention.ops``, which launches the Hopper
kernel on CUDA tensors. Single-token decode attention (``attn_decode`` for
the lock-step cache, ``attn_decode_slots`` for the serve tier's slot pool)
is plain torch, as in the reference, which computes it outside any Pallas
kernel; the int8 KV cache quantises per (slot, head) vector.

``init_*`` return dicts of tensors shaped like the reference's pytrees;
``p`` arguments are any mapping with those keys (a dict, or the
``lm.Params`` module that holds them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
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
    ``jnp.dot(..., preferred_element_type=f32)``. ``torch.mm``'s
    ``out_dtype`` has no derivative, so a product that needs a gradient
    widens its bf16 operands (exactly) and multiplies in f32."""
    if x.dtype == torch.float32:
        return x @ w
    needs_grad = torch.is_grad_enabled() and (x.requires_grad
                                              or w.requires_grad)
    if x.is_cuda and not needs_grad:
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


def attn_forward(cfg: ModelConfig, p, x, positions, *, causal: bool = True,
                 return_kv: bool = False, attn_impl: str | None = None):
    """Full-sequence self-attention (train / prefill), causal unless the
    caller (the encoder) says otherwise. x: (B, S, d). ``attn_impl`` is
    passed to ``ops.attention`` (None: the kernel on CUDA tensors)."""
    h = rmsnorm(x, p["ln"])
    q, k, v = _qkv(cfg, p, h, positions)
    o = attn_ops.attention(q, k, v, causal=causal, window=cfg.attn_window,
                           impl=attn_impl)
    B, S = x.shape[:2]
    out = x + matmul(o.reshape(B, S, -1), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def decode_mode(cfg: ModelConfig, global_batch: int, seq_len: int):
    """The KV-cache layout, as the reference picks it statically: a dict of
    ``{kind, s_cache}``.

      kind "W": sliding-window ring cache of ``min(window, seq_len + 1)``
                slots;
      kind "A": ``seq_len + 1`` slots, kv heads whole on the card.

    The reference's other layouts shard the cache over a mesh: kind "B"
    puts the sequence over tensor-parallel devices when they outnumber the
    kv heads, and kind "A" puts it over data-parallel devices when they do
    not divide the batch. On one card tp = dp = 1, which divides every kv
    head count and every batch, so neither arises. ``global_batch`` is kept
    for the reference's signature."""
    del global_batch
    window = cfg.attn_window
    if window and window > 0:
        return dict(kind="W", s_cache=min(window, seq_len + 1))
    return dict(kind="A", s_cache=seq_len + 1)


# --------------------------------------------------------------------------
# int8 KV quantisation: absmax per (slot, head) vector


def kv_quantize(x):
    """x: (..., hd) -> (int8 values, f32 scale[..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _write_slot(cache, slot, val):
    """``cache[:, slot] = val[:, 0]`` in place, for a 0-d device ``slot``
    (no host sync); the reference's ``dynamic_update_slice`` on axis 1."""
    cache.index_copy_(1, slot.reshape(1), val.to(cache.dtype))


def attn_decode(cfg: ModelConfig, p, x, k_cache, v_cache, cache_pos, index,
                mode, k_scale=None, v_scale=None):
    """Lock-step single-token decode under ``mode`` (kind "A" or "W").

    x: (B, 1, d); caches (B, S, KV, hd); cache_pos (S,) position per cache
    slot (-1 empty), shared by the batch; index: 0-d number of tokens
    already in the sequence. Writes the new k/v (quantised, with their
    scales, when ``k_scale`` is given) and position into slot ``index``
    (``index % S`` in the ring) in place, where the reference returns new
    arrays from a donated cache, and returns the block's output."""
    quant = k_scale is not None
    B = x.shape[0]
    h = rmsnorm(x, p["ln"])
    hd = cfg.hd
    q = matmul(h, p["wq"]).reshape(B, 1, -1, hd)
    k = matmul(h, p["wk"]).reshape(B, 1, -1, hd)
    v = matmul(h, p["wv"]).reshape(B, 1, -1, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = rope(q, index[None], cfg.rope_theta)
    k = rope(k, index[None], cfg.rope_theta)

    S = k_cache.shape[1]
    window = cfg.attn_window
    slot = index % S if mode["kind"] == "W" else index
    # an update past the end lands on the last slot, as a clamped
    # dynamic_update_slice does
    slot = torch.clamp(slot, max=S - 1).long()
    if quant:
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        for c, val in ((k_cache, kq), (v_cache, vq), (k_scale, ks),
                       (v_scale, vs)):
            _write_slot(c, slot, val)
        k_att = kv_dequantize(k_cache, k_scale, x.dtype)
        v_att = kv_dequantize(v_cache, v_scale, x.dtype)
    else:
        _write_slot(k_cache, slot, k)
        _write_slot(v_cache, slot, v)
        k_att, v_att = k_cache, v_cache
    cache_pos.index_copy_(0, slot.reshape(1),
                          index.reshape(1).to(cache_pos.dtype))

    valid = (cache_pos >= 0) & (cache_pos <= index)
    if window and window > 0:
        valid &= cache_pos > (index - window)
    o, _ = attn_ref.masked_decode(q[:, 0], k_att, v_att, valid)
    return x + matmul(o.reshape(B, 1, -1).to(x.dtype), p["wo"])


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
    o, _ = attn_ref.masked_decode(q[:, 0], k_cache, v_cache, valid)
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
