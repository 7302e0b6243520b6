"""Encoder-decoder backbone (Seamless-M4T style): the port of
``repro/models/encdec.py``, the audio frontend stubbed as there.

The speech encoder's conformer / conv frontend is not implemented: the
batch supplies precomputed frame embeddings ``enc_embeds`` ``(B, S_enc,
d)``. This module runs the transformer encoder over them (rope, no causal
mask) and the text decoder with causal self-attention and cross-attention
to the encoder's output (no rope, no qk-norm, ``Sq`` and ``S_enc``
independent). Every full-sequence attention goes through
``kernels.flash_attention.ops``, so on CUDA tensors each launches the
Hopper kernel; the single-token decode's self and cross attention are
plain torch, as in the reference.

Parameters live in an ``lm.Params`` module holding the reference's tree
with its stacked layer axes unstacked into ``ModuleList``s::

  embed.{table, head, ln_f}
  enc_layers.<i>.{attn, mlp}
  dec_layers.<i>.{self, cross, mlp}       (each attention as layers.init_attn)
  enc_ln

``testing.parity.state_from_jax`` carries the reference's tree into it.

Cache (lock step, one scalar ``index`` for the batch): the decoder's self
cache in the layout ``layers.decode_mode`` picks (``k``/``v`` ``(L, B, S,
KV, hd)``, ``pos`` ``(S,)``), and the cross cache ``cross_k``/``cross_v``
``(L, B, S_enc, KV, hd)`` with ``enc_len``, static after prefill: k/v are
projected from the encoder's output once. Decode writes the self cache in
place and leaves the cross cache alone.

The reference's ``param_specs`` and ``cache_specs`` place these trees on a
device mesh; they wait for the LM's multi-card sharding (ROADMAP.md §1,
item 10). Its ``remat`` flags (``jax.checkpoint``) have no counterpart:
the port's train step trains by autograd of the plain attention, as
``lm.make_train_step`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.config import ModelConfig


def _enc_layers(cfg: ModelConfig) -> int:
    return cfg.encoder_layers or cfg.num_layers


# ---------------------------------------------------------------- params


def init_enc_block(cfg: ModelConfig, generator, device):
    return {"attn": L.init_attn(cfg, generator, device),
            "mlp": L.init_mlp(cfg, generator, device)}


def init_dec_block(cfg: ModelConfig, generator, device):
    return {"self": L.init_attn(cfg, generator, device),
            "cross": L.init_attn(cfg, generator, device),
            "mlp": L.init_mlp(cfg, generator, device)}


def init_params(cfg: ModelConfig, seed: int, *, device=None) -> LM.Params:
    """Random weights from ``seed``, drawn on ``device`` by one explicit
    ``torch.Generator``, in the reference's tree (module docstring). On
    the ``meta`` device nothing is allocated (the dry run's counts)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    return LM.Params({
        "embed": L.init_embed(cfg, gen, dev),
        "enc_layers": [init_enc_block(cfg, gen, dev)
                       for _ in range(_enc_layers(cfg))],
        "dec_layers": [init_dec_block(cfg, gen, dev)
                       for _ in range(cfg.num_layers)],
        "enc_ln": torch.ones((cfg.d_model,), dtype=L.dtype_of(cfg),
                             device=dev),
    })


# ---------------------------------------------------------------- forward


def encode(cfg: ModelConfig, params, enc_embeds, *,
           attn_impl: str | None = None):
    """The encoder over frame embeddings ``(B, S_enc, d)``: rope on, no
    causal mask. ``attn_impl`` is passed to ``ops.attention``."""
    x = enc_embeds.to(L.dtype_of(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    for lp in params["enc_layers"]:
        x = L.attn_forward(cfg, lp["attn"], x, positions, causal=False,
                           attn_impl=attn_impl)
        x = L.mlp_forward(cfg, lp["mlp"], x)
    return L.rmsnorm(x, params["enc_ln"])


def _cross_attn(cfg: ModelConfig, p, x, enc_out, *, collect: bool = False,
                attn_impl: str | None = None):
    """Full cross-attention (train / prefill): q from the decoder's ``x``,
    k/v from ``enc_out``, no rope, no mask. With ``collect``, also returns
    the cross k/v for the cache."""
    h = L.rmsnorm(x, p["ln"])
    hd = cfg.hd
    B, Sq = x.shape[:2]
    Sk = enc_out.shape[1]
    q = L.matmul(h, p["wq"]).reshape(B, Sq, -1, hd)
    k = L.matmul(enc_out, p["wk"]).reshape(B, Sk, -1, hd)
    v = L.matmul(enc_out, p["wv"]).reshape(B, Sk, -1, hd)
    o = attn_ops.attention(q, k, v, causal=False, impl=attn_impl)
    out = x + L.matmul(o.reshape(B, Sq, -1), p["wo"])
    if collect:
        return out, (k, v)
    return out


def _cross_attn_decode(cfg: ModelConfig, p, x, k_cache, v_cache, enc_len):
    """x: (B, 1, d); the static cross caches (B, S_enc, KV, hd), their
    first ``enc_len`` slots valid."""
    B = x.shape[0]
    h = L.rmsnorm(x, p["ln"])
    q = L.matmul(h, p["wq"]).reshape(B, -1, cfg.hd)
    valid = torch.arange(k_cache.shape[1], device=x.device) < enc_len
    o, _ = attn_ref.masked_decode(q, k_cache, v_cache, valid)
    return x + L.matmul(o.reshape(B, 1, -1).to(x.dtype), p["wo"])


def decoder_forward(cfg: ModelConfig, params, tokens, enc_out, *,
                    collect_cache: bool = False,
                    attn_impl: str | None = None):
    """The decoder over ``tokens`` ``(B, S)`` attending ``enc_out``.
    Returns ``(h, ys)``: ys is ``(self_k, self_v, cross_k, cross_v)``, each
    stacked over layers ``(L, B, S or S_enc, KV, hd)``, when
    ``collect_cache``, else ``()``."""
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    h = x
    ys = []
    for lp in params["dec_layers"]:
        if collect_cache:
            h, (sk, sv) = L.attn_forward(cfg, lp["self"], h, positions,
                                         return_kv=True, attn_impl=attn_impl)
            h, (ck, cv) = _cross_attn(cfg, lp["cross"], h, enc_out,
                                      collect=True, attn_impl=attn_impl)
            ys.append((sk, sv, ck, cv))
        else:
            h = L.attn_forward(cfg, lp["self"], h, positions,
                               attn_impl=attn_impl)
            h = _cross_attn(cfg, lp["cross"], h, enc_out,
                            attn_impl=attn_impl)
        h = L.mlp_forward(cfg, lp["mlp"], h)
    if not collect_cache:
        return h, ()
    return h, tuple(torch.stack(t) for t in zip(*ys))


def loss_forward(cfg: ModelConfig, params, batch, *,
                 attn_impl: str | None = None):
    """``(sum_loss, count, aux)`` of a batch ``{enc_embeds, tokens,
    labels}``, aux 0 as in the reference. With ``attn_impl="ref"`` the
    loss is differentiable (the train step's route)."""
    enc_out = encode(cfg, params, batch["enc_embeds"], attn_impl=attn_impl)
    h, _ = decoder_forward(cfg, params, batch["tokens"], enc_out,
                           attn_impl=attn_impl)
    s, c = L.lm_loss(cfg, params["embed"], h, batch["labels"])
    return s, c, torch.zeros((), dtype=torch.float32, device=s.device)


# ---------------------------------------------------------------- serving


def init_cache(cfg: ModelConfig, global_batch: int, seq_len: int = 0, *,
               prefilled: bool = False, device=None):
    """Empty lock-step cache (zeros, positions -1), the encoder's length
    taken as ``seq_len``; with ``prefilled``, a placeholder at ``index =
    seq_len``."""
    dev = resolve_device(device)
    s_c = L.decode_mode(cfg, global_batch, seq_len)["s_cache"]
    dt = L.dtype_of(cfg)

    def z(s):
        return torch.zeros((cfg.num_layers, global_batch, s,
                            cfg.num_kv_heads, cfg.hd), dtype=dt, device=dev)

    def scalar(n):
        return torch.tensor(n, dtype=torch.int32, device=dev)
    return {"index": scalar(seq_len if prefilled else 0),
            "k": z(s_c), "v": z(s_c),
            "pos": torch.full((s_c,), -1, dtype=torch.int32, device=dev),
            "cross_k": z(seq_len), "cross_v": z(seq_len),
            "enc_len": scalar(seq_len)}


def make_prefill(cfg: ModelConfig, seq_len: int | None = None, *,
                 attn_impl: str | None = None):
    """Lock-step prefill: ``prefill(params, batch) -> (logits, cache)`` for
    a batch ``{enc_embeds, tokens}``: the last token's logits ``(B,
    V_pad)`` f32 and the cache at ``index = S``, its self cache laid out
    for ``seq_len`` tokens (the prompt's length when None). ``attn_impl``
    picks the attention route (None: the kernel on CUDA tensors;
    ``"ref"`` for the on-card comparison)."""

    def prefill(params, batch):
        enc_out = encode(cfg, params, batch["enc_embeds"],
                         attn_impl=attn_impl)
        h, (sk, sv, ck, cv) = decoder_forward(
            cfg, params, batch["tokens"], enc_out, collect_cache=True,
            attn_impl=attn_impl)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, -1])
        B, S_ = batch["tokens"].shape
        mode = L.decode_mode(cfg, B, S_ if seq_len is None else seq_len)
        cache: Dict[str, Any] = {"index": torch.tensor(
            S_, dtype=torch.int32, device=h.device)}
        cache["k"], cache["v"], cache["pos"] = LM._pack_kv(sk, sv, S_, mode)
        cache.update(cross_k=ck, cross_v=cv, enc_len=torch.tensor(
            enc_out.shape[1], dtype=torch.int32, device=h.device))
        return logits, cache

    return prefill


def make_decode(cfg: ModelConfig):
    """Lock-step decode: ``decode(params, cache, token) -> (logits,
    cache')`` for ONE new token ``(B, 1)`` of every row. The self cache's
    k/v and ``pos`` are written in place (layout read off the cache); the
    cross cache is read only; ``cache'`` holds the advanced index."""

    def decode(params, cache, token):
        index = cache["index"]
        h = L.embed_tokens(cfg, params["embed"], token)       # (B, 1, d)
        k, v = cache["k"], cache["v"]
        mode = L.decode_mode(cfg, k.shape[1], k.shape[2] - 1)
        for i, lp in enumerate(params["dec_layers"]):
            h = L.attn_decode(cfg, lp["self"], h, k[i], v[i], cache["pos"],
                              index, mode)
            h = _cross_attn_decode(cfg, lp["cross"], h, cache["cross_k"][i],
                                   cache["cross_v"][i], cache["enc_len"])
            h = L.mlp_forward(cfg, lp["mlp"], h)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, 0])
        return logits, dict(cache, index=index + 1)

    return decode
