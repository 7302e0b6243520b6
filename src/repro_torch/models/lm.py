"""Decoder LM: the serve subset of ``repro/models/lm.py`` for the dense family.

Parameters live in :class:`LM`, an ``nn.Module`` tree of frozen tensors::

  embed.{table, head, ln_f}
  layers.<i>.attn.{ln, wq, wk, wv, wo[, q_norm, k_norm]}
  layers.<i>.mlp.{ln, w1, w2[, w3]}

which is the reference's pytree with its stacked ``layers`` axis unstacked
into a ``ModuleList`` (``testing.parity`` converts one into the other).
The forward functions are plain functions of that tree; the layer stack
is a Python loop where the reference scans.

The serve tier keeps one cache per slot: ``k``/``v`` ``(L, n_slots, S,
KV, hd)``, ``pos`` ``(n_slots, S)`` (-1 empty) and ``index`` ``(n_slots,)``.
Decode writes into it in place, where the reference donates it to a jit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class Params(nn.Module):
    """Frozen tensors held as a tree: a dict becomes a submodule, a list a
    ``ModuleList``, a tensor a parameter. ``p["name"]`` reads a child, so
    layer functions take a module where the reference takes a dict."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(v) for v in val))
            else:
                self.register_parameter(
                    name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


class LM(Params):
    """The parameters of one decoder LM, with its config."""

    def __init__(self, cfg: ModelConfig, tree: Mapping[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state: Mapping[str, Any]):
        """Build the module around the tensors of ``state`` (no copy)."""
        tree: Dict[str, Any] = {}
        for key, val in state.items():
            node = tree
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = val
        tree["layers"] = [tree["layers"][str(i)]
                          for i in range(len(tree["layers"]))]
        return cls(cfg, tree)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def _block_kind(cfg: ModelConfig) -> str:
    if cfg.family in ("dense", "vlm"):
        return "dense"
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the moe family is not ported to repro_torch yet; "
            "see ROADMAP.md, open items")
    if cfg.family in ("ssm", "hybrid"):
        return "ssm"
    raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, seed: int, *, device=None) -> LM:
    """Random weights from ``seed``, drawn on ``device`` by one explicit
    ``torch.Generator`` (N(0, 1/fan_in) matrices, unit norms)."""
    if _block_kind(cfg) != "dense":
        raise NotImplementedError(f"{cfg.name}: only the dense family is "
                                  "ported; see ROADMAP.md, open items")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tree = {"embed": L.init_embed(cfg, gen, dev),
            "layers": [{"attn": L.init_attn(cfg, gen, dev),
                        "mlp": L.init_mlp(cfg, gen, dev)}
                       for _ in range(cfg.num_layers)]}
    return LM(cfg, tree)


# --------------------------------------------------------------------------
# full-sequence forward (prefill)


def stack_forward(cfg: ModelConfig, params: LM, x, positions, *,
                  attn_impl: str | None = None):
    """Run the whole layer stack, collecting the cache. Returns
    ``(h, (k, v))`` with k/v stacked over layers, each
    ``(L, B, S, KV, hd)``. (The reference's ``aux_loss_sum`` is always 0
    for the dense family and is not returned.)"""
    _block_kind(cfg)
    h = x
    ks, vs = [], []
    for lp in params["layers"]:
        h, (k, v) = L.attn_forward(cfg, lp["attn"], h, positions,
                                   return_kv=True, attn_impl=attn_impl)
        ks.append(k)
        vs.append(v)
        h = L.mlp_forward(cfg, lp["mlp"], h)
    return h, (torch.stack(ks), torch.stack(vs))


def embed_inputs(cfg: ModelConfig, params: LM, batch):
    x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
    return x, torch.arange(x.shape[1], device=x.device)


# --------------------------------------------------------------------------
# per-slot cache (continuous-batching serve tier)


def _slot_cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Cache slots per request in the serve tier, after the reference's
    ``_slot_mode`` rejections: attention KV families only, no sliding
    window. On one card the layout is always its kind "A"."""
    if _block_kind(cfg) not in ("dense", "moe"):
        raise ValueError(
            f"serve tier needs an attention KV cache; family "
            f"{cfg.family!r} has none (ssm/hybrid state is lock-step only)")
    if cfg.attn_window:
        raise ValueError("serve tier does not support sliding-window "
                         "(ring) caches")
    return seq_len + 1


def init_cache_slots(cfg: ModelConfig, n_slots: int, seq_len: int, *,
                     device=None):
    """Slot-pool cache with every slot empty."""
    s_c = _slot_cache_len(cfg, seq_len)
    dev = resolve_device(device)
    shape = (cfg.num_layers, n_slots, s_c, cfg.num_kv_heads, cfg.hd)
    return {"index": torch.zeros((n_slots,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=L.dtype_of(cfg), device=dev),
            "v": torch.zeros(shape, dtype=L.dtype_of(cfg), device=dev),
            "pos": torch.full((n_slots, s_c), -1, dtype=torch.int32,
                              device=dev)}


def make_prefill_slots(cfg: ModelConfig, seq_len: int, *,
                       attn_impl: str | None = None):
    """Prefill one serve admission bucket at fixed shapes with per-row
    prompt lengths: logits come from each row's LAST REAL token and cache
    positions at and after the prompt are marked empty (-1), so right-padded
    prompts decode exactly as unpadded ones."""
    s_c = _slot_cache_len(cfg, seq_len)

    def prefill(params: LM, batch, prompt_len):
        x, positions = embed_inputs(cfg, params, batch)
        h, (k, v) = stack_forward(cfg, params, x, positions,
                                  attn_impl=attn_impl)
        S = x.shape[1]
        last = torch.clamp(prompt_len.long() - 1, 0, S - 1)
        h_last = h[torch.arange(h.shape[0], device=h.device), last]
        logits = L.lm_logits_last(cfg, params["embed"], h_last)
        pad = s_c - S
        posarr = torch.arange(s_c, dtype=torch.int32, device=h.device)[None]
        posarr = torch.where(posarr < prompt_len[:, None], posarr,
                             torch.full_like(posarr, -1))
        cache = {"index": prompt_len.to(torch.int32),
                 "k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                 "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
                 "pos": posarr}
        return logits, cache

    return prefill


def make_decode_slots(cfg: ModelConfig, seq_len: int):
    """Continuous-batching decode: ONE new token for every ACTIVE slot.
    ``token`` is (n_slots, 1), ``active`` (n_slots,) bool. Inactive slots
    are computed but never written, so admissions and retirements between
    calls never change a shape."""
    _slot_cache_len(cfg, seq_len)

    def decode(params: LM, cache, token, active):
        index = cache["index"]
        h = L.embed_tokens(cfg, params["embed"], token)
        pos = cache["pos"]
        for i, lp in enumerate(params["layers"]):
            h, _, _, pos = L.attn_decode_slots(
                cfg, lp["attn"], h, cache["k"][i], cache["v"][i], pos, index,
                active)
            h = L.mlp_forward(cfg, lp["mlp"], h)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, 0])
        new_cache = dict(cache, pos=pos,
                         index=index + active.to(index.dtype))
        return logits, new_cache

    return decode
