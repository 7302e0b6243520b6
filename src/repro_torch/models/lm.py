"""Decoder LM: the port of ``repro/models/lm.py`` for the dense and ssm
families.

Parameters live in :class:`LM`, an ``nn.Module`` tree of frozen tensors::

  embed.{table, head, ln_f}
  layers.<i>.attn.{ln, wq, wk, wv, wo[, q_norm, k_norm]}     (dense)
  layers.<i>.mlp.{ln, w1, w2[, w3]}                          (dense)
  layers.<i>.mamba.{ln, wz, wx, wbc, wdt, conv_x, ...}       (ssm)

which is the reference's pytree with its stacked ``layers`` axis unstacked
into a ``ModuleList`` (``testing.parity`` converts one into the other).
The forward functions are plain functions of that tree; the layer stack
is a Python loop where the reference scans. The moe and hybrid families
are not ported yet and raise.

Two cache layouts:

* the serve tier's slot pool (dense): ``k``/``v`` ``(L, n_slots, S, KV,
  hd)``, ``pos`` ``(n_slots, S)`` (-1 empty) and ``index`` ``(n_slots,)``;
* the lock-step cache of ``init_cache`` / ``make_prefill`` /
  ``make_decode`` (ssm): ``ssm`` ``(L, B, H, P, N)`` f32, ``conv_x`` ``(L,
  B, W-1, d_inner)``, ``conv_bc`` ``(L, B, W-1, 2GN)`` and one scalar
  ``index`` for the whole batch, which starts and stops together.

Decode writes into a cache in place, where the reference donates it to a
jit. The dense lock-step layout is not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
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
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family (the shared attention block of "
            "zamba2_7b) is not ported to repro_torch yet; see ROADMAP.md, "
            "open items")
    if cfg.family == "ssm":
        return "ssm"
    raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, seed: int, *, device=None) -> LM:
    """Random weights from ``seed``, drawn on ``device`` by one explicit
    ``torch.Generator`` (N(0, 1/fan_in) matrices, unit norms)."""
    kind = _block_kind(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embed = L.init_embed(cfg, gen, dev)
    if kind == "ssm":
        layers = [{"mamba": S.init_mamba(cfg, gen, dev)}
                  for _ in range(cfg.num_layers)]
    else:
        layers = [{"attn": L.init_attn(cfg, gen, dev),
                   "mlp": L.init_mlp(cfg, gen, dev)}
                  for _ in range(cfg.num_layers)]
    return LM(cfg, {"embed": embed, "layers": layers})


# --------------------------------------------------------------------------
# full-sequence forward (loss / prefill)


def stack_forward(cfg: ModelConfig, params: LM, x, positions, *,
                  collect_cache: bool = False, attn_impl: str | None = None,
                  ssd_impl: str | None = None):
    """Run the whole layer stack. Returns ``(h, cache_ys)``; cache_ys (when
    ``collect_cache``, else ``()``):

      dense: ``(k, v)`` stacked over layers, each ``(L, B, S, KV, hd)``;
      ssm:   ``(ssm_state, tail_x, tail_bc)`` stacked over layers.

    (The reference's ``aux_loss_sum`` is always 0 for these families and is
    not returned.) ``attn_impl`` / ``ssd_impl`` pick the attention and scan
    routes (None: the kernels on CUDA tensors)."""
    kind = _block_kind(cfg)
    h = x
    ys = []
    for lp in params["layers"]:
        if kind == "ssm":
            out = S.mamba_forward(cfg, lp["mamba"], h,
                                  return_state=collect_cache,
                                  ssd_impl=ssd_impl)
        else:
            out = L.attn_forward(cfg, lp["attn"], h, positions,
                                 return_kv=collect_cache, attn_impl=attn_impl)
        h, y = out if collect_cache else (out, None)
        ys.append(y)
        if kind == "dense":
            h = L.mlp_forward(cfg, lp["mlp"], h)
    if not collect_cache:
        return h, ()
    return h, tuple(torch.stack(t) for t in zip(*ys))


def embed_inputs(cfg: ModelConfig, params: LM, batch):
    x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
    return x, torch.arange(x.shape[1], device=x.device)


def loss_forward(cfg: ModelConfig, params: LM, batch):
    """The stateless forward and its loss: ``(sum_loss, count, aux)`` as the
    reference returns them (``aux`` is 0 for these families). Forward only
    through the kernels: the scan kernel has no backward yet, and raises if
    asked for one."""
    x, positions = embed_inputs(cfg, params, batch)
    h, _ = stack_forward(cfg, params, x, positions)
    s, c = L.lm_loss(cfg, params["embed"], h, batch["labels"])
    return s, c, torch.zeros((), dtype=torch.float32, device=h.device)


# --------------------------------------------------------------------------
# lock-step cache, prefill and decode (the ssm family)


def _lockstep(cfg: ModelConfig) -> None:
    """The lock-step programs are ported for the pure-ssm family only."""
    if _block_kind(cfg) != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the lock-step prefill/decode of the {cfg.family} "
            "family is not ported yet (its serving path is the slot-pool "
            "serve tier); see ROADMAP.md, open items")


def init_cache(cfg: ModelConfig, global_batch: int, *, device=None):
    """Empty lock-step cache (zeros, ``index`` 0): the state before the
    first token. An ssm cache has no sequence capacity, so unlike the
    reference's it takes no sequence length."""
    _lockstep(cfg)
    dev = resolve_device(device)
    B, nl = global_batch, cfg.num_layers
    dt = L.dtype_of(cfg)
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, gn2 = cfg.ssm_conv - 1, 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "index": torch.zeros((), dtype=torch.int32, device=dev),
        "ssm": torch.zeros((nl, B, H, Pd, N), dtype=torch.float32,
                           device=dev),
        "conv_x": torch.zeros((nl, B, W, cfg.d_inner), dtype=dt, device=dev),
        "conv_bc": torch.zeros((nl, B, W, gn2), dtype=dt, device=dev)}


def make_prefill(cfg: ModelConfig, *, ssd_impl: str | None = None):
    """Lock-step prefill: ``prefill(params, batch) -> (logits, cache)``,
    logits of the last token ``(B, V_pad)`` f32 and the cache of
    ``init_cache``'s layout at ``index = S``. Shapes come from the batch
    (the reference's ``global_batch`` / ``seq_len`` pick sharded cache
    layouts, which one card does not have)."""
    _lockstep(cfg)

    def prefill(params: LM, batch):
        x, positions = embed_inputs(cfg, params, batch)
        h, (st, tx, tbc) = stack_forward(cfg, params, x, positions,
                                         collect_cache=True,
                                         ssd_impl=ssd_impl)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, -1])
        cache = {"index": torch.tensor(x.shape[1], dtype=torch.int32,
                                       device=x.device),
                 "ssm": st, "conv_x": tx, "conv_bc": tbc}
        return logits, cache

    return prefill


def make_decode(cfg: ModelConfig):
    """Lock-step decode: ``decode(params, cache, token) -> (logits,
    cache')`` for ONE new token ``(B, 1)`` of every row. The states are
    written into ``cache``'s tensors in place; ``cache'`` holds them and the
    advanced index."""
    _lockstep(cfg)

    def decode(params: LM, cache, token):
        h = L.embed_tokens(cfg, params["embed"], token)       # (B, 1, d)
        for i, lp in enumerate(params["layers"]):
            h, st, tx, tbc = S.mamba_decode(
                cfg, lp["mamba"], h, cache["ssm"][i], cache["conv_x"][i],
                cache["conv_bc"][i])
            cache["ssm"][i].copy_(st)
            cache["conv_x"][i].copy_(tx)
            cache["conv_bc"][i].copy_(tbc)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, 0])
        return logits, dict(cache, index=cache["index"] + 1)

    return decode


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
                                  collect_cache=True, attn_impl=attn_impl)
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
