"""Decoder LM: the port of ``repro/models/lm.py`` for the dense, vlm, ssm,
moe and hybrid families (the encoder-decoder is ``models/encdec.py``).

Parameters live in :class:`LM`, an ``nn.Module`` tree of frozen tensors::

  embed.{table, head, ln_f}
  layers.<i>.attn.{ln, wq, wk, wv, wo[, q_norm, k_norm]}     (dense, moe)
  layers.<i>.mlp.{ln, w1, w2[, w3]}                          (dense, vlm)
  layers.<i>.moe.{ln, router, we1, we3, we2}                 (moe)
  layers.<i>.mamba.{ln, wz, wx, wbc, wdt, conv_x, ...}       (ssm, hybrid)
  shared.{attn, mlp}                                         (hybrid)

which is the reference's pytree with its stacked ``layers`` axis unstacked
into a ``ModuleList`` (``testing.parity`` converts one into the other).
The forward functions are plain functions of that tree; the layer stack
is a Python loop where the reference scans. The hybrid family (Zamba2)
runs one shared attention + MLP block, one set of weights, before mamba
layer i whenever ``i % attn_every == 0``: ``n_full`` groups of
``attn_every`` mamba layers and a tail group, each invocation with its own
KV cache. The moe family's FFN is ``models/moe.py``.

Two cache layouts:

* the serve tier's slot pool (dense): ``k``/``v`` ``(L, n_slots, S, KV,
  hd)``, ``pos`` ``(n_slots, S)`` (-1 empty) and ``index`` ``(n_slots,)``;
* the lock-step cache of ``init_cache`` / ``make_prefill`` /
  ``make_decode``, with one scalar ``index`` for the whole batch, which
  starts and stops together. Dense and moe: ``k``/``v`` ``(L, B, S, KV,
  hd)`` (int8 with f32 ``k_scale``/``v_scale`` ``(L, B, S, KV, 1)`` when
  quantised) and ``pos`` ``(S,)``, in the layout ``layers.decode_mode``
  picks (kind "A", or the sliding window's ring, kind "W"). Ssm: ``ssm``
  ``(L, B, H, P, N)`` f32, ``conv_x`` ``(L, B, W-1, d_inner)`` and
  ``conv_bc`` ``(L, B, W-1, 2GN)``. Hybrid: the ssm cache and ``k``/``v``
  ``(n_inv, B, S, KV, hd)`` over the shared block's invocations, with
  ``pos``.

The vlm family is the dense one with the vision frontend's stub in
``embed_inputs`` (``patch_embeds`` take the first positions). Decode
writes into a cache in place, where the reference donates it to a jit.
``make_train_step`` is the reference's microbatched step on one card,
for every decoder family (and the encdec's, given its ``loss_fwd``); it
trains by autograd of the plain routes, the reference's own gradient route
(its attention, scan and ragged-product Pallas kernels have no
``custom_vjp``): the plain attention (dense, vlm, moe, and the hybrid's
shared block), the plain scan (ssm, hybrid) and, for the moe experts, the
plain ragged product (``moe.py`` says which dispatch runs where). The
kernel routes stay forward-only and raise if asked for a gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import Optimizer


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


def nest_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A flat state dict (``layers.0.attn.wq``...) -> the tree ``Params``
    takes: dotted keys nest into dicts, and a dict keyed ``0..n-1`` (a
    ``ModuleList``'s children) becomes a list. The tensors are not
    copied."""
    tree: Dict[str, Any] = {}
    for key, val in state.items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


class LM(Params):
    """The parameters of one decoder LM, with its config."""

    def __init__(self, cfg: ModelConfig, tree: Mapping[str, Any]):
        super().__init__(tree)
        self.cfg = cfg

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig, state: Mapping[str, Any]):
        """Build the module around the tensors of ``state`` (no copy)."""
        return cls(cfg, nest_state(state))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def _block_kind(cfg: ModelConfig) -> str:
    if cfg.family in ("dense", "vlm"):
        return "dense"
    if cfg.family in ("moe", "ssm", "hybrid"):
        return cfg.family
    raise ValueError(cfg.family)


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The hybrid's shared block is a dense attention + MLP block."""
    return dataclasses.replace(cfg, family="dense")


def _hybrid_groups(cfg: ModelConfig):
    """``(attn_every, n_full, tail)``: full groups of ``attn_every`` mamba
    layers and the layers left over."""
    k = cfg.attn_every
    n_full = cfg.num_layers // k
    return k, n_full, cfg.num_layers - n_full * k


def n_shared_invocations(cfg: ModelConfig) -> int:
    if cfg.family != "hybrid" or not cfg.attn_every:
        return 0
    _, n_full, tail = _hybrid_groups(cfg)
    return n_full + (1 if tail else 0)


def init_params(cfg: ModelConfig, seed: int, *, device=None) -> LM:
    """Random weights from ``seed``, drawn on ``device`` by one explicit
    ``torch.Generator`` (N(0, 1/fan_in) matrices, unit norms). On the
    ``meta`` device nothing is allocated (the dry run's counts)."""
    kind = _block_kind(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    embed = L.init_embed(cfg, gen, dev)
    if kind in ("ssm", "hybrid"):
        layers = [{"mamba": S.init_mamba(cfg, gen, dev)}
                  for _ in range(cfg.num_layers)]
    elif kind == "moe":
        layers = [{"attn": L.init_attn(cfg, gen, dev),
                   "moe": M.init_moe(cfg, gen, dev)}
                  for _ in range(cfg.num_layers)]
    else:
        layers = [{"attn": L.init_attn(cfg, gen, dev),
                   "mlp": L.init_mlp(cfg, gen, dev)}
                  for _ in range(cfg.num_layers)]
    tree = {"embed": embed, "layers": layers}
    if kind == "hybrid":
        scfg = _shared_cfg(cfg)
        tree["shared"] = {"attn": L.init_attn(scfg, gen, dev),
                          "mlp": L.init_mlp(scfg, gen, dev)}
    return LM(cfg, tree)


# --------------------------------------------------------------------------
# full-sequence forward (loss / prefill)


def stack_forward(cfg: ModelConfig, params: LM, x, positions, *,
                  collect_cache: bool = False, attn_impl: str | None = None,
                  ssd_impl: str | None = None, gmm_impl: str | None = None):
    """Run the whole layer stack. Returns ``(h, aux_loss_sum, cache_ys)``;
    cache_ys (when ``collect_cache``, else ``()``):

      dense/moe: ``(k, v)`` stacked over layers, each ``(L, B, S, KV, hd)``;
      ssm:       ``(ssm_state, tail_x, tail_bc)`` stacked over layers;
      hybrid:    ``{ssm, conv_x, conv_bc, k, v}``, k/v stacked over the
                 shared block's invocations.

    ``aux_loss_sum`` is the moe layers' load-balance loss summed (0 for the
    other families). ``attn_impl`` / ``ssd_impl`` / ``gmm_impl`` pick the
    attention, scan and expert-product routes (None: the kernels on CUDA
    tensors)."""
    kind = _block_kind(cfg)
    if kind == "hybrid":
        return _hybrid_forward(cfg, params, x, positions,
                               collect_cache=collect_cache,
                               attn_impl=attn_impl, ssd_impl=ssd_impl)
    h = x
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
        elif kind == "moe":
            h, layer_aux = M.moe_forward(cfg, lp["moe"], h,
                                         gmm_impl=gmm_impl)
            aux = aux + layer_aux
    if not collect_cache:
        return h, aux, ()
    return h, aux, tuple(torch.stack(t) for t in zip(*ys))


def _hybrid_forward(cfg: ModelConfig, params: LM, x, positions, *,
                    collect_cache: bool, attn_impl: str | None,
                    ssd_impl: str | None):
    """The hybrid stack: for each group, the shared block, then its mamba
    layers (``attn_every`` of them; the tail group has the rest)."""
    k = cfg.attn_every
    scfg = _shared_cfg(cfg)
    shared, layers = params["shared"], params["layers"]
    h = x
    kvs, states = [], []
    for gi in range(n_shared_invocations(cfg)):
        out = L.attn_forward(scfg, shared["attn"], h, positions,
                             return_kv=collect_cache, attn_impl=attn_impl)
        h, kv = out if collect_cache else (out, None)
        kvs.append(kv)
        h = L.mlp_forward(scfg, shared["mlp"], h)
        for lp in layers[gi * k:(gi + 1) * k]:
            out = S.mamba_forward(cfg, lp["mamba"], h,
                                  return_state=collect_cache,
                                  ssd_impl=ssd_impl)
            h, st = out if collect_cache else (out, None)
            states.append(st)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if not collect_cache:
        return h, aux, ()
    st, tx, tbc = (torch.stack(t) for t in zip(*states))
    kk, vv = (torch.stack(t) for t in zip(*kvs))
    return h, aux, {"ssm": st, "conv_x": tx, "conv_bc": tbc, "k": kk,
                    "v": vv}


def embed_inputs(cfg: ModelConfig, params: LM, batch):
    """Token embeddings and positions. The vision frontend's stub: where
    ``cfg.modality == "vision"`` and the batch holds ``patch_embeds`` ``(B,
    n_patch, d)``, those replace the first ``n_patch`` token embeddings,
    cast to the model's dtype."""
    x = L.embed_tokens(cfg, params["embed"], batch["tokens"])
    if cfg.modality == "vision" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def loss_forward(cfg: ModelConfig, params: LM, batch, *,
                 attn_impl: str | None = None, ssd_impl: str | None = None,
                 gmm_impl: str | None = None):
    """The stateless forward and its loss: ``(sum_loss, count, aux)`` as the
    reference returns them (``aux`` is the moe load-balance loss, 0 for the
    other families). The ``*_impl`` pick the routes as in
    ``stack_forward``. The kernel routes are forward-only and raise if
    asked for a gradient; with ``"ref"`` the loss is differentiable, as
    ``make_train_step`` uses it."""
    x, positions = embed_inputs(cfg, params, batch)
    h, aux, _ = stack_forward(cfg, params, x, positions, attn_impl=attn_impl,
                              ssd_impl=ssd_impl, gmm_impl=gmm_impl)
    s, c = L.lm_loss(cfg, params["embed"], h, batch["labels"])
    return s, c, aux


# --------------------------------------------------------------------------
# training step (microbatched gradient accumulation + optimizer)

AUX_COEF = 0.01


def trainable(params: LM) -> Dict[str, torch.Tensor]:
    """The leaves the train step differentiates and updates, by name (the
    optimizer's tree): ``opt.init(trainable(params))``."""
    return dict(params.named_parameters())


def value_and_grad(params: LM, loss_fn):
    """``(loss, grads)`` of ``loss_fn() -> scalar`` with respect to
    ``trainable(params)``, grads by name in each leaf's dtype (zeros for a
    leaf the loss does not reach). The leaves are frozen; they are marked
    for the gradient for this call only."""
    leaves = trainable(params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss = loss_fn()
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    grads = {n: torch.zeros_like(t) if gi is None else gi
             for (n, t), gi in zip(leaves.items(), g)}
    return loss.detach(), grads


def apply_to(params: LM, updates) -> LM:
    """Add ``updates`` (by name) to the LM's leaves in place, each result
    cast to its leaf's dtype: the reference's ``apply_updates``."""
    with torch.no_grad():
        for n, t in trainable(params).items():
            t.copy_((t + updates[n]).to(t.dtype))
    return params


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    num_microbatches: int = 1, *, loss_fwd=None):
    """The reference's microbatched gradient-accumulation step on one card:
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "gnorm"})``.

    ``loss_fwd(params, batch) -> (sum_loss, count, aux)`` defaults to the
    decoder-LM loss through the PLAIN routes of every family: the
    attention, the scan and the moe experts' ragged product
    (``attn_impl="ref"``, ``ssd_impl="ref"``, ``gmm_impl="ref"``). The
    reference's Pallas kernels have no ``custom_vjp``, so its gradient is
    autodiff of its plain versions, and the port's kernel routes are
    forward-only. On the card the experts' plain product is the loop over
    the groups (``gmm/ref.grouped_matmul_looped``), whose autograd needs no
    per-row weight gather; on the CPU the capacity buffers' einsums, as the
    reference trains off-TPU. The hybrid's shared block is one set of
    leaves, so its gradient is the sum over its invocations. The batch is
    split into ``num_microbatches`` row blocks whose gradients accumulate in
    f32; the global norm is clipped at ``cfg.max_grad_norm``. The LM's
    leaves are frozen; the step marks them for the gradient itself and
    writes the update into them in place (the reference returns new
    arrays), so ``params`` comes back as the same module. ``opt_state`` is
    ``opt.init(trainable(params))``."""
    if loss_fwd is None:
        def loss_fwd(p, b):
            return loss_forward(cfg, p, b, attn_impl="ref", ssd_impl="ref",
                                gmm_impl="ref")

    def train_step(params: LM, opt_state, batch):
        nm = num_microbatches
        rows = batch["labels"].shape[0]
        if rows % nm:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{nm} microbatches")
        mb = rows // nm
        count = (batch["labels"] >= 0).sum()
        denom = torch.clamp(count, min=1).to(torch.float32)
        grads = {n: torch.zeros_like(t, dtype=torch.float32)
                 for n, t in trainable(params).items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=denom.device)
        for i in range(nm):
            b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            part = {}

            def loss_fn():
                s, _, aux = loss_fwd(params, b)
                part["s"] = s.detach()
                return s / denom + AUX_COEF * aux / nm
            _, g = value_and_grad(params, loss_fn)
            for n, gi in g.items():
                grads[n] += gi.to(torch.float32)
            loss_sum = loss_sum + part["s"]
        total = sum(torch.sum(g * g) for g in grads.values())
        gnorm = torch.sqrt(total + 1e-12)
        scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-9), max=1.0)
        grads = {n: g * scale for n, g in grads.items()}
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state,
                                            trainable(params))
        apply_to(params, updates)
        return params, opt_state, {"loss": loss_sum / denom, "gnorm": gnorm}

    return train_step


# --------------------------------------------------------------------------
# lock-step cache, prefill and decode


def init_cache(cfg: ModelConfig, global_batch: int, seq_len: int = 0, *,
               prefilled: bool = False, kv_int8: bool = False, device=None):
    """Empty lock-step cache (zeros, positions -1): the state before the
    first token, or, with ``prefilled``, a placeholder at ``index =
    seq_len``. A dense or moe cache holds ``decode_mode``'s ``s_cache``
    slots for ``seq_len`` tokens (int8 with f32 scales when ``kv_int8``); an
    ssm cache has no sequence capacity and ignores ``seq_len`` and
    ``kv_int8``; a hybrid cache is the ssm cache and an fp KV cache over the
    shared block's invocations (``kv_int8`` ignored, as the reference's
    ``api.build`` ignores it there)."""
    kind = _block_kind(cfg)
    dev = resolve_device(device)
    B, nl = global_batch, cfg.num_layers
    dt = L.dtype_of(cfg)
    cache: Dict[str, Any] = {"index": torch.tensor(
        seq_len if prefilled else 0, dtype=torch.int32, device=dev)}

    def kv(n_layers, quant):
        s_c = L.decode_mode(cfg, B, seq_len)["s_cache"]
        shape = (n_layers, B, s_c, cfg.num_kv_heads, cfg.hd)
        kdt = torch.int8 if quant else dt
        cache["k"] = torch.zeros(shape, dtype=kdt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=kdt, device=dev)
        if quant:
            sshape = shape[:-1] + (1,)
            cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=dev)
            cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=dev)
        cache["pos"] = torch.full((s_c,), -1, dtype=torch.int32, device=dev)

    if kind in ("dense", "moe"):
        kv(nl, kv_int8)
        return cache
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    W, gn2 = cfg.ssm_conv - 1, 2 * cfg.ssm_groups * cfg.ssm_state
    cache["ssm"] = torch.zeros((nl, B, H, Pd, N), dtype=torch.float32,
                               device=dev)
    cache["conv_x"] = torch.zeros((nl, B, W, cfg.d_inner), dtype=dt,
                                  device=dev)
    cache["conv_bc"] = torch.zeros((nl, B, W, gn2), dtype=dt, device=dev)
    if kind == "hybrid":
        kv(n_shared_invocations(cfg), False)
    return cache


def _pack_kv(k, v, S_: int, mode):
    """Prefill k/v ``(L, B, S_, KV, hd)`` -> the cache layout of ``mode``
    and its ``pos`` array. Kind "W" keeps the last ``s_cache`` positions,
    each in ring slot ``pos % s_cache``; kind "A" pads with empty slots."""
    s_c = mode["s_cache"]
    dev = k.device
    if mode["kind"] == "W":
        keepn = min(s_c, S_)
        pos = torch.arange(S_ - keepn, S_, device=dev)
        slots = pos % s_c

        def ring(a):
            out = a.new_zeros(a.shape[:2] + (s_c,) + a.shape[3:])
            out[:, :, slots] = a[:, :, S_ - keepn:]
            return out
        posarr = torch.full((s_c,), -1, dtype=torch.int32, device=dev)
        posarr[slots] = pos.to(torch.int32)
        return ring(k), ring(v), posarr
    pad = s_c - S_
    if pad < 0:
        raise ValueError(f"a prompt of {S_} tokens does not fit a cache of "
                         f"{s_c} slots")
    posarr = torch.cat([torch.arange(S_, dtype=torch.int32, device=dev),
                        torch.full((pad,), -1, dtype=torch.int32,
                                   device=dev)])
    return (F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad)),
            posarr)


def make_prefill(cfg: ModelConfig, seq_len: int | None = None, *,
                 kv_int8: bool = False, attn_impl: str | None = None,
                 ssd_impl: str | None = None, gmm_impl: str | None = None):
    """Lock-step prefill: ``prefill(params, batch) -> (logits, cache)``,
    logits of the last token ``(B, V_pad)`` f32 and the cache of
    ``init_cache``'s layout at ``index = S``. A KV cache is laid out for
    ``seq_len`` tokens (the prompt's length when None), quantised to int8
    when ``kv_int8`` (dense and moe). ``attn_impl`` / ``ssd_impl`` /
    ``gmm_impl`` pick the routes (None: the kernels on CUDA tensors;
    ``"ref"`` for the on-card comparison)."""
    kind = _block_kind(cfg)

    def prefill(params: LM, batch):
        x, positions = embed_inputs(cfg, params, batch)
        B, S_ = x.shape[:2]
        h, _, ys = stack_forward(cfg, params, x, positions,
                                 collect_cache=True, attn_impl=attn_impl,
                                 ssd_impl=ssd_impl, gmm_impl=gmm_impl)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, -1])
        cache: Dict[str, Any] = {"index": torch.tensor(
            S_, dtype=torch.int32, device=x.device)}
        mode = L.decode_mode(cfg, B, S_ if seq_len is None else seq_len)
        if kind in ("dense", "moe"):
            k, v = ys
            if kv_int8:
                (kq, ks), (vq, vs) = L.kv_quantize(k), L.kv_quantize(v)
                cache["k"], cache["v"], cache["pos"] = _pack_kv(kq, vq, S_,
                                                                mode)
                cache["k_scale"], cache["v_scale"], _ = _pack_kv(ks, vs, S_,
                                                                 mode)
            else:
                cache["k"], cache["v"], cache["pos"] = _pack_kv(k, v, S_,
                                                                mode)
        elif kind == "hybrid":
            cache.update(ssm=ys["ssm"], conv_x=ys["conv_x"],
                         conv_bc=ys["conv_bc"])
            cache["k"], cache["v"], cache["pos"] = _pack_kv(
                ys["k"], ys["v"], S_, mode)
        else:
            cache["ssm"], cache["conv_x"], cache["conv_bc"] = ys
        return logits, cache

    return prefill


def _mamba_decode_into(cfg: ModelConfig, lp, h, cache, i: int):
    """Mamba layer ``i``'s decode step, its states written into the cache
    in place."""
    h, st, tx, tbc = S.mamba_decode(cfg, lp["mamba"], h, cache["ssm"][i],
                                    cache["conv_x"][i], cache["conv_bc"][i])
    cache["ssm"][i].copy_(st)
    cache["conv_x"][i].copy_(tx)
    cache["conv_bc"][i].copy_(tbc)
    return h


def make_decode(cfg: ModelConfig, *, gmm_impl: str | None = None):
    """Lock-step decode: ``decode(params, cache, token) -> (logits,
    cache')`` for ONE new token ``(B, 1)`` of every row. The states (k/v,
    their int8 scales and ``pos``; the ssm states) are written into
    ``cache``'s tensors in place; ``cache'`` holds them and the advanced
    index. A KV cache's layout is read off the cache itself. ``gmm_impl``
    picks the moe experts' route as in ``stack_forward``."""
    kind = _block_kind(cfg)

    def decode(params: LM, cache, token):
        index = cache["index"]
        h = L.embed_tokens(cfg, params["embed"], token)       # (B, 1, d)
        if kind in ("dense", "moe"):
            k, v = cache["k"], cache["v"]
            mode = L.decode_mode(cfg, k.shape[1], k.shape[2] - 1)
            quant = "k_scale" in cache
            for i, lp in enumerate(params["layers"]):
                scales = (dict(k_scale=cache["k_scale"][i],
                               v_scale=cache["v_scale"][i]) if quant
                          else {})
                h = L.attn_decode(cfg, lp["attn"], h, k[i], v[i],
                                  cache["pos"], index, mode, **scales)
                if kind == "moe":
                    h, _ = M.moe_forward(cfg, lp["moe"], h,
                                         gmm_impl=gmm_impl)
                else:
                    h = L.mlp_forward(cfg, lp["mlp"], h)
        elif kind == "hybrid":
            k, v = cache["k"], cache["v"]
            scfg = _shared_cfg(cfg)
            mode = L.decode_mode(scfg, k.shape[1], k.shape[2] - 1)
            shared, layers = params["shared"], params["layers"]
            every = cfg.attn_every
            for gi in range(n_shared_invocations(cfg)):
                h = L.attn_decode(scfg, shared["attn"], h, k[gi], v[gi],
                                  cache["pos"], index, mode)
                h = L.mlp_forward(scfg, shared["mlp"], h)
                for i in range(gi * every,
                               min((gi + 1) * every, cfg.num_layers)):
                    h = _mamba_decode_into(cfg, layers[i], h, cache, i)
        else:
            for i, lp in enumerate(params["layers"]):
                h = _mamba_decode_into(cfg, lp, h, cache, i)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, 0])
        return logits, dict(cache, index=index + 1)

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
        h, _, (k, v) = stack_forward(cfg, params, x, positions,
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
    kind = _block_kind(cfg)

    def decode(params: LM, cache, token, active):
        index = cache["index"]
        h = L.embed_tokens(cfg, params["embed"], token)
        pos = cache["pos"]
        for i, lp in enumerate(params["layers"]):
            h, _, _, pos = L.attn_decode_slots(
                cfg, lp["attn"], h, cache["k"][i], cache["v"][i], pos, index,
                active)
            if kind == "moe":
                h, _ = M.moe_forward(cfg, lp["moe"], h)
            else:
                h = L.mlp_forward(cfg, lp["mlp"], h)
        logits = L.lm_logits_last(cfg, params["embed"], h[:, 0])
        new_cache = dict(cache, pos=pos,
                         index=index + active.to(index.dtype))
        return logits, new_cache

    return decode
