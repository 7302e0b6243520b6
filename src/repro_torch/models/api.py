"""Step entry points: the one-card subset of ``repro/models/api.py``.

The reference wraps each step in ``shard_map`` + ``jit`` and counts traces.
PyTorch runs eagerly, so a bundle's ``fn`` is a plain callable on a device
that counts the distinct input shapes it has seen (``shape_count``). That
keeps the serving invariants assertable: one decode shape forever and at
most one prefill shape per prompt bucket.

``build`` makes the lock-step prefill and decode steps (the dense, vlm,
ssm, moe, hybrid and encdec families; fp or int8 KV caches on dense, vlm
and moe) and the microbatched train step (every family);
``build_serve_prefill`` / ``build_serve_decode`` make the slot-pool steps
of the continuous-batching serve tier (the dense, vlm and moe families;
the others raise ValueError, as in the reference);
``as_predict_fn`` pins a world model to the MBRL predict contract.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim.optimizers import adam
from repro_torch.utils.shape_stats import ShapeCounted


@dataclasses.dataclass
class StepBundle:
    kind: str
    fn: ShapeCounted
    cfg: ModelConfig
    shape: InputShape
    device: torch.device
    num_microbatches: int = 1


def pick_microbatches(cfg: ModelConfig, shape: InputShape,
                      target_tokens: int = 8192) -> int:
    """Microbatches of a train step: ``shape.microbatch`` if set, else the
    largest divisor of the batch that keeps about ``target_tokens`` a
    microbatch (the reference's rule at dp=1)."""
    if shape.kind != "train":
        return 1
    if shape.microbatch:
        return shape.microbatch
    b = max(shape.global_batch, 1)
    want = max(1, (b * shape.seq_len) // target_tokens)
    return max(c for c in range(1, b + 1) if b % c == 0 and c <= want)


def grow_cache(cache, to_len: int):
    """Grow a decode KV cache's sequence capacity to ``to_len`` slots.

    ``k``/``v`` (and int8 scales when present) gain zero slots on the
    sequence axis while ``pos`` gains EMPTY (-1) slots: a 0-padded pos would
    alias position 0 and corrupt the attention mask. Handles the lock-step
    layout (pos ``(S,)``) and the slot-pool layout (pos ``(B, S)``).
    Returns a shallow copy; the same tensors when already at ``to_len``.
    """
    if "k" not in cache or "pos" not in cache:
        raise ValueError("grow_cache needs an attention KV cache "
                         "(ssm/hybrid state caches have no seq capacity)")
    cur = cache["k"].shape[2]
    if to_len < cur:
        raise ValueError(f"grow_cache cannot shrink the cache "
                         f"({cur} -> {to_len})")
    pad = to_len - cur
    out = dict(cache)
    if pad == 0:
        return out
    for key in ("k", "v", "k_scale", "v_scale"):
        if key in cache:
            a = cache[key]
            out[key] = F.pad(a, (0, 0) * (a.dim() - 3) + (0, pad))
    out["pos"] = F.pad(cache["pos"], (0, pad), value=-1)
    return out


def _mod(cfg: ModelConfig):
    """The module of ``cfg``'s family: ``init_params``, ``init_cache``,
    ``make_prefill``, ``make_decode`` and ``loss_forward``."""
    return E if cfg.family == "encdec" else LM


def build(cfg: ModelConfig, shape: InputShape, *, device=None,
          kv_int8: bool = False, attn_impl: str | None = None,
          ssd_impl: str | None = None,
          gmm_impl: str | None = None) -> StepBundle:
    """The step of ``shape.kind``:

    * ``"prefill"``: ``bundle.fn(params, batch) -> (logits, cache)``, batch
      ``{"tokens": (B, S)}`` (with ``"enc_embeds"`` ``(B, S_enc, d)`` for
      the encdec family; optionally ``"patch_embeds"`` ``(B, n_patch, d)``
      for a vision model), the cache laid out for ``shape.seq_len``
      tokens (int8 when ``kv_int8``, dense, vlm and moe families).
      ``attn_impl="ref"`` / ``ssd_impl="ref"`` / ``gmm_impl="ref"`` run the
      plain attention / scan / expert products instead of the kernels (for
      the on-card comparison only);
    * ``"decode"``: ``bundle.fn(params, cache, token) -> (logits, cache')``
      for one token ``(B, 1)``; the cache is updated in place, where the
      reference donates it to its jit (``gmm_impl`` as for prefill);
    * ``"train"``: ``bundle.fn(params, opt_state, batch) -> (params,
      opt_state, {"loss", "gnorm"})`` with Adam at ``cfg.lr`` (``opt_state
      = adam(cfg.lr).init(LM.trainable(params))``) over
      ``pick_microbatches`` microbatches, through the plain attention,
      scan and moe expert products (``LM.make_train_step``; the encdec
      family's loss is ``encdec.loss_forward``). The ``*_impl`` arguments
      do not apply: the kernel routes are forward-only.

    The encdec family's params come from ``encdec.init_params`` (any
    family's: ``_mod(cfg).init_params``); it takes ``attn_impl`` only."""
    dev = resolve_device(device)
    nm = 1
    quant = kv_int8 and cfg.family in ("dense", "vlm", "moe")
    encdec = cfg.family == "encdec"
    if shape.kind == "prefill":
        fn = (E.make_prefill(cfg, shape.seq_len, attn_impl=attn_impl)
              if encdec else
              LM.make_prefill(cfg, shape.seq_len, kv_int8=quant,
                              attn_impl=attn_impl, ssd_impl=ssd_impl,
                              gmm_impl=gmm_impl))
    elif shape.kind == "decode":
        fn = (E.make_decode(cfg) if encdec
              else LM.make_decode(cfg, gmm_impl=gmm_impl))
    elif shape.kind == "train":
        nm = pick_microbatches(cfg, shape)
        loss_fwd = None
        if encdec:
            def loss_fwd(p, b):
                return E.loss_forward(cfg, p, b, attn_impl="ref")
        fn = LM.make_train_step(cfg, adam(cfg.lr), nm, loss_fwd=loss_fwd)
    else:
        raise ValueError(f"unknown step kind {shape.kind!r}")
    return StepBundle(shape.kind, ShapeCounted(fn), cfg, shape, dev, nm)


# --------------------------------------------------------------------------
# world-model plumbing: the predict_fn contract


def as_predict_fn(fn):
    """Pin ``fn`` to the world-model predict contract:
    ``predict(params, obs, act, generator) -> next_obs`` with
    ``next_obs.shape == obs.shape``.

    This is what ``mbrl.algos.make_algo(predict_fn=...)`` swaps in for the
    ensemble fast path. The wrapper checks the shape contract on every
    call (the reference checks it at trace time), so a world model that
    returns another state layout fails at swap-in, not deep in a rollout,
    and tags the callable (``is_predict_fn``) so engines can validate a
    handed-in model."""

    @functools.wraps(fn)
    def predict(params, obs, act, generator):
        out = fn(params, obs, act, generator)
        if out.shape != obs.shape:
            raise ValueError(
                f"predict_fn contract: next_obs shape {tuple(out.shape)} "
                f"!= obs shape {tuple(obs.shape)}")
        return out

    predict.is_predict_fn = True
    return predict


def build_serve_prefill(cfg: ModelConfig, global_batch: int, seq_len: int,
                        *, device=None, attn_impl: str | None = None
                        ) -> StepBundle:
    """Serve-tier prefill of ONE admission bucket at fixed shapes.

    ``bundle.fn(params, batch, prompt_len)`` -> (per-row last-REAL-token
    logits, slot-layout cache); ``prompt_len`` is (B,) int32 so shorter
    prompts right-pad into the bucket. ``attn_impl="ref"`` runs the plain
    attention instead of the kernel (for the on-card comparison only)."""
    dev = resolve_device(device)
    B, S = global_batch, seq_len
    shape = InputShape(f"serve-prefill-{S}", S, B, "prefill")
    fn = LM.make_prefill_slots(cfg, S, attn_impl=attn_impl)
    return StepBundle("serve_prefill", ShapeCounted(fn), cfg, shape, dev)


def build_serve_decode(cfg: ModelConfig, n_slots: int, seq_len: int, *,
                       device=None) -> StepBundle:
    """Serve-tier continuous-batching decode at (n_slots, seq_len).

    ``bundle.fn(params, cache, token, active)`` -> (logits, cache'); the
    cache's k/v/pos are updated in place."""
    dev = resolve_device(device)
    B, S = n_slots, seq_len
    shape = InputShape(f"serve-decode-{S}", S, B, "decode")
    fn = LM.make_decode_slots(cfg, S)
    return StepBundle("serve_decode", ShapeCounted(fn), cfg, shape, dev)
