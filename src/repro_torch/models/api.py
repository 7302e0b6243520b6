"""Step entry points: the serving subset of ``repro/models/api.py``.

The reference wraps each step in ``shard_map`` + ``jit`` and counts traces.
PyTorch runs eagerly, so a bundle's ``fn`` is a plain callable on a device
that counts the distinct input shapes it has seen (``shape_count``). That
keeps the serving invariants assertable: one decode shape forever and at
most one prefill shape per prompt bucket.

``build`` makes the lock-step prefill and decode steps (the ssm family's
serving path); ``build_serve_prefill`` / ``build_serve_decode`` make the
slot-pool steps of the continuous-batching serve tier (the dense family).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import lm as LM
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.utils.shape_stats import ShapeCounted


@dataclasses.dataclass
class StepBundle:
    kind: str
    fn: ShapeCounted
    cfg: ModelConfig
    shape: InputShape
    device: torch.device


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


def build(cfg: ModelConfig, shape: InputShape, *, device=None,
          ssd_impl: str | None = None) -> StepBundle:
    """The lock-step step of ``shape.kind``:

    * ``"prefill"``: ``bundle.fn(params, batch) -> (logits, cache)``, batch
      ``{"tokens": (B, S)}``; ``ssd_impl="ref"`` runs the plain scan instead
      of the kernel (for the on-card comparison only);
    * ``"decode"``: ``bundle.fn(params, cache, token) -> (logits, cache')``
      for one token ``(B, 1)``; the cache's states are updated in place,
      where the reference donates the cache to its jit.

    ``"train"`` is not ported: the scan kernel has no backward yet."""
    dev = resolve_device(device)
    if shape.kind == "prefill":
        fn = LM.make_prefill(cfg, ssd_impl=ssd_impl)
    elif shape.kind == "decode":
        fn = LM.make_decode(cfg)
    elif shape.kind == "train":
        raise NotImplementedError(
            "the train step is not ported to repro_torch yet: it needs "
            "backward kernels (ssd, flash attention); see ROADMAP.md, open "
            "items")
    else:
        raise ValueError(f"unknown step kind {shape.kind!r}")
    return StepBundle(shape.kind, ShapeCounted(fn), cfg, shape, dev)


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
