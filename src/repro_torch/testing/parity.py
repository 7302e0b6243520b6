"""Converters from the reference's parameter pytrees to the port's.

The tests build params with the JAX package, turn the tree into numpy
arrays (``np.asarray`` on the JAX side), and hand it here. Three layouts:

* the LM and the encoder-decoder (``state_from_jax``): each stacked
  layer axis is unstacked into the port's per-layer ``ModuleList``, so
  ``layers/attn/wq[i]`` becomes ``layers.i.attn.wq`` (a moe layer's
  ``layers/moe/we1[i]`` ``layers.i.moe.we1``, the encdec's
  ``dec_layers/cross/wq[i]`` ``dec_layers.i.cross.wq``); the hybrid's
  ``shared`` block and the encdec's ``enc_ln`` keep their trees;
* the transformer world model (``world_model_from_jax``): a
  ``WorldModelDynamics``' LM parameters, normaliser and Adam state, the
  moments keyed by the port's parameter names;
* the MBRL trees (``tree_from_jax`` / ``tree_to_numpy``): the dynamics
  ensemble ``{"members": {"w": [(K,a,b) ...], "b": [...]}, "norm": {...}}``
  and the policy ``{"w": [...], "b": [...], "log_std": ...}`` keep their
  dict and list structure leaf for leaf.

Weights are carried across through these; the port never re-derives a
``jax.random`` draw. This module imports no JAX: bf16 leaves arrive as
numpy ``bfloat16`` arrays (ml_dtypes) and are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.models import lm as LM
from repro_torch.optim.optimizers import AdamState
from repro_torch.utils.tree import tree_map


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]):
    for name, val in tree.items():
        key = f"{prefix}{name}"
        if isinstance(val, Mapping):
            _flatten(val, key + ".", out)
        else:
            out[key] = val


# the reference's parameter groups: kept whole, or stacked on axis 0 over
# the layers (the decoder LM's ``layers``, the encdec's two stacks)
WHOLE_GROUPS = ("embed", "shared", "enc_ln")
STACKED_GROUPS = ("layers", "enc_layers", "dec_layers")


def state_from_jax(tree: Mapping[str, Any], device="cpu"
                   ) -> Dict[str, torch.Tensor]:
    """A reference parameter tree of numpy arrays -> the port's
    ``state_dict()`` layout. The LM's ``{"embed", "layers"[, "shared"]}``
    gives ``embed.table``, ``layers.0.attn.wq``, ``shared.attn.wq``...;
    the encdec's ``{"embed", "enc_layers", "dec_layers", "enc_ln"}`` gives
    ``enc_layers.0.attn.wq``, ``dec_layers.0.cross.wq``, ``enc_ln``...
    (``lm.LM.from_state_dict`` and ``lm.nest_state`` build the modules)."""
    extra = set(tree) - set(WHOLE_GROUPS) - set(STACKED_GROUPS)
    if extra:
        raise ValueError(f"no port for parameter groups {sorted(extra)}")
    flat: Dict[str, Any] = {}
    for group in WHOLE_GROUPS:
        if isinstance(tree.get(group), Mapping):
            _flatten(tree[group], group + ".", flat)
        elif group in tree:
            flat[group] = tree[group]
    for group in STACKED_GROUPS:
        if group not in tree:
            continue
        stacked: Dict[str, Any] = {}
        _flatten(tree[group], "", stacked)
        n_layers = {np.asarray(v).shape[0] for v in stacked.values()}
        if len(n_layers) != 1:
            raise ValueError(f"stacked {group} leaves disagree on depth: "
                             f"{n_layers}")
        for i in range(n_layers.pop()):
            for key, val in stacked.items():
                flat[f"{group}.{i}.{key}"] = np.asarray(val)[i]
    return {k: to_tensor(v, device) for k, v in flat.items()}


def tree_from_jax(tree, device="cpu"):
    """A numpy tree (dicts, lists, tuples) -> the same tree of tensors."""
    return tree_map(lambda a: to_tensor(a, device), tree)


def tree_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def world_model_from_jax(wm, params, norm, opt_state, device="cpu"):
    """Carry a reference ``WorldModelDynamics``' state, given as numpy
    trees (its ``params``, ``norm`` and ``opt_state``, an
    ``AdamState(step, mu, nu)`` over the params' tree), into the port's
    ``wm`` in place, and return ``wm``."""
    wm.params = LM.LM.from_state_dict(wm.mcfg, state_from_jax(params, device))
    wm.norm = {k: to_tensor(v, device) for k, v in norm.items()}
    step, mu, nu = opt_state
    names = list(LM.trainable(wm.params))
    mu, nu = state_from_jax(mu, device), state_from_jax(nu, device)
    wm.opt_state = AdamState(to_tensor(step, device),
                             {n: mu[n] for n in names},
                             {n: nu[n] for n in names})
    return wm
