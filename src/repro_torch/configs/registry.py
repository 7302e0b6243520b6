"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro/configs/registry.py``. Every id of the reference resolves,
as there: the dense, vision (``phi3_vision_4_2b``), ssm, moe, hybrid and
encoder-decoder (``seamless_m4t_medium``) archs.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "glm4_9b",
    "phi3_vision_4_2b",
    "qwen3_moe_235b_a22b",
    "mixtral_8x7b",
    "qwen3_14b",
    "seamless_m4t_medium",
    "granite_3_8b",
    "zamba2_7b",
    "moonshot_v1_16b_a3b",
    "mamba2_2_7b",
]

# CLI ids (dashes) -> module names
ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
ALIASES.update({
    "glm4-9b": "glm4_9b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-14b": "qwen3_14b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "granite-3-8b": "granite_3_8b",
    "zamba2-7b": "zamba2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-2.7b": "mamba2_2_7b",
})


# long_500k applicability: "native" (sub-quadratic as published), "window"
# (run with the documented sliding-window variant), or "skip"
LONG_CONTEXT = {
    "mamba2_2_7b": "native",
    "zamba2_7b": "native",
    "mixtral_8x7b": "native",        # its sliding window is the arch's own
    "glm4_9b": "window",
    "qwen3_14b": "window",
    "granite_3_8b": "window",
    "qwen3_moe_235b_a22b": "window",
    "phi3_vision_4_2b": "window",
    "moonshot_v1_16b_a3b": "window",
    "seamless_m4t_medium": "skip",   # an encoder-decoder speech model
}

LONG_WINDOW = 4096


def normalize(arch_id: str) -> str:
    key = arch_id.replace("_", "-").lower()
    if key in ALIASES:
        return ALIASES[key]
    if arch_id in ARCH_IDS:
        return arch_id
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALIASES)}")


def get_config(arch_id: str, *, reduced: bool = False,
               long_context: bool = False) -> ModelConfig:
    """The config of ``arch_id``. ``long_context`` gives the full-size
    sliding-window variant (``attn_window=LONG_WINDOW``, name ``+swa``)
    of the archs that run long contexts that way, as the reference does:
    the dense family's way into the ring cache (kind "W"). An arch that
    does not run long contexts (``"skip"``) raises ValueError there, as in
    the reference."""
    name = normalize(arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.REDUCED if reduced else mod.CONFIG
    if long_context and not reduced:
        if LONG_CONTEXT[name] == "skip":
            raise ValueError(f"{arch_id}: long_500k not applicable")
        if LONG_CONTEXT[name] == "window" and not cfg.attn_window:
            cfg = dataclasses.replace(cfg, attn_window=LONG_WINDOW,
                                      name=cfg.name + "+swa")
    return cfg
