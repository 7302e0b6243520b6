"""Architecture registry: ``--arch <id>`` resolves here.

Port of ``repro/configs/registry.py``. Every id of the reference resolves,
but only the dense decoders of the serving path and the pure-ssm
Mamba2 are ported so far; the others raise and point at ROADMAP.md, which
lists what is still to port.
"""
from __future__ import annotations

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

PORTED = {"glm4_9b", "granite_3_8b", "qwen3_14b", "mamba2_2_7b"}

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


def normalize(arch_id: str) -> str:
    key = arch_id.replace("_", "-").lower()
    if key in ALIASES:
        return ALIASES[key]
    if arch_id in ARCH_IDS:
        return arch_id
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ALIASES)}")


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    name = normalize(arch_id)
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet (ported: "
            f"{sorted(PORTED)}); see ROADMAP.md, open items")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.REDUCED if reduced else mod.CONFIG
