"""Architecture configs (port of ``repro/configs``); ``get_config`` resolves ``--arch``."""
from repro_torch.configs.registry import ARCH_IDS, get_config, normalize

__all__ = ["ARCH_IDS", "get_config", "normalize"]
