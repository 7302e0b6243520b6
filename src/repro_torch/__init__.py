"""PyTorch port of the ``repro`` package for one NVIDIA H100.

The JAX package ``src/repro/`` is the reference; each module here mirrors
the module of the same path there. Plain tensor code is PyTorch, and every
Pallas TPU kernel on a ported path is a hand-written Hopper kernel under
``kernels/<family>/csrc/``. Nothing here imports ``jax`` or ``repro``.

Entry points take ``device=None``, which means CUDA: they raise when no GPU
is present unless the caller passes ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run on the CPU explicitly")
    return dev
