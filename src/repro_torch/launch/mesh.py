"""Mesh construction: the port of ``repro/launch/mesh.py``.

Functions, not module-level constants, so that importing this module
touches no device.

* ``make_local_mesh()``: every local card on one ``("data",)`` axis, the
  counterpart of the reference's ``make_production_mesh`` (the TPU pod's
  mesh) on one host with cards.
* ``make_smoke_mesh()``: a 1 x 1 ``("data", "model")`` mesh.
* ``make_mesh(n)``: ``n`` cards, ``cuda:0`` to ``cuda:n-1``; more than the
  host has raises, as the reference's ``--mesh N`` does. Only when asked
  with ``device=`` does it stand ``n`` entries of that one device in for
  ``n`` devices (the counterpart of the reference's
  ``--xla_force_host_platform_device_count``): the CPU tests and the card's
  smoke test shard that way, and nothing falls back to it on its own.
"""
from __future__ import annotations

import torch

from repro_torch.core.roles import Mesh


def make_mesh(n: int, device=None) -> Mesh:
    """A 1-d mesh of ``n`` entries: the first ``n`` cards, or, with
    ``device``, ``n`` stand-ins of that one device."""
    n = int(n)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh([dev] * n, ("data",))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise RuntimeError(
            f"a mesh of {n} cards asked for, {have} available; pass "
            "device= to stand one device in for several")
    return Mesh([torch.device("cuda", i) for i in range(n)], ("data",))


def make_local_mesh(device=None) -> Mesh:
    """Every local card on one ``("data",)`` axis; with ``device``, a
    mesh of that one device (``device="cpu"``: the CPU host)."""
    if device is not None:
        return make_mesh(1, device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a local mesh; pass "
                           "device='cpu' for a mesh of the CPU")
    return make_mesh(torch.cuda.device_count())


def make_smoke_mesh(device=None) -> Mesh:
    """1 x 1 mesh (same code path, trivial splits): the first card, or
    ``device``."""
    dev = torch.device("cuda", 0) if device is None else device
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the smoke mesh; pass "
                           "device='cpu'")
    return Mesh([[dev]], ("data", "model"))
