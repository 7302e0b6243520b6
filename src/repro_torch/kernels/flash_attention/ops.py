"""Dispatching wrapper for attention.

``attention(...)`` launches the Hopper kernel (``cuda.py``) on CUDA
tensors and runs the plain PyTorch ``ref.chunked_attention`` on CPU
tensors. A CUDA tensor never reaches the plain version unless the caller
names ``impl="ref"``, which the on-card comparison does. ``launches``
counts the kernel launches made here, so a run can show that its path went
through the kernel.

The kernel route is forward-only: it runs inside ``FlashAttention``, whose
backward raises, so a gradient through it fails loudly instead of losing
the attention term. ``impl="ref"`` is differentiable, as the reference's
``ref`` route is.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.flash_attention import cuda, ref

launches = 0
# the count stays exact when threads launch at once
_count_lock = threading.Lock()


class FlashAttention(torch.autograd.Function):
    """The kernel's forward; asking it for a gradient raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        global launches
        out = cuda.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
        with _count_lock:
            launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the flash_attention kernel is forward-only: attention has no "
            "backward kernel yet (ROADMAP.md, open items); differentiate "
            "the plain version with impl='ref' meanwhile")


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, impl: str | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    ``impl``: None picks by device (kernel on CUDA, ref on CPU); "cuda"
    insists on the kernel; "ref" runs the plain version anywhere. Sq > Sk
    (cross-attention) is taken without the causal mask, where every query
    row sees every key, and refused with it."""
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f"attention needs Sq <= Sk (got {q.shape[1]} > "
                         f"{k.shape[1]}): a query row left without any key "
                         "has no defined output")
    if impl == "ref" or (impl is None and not q.is_cuda):
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return FlashAttention.apply(q, k, v, causal, window, scale)
