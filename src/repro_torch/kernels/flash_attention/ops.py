"""Dispatching wrapper for attention.

``attention(...)`` launches the Hopper kernel (``cuda.py``) on CUDA
tensors and runs the plain PyTorch ``ref.chunked_attention`` on CPU
tensors. A CUDA tensor never reaches the plain version unless the caller
names ``impl="ref"``, which the on-card comparison does. ``launches``
counts the kernel launches made here, so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import cuda, ref

launches = 0


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: float | None = None, impl: str | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D).

    ``impl``: None picks by device (kernel on CUDA, ref on CPU); "cuda"
    insists on the kernel; "ref" runs the plain version anywhere."""
    global launches
    if q.shape[1] > k.shape[1]:
        raise ValueError(f"attention needs Sq <= Sk (got {q.shape[1]} > "
                         f"{k.shape[1]}): a query row left without any key "
                         "has no defined output")
    if impl == "ref" or (impl is None and not q.is_cuda):
        return ref.chunked_attention(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown attention impl {impl!r}")
    out = cuda.flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    launches += 1
    return out
