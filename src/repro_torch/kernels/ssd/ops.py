"""Dispatching wrapper for the Mamba-2 SSD scan: the port of
``repro/kernels/ssd/ops.py``.

``ssd(x, dt, A, B_, C, *, chunk, initial_state, return_final_state,
impl)`` keeps the contract of ``ref.ssd_chunked``. ``impl``:

* None: the kernel on CUDA tensors, ``ref`` on CPU tensors. A CUDA tensor
  reaches ``ref`` only when the caller names ``impl="ref"``, as the on-card
  comparison does.
* ``"cuda"``: the hand-written kernel (``cuda.py``). Unlike the reference's
  Pallas kernel, which asserts that it is given no state, it takes the
  initial state and returns the final one, so the stateful prefill runs on
  it as well as the stateless forward.
* ``"ref"``: the plain version, differentiable.

The kernel route is forward-only, like the Pallas kernel, which has no VJP:
it runs inside ``SSDChunked``, whose backward raises. ``launches`` counts
the kernel launches made here, so a run can show that its path went through
the kernel. Single-token decode has no kernel in the reference either:
``ssd_decode_step`` and ``ssd_sequential`` are the plain versions.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.ssd import cuda, ref

launches = 0    # ssd_chunked, one per scan through the kernel
# the count stays exact when threads launch at once
_count_lock = threading.Lock()

ssd_decode_step = ref.ssd_decode_step
ssd_sequential = ref.ssd_sequential


class SSDChunked(torch.autograd.Function):
    """The kernel's forward; asking it for a gradient raises."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C, initial_state, chunk,
                return_final_state):
        global launches
        out = cuda.ssd_chunked(x, dt, A, B_, C, chunk=chunk,
                               initial_state=initial_state,
                               return_final_state=return_final_state)
        with _count_lock:
            launches += 1
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the ssd_chunked kernel is forward-only, like the reference's "
            "Pallas kernel: Mamba training needs an ssd backward kernel "
            "(ROADMAP.md, open items); differentiate the plain version with "
            "impl='ref' meanwhile")


def ssd(x, dt, A, B_, C, *, chunk: int = 128, initial_state=None,
        return_final_state: bool = False, impl: str | None = None):
    """The SSD scan; see the module docstring for ``impl``. Returns y
    (B, L, H, P) in x's dtype, and the final state (B, H, P, N) f32 when
    ``return_final_state``."""
    if impl is None:
        impl = "cuda" if x.is_cuda else "ref"
    if impl == "ref":
        return ref.ssd_chunked(x, dt, A, B_, C, chunk=chunk,
                               initial_state=initial_state,
                               return_final_state=return_final_state)
    if impl != "cuda":
        raise ValueError(f"unknown ssd impl {impl!r}")
    contig = [t.contiguous() for t in (x, dt, A, B_, C)]
    if initial_state is not None:
        initial_state = initial_state.contiguous()
    return SSDChunked.apply(*contig, initial_state, chunk,
                            return_final_state)
