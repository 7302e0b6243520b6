"""Dispatching wrapper for grouped matmul / ensemble MLP: the port of
``repro/kernels/gmm/ops.py``.

``grouped_matmul`` covers both layouts: equal-group batched (lhs 3-D) and
ragged (lhs 2-D + ``group_sizes``, rows sorted by group). With
``impl=None`` CUDA tensors go to the hand-written kernels (``cuda.py``) and
CPU tensors to the plain ``ref``; a CUDA tensor reaches ``ref`` only when
the caller names ``impl="ref"``, as the on-card comparison does.

Gradients. The reference has no backward rule of its own for either
kernel (``kernels/gmm/`` holds no ``custom_vjp``); its gradient is autodiff
of the plain products, which this reproduces:

* equal: both routes run inside a ``torch.autograd.Function`` that takes
  the grouped product as a parameter, so the CPU runs the same backward
  wiring with the plain product that the card runs with the kernel. The
  backward is the same kernel on transposed operands, ``dX = dY x W^T``
  and ``dW = X^T x dY``, each only when autograd asks for it.
* ragged: the plain route calls ``ref.grouped_matmul`` directly, so
  autograd runs through its gather as ``jax.grad`` runs through the
  reference's ``ref`` route. The kernel route runs inside
  ``RaggedGroupedMatmul``, whose backward recomputes the plain product on
  its saved inputs and returns autograd's vector-Jacobian product of it
  (the pattern of ``imag/ops.py``'s ``FusedStep``), until the ragged
  kernel has a backward kernel of its own.

The counters count kernel launches made here, the equal kernel's forward
and backward apart, so a run can show that its path went through them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gmm import cuda, ref

equal_launches = 0        # gmm_equal, forward products
equal_bwd_launches = 0    # gmm_equal, backward products (dX and dW)
ragged_launches = 0       # gmm_ragged


def _kernel_equal(a, b, backward: bool = False):
    global equal_launches, equal_bwd_launches
    out = cuda.gmm_equal(a, b)
    if backward:
        equal_bwd_launches += 1
    else:
        equal_launches += 1
    return out


def _ref_equal(a, b, backward: bool = False):
    return ref.grouped_matmul(a, b)


def _kernel_ragged(lhs, rhs, group_sizes):
    global ragged_launches
    # (G + 1,) row offsets, computed on the device: no host sync
    offsets = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=lhs.device),
        torch.cumsum(group_sizes, 0, dtype=torch.int32)])
    out = cuda.gmm_ragged(lhs.contiguous(), rhs.contiguous(), offsets)
    ragged_launches += 1
    return out


class EqualGroupedMatmul(torch.autograd.Function):
    """lhs (G, M, K) x rhs (G, K, N) through ``product(a, b, backward)``,
    with the backward as two more grouped products."""

    @staticmethod
    def forward(ctx, lhs, rhs, product):
        ctx.product = product
        ctx.save_for_backward(lhs, rhs)
        return product(lhs, rhs)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs = ctx.saved_tensors
        dy = dy.contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = ctx.product(dy, rhs.transpose(1, 2), backward=True)
        if ctx.needs_input_grad[1]:
            d_rhs = ctx.product(lhs.transpose(1, 2), dy, backward=True)
        return d_lhs, d_rhs, None


class RaggedGroupedMatmul(torch.autograd.Function):
    """Ragged lhs (M, K) x rhs (G, K, N) through ``product``, with
    autograd of the plain ``ref.grouped_matmul`` as the backward."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, product):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return product(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            # recompute on detached aliases of the inputs (no copy), so the
            # gradient stops at them
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip((lhs, rhs), need)]
            out = ref.grouped_matmul(*leaves, group_sizes)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(leaves, need) if n], dy))
        return tuple(next(grads) if n else None for n in need) + (None, None)


def _use_kernel(t: torch.Tensor, impl) -> bool:
    if impl is None:
        return t.is_cuda
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown grouped_matmul impl {impl!r}")
    return impl == "cuda"


def grouped_matmul(lhs, rhs, group_sizes=None, *, impl: str | None = None):
    """Equal-group (lhs 3-D, no sizes) or ragged (lhs 2-D + group_sizes)
    grouped matmul — same contract as ``ref.grouped_matmul``.

    ``impl``: None picks by device (kernel on CUDA, ref on CPU); "cuda"
    insists on the kernel; "ref" runs the plain version anywhere."""
    kernel = _use_kernel(lhs, impl)
    if group_sizes is None:
        return EqualGroupedMatmul.apply(
            lhs, rhs, _kernel_equal if kernel else _ref_equal)
    if not kernel:
        return ref.grouped_matmul(lhs, rhs, group_sizes)
    return RaggedGroupedMatmul.apply(lhs, rhs, group_sizes, _kernel_ragged)


def ensemble_mlp(members, x, *, impl: str | None = None):
    """K-member MLP forward on shared rows: (K, B, Dout)."""
    return ref.ensemble_mlp(
        members, x, matmul=lambda h, w: grouped_matmul(h, w, impl=impl))


def ensemble_mlp_select(members, x, idx, *, impl: str | None = None):
    """Forward row b through member ``idx[b]`` only. Same output as
    ``ensemble_mlp(members, x)[idx[b], b]`` for every b."""
    return ref.ensemble_mlp_select(
        members, x, idx,
        matmul=lambda h, w, sizes: grouped_matmul(h, w, sizes, impl=impl))
