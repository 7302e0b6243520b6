"""Dispatching wrapper for grouped matmul / ensemble MLP: the port of
``repro/kernels/gmm/ops.py``.

``grouped_matmul`` covers both layouts: equal-group batched (lhs 3-D) and
ragged (lhs 2-D + ``group_sizes``, rows sorted by group). With
``impl=None`` CUDA tensors go to the hand-written kernels (``cuda.py``) and
CPU tensors to the plain ``ref``; a CUDA tensor reaches ``ref`` only when
the caller names ``impl="ref"``, as the on-card comparison does.

Gradients. The reference has no backward rule of its own for either
kernel (``kernels/gmm/`` holds no ``custom_vjp``); its gradient is autodiff
of the plain products, to any order (MB-MPO's inner step differentiates
a gradient again). The port reproduces that with Functions whose backward
is built from Functions, each taking its products as a parameter, so the
CPU can run the card's wiring with the plain products injected:

* equal: ``EqualGroupedMatmul`` (both routes). Its backward is the same
  Function on transposed views, ``dX = dY x W^T`` and ``dW = X^T x dY``.
* ragged, kernel route: ``RaggedGroupedMatmul`` R, ``y = R(x, W)`` (row m
  of group g times ``W[g]``), and ``RaggedTransposedMatmul`` T,
  ``T(a, b)[g] = a[rows of g]^T x b[rows of g]``. R's backward is
  ``dx = R(dy, W^T)`` (the weights read transposed in place) and
  ``dW = T(x, dy)``; T's is ``da = R(b, dZ^T)`` and ``db = R(a, dZ)``. So
  the two are closed under differentiation.
* ragged, plain route: autograd through ``ref.grouped_matmul``'s gather,
  as ``jax.grad`` runs through the reference's ``ref`` route. It is the
  independent yardstick the card holds the Functions to.

Each backward computes only the operands ``needs_input_grad`` asks for.
Offsets stay on the device and no size is read on the host.

The counters count kernel launches made here, so a run can show that its
path went through them: the equal kernel's forward and backward products
apart, and the ragged kernel's forward products, its products inside a
backward (``dx``, and T's backward), and ``gmm_ragged_dw`` (``dW``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.gmm import cuda, ref

equal_launches = 0        # gmm_equal, forward products
equal_bwd_launches = 0    # gmm_equal, backward products (dX and dW)
ragged_launches = 0       # gmm_ragged, forward products
ragged_bwd_launches = 0   # gmm_ragged inside a backward (dx)
ragged_dw_launches = 0    # gmm_ragged_dw (dW)


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


def _kernel_ragged(lhs, rhs, offsets, backward: bool = False):
    global ragged_launches, ragged_bwd_launches
    # rhs may be a transposed view: the kernel reads it in place
    out = cuda.gmm_ragged(lhs.contiguous(), rhs, offsets)
    if backward:
        ragged_bwd_launches += 1
    else:
        ragged_launches += 1
    return out


def _kernel_ragged_t(a, b, offsets):
    global ragged_dw_launches
    out = cuda.gmm_ragged_dw(a.contiguous(), b.contiguous(), offsets)
    ragged_dw_launches += 1
    return out


def _ref_ragged(lhs, rhs, group_sizes, backward: bool = False):
    return ref.grouped_matmul(lhs, rhs, group_sizes)


def _ref_ragged_t(a, b, group_sizes):
    return ref.ragged_transposed_matmul(a, b, group_sizes)


class RaggedProducts(NamedTuple):
    """The two ragged products a route runs, each given ``groups``: the
    (G + 1,) offsets for the kernels, the (G,) sizes for the plain ones.

    ``matmul(lhs (M, K), rhs (G, K, N), groups, backward=False)`` -> (M, N);
    ``rhs`` may be a transposed view. ``matmul_t(a (M, K), b (M, N),
    groups)`` -> (G, K, N)."""
    matmul: Callable
    matmul_t: Callable

    def in_backward(self) -> "RaggedProducts":
        return self._replace(
            matmul=functools.partial(self.matmul, backward=True))


KERNEL_RAGGED = RaggedProducts(_kernel_ragged, _kernel_ragged_t)
PLAIN_RAGGED = RaggedProducts(_ref_ragged, _ref_ragged_t)


class EqualGroupedMatmul(torch.autograd.Function):
    """lhs (G, M, K) x rhs (G, K, N) through ``product(a, b, backward)``,
    with the backward as two more of these Functions, on transposed views
    and with ``backward=True`` bound."""

    @staticmethod
    def forward(ctx, lhs, rhs, product):
        ctx.product = product
        ctx.save_for_backward(lhs, rhs)
        return product(lhs, rhs)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs = ctx.saved_tensors
        dy = dy.contiguous()
        product = functools.partial(ctx.product, backward=True)
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = EqualGroupedMatmul.apply(dy, rhs.transpose(1, 2),
                                             product)
        if ctx.needs_input_grad[1]:
            d_rhs = EqualGroupedMatmul.apply(lhs.transpose(1, 2), dy,
                                             product)
        return d_lhs, d_rhs, None


class RaggedGroupedMatmul(torch.autograd.Function):
    """R: ragged lhs (M, K) x rhs (G, K, N) -> (M, N) through
    ``products.matmul``; backward ``dx = R(dy, rhs^T)``, ``dW = T(lhs,
    dy)``."""

    @staticmethod
    def forward(ctx, lhs, rhs, groups, products):
        ctx.products = products
        ctx.save_for_backward(lhs, rhs, groups)
        return products.matmul(lhs, rhs, groups)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, groups = ctx.saved_tensors
        dy = dy.contiguous()
        products = ctx.products.in_backward()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = RaggedGroupedMatmul.apply(dy, rhs.transpose(1, 2),
                                              groups, products)
        if ctx.needs_input_grad[1]:
            d_rhs = RaggedTransposedMatmul.apply(lhs, dy, groups, products)
        return d_lhs, d_rhs, None, None


class RaggedTransposedMatmul(torch.autograd.Function):
    """T: a (M, K), b (M, N) -> (G, K, N), ``out[g] = a[rows of g]^T x
    b[rows of g]``, through ``products.matmul_t``; backward ``da = R(b,
    dZ^T)``, ``db = R(a, dZ)``."""

    @staticmethod
    def forward(ctx, a, b, groups, products):
        ctx.products = products
        ctx.save_for_backward(a, b, groups)
        return products.matmul_t(a, b, groups)

    @staticmethod
    def backward(ctx, dz):
        a, b, groups = ctx.saved_tensors
        dz = dz.contiguous()
        products = ctx.products.in_backward()
        d_a = d_b = None
        if ctx.needs_input_grad[0]:
            d_a = RaggedGroupedMatmul.apply(b, dz.transpose(1, 2), groups,
                                            products)
        if ctx.needs_input_grad[1]:
            d_b = RaggedGroupedMatmul.apply(a, dz, groups, products)
        return d_a, d_b, None, None


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
    return RaggedGroupedMatmul.apply(lhs, rhs, ref.group_offsets(group_sizes),
                                     KERNEL_RAGGED)


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
