"""Dispatching wrapper for the fused imagination step: the port of
``repro/kernels/imag/ops.py``.

``fused_step(members, norm, pol, s, eps, member_idx)`` runs one whole
imagination step: policy head, reparameterised action sample, assigned-
member dynamics forward, denormalised next state. ``impl``:

* None: the kernel on CUDA tensors, ``ref`` on CPU tensors. A CUDA tensor
  reaches ``ref`` only when the caller names ``impl="ref"``, as the on-card
  comparison does.
* ``"cuda"``: sort the rows by member, one launch of the hand-written
  kernel (``cuda.py``) over the sorted rows, unsort. B rows of work
  whatever K is.
* ``"ref"``: the plain version, ``ref.fused_step`` (all K members, then a
  row select), the bit-reference.

The reference's CPU default, the flat XLA spelling (``impl="fused"``), is a
speed trick of JAX on the CPU and is not ported: the port's CPU route is
``ref``.

The kernel runs inside ``FusedStep``, a ``torch.autograd.Function`` whose
backward has no kernel of its own, as in the reference, where
``_pallas_sorted_bwd`` is ``jax.vjp`` of the oracle: it recomputes
``ref.fused_step`` on the saved sorted rows and returns its gradients built
with ``create_graph=True``, so the backward can itself be differentiated
(MB-MPO's meta-gradient goes through an inner gradient of the rollout).
``sorted_step`` takes the sorted forward as a parameter, so the CPU tests
run the same wiring with ``ref_sorted``.

``sort_plan`` precomputes the sort and the group offsets; a rollout calls
it once for the whole horizon's member draws.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels.imag import cuda, ref
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

launches = 0    # imag_fused, one per step through the kernel
# the count stays exact when worker threads launch at once
_count_lock = threading.Lock()


def uses_kernel(t: torch.Tensor, impl=None) -> bool:
    """Whether ``fused_step(..., impl=impl)`` on tensors like ``t`` launches
    the kernel."""
    if impl is None:
        return t.is_cuda
    if impl not in ("cuda", "ref"):
        raise ValueError(f"unknown fused_step impl {impl!r}")
    return impl == "cuda"


def sort_plan(member_idx: torch.Tensor, n_groups: int):
    """Sort/unsort plan for the kernel route: ``(order, offsets)``.

    member_idx: (..., B) int; leading axes (the horizon) are planned in one
    call. ``order`` sorts the trailing axis by member, stably; ``offsets``
    (..., K + 1) int32 are cumulative group offsets. The sizes are a
    compare-and-sum and the offsets a device ``cumsum``: no host sync (CUDA
    ``bincount`` reads the largest id back to size its output)."""
    order = torch.argsort(member_idx, dim=-1, stable=True)
    groups = torch.arange(n_groups, device=member_idx.device,
                          dtype=member_idx.dtype)
    sizes = (member_idx[..., :, None] == groups).sum(-2, dtype=torch.int32)
    zeros = torch.zeros(sizes.shape[:-1] + (1,), dtype=torch.int32,
                        device=member_idx.device)
    return order, torch.cat([zeros, torch.cumsum(sizes, -1,
                                                 dtype=torch.int32)], -1)


def kernel_sorted(offsets, gid, members, norm, pol, s, eps):
    """The kernel on member-sorted rows; counts its launch."""
    global launches
    out = cuda.fused_step_sorted(members, norm, pol, s, eps, offsets)
    with _count_lock:
        launches += 1
    return out


def ref_sorted(offsets, gid, members, norm, pol, s, eps):
    """The plain version on member-sorted rows (``gid``: each row's
    member)."""
    return ref.fused_step(members, norm, pol, s, eps, gid)


class FusedStep(torch.autograd.Function):
    """``forward(offsets, gid, members, norm, pol, s, eps)`` on sorted rows,
    with autograd of ``ref.fused_step`` as the backward."""

    @staticmethod
    def forward(ctx, forward, skeleton, offsets, gid, *leaves):
        ctx.skeleton = skeleton
        ctx.save_for_backward(gid, *leaves)
        return forward(offsets, gid, *tree_unflatten(skeleton, leaves))

    @staticmethod
    def backward(ctx, ds2, da, dpre):
        gid, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        grads = iter(())
        if any(need):
            with torch.enable_grad():
                # recompute on fresh views of the inputs: the gradient is
                # taken w.r.t. the views, so the engine stops there and
                # never walks on into the steps that made the inputs (a
                # rollout's earlier steps, each re-entering this backward),
                # while the views keep the result differentiable w.r.t. the
                # inputs themselves
                views = [x.view_as(x) for x in leaves]
                outs = ref.fused_step(*tree_unflatten(ctx.skeleton, views),
                                      gid)
                grads = iter(torch.autograd.grad(
                    outs, [v for v, n in zip(views, need) if n],
                    (ds2, da, dpre), create_graph=True, allow_unused=True))
        out = []
        for x, n in zip(leaves, need):
            g = next(grads) if n else None
            out.append(torch.zeros_like(x) if n and g is None else g)
        return (None, None, None, None, *out)


def sorted_step(members, norm, pol, s, eps, member_idx, *, plan=None,
                forward=kernel_sorted):
    """The kernel route: sort rows by member, ``FusedStep`` over the sorted
    rows, unsort. ``forward`` is the sorted forward (the kernel, or
    ``ref_sorted``). Returns ``(s2, a, pre)`` in input row order."""
    if plan is None:
        plan = sort_plan(member_idx, members["w"][0].shape[0])
    order, offsets = plan
    tree = (members, norm, pol, s[order], eps[order])
    out = FusedStep.apply(forward, tree_map(lambda _: 0, tree), offsets,
                          member_idx[order], *tree_leaves(tree))
    return tuple(v.new_empty(v.shape).index_copy(0, order, v) for v in out)


def fused_step(members, norm, pol, s, eps, member_idx, *,
               impl: str | None = None, plan=None):
    """One fused imagination step; see the module docstring for ``impl``.

    ``plan``: a precomputed ``sort_plan`` for this step's assignment (kernel
    route only; ``ref`` is row-order-blind and ignores it). Returns
    ``(s2, a, pre)`` in input row order."""
    if uses_kernel(s, impl):
        return sorted_step(members, norm, pol, s, eps, member_idx, plan=plan)
    return ref.fused_step(members, norm, pol, s, eps, member_idx)
