"""Plain PyTorch grouped/batched matmul: the port of
``repro/kernels/gmm/ref.py``, with the same three entry points and
contracts.

  * ``ensemble_mlp`` — K-member MLP forward on shared inputs (the MBRL
    dynamics-ensemble training loop, where every member sees every row).
  * ``grouped_matmul`` — equal-group (G, M, K) x (G, K, N) batched matmul
    OR, when ``group_sizes`` is given, a RAGGED grouped matmul: ``lhs`` is
    (M, K) with rows sorted by group, row m in group g is multiplied by
    ``rhs[g]``. Zero-size groups are legal.
  * ``ensemble_mlp_select`` — the sample-then-compute imagination path:
    each row is evaluated by exactly ONE assigned member (sort rows by
    member, ragged grouped MLP forward, unsort).

and one the reference has no name for: ``ragged_transposed_matmul``, the
per-group product ``a[rows of g]^T x b[rows of g]``, which is the ragged
product's gradient with respect to its weights (``gmm_ragged_dw`` on the
card).

This is the kernels' plain version: the CPU runs it, the tests hold it
against the JAX oracle, and ``chip_smoke.py`` holds the kernels against
it on the card. Like the oracle, the ragged product materialises the
per-row gathered ``rhs`` (M, K, N); it is the reference, not a fast path.
In bf16 it multiplies in f32 and rounds the result once, as the oracle
does. ``grouped_matmul_looped`` is the same ragged product as a loop over
the groups, whose memory does not grow with M x K x N: the plain route on
the card (``ops.grouped_matmul``), where the gather would not fit at the
MoE's widths (Mixtral's prefill: 481 GB).
"""
from __future__ import annotations

import torch


def group_ids(group_sizes: torch.Tensor, m: int) -> torch.Tensor:
    """Row -> group id for rows sorted by group. Rows beyond
    ``sum(group_sizes)`` clamp to the last group."""
    ends = torch.cumsum(group_sizes, 0)
    rows = torch.arange(m, device=group_sizes.device, dtype=ends.dtype)
    return torch.searchsorted(ends, rows, right=True).clamp(
        0, group_sizes.shape[0] - 1)


def group_sizes_of(idx: torch.Tensor, n_groups: int) -> torch.Tensor:
    """``bincount(idx, minlength=n_groups)`` as a (G,) int32 tensor,
    computed without a host sync (CUDA ``bincount`` reads ``idx.max()``
    back to size its output)."""
    groups = torch.arange(n_groups, device=idx.device, dtype=idx.dtype)
    return (idx[None, :] == groups[:, None]).sum(1, dtype=torch.int32)


def group_offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """(G + 1,) int32 row offsets of the groups, ``offsets[g]`` the first
    row of group g, computed on the sizes' device: no host sync."""
    return torch.cat([
        torch.zeros(1, dtype=torch.int32, device=group_sizes.device),
        torch.cumsum(group_sizes, 0, dtype=torch.int32)])


def grouped_matmul(lhs, rhs, group_sizes=None):
    """Equal-group: lhs (G, M, K) x rhs (G, K, N) -> (G, M, N).
    Ragged (``group_sizes`` given): lhs (M, K) sorted by group x
    rhs (G, K, N) -> (M, N), with ``group_sizes`` (G,) summing to M."""
    if group_sizes is None:
        return torch.matmul(lhs, rhs)
    gid = group_ids(group_sizes, lhs.shape[0])
    if lhs.dtype != torch.bfloat16:
        return torch.einsum("mk,mkn->mn", lhs, rhs[gid])
    return torch.einsum("mk,mkn->mn", lhs.float(),
                        rhs[gid].float()).to(lhs.dtype)


def _mm_f32(a, b):
    """a @ b; bf16 operands summed in f32 and returned in f32, through the
    card's f32-accumulating product, or widened (exactly) elsewhere and
    where a gradient is needed (``torch.mm(out_dtype=)`` has none)."""
    if a.dtype != torch.bfloat16:
        return a @ b
    needs_grad = torch.is_grad_enabled() and (a.requires_grad
                                              or b.requires_grad)
    if a.is_cuda and not needs_grad:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def grouped_matmul_looped(lhs, rhs, group_sizes):
    """The ragged ``grouped_matmul`` as a loop over the groups: rows
    ``[off_g, off_g + size_g)`` times ``rhs[g]``, f32 sums rounded once to
    ``lhs.dtype``; rows beyond ``sum(group_sizes)`` are multiplied by the
    last group, as there. ``group_sizes`` is read on the host (a tensor),
    or given there (a sequence, so a CUDA graph can capture the loop).

    The rows are split and the weights unbound once, and the products
    joined by one ``cat``, so that autograd's backward writes each
    operand's gradient once (one ``cat`` of the row blocks' gradients, one
    ``stack`` of the groups' weight gradients, an unused group's zero).
    Indexing ``rhs[g]`` and writing slices of the output in place would
    give the same values, but a backward that builds a full-size gradient
    of each operand for every group, which at Moonlight's 64 experts took
    most of a train step's device time (``chip_smoke.py``'s
    ``moe_train``)."""
    sizes = (group_sizes.tolist() if torch.is_tensor(group_sizes)
             else list(group_sizes))
    M = lhs.shape[0]
    rows, start = [], 0
    for g, size in enumerate(sizes):
        end = M if g == len(sizes) - 1 else min(start + max(int(size), 0), M)
        rows.append(end - start)
        start = end
    weights = rhs.unbind(0)
    out = [_mm_f32(block, weights[g]).to(lhs.dtype) if rows[g]
           else lhs.new_empty((0, rhs.shape[2]))
           for g, block in enumerate(lhs.split(rows))]
    return torch.cat(out) if out else lhs.new_empty((M, rhs.shape[2]))


def ragged_transposed_matmul(a, b, group_sizes):
    """a (M, K) and b (M, N), rows sorted by group -> (G, K, N) with
    ``out[g] = a[rows of g]^T x b[rows of g]``; an empty group gives
    zeros. It is the gradient of ``sum(b * grouped_matmul(a, w, sizes))``
    with respect to ``w``, so rows beyond ``sum(group_sizes)`` count in the
    last group, as they do there. A row's one-hot group mask selects its
    rows without reading the sizes on the host."""
    G = group_sizes.shape[0]
    gid = group_ids(group_sizes, a.shape[0])
    onehot = (gid[:, None] == torch.arange(G, device=gid.device)).to(a.dtype)
    return torch.einsum("mg,mk,mn->gkn", onehot, a, b)


def ensemble_mlp(members, x, *, matmul=grouped_matmul):
    """members: {"w": [(K,a,b) ...], "b": [(K,b) ...]}; x: (B, Din)
    shared across members. Returns (K, B, Dout). tanh hidden activations.
    The first layer reads ``x`` through a stride-0 broadcast over the
    members, never a K-fold copy. ``matmul`` lets the dispatcher swap in
    the kernel."""
    K = members["w"][0].shape[0]
    h = x.contiguous()[None].expand((K,) + tuple(x.shape))
    n = len(members["w"])
    for i, (w, b) in enumerate(zip(members["w"], members["b"])):
        h = matmul(h, w) + b[:, None, :]
        if i < n - 1:
            h = torch.tanh(h)
    return h


def ensemble_mlp_select(members, x, idx, *, matmul=grouped_matmul):
    """Per-row member-assigned MLP forward (sort / compute / unsort).

    x: (B, Din); idx: (B,) int member assignment. Row b flows through
    member ``idx[b]`` only — equivalent to ``ensemble_mlp(...)[idx[b], b]``
    at 1/K the FLOPs. Rows are sorted by member (stably), each layer is
    one ragged ``grouped_matmul`` with ``group_sizes = bincount(idx)``
    (empty members are zero-size groups), and the result is scattered
    back to input order."""
    K = members["w"][0].shape[0]
    order = torch.argsort(idx, stable=True)
    gid = idx[order]
    sizes = group_sizes_of(idx, K)
    h = x[order]
    n = len(members["w"])
    for i, (w, b) in enumerate(zip(members["w"], members["b"])):
        h = matmul(h, w, sizes) + b[gid]
        if i < n - 1:
            h = torch.tanh(h)
    out = torch.empty_like(h)
    out[order] = h
    return out
