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

This is the kernels' plain version: the CPU runs it, the tests hold it
against the JAX oracle, and ``chip_smoke.py`` holds the kernels against
it on the card. Like the oracle, the ragged product materialises the
per-row gathered ``rhs`` (M, K, N); it is the reference, not a fast path.
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


def grouped_matmul(lhs, rhs, group_sizes=None):
    """Equal-group: lhs (G, M, K) x rhs (G, K, N) -> (G, M, N).
    Ragged (``group_sizes`` given): lhs (M, K) sorted by group x
    rhs (G, K, N) -> (M, N), with ``group_sizes`` (G,) summing to M."""
    if group_sizes is None:
        return torch.matmul(lhs, rhs)
    gid = group_ids(group_sizes, lhs.shape[0])
    return torch.einsum("mk,mkn->mn", lhs, rhs[gid])


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
