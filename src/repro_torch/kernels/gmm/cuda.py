"""Binding of the hand-written Hopper grouped-matmul kernels.

``csrc/gmm.cu`` replaces the TPU kernels
``repro/kernels/gmm/pallas.py::_equal_grouped_matmul`` and
``::_ragged_grouped_matmul``, and adds the ragged product's weight
gradient ``gmm_ragged_dw``; its header says what bounds them and how they
are laid out. The library is compiled by ``kernels/build.py`` at the
first launch, never at import. The functions launch on the current
stream, do not synchronise, and raise on inputs the kernels do not take.

The planners (:func:`plan_equal`, :func:`plan_ragged`,
:func:`plan_ragged_dw`) pick each kernel's output tile and split from the
product's shape alone, in Python, so the CPU tests check the plan that the
card runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "gmm.cu"

NUM_SMS = 132                   # H100 SXM
BK = 32                         # gmm_equal's contraction tile
MAX_SPLIT = 4                   # blocks per cluster, one contraction range each
MAX_DW_SPLIT = 8                # gmm_ragged_dw: the portable cluster size
MAX_GROUPS = 65535              # the grid's y extent
# the output tiles gmm.cu instantiates, widest first
TILES = ((64, 64), (64, 32), (32, 64), (32, 32))


@dataclasses.dataclass(frozen=True)
class EqualPlan:
    """``gmm_equal``'s launch: (bm x bn) output tiles (gmm.cu instantiates
    64 x 64, 64 x 32, 32 x 64 and 32 x 32), each summed by a cluster of
    ``split`` blocks over disjoint contraction ranges; ``blocks`` in all."""
    bm: int
    bn: int
    split: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class RaggedPlan:
    """``gmm_ragged``'s launch: one block a (bm x bn) output tile."""
    bm: int
    bn: int
    blocks: int


@dataclasses.dataclass(frozen=True)
class RaggedDwPlan:
    """``gmm_ragged_dw``'s launch: (bm x bn) tiles of each group's (K, N)
    gradient, each summed by a cluster of ``split`` blocks over disjoint
    runs of the group's rows; ``blocks`` in all."""
    bm: int
    bn: int
    split: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fits(bm: int, bn: int, rows: int, cols: int) -> bool:
    """A tile side of 64 is not taken for an extent of 32 or less."""
    return not ((bm == 64 and rows <= 32) or (bn == 64 and cols <= 32))


@functools.lru_cache(maxsize=256)
def plan_equal(G: int, M: int, N: int, K: int) -> EqualPlan:
    """Two regimes, as timed on the H100 over every tile and split at the
    model learner's shapes (``PERF.md``):

    * when 64 x 64 tiles alone give two blocks per SM, the product is
      bounded by tensor-core work: 64 x 64 tiles, no split;
    * else it is bounded by the serial chain of mma steps each warp runs:
      the largest of 64 x 32, 32 x 64, 32 x 32 and then the smallest split
      that give 1.5 blocks per SM, or failing that the 32 x 32 tile at the
      largest split (at least one 32-wide contraction tile per range).

    A tile wider than a side of 32 or less is not taken. Raises ValueError
    on a shape the kernel cannot launch."""
    if min(G, M, N, K) < 0:
        raise ValueError(f"gmm_equal: negative extent in {(G, M, N, K)}")
    if G > MAX_GROUPS:
        raise ValueError(f"gmm_equal: {G} groups, the kernel takes at most "
                         f"{MAX_GROUPS}")

    def tiles(bm, bn):
        return G * _cdiv(M, bm) * _cdiv(N, bn)
    if M > 32 and N > 32 and tiles(64, 64) >= 2 * NUM_SMS:
        return EqualPlan(64, 64, 1, tiles(64, 64))
    k_tiles = max(_cdiv(K, BK), 1)
    for bm, bn in TILES[1:]:
        if not _fits(bm, bn, M, N):
            continue
        for split in range(1, min(MAX_SPLIT, k_tiles) + 1):
            if 2 * tiles(bm, bn) * split >= 3 * NUM_SMS:
                return EqualPlan(bm, bn, split, tiles(bm, bn) * split)
    split = min(MAX_SPLIT, k_tiles)
    return EqualPlan(32, 32, split, tiles(32, 32) * split)


@functools.lru_cache(maxsize=256)
def plan_ragged(M: int, N: int, K: int) -> RaggedPlan:
    """The widest tile that gives four blocks per SM, else 32 x 32 (the
    most blocks): a block's chain of mma steps, not the card's tensor-core
    rate, bounds these products, so blocks in flight count more than the
    reuse of a wider tile. At the assigned predictor's M = 5,000: 64 x 32
    for an output 256 wide (632 blocks), 32 x 32 for one 23 or 30 wide
    (157). A block's work is its tile times K, whichever group it falls
    in, so K does not move the choice. Raises ValueError on a shape the
    kernel cannot launch."""
    if min(M, N, K) < 0:
        raise ValueError(f"gmm_ragged: negative extent in {(M, N, K)}")

    def blocks(bm, bn):
        return _cdiv(M, bm) * _cdiv(N, bn)
    for bm, bn in TILES:
        if _fits(bm, bn, M, N) and blocks(bm, bn) >= 4 * NUM_SMS:
            return RaggedPlan(bm, bn, blocks(bm, bn))
    return RaggedPlan(32, 32, blocks(32, 32))


@functools.lru_cache(maxsize=256)
def plan_ragged_dw(G: int, M: int, K: int, N: int) -> RaggedDwPlan:
    """(G, K, N) gradient tiles over M rows in G groups: the widest tile,
    then the smallest split, that give two blocks per SM, a split being at
    most 8 blocks and at most the 32-row tiles of a group of M / G rows
    (the sizes live on the card); failing that, 32 x 32 at the largest
    split. At (5, 5,000, 256, 256): 64 x 64 tiles split 4 ways (320
    blocks); at K = 30 or N = 23: 32 x 32 split 7 ways (280). Raises
    ValueError on a shape the kernel cannot launch."""
    if min(G, M, K, N) < 0:
        raise ValueError(f"gmm_ragged_dw: negative extent in {(G, M, K, N)}")
    if G > MAX_GROUPS:
        raise ValueError(f"gmm_ragged_dw: {G} groups, the kernel takes at "
                         f"most {MAX_GROUPS}")
    max_split = min(MAX_DW_SPLIT, max(_cdiv(M, max(G, 1) * BK), 1))

    def tiles(bm, bn):
        return G * _cdiv(K, bm) * _cdiv(N, bn)
    for bm, bn in TILES:
        if not _fits(bm, bn, K, N):
            continue
        for split in range(1, max_split + 1):
            if tiles(bm, bn) * split >= 2 * NUM_SMS:
                return RaggedDwPlan(bm, bn, split, tiles(bm, bn) * split)
    return RaggedDwPlan(32, 32, max_split, tiles(32, 32) * max_split)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gmm_equal.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gmm_equal.restype = ctypes.c_int
    lib.gmm_ragged.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.gmm_ragged.restype = ctypes.c_int
    lib.gmm_ragged_dw.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.gmm_ragged_dw.restype = ctypes.c_int
    lib.gmm_error_string.argtypes = [ctypes.c_int]
    lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def _check_f32(name: str, t: torch.Tensor, dims: int,
               device: torch.device) -> None:
    if not t.is_cuda:
        raise ValueError(f"gmm kernel: {name} is on {t.device}, not a CUDA "
                         "device")
    if t.device != device:
        raise ValueError(f"gmm kernel: operands on {device} and {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"gmm kernel takes float32, got {name} {t.dtype}")
    if t.dim() != dims:
        raise ValueError(f"gmm kernel: {name} must be {dims}-D, got shape "
                         f"{tuple(t.shape)}")


def _layout(name: str, t: torch.Tensor):
    """(transposed, group stride) of a (G, R, C) operand whose (R, C)
    slices are dense, stored either as given or transposed."""
    inner = t[0] if t.shape[0] else t.new_empty(t.shape[1:])
    if inner.is_contiguous():
        trans = 0
    elif inner.t().is_contiguous():
        trans = 1
    else:
        raise ValueError(f"gmm kernel: each group of {name} must be a dense "
                         f"matrix or its transpose; got strides "
                         f"{tuple(t.stride())} for shape {tuple(t.shape)}")
    return trans, (t.stride(0) if t.shape[0] > 1 else 0)


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.gmm_error_string(err).decode())


def gmm_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (G, M, K) x b (G, K, N) -> (G, M, N), float32 on one card.

    ``a`` and ``b`` may be transposed views (``x.transpose(1, 2)`` of a
    contiguous tensor) and may broadcast over the groups (stride 0, as
    ``x[None].expand(G, M, K)``): the kernel reads them in place. The
    launch follows :func:`plan_equal`."""
    _check_f32("a", a, 3, a.device)
    _check_f32("b", b, 3, a.device)
    G, M, K = a.shape
    if b.shape[0] != G or b.shape[1] != K:
        raise ValueError(f"gmm_equal: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree")
    N = b.shape[2]
    trans_a, a_gs = _layout("a", a)
    trans_b, b_gs = _layout("b", b)
    plan = plan_equal(G, M, N, K)
    c = torch.empty((G, M, N), dtype=torch.float32, device=a.device)
    lib = _library()
    err = lib.gmm_equal(a.data_ptr(), b.data_ptr(), c.data_ptr(), G, M, N, K,
                        trans_a, trans_b, a_gs, b_gs, plan.bm, plan.bn,
                        plan.split,
                        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, lib, "gmm_equal")
    return c


def _check_offsets(name: str, offsets: torch.Tensor, G: int,
                   device: torch.device) -> None:
    if (not offsets.is_cuda or offsets.device != device
            or offsets.dtype != torch.int32 or offsets.shape != (G + 1,)
            or not offsets.is_contiguous()):
        raise ValueError(f"{name}: offsets must be ({G + 1},) int32, "
                         f"contiguous, on {device}; got "
                         f"{tuple(offsets.shape)} {offsets.dtype} on "
                         f"{offsets.device}")


def _check_contiguous(name: str, **tensors) -> None:
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def gmm_ragged(lhs: torch.Tensor, rhs: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """lhs (M, K), rows sorted by group, x rhs (G, K, N) -> (M, N).
    ``offsets``: (G + 1,) int32 on the card, ``offsets[g]`` the first row
    of group g and ``offsets[G] == M``; rows past ``offsets[G]`` get 0.
    ``rhs`` may be a transposed view (``w.transpose(1, 2)`` of a
    contiguous (G, N, K) tensor, as the backward's ``dx = dy x W^T``
    passes it): the kernel reads it in place. The launch follows
    :func:`plan_ragged`."""
    _check_f32("lhs", lhs, 2, lhs.device)
    _check_f32("rhs", rhs, 3, lhs.device)
    M, K = lhs.shape
    G, _, N = rhs.shape
    if rhs.shape[1] != K:
        raise ValueError(f"gmm_ragged: lhs {tuple(lhs.shape)} and rhs "
                         f"{tuple(rhs.shape)} disagree")
    _check_offsets("gmm_ragged", offsets, G, lhs.device)
    _check_contiguous("gmm_ragged", lhs=lhs)
    trans_b, b_gs = _layout("rhs", rhs)
    plan = plan_ragged(M, N, K)
    out = torch.empty((M, N), dtype=torch.float32, device=lhs.device)
    lib = _library()
    err = lib.gmm_ragged(lhs.data_ptr(), rhs.data_ptr(), offsets.data_ptr(),
                         out.data_ptr(), G, M, N, K, trans_b, b_gs, plan.bm,
                         plan.bn,
                         torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_on(err, lib, "gmm_ragged")
    return out


def gmm_ragged_dw(a: torch.Tensor, b: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """a (M, K) and b (M, N), rows sorted by group -> (G, K, N) with
    ``out[g] = a[rows of g]^T x b[rows of g]``: the ragged product's
    weight gradient, ``dW = T(x, dy)``. ``offsets`` as for
    :func:`gmm_ragged`; an empty group's slice is zeros, rows past
    ``offsets[G]`` count in no group. The launch follows
    :func:`plan_ragged_dw`."""
    _check_f32("a", a, 2, a.device)
    _check_f32("b", b, 2, a.device)
    M, K = a.shape
    N = b.shape[1]
    if b.shape[0] != M:
        raise ValueError(f"gmm_ragged_dw: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} disagree")
    G = offsets.shape[0] - 1 if offsets.dim() == 1 else 0
    _check_offsets("gmm_ragged_dw", offsets, G, a.device)
    _check_contiguous("gmm_ragged_dw", a=a, b=b)
    plan = plan_ragged_dw(G, M, K, N)
    out = torch.empty((G, K, N), dtype=torch.float32, device=a.device)
    lib = _library()
    err = lib.gmm_ragged_dw(a.data_ptr(), b.data_ptr(), offsets.data_ptr(),
                            out.data_ptr(), G, M, K, N, plan.bm, plan.bn,
                            plan.split,
                            torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, lib, "gmm_ragged_dw")
    return out
