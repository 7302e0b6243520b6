"""Binding of the hand-written Hopper grouped-matmul kernels.

``csrc/gmm.cu`` replaces the TPU kernels
``repro/kernels/gmm/pallas.py::_equal_grouped_matmul`` and
``::_ragged_grouped_matmul``; its header says what bounds them and how
they are laid out. The library is compiled by ``kernels/build.py`` at the
first launch, never at import. Both functions launch on the current
stream, do not synchronise, and raise on inputs the kernels do not take.

:func:`plan_equal` picks ``gmm_equal``'s output tile and contraction split
from the product's shape alone, in Python, so the CPU tests check the plan
that the card runs.
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
MAX_GROUPS = 65535              # the grid's y extent


@dataclasses.dataclass(frozen=True)
class EqualPlan:
    """``gmm_equal``'s launch: (bm x bn) output tiles (gmm.cu instantiates
    64 x 64, 64 x 32, 32 x 64 and 32 x 32), each summed by a cluster of
    ``split`` blocks over disjoint contraction ranges; ``blocks`` in all."""
    bm: int
    bn: int
    split: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    for bm, bn in ((64, 32), (32, 64), (32, 32)):
        if (bm == 64 and M <= 32) or (bn == 64 and N <= 32):
            continue
        for split in range(1, min(MAX_SPLIT, k_tiles) + 1):
            if 2 * tiles(bm, bn) * split >= 3 * NUM_SMS:
                return EqualPlan(bm, bn, split, tiles(bm, bn) * split)
    split = min(MAX_SPLIT, k_tiles)
    return EqualPlan(32, 32, split, tiles(32, 32) * split)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gmm_equal.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gmm_equal.restype = ctypes.c_int
    lib.gmm_ragged.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.gmm_ragged.restype = ctypes.c_int
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


def gmm_ragged(lhs: torch.Tensor, rhs: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """lhs (M, K), rows sorted by group, x rhs (G, K, N) -> (M, N).
    ``offsets``: (G + 1,) int32 on the card, ``offsets[g]`` the first row
    of group g and ``offsets[G] == M``; rows past ``offsets[G]`` get 0."""
    _check_f32("lhs", lhs, 2, lhs.device)
    _check_f32("rhs", rhs, 3, lhs.device)
    M, K = lhs.shape
    G, _, N = rhs.shape
    if rhs.shape[1] != K:
        raise ValueError(f"gmm_ragged: lhs {tuple(lhs.shape)} and rhs "
                         f"{tuple(rhs.shape)} disagree")
    if (not offsets.is_cuda or offsets.device != lhs.device
            or offsets.dtype != torch.int32 or offsets.shape != (G + 1,)):
        raise ValueError(f"gmm_ragged: offsets must be ({G + 1},) int32 on "
                         f"{lhs.device}, got {tuple(offsets.shape)} "
                         f"{offsets.dtype} on {offsets.device}")
    for name, t in (("lhs", lhs), ("rhs", rhs), ("offsets", offsets)):
        if not t.is_contiguous():
            raise ValueError(f"gmm_ragged: {name} must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=lhs.device)
    lib = _library()
    err = lib.gmm_ragged(lhs.data_ptr(), rhs.data_ptr(), offsets.data_ptr(),
                         out.data_ptr(), G, M, N, K,
                         torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_on(err, lib, "gmm_ragged")
    return out
