"""Binding of the hand-written Hopper grouped-matmul kernels.

``csrc/gmm.cu`` replaces the TPU kernels
``repro/kernels/gmm/pallas.py::_equal_grouped_matmul`` and
``::_ragged_grouped_matmul``, and adds the ragged product's weight
gradient ``gmm_ragged_dw``; its header says what bounds them and how they
are laid out. ``gmm_equal`` and ``gmm_ragged_dw`` take float32;
``gmm_ragged`` takes float32 or bfloat16 (both operands of one dtype, the
output in it too), as the reference's ragged kernel follows ``lhs.dtype``.
The library is compiled by ``kernels/build.py`` at the
first launch, never at import. The functions launch on the current
stream, do not synchronise, and raise on inputs the kernels do not take.

The planners (:func:`plan_equal`, :func:`plan_ragged`,
:func:`plan_ragged_dw`, :func:`plan_ragged_bf16`) pick each kernel's
output tile and split, and the bf16 product's route, from the product's
shape alone, in Python, so the CPU tests check the plan that the card
runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
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
# the bf16 TMA route's (bm, bn, stages), as gmm.cu instantiates them
BF16_TILES = ((64, 128, 4), (128, 256, 4))
MAX_TMA_GROUPS = 1024           # gmm.cu's boundary table in shared memory
ROUTE_WGMMA = "tma_wgmma"       # gmm_ragged_bf16_wgmma
ROUTE_MMA_SYNC = "mma_sync"     # gmm_ragged_bf16, on mma.sync

# bf16 launches by route, counted where each kernel is launched, so that a
# run can show which route its products took
bf16_wgmma_launches = 0
bf16_mma_sync_launches = 0
_route_lock = threading.Lock()


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
class RaggedBf16Plan:
    """``gmm_ragged``'s bf16 launch: the route, the (bm x bn) unit and the
    ring's ``stages`` (2 on the mma.sync route, its cp.async stages), and
    ``blocks``: on the TMA route the bound (ceil(M / bm) + G + 1) x
    ceil(N / bn) on the units, of which the blocks past the real count
    exit; on the mma.sync route one block an output tile."""
    route: str
    bm: int
    bn: int
    stages: int
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


def _bf16_mma_sync_plan(M: int, N: int, K: int) -> RaggedBf16Plan:
    """The mma.sync route at ``plan_ragged``'s tile."""
    p = plan_ragged(M, N, K)
    return RaggedBf16Plan(ROUTE_MMA_SYNC, p.bm, p.bn, 2, p.blocks)


def _bf16_tma_plan(M: int, N: int, G: int, bm: int, bn: int,
                   stages: int) -> RaggedBf16Plan:
    blocks = (_cdiv(M, bm) + G + 1) * _cdiv(N, bn) if M and N else 0
    return RaggedBf16Plan(ROUTE_WGMMA, bm, bn, stages, blocks)


@functools.lru_cache(maxsize=256)
def plan_ragged_bf16(M: int, N: int, K: int, G: int,
                     aligned: bool = True) -> RaggedBf16Plan:
    """The bf16 ragged product's route and tile, from its shape.

    The TMA and wgmma route takes what a tensor map can address: K > 0
    and N multiples of 8 (rows of 16 bytes, in either layout of rhs), at
    least one group and ``aligned`` (both bases 16-byte aligned and the
    group stride a multiple of 8 values, as the caller finds them). Any
    other shape goes to the mma.sync kernel at :func:`plan_ragged`'s
    tile, decided here, before the launch, never after a failure. Tiles,
    as timed on the H100 at the MoE's shapes (``PERF.md``): groups of at
    most 64 rows on average (decode, and Moonlight's ~48-row prefill
    groups: the experts' bytes bound them) take 64 x 128 units on a ring
    of 4 stages, two blocks an SM; larger groups (Mixtral's ~512 rows) are
    bounded by the tensor cores and take 128 x 256 units on two
    warpgroups. TMA fills zeros past N and the stores are masked, so
    either tile takes every N the route takes. Raises ValueError on negative extents and on
    more than ``MAX_TMA_GROUPS`` groups (the kernel's table of offsets
    lives in shared memory)."""
    if min(M, N, K, G) < 0:
        raise ValueError(f"gmm_ragged bf16: negative extent in "
                         f"{(M, N, K, G)}")
    if G > MAX_TMA_GROUPS:
        raise ValueError(f"gmm_ragged bf16: {G} groups, the kernel takes "
                         f"at most {MAX_TMA_GROUPS}")
    if not (aligned and G >= 1 and K > 0 and K % 8 == 0 and N % 8 == 0):
        return _bf16_mma_sync_plan(M, N, K)
    if M <= 64 * G:
        return _bf16_tma_plan(M, N, G, 64, 128, 4)
    return _bf16_tma_plan(M, N, G, 128, 256, 4)


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
    lib.gmm_ragged_bf16.argtypes = lib.gmm_ragged.argtypes
    lib.gmm_ragged_bf16.restype = ctypes.c_int
    lib.gmm_ragged_bf16_wgmma.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.gmm_ragged_bf16_wgmma.restype = ctypes.c_int
    lib.gmm_ragged_dw.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.gmm_ragged_dw.restype = ctypes.c_int
    lib.gmm_error_string.argtypes = [ctypes.c_int]
    lib.gmm_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dims: int, device: torch.device,
           dtype: torch.dtype = torch.float32) -> None:
    if not t.is_cuda:
        raise ValueError(f"gmm kernel: {name} is on {t.device}, not a CUDA "
                         "device")
    if t.device != device:
        raise ValueError(f"gmm kernel: operands on {device} and {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"gmm kernel takes {dtype} here, got {name} "
                         f"{t.dtype}")
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
    _check("a", a, 3, a.device)
    _check("b", b, 3, a.device)
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


_RAGGED_DTYPES = (torch.float32, torch.bfloat16)


def gmm_ragged(lhs: torch.Tensor, rhs: torch.Tensor,
               offsets: torch.Tensor) -> torch.Tensor:
    """lhs (M, K), rows sorted by group, x rhs (G, K, N) -> (M, N) in
    ``lhs.dtype``, float32 (3xTF32 tiles) or bfloat16 (bf16 tiles, f32
    sums rounded once); ``rhs`` of the same dtype.
    ``offsets``: (G + 1,) int32 on the card, ``offsets[g]`` the first row
    of group g and ``offsets[G] == M``; rows past ``offsets[G]`` get 0.
    ``rhs`` may be a transposed view (``w.transpose(1, 2)`` of a
    contiguous (G, N, K) tensor, as the backward's ``dx = dy x W^T``
    passes it): the kernel reads it in place. The float32 launch follows
    :func:`plan_ragged`, the bfloat16 one :func:`plan_ragged_bf16`."""
    if lhs.dtype not in _RAGGED_DTYPES:
        raise ValueError(f"gmm_ragged takes float32 or bfloat16, got lhs "
                         f"{lhs.dtype}")
    _check("lhs", lhs, 2, lhs.device, lhs.dtype)
    _check("rhs", rhs, 3, lhs.device, lhs.dtype)
    M, K = lhs.shape
    G, _, N = rhs.shape
    if rhs.shape[1] != K:
        raise ValueError(f"gmm_ragged: lhs {tuple(lhs.shape)} and rhs "
                         f"{tuple(rhs.shape)} disagree")
    _check_offsets("gmm_ragged", offsets, G, lhs.device)
    _check_contiguous("gmm_ragged", lhs=lhs)
    trans_b, b_gs = _layout("rhs", rhs)
    if lhs.dtype == torch.bfloat16:
        aligned = ((lhs.data_ptr() | rhs.data_ptr()) % 16 == 0
                   and b_gs % 8 == 0)
        return _gmm_ragged_bf16(lhs, rhs, offsets,
                                plan_ragged_bf16(M, N, K, G, aligned))
    plan = plan_ragged(M, N, K)
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    lib = _library()
    err = lib.gmm_ragged(lhs.data_ptr(), rhs.data_ptr(), offsets.data_ptr(),
                         out.data_ptr(), G, M, N, K, trans_b, b_gs, plan.bm,
                         plan.bn,
                         torch.cuda.current_stream(lhs.device).cuda_stream)
    _raise_on(err, lib, "gmm_ragged")
    return out


def _gmm_ragged_bf16(lhs: torch.Tensor, rhs: torch.Tensor,
                     offsets: torch.Tensor,
                     plan: RaggedBf16Plan) -> torch.Tensor:
    """The bf16 product on the route and tile ``plan`` names, checked by
    :func:`gmm_ragged`: its launcher, and ``chip_smoke.py``'s, which
    forces the mma.sync route or another tile at the same shape to
    time it beside the planned one. Adds one to the route's count."""
    global bf16_wgmma_launches, bf16_mma_sync_launches
    M, K = lhs.shape
    G, _, N = rhs.shape
    trans_b, b_gs = _layout("rhs", rhs)
    out = torch.empty((M, N), dtype=lhs.dtype, device=lhs.device)
    lib = _library()
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    args = (lhs.data_ptr(), rhs.data_ptr(), offsets.data_ptr(),
            out.data_ptr(), G, M, N, K, trans_b, b_gs, plan.bm, plan.bn)
    if plan.route == ROUTE_WGMMA:
        err = lib.gmm_ragged_bf16_wgmma(*args, plan.stages, stream)
    elif plan.route == ROUTE_MMA_SYNC:
        err = lib.gmm_ragged_bf16(*args, stream)
    else:
        raise ValueError(f"gmm_ragged bf16: unknown route {plan.route!r}")
    _raise_on(err, lib, f"gmm_ragged bf16 ({plan.route})")
    with _route_lock:
        if plan.route == ROUTE_WGMMA:
            bf16_wgmma_launches += 1
        else:
            bf16_mma_sync_launches += 1
    return out


def gmm_ragged_dw(a: torch.Tensor, b: torch.Tensor,
                  offsets: torch.Tensor) -> torch.Tensor:
    """a (M, K) and b (M, N), rows sorted by group -> (G, K, N) with
    ``out[g] = a[rows of g]^T x b[rows of g]``: the ragged product's
    weight gradient, ``dW = T(x, dy)``. ``offsets`` as for
    :func:`gmm_ragged`; an empty group's slice is zeros, rows past
    ``offsets[G]`` count in no group. The launch follows
    :func:`plan_ragged_dw`."""
    _check("a", a, 2, a.device)
    _check("b", b, 2, a.device)
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
