"""Binding of the hand-written Hopper fused imagination step.

``csrc/imag.cu`` replaces the TPU kernel
``repro/kernels/imag/pallas.py::fused_step_sorted``; its header says what
bounds it and how it is laid out. The library is compiled by
``kernels/build.py`` at the first launch, never at import. The function
launches on the current stream, does not synchronise, and raises on inputs
the kernel does not take.

:func:`plan_step` picks the launch (rows a tile, blocks a cluster,
clusters a member) from the shapes alone, in Python, and computes the
kernel's shared memory as ``imag.cu`` lays it out, so the CPU tests check
the plan that the card runs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "imag.cu"
MAX_LAYERS = 8
NUM_SMS = 132                   # H100 SXM
MAX_CLUSTER = 8                 # the portable cluster size
MAX_SMEM = 232448               # bytes of shared memory a block may use
SM_SMEM = 233472                # bytes of shared memory an SM has for blocks
BLOCK_RESERVED = 1024           # bytes the card keeps for each block
MAX_MEMBERS = 65535             # the grid's y extent


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round8(x: int) -> int:
    return (x + 7) // 8 * 8


def _stride4(x: int) -> int:
    """``imag.cu``'s activation row stride: round4(x), plus 4 if that is a
    multiple of 8."""
    r = _round4(x)
    return r if r % 8 else r + 4


def _weight_stride(ld: int) -> int:
    """``imag.cu``'s weight row stride for a tile ``ld`` wide."""
    return ld if ld % 16 else ld + 8


def slice_width(dout: int, cluster: int) -> int:
    """Columns of a member layer of width ``dout`` that each block of a
    cluster owns (the last blocks may own fewer, or none): a multiple of
    8, the width of an mma tile, as ``imag.cu``'s ``fill`` computes it."""
    return _round8(_cdiv(dout, cluster))


def smem_bytes(rows: int, cluster: int, dyn_dims: Sequence[int],
               pol_dims: Sequence[int]) -> int:
    """Dynamic shared memory of one block, laid out as ``imag.cu`` lays it
    out: the whole policy and this block's column slice of every member
    layer, each ``[round8(din)][stride]`` plus ``[ld]`` of bias; X (rows x
    obs + act); H0 and H1 (rows x the widest hidden layer's cluster x
    slice); P0 and P1 (the policy's activations of the own rows, P0 also
    the last layer's own columns of every row); Pin (the own rows' [s,
    a]); the partial sums of a split contraction (8 warps x 256 floats).
    Row strides are padded as ``imag.cu`` pads them."""
    floats = 0
    for din, dout in zip(pol_dims[:-1], pol_dims[1:]):
        ld = _round8(dout)
        floats += _round8(din) * _weight_stride(ld) + ld
    lds = [slice_width(d, cluster) for d in dyn_dims[1:]]
    for din, ld in zip(dyn_dims[:-1], lds):
        floats += _round8(din) * _weight_stride(ld) + ld
    sx = _stride4(_round8(dyn_dims[-1] + pol_dims[-1]))
    sh = _stride4(max([4] + [cluster * ld for ld in lds[:-1]]))
    sp = _stride4(max(4, *(_round8(d) for d in pol_dims[1:])))
    own = _cdiv(rows, cluster)
    floats += (rows * (sx + 2 * sh) + max(own * sp, rows * lds[-1])
               + own * (sp + sx) + 8 * 2 * 32 * 4)
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """``imag_fused``'s launch: a member's sorted rows in tiles of
    ``rows``; each tile taken by a cluster of ``cluster`` blocks, each
    block owning 1/cluster of every member layer's columns and the policy
    head of every cluster-th row; ``row_clusters`` clusters a member, the
    q-th taking tiles q, q + row_clusters, ...; grid (row_clusters x
    cluster, K), ``blocks`` in all, ``smem`` bytes each."""
    rows: int
    cluster: int
    row_clusters: int
    blocks: int
    smem: int


def blocks_per_sm(smem: int) -> int:
    """Blocks of 256 threads that fit an SM with ``smem`` bytes of shared
    memory each."""
    return max(1, min(8, SM_SMEM // (smem + BLOCK_RESERVED)))


@functools.lru_cache(maxsize=256)
def plan_step(B: int, K: int, dyn_dims: tuple, pol_dims: tuple) -> StepPlan:
    """Tiles of 16 rows (one mma tile), or 32 when a member's expected share
    of the batch (B / K) exceeds 64 rows and as many blocks fit an SM. The
    widest cluster whose shared memory fits and whose grid, one cluster an
    expected tile, fits the card at once: a small batch spreads each
    member's weights over up to 8 SMs; a large one takes narrower clusters
    and more of them. Failing that, the narrowest cluster that fits.
    Clusters a member to take twice its expected tiles (so a member drawn
    more often than average is not left to one cluster), no more than one
    member could use, and no more than fit the card at once. A cluster with
    no tile of its member exits at once. Raises ValueError when no cluster
    size fits a block's shared memory or the grid cannot be launched."""
    if K > MAX_MEMBERS:
        raise ValueError(f"imag kernel: {K} members, the grid takes at most "
                         f"{MAX_MEMBERS}")
    K1 = max(K, 1)

    def rows_for(c):
        small = smem_bytes(16, c, dyn_dims, pol_dims)
        if B > 64 * K1 and blocks_per_sm(smem_bytes(
                32, c, dyn_dims, pol_dims)) == blocks_per_sm(small):
            return 32
        return 16
    fits = [c for c in (1, 2, 4, MAX_CLUSTER)
            if smem_bytes(rows_for(c), c, dyn_dims, pol_dims) <= MAX_SMEM]
    if not fits:
        raise ValueError(
            f"imag kernel: member widths {list(dyn_dims)} and policy widths "
            f"{list(pol_dims)} need more than {MAX_SMEM} bytes of shared "
            f"memory a block even at clusters of {MAX_CLUSTER}")

    def at_once(c):  # blocks of c's plan that the card runs together
        return blocks_per_sm(smem_bytes(rows_for(c), c, dyn_dims,
                                        pol_dims)) * NUM_SMS
    wide = [c for c in fits
            if K1 * _cdiv(_cdiv(B, K1), rows_for(c)) * c <= at_once(c)]
    cluster = max(wide) if wide else min(fits)
    rows = rows_for(cluster)
    tiles = max(1, _cdiv(_cdiv(B, K1), rows))
    row_clusters = max(1, min(_cdiv(B, rows), 2 * tiles,
                              at_once(cluster) // (K1 * cluster)))
    return StepPlan(rows, cluster, row_clusters, K * row_clusters * cluster,
                    smem_bytes(rows, cluster, dyn_dims, pol_dims))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.imag_fused_step.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int, ints, ptrs, ptrs] * 2
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.imag_fused_step.restype = ctypes.c_int
    lib.imag_smem_bytes.argtypes = [ctypes.c_int, ints] * 2 + [ctypes.c_int] * 2
    lib.imag_smem_bytes.restype = ctypes.c_longlong
    lib.imag_error_string.argtypes = [ctypes.c_int]
    lib.imag_error_string.restype = ctypes.c_char_p
    return lib


def kernel_smem_bytes(rows: int, cluster: int, dyn_dims: Sequence[int],
                      pol_dims: Sequence[int]) -> int:
    """The shared memory that ``imag.cu`` itself lays out for these widths
    and plan (-1 if it does not take them): what :func:`smem_bytes` must
    equal."""
    return _library().imag_smem_bytes(
        len(pol_dims) - 1, _array(ctypes.c_int, list(pol_dims)),
        len(dyn_dims) - 1, _array(ctypes.c_int, list(dyn_dims)), rows,
        cluster)


def _check(name: str, t: torch.Tensor, shape, device: torch.device,
           dtype=torch.float32) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"imag kernel: {name} is on {t.device}, not "
                         f"{device}")
    if t.dtype != dtype:
        raise ValueError(f"imag kernel takes {dtype} {name}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"imag kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"imag kernel: {name} must be contiguous")


def _dims(ws, stacked: bool, name: str):
    if not 1 <= len(ws) <= MAX_LAYERS:
        raise ValueError(f"imag kernel: {name} needs 1..{MAX_LAYERS} layers, "
                         f"got {len(ws)}")
    d = 1 if stacked else 0
    if any(w.dim() != 2 + d for w in ws):
        raise ValueError(f"imag kernel: {name} weights must be {2 + d}-D, "
                         f"got {[tuple(w.shape) for w in ws]}")
    dims = [ws[0].shape[d]] + [w.shape[d + 1] for w in ws]
    for i, w in enumerate(ws):
        if w.shape[d] != dims[i]:
            raise ValueError(f"imag kernel: {name} layer {i} has shape "
                             f"{tuple(w.shape)} after width {dims[i]}")
    return dims


def _array(ctype, values):
    return (ctype * len(values))(*values)


def fused_step_sorted(members, norm, pol, s: torch.Tensor, eps: torch.Tensor,
                      offsets: torch.Tensor):
    """One fused step on rows sorted by member: returns ``(s2, a, pre)`` in
    the same order. ``offsets``: (K + 1,) int32 on the card, member g owning
    rows ``offsets[g]:offsets[g + 1]`` and ``offsets[K] == B``. Every
    tensor is float32, contiguous and on the one card of ``s``."""
    dev = s.device
    if not s.is_cuda:
        raise ValueError(f"imag kernel: s is on {dev}, not a CUDA device")
    B, obs = s.shape
    K = members["w"][0].shape[0]
    dyn_dims = _dims(members["w"], True, "members")
    pol_dims = _dims(pol["w"], False, "policy")
    act = pol_dims[-1]
    if dyn_dims[0] != obs + act or dyn_dims[-1] != obs or pol_dims[0] != obs:
        raise ValueError(f"imag kernel: member widths {dyn_dims} and policy "
                         f"widths {pol_dims} do not fit obs {obs}")
    _check("s", s, (B, obs), dev)
    _check("eps", eps, (B, act), dev)
    _check("offsets", offsets, (K + 1,), dev, torch.int32)
    for i, (w, b) in enumerate(zip(members["w"], members["b"])):
        _check(f"members w[{i}]", w, (K, dyn_dims[i], dyn_dims[i + 1]), dev)
        _check(f"members b[{i}]", b, (K, dyn_dims[i + 1]), dev)
    for i, (w, b) in enumerate(zip(pol["w"], pol["b"])):
        _check(f"policy w[{i}]", w, (pol_dims[i], pol_dims[i + 1]), dev)
        _check(f"policy b[{i}]", b, (pol_dims[i + 1],), dev)
    _check("log_std", pol["log_std"], (act,), dev)
    for k, n in (("mu_in", obs + act), ("sig_in", obs + act),
                 ("mu_out", obs), ("sig_out", obs)):
        _check(k, norm[k], (n,), dev)
    plan = plan_step(B, K, tuple(dyn_dims), tuple(pol_dims))
    s2 = torch.empty((B, obs), dtype=torch.float32, device=dev)
    a = torch.empty((B, act), dtype=torch.float32, device=dev)
    pre = torch.empty((B, act), dtype=torch.float32, device=dev)
    ptr = ctypes.c_void_p

    def layers(ws, bs):
        return (_array(ptr, [w.data_ptr() for w in ws]),
                _array(ptr, [b.data_ptr() for b in bs]))
    pol_w, pol_b = layers(pol["w"], pol["b"])
    dyn_w, dyn_b = layers(members["w"], members["b"])
    lib = _library()
    err = lib.imag_fused_step(
        s.data_ptr(), eps.data_ptr(), offsets.data_ptr(),
        len(pol["w"]), _array(ctypes.c_int, pol_dims), pol_w, pol_b,
        len(members["w"]), _array(ctypes.c_int, dyn_dims), dyn_w, dyn_b,
        pol["log_std"].data_ptr(), norm["mu_in"].data_ptr(),
        norm["sig_in"].data_ptr(), norm["mu_out"].data_ptr(),
        norm["sig_out"].data_ptr(), s2.data_ptr(), a.data_ptr(),
        pre.data_ptr(), B, K, plan.rows, plan.cluster, plan.row_clusters,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("imag_fused_step kernel launch failed: "
                           + lib.imag_error_string(err).decode())
    return s2, a, pre
