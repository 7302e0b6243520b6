"""Binding of the hand-written Hopper SSD chunked scan.

``csrc/ssd.cu`` replaces the TPU kernel
``repro/kernels/ssd/pallas.py::ssd_chunked``; its header says what bounds
it and how it is laid out: bf16 inputs run on tensor-core tiles, f32 ones
on the CUDA cores. The library is compiled by ``kernels/build.py`` at the
first launch, never at import. The function launches on the current
stream, does not synchronise, and raises on inputs the kernel does not
take. :func:`plan` reports a route's launch as the card sees it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
# the largest chunk, head dim and state size the kernel takes (ssd.cu's
# QM, PM, NM): a block's tiles are sized for them
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "f32 FMAs on the CUDA cores",
          torch.bfloat16: "bf16 mma.sync m16n8k16, f32 accumulate"}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.ssd_chunked_fwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.ssd_chunked_fwd.restype = ctypes.c_int
    lib.ssd_plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ssd_plan.restype = ctypes.c_int
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape, device: torch.device,
           dtypes) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"ssd kernel: {name} is on {t.device}, not {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"ssd kernel takes {name} as one of "
                         f"{[str(d) for d in dtypes]}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd kernel: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"ssd kernel: {name} must be contiguous")


def plan(dtype: torch.dtype) -> dict:
    """The launch of ``dtype``'s route on the current card: threads and
    dynamic shared memory of a block, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spill) bytes a thread, and the (chunk, head dim, state) tile a
    block owns. One block per (batch, head)."""
    out = (ctypes.c_int * 5)()
    lib = _library()
    err = lib.ssd_plan(_DTYPE_CODES[dtype], out)
    if err:
        raise RuntimeError("ssd_plan failed: "
                           + lib.ssd_error_string(err).decode())
    return {"route": ROUTES[dtype],
            "tile": [MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE],
            "threads": out[0], "smem": out[1], "blocks_per_sm": out[2],
            "registers": out[3], "local_bytes": out[4]}


def ssd_chunked(x, dt, A, B_, C, *, chunk: int = 128, initial_state=None,
                return_final_state: bool = False):
    """x: (B, L, H, P) float32 or bfloat16; dt: (B, L, H) float32; A: (H,)
    float32; B_/C: (B, L, G, N) in x's dtype; initial_state: optional
    (B, H, P, N) float32. Returns y (B, L, H, P) in x's dtype and, when
    asked, the final state (B, H, P, N) float32 — the contract of
    ``ref.ssd_chunked``. Every tensor is contiguous and on x's card."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"ssd kernel: x is on {dev}, not a CUDA device")
    if x.dim() != 4 or B_.dim() != 4:
        raise ValueError(f"ssd kernel: x {tuple(x.shape)} and B "
                         f"{tuple(B_.shape)} must be 4-D")
    Bsz, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"ssd kernel takes chunks of 1..{MAX_CHUNK} steps, "
                         f"got {chunk}")
    if P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd kernel takes head dims up to {MAX_HEAD_DIM} "
                         f"and states up to {MAX_STATE}, got P {P}, N {N}")
    if H % G or L < 1:
        raise ValueError(f"ssd kernel: {H} heads in {G} groups, L {L}")
    _check("x", x, (Bsz, L, H, P), dev, tuple(_DTYPE_CODES))
    _check("dt", dt, (Bsz, L, H), dev, (torch.float32,))
    _check("A", A, (H,), dev, (torch.float32,))
    _check("B", B_, (Bsz, L, G, N), dev, (x.dtype,))
    _check("C", C, (Bsz, L, G, N), dev, (x.dtype,))
    if initial_state is not None:
        _check("initial_state", initial_state, (Bsz, H, P, N), dev,
               (torch.float32,))
    y = torch.empty_like(x)
    final = (torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
             if return_final_state else None)
    lib = _library()
    err = lib.ssd_chunked_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
        C.data_ptr(),
        None if initial_state is None else initial_state.data_ptr(),
        y.data_ptr(), None if final is None else final.data_ptr(),
        _DTYPE_CODES[x.dtype], Bsz, L, H, P, N, G, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("ssd_chunked kernel launch failed: "
                           + lib.ssd_error_string(err).decode())
    if return_final_state:
        return y, final
    return y
