"""Binding of the hand-written Hopper flash-attention kernel.

``csrc/flash_attention.cu`` replaces the TPU kernel
``repro/kernels/flash_attention/pallas.py::flash_attention``; its header
says what bounds it and how it is laid out. The library is compiled by
``kernels/build.py`` at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# head dims the kernel is compiled for; any multiple of 8 up to the largest
# runs in the next one up, its tail loaded as zeros (csrc header, "Head dims")
INSTANCE_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.flash_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def instance_dim(D: int) -> int:
    """The compiled head dim that runs head dim ``D``; raises ValueError for
    a ``D`` the kernel does not take (not a multiple of 8, or above 128)."""
    if D % 8 or not 8 <= D <= INSTANCE_DIMS[-1]:
        raise ValueError(f"flash_attention kernel supports head dims that "
                         f"are multiples of 8 up to {INSTANCE_DIMS[-1]}, "
                         f"got {D}")
    return next(i for i in INSTANCE_DIMS if D <= i)


def _check(q, k, v, causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v on different "
                             "devices")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_attention kernel takes float32 or "
                             f"bfloat16 q, k, v of one dtype; got {q.dtype}, "
                             f"{k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D, "
                             f"got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be "
                             "contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: bf16 {name} must "
                             "start 16-byte aligned (its tiles load by "
                             "16-byte copies)")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention kernel: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)} disagree")
    if Hq % k.shape[2]:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads "
                         f"{k.shape[2]}")
    instance_dim(D)
    if causal and Sq > k.shape[1]:
        raise ValueError(f"flash_attention kernel needs Sq <= Sk (got "
                         f"{Sq} > {k.shape[1]}): a query row left without "
                         "any key has no defined output")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q.dtype.

    Sq > Sk (cross-attention) runs without the causal mask only.
    Launches the kernel on the current stream and does not synchronise.
    Raises ValueError on inputs the kernel does not take and RuntimeError
    if the launch is refused."""
    _check(q, k, v, causal)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    o = torch.empty_like(q)
    lib = _library()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        _DTYPE_CODES[q.dtype], B, Sq, Sk, Hq, Hkv, D, float(scale),
        int(bool(causal)), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    return o
