"""Binding of the hand-written Hopper fused imagination step.

``csrc/imag.cu`` replaces the TPU kernel
``repro/kernels/imag/pallas.py::fused_step_sorted``; its header says what
bounds it and how it is laid out. The library is compiled by
``kernels/build.py`` at the first launch, never at import. The function
launches on the current stream, does not synchronise, and raises on inputs
the kernel does not take.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "imag.cu"
MAX_LAYERS = 8


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.imag_fused_step.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int, ints, ptrs, ptrs] * 2
        + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.imag_fused_step.restype = ctypes.c_int
    lib.imag_error_string.argtypes = [ctypes.c_int]
    lib.imag_error_string.restype = ctypes.c_char_p
    return lib


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
        pre.data_ptr(), B, K, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("imag_fused_step kernel launch failed: "
                           + lib.imag_error_string(err).decode())
    return s2, a, pre
