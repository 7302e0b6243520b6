#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device`` / ``build``: the card, then every kernel built from the
   sources in this checkout (one ``nvcc`` per source, all at once), with
   the tensor-core (``HMMA``) instructions of each library counted by
   ``cuobjdump -sass``; the phase fails if any of the four has none.
2. ``kernel_check``: the flash-attention kernel against its plain PyTorch
   version on the card at the serving path's shapes and at edge shapes,
   with times of the kernel, the plain version and one PyTorch library
   call (SDPA), the kernel's achieved TFLOP/s, and the least time the card
   could take. Times are device time per call, from CUDA events around
   the replay of a CUDA graph of many calls, so the host's launch cost
   drops out; ``wall_ms`` is the kernel's time per call launched from the
   host.
3. ``gmm_check``: the same for the grouped-matmul kernels: ``gmm_equal``
   forward and its two backward products at the model learner's shapes,
   with the tile and contraction split its planner chose, ``gmm_ragged``
   at the assigned predictor's with its backward products (``dx`` by the
   same kernel on transposed weights, ``dW`` by ``gmm_ragged_dw``) and
   ``torch._grouped_mm`` where it takes f32, and both at edge shapes. Then
   ``gmm_plan_sweep``: ``gmm_equal`` on every tile and split it takes, at
   each learner product, beside the planner's choice, and the ragged
   kernels on every tile (and ``dW`` split) at the assigned layers.
   ``imag_check``: the same for the fused imagination step ``imag_fused``
   at the policy improver's shape (B = 64), at B = 4,096, at MB-MPO's K = 1
   member slice and at edge shapes, with device times by CUDA-graph replay
   and the launch plan (rows a tile, blocks a cluster, clusters a member,
   blocks, shared bytes a block, the last as the kernel lays it out too);
   then first- and second-order gradients through its autograd Function
   against the plain version's autograd.
   ``ssd_check``: the SSD chunked-scan kernel ``ssd_chunked`` against its
   plain version at the Mamba2-2.7B prefill shape (bf16, final state out),
   at the stateless forward's, with a state in and out, and at edge
   shapes, with device times by CUDA-graph replay and the route's plan
   (tile, threads, shared bytes and registers a block, blocks an SM by
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
4. ``model_check``: GLM-4-9B at full width, cut to 2 layers; prefill logits
   through the kernel against the same through the plain attention.
5. ``serve``: ``WorldModelServer`` on the full 40-layer GLM-4-9B with a
   ``ParameterServer``, mixed prompt lengths and a mid-run push; asserts
   the serving invariants and that every prefill went through the kernel.
   Then ``decode_profile``: ``torch.profiler`` over a few full-width decode
   ticks (device time, busy share, kernels per tick), after the counts of
   the main path are read.
6. ``model_learn``: Algorithms 1-2 on ``pr2_lego_stack`` at the widest
   ensemble the repo ships (hidden 256, depth 2, 5 members): a collector
   farm of 20 robots fills the learner's ring, epoch by epoch, then ten
   more epochs run on the full ring. Asserts the exact trajectory count,
   one input shape for ``train_epoch`` and ``val_loss``, one model version
   per epoch, the ``gmm_equal`` launches each epoch implies, and a falling
   validation loss. Then ``epoch_profile``: ``torch.profiler`` over one
   more epoch (device time, busy share, kernels per epoch).
7. ``assigned_predict``: the published ensemble predicts the val ring's
   transitions with sampled members through ``gmm_ragged``, held against
   the all-member forward's row-selected output. Then ``assigned_grad``:
   gradients of a loss of that prediction w.r.t. the inputs and every
   member weight, first order and through an MB-MPO-style inner step
   (second order), through the kernels (forward, ``dx`` and ``dW``)
   against autograd of the plain route; the launches the depth implies;
   the device time and the peak memory one backward adds.
8. ``policy_improve``: Algorithm 3, a ``PolicyImprovementWorker`` on the
   ensemble that ``model_learn`` published, at ``AlgoConfig`` defaults (64
   imagined starts, horizon 50, 5 members) with the policy of
   ``examples/pr2_arm.py``: ME-TRPO steps, then ME-PPO and MB-MPO steps.
   Asserts H ``imag_fused`` launches per ME step and 2·K·H per MB-MPO
   step, one ``improve`` input shape, one policy version per step, finite
   imagined returns and at least one TRPO step found. Then
   ``improve_profile``: ``torch.profiler`` over one more ME-TRPO step.
9. ``ssm_model_check``: Mamba2-2.7B at full width, cut to 2 layers, f32:
   prefill(S) then decode(token S) against prefill(S + 1), and the kernel
   route against the plain scan.
10. ``ssm_serve``: lock-step serving of the full 64-layer Mamba2-2.7B in
   bf16: batch 4, 1,024-token prompts, 32 greedy tokens. Asserts 64
   ``ssd_chunked`` launches per prefill, one decode input shape and finite
   logits; reports prefill, time to first token, decode tokens/s, tick
   latencies and peak memory. Then ``ssm_tick_profile``:
   ``torch.profiler`` over one more tick.
11. ``ssm_forward``: the stateless ``loss_forward`` at batch 4, 2,048
   tokens, forward only: 64 launches, tokens/s, the scan's share of
   device time.
12. ``kernels``: one entry per kernel, as the port's records expect.

Each kernel's launches are counted from 0 just before the phase that
drives its path (``serve``, ``model_learn``, ``assigned_predict``,
``assigned_grad``, ``policy_improve``, ``ssm_serve``, ``ssm_forward``)
and read just after it; comparison launches never count. The line before
the last is the card's name and power limit from ``nvidia-smi``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. It imports nothing of JAX and nothing
of the JAX package ``repro``.

    python3 chip_smoke.py --backward-cost SRC

imports ``repro_torch`` from the directory SRC instead (a checkout's
``src``, such as a parent commit's) and prints one line: the device time
and the peak memory of one backward of the assigned predictor at the
val ring's size, random weights. It serves comparisons between trees.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
# dense TF32 on the tensor cores; an f32-accurate product there takes three
# TF32 passes (3xTF32), so its least time is 3 * flops at this rate
TF32_FLOPS = 494.7e12
HBM_BYTES_PER_S = 3.35e12
# kernel vs plain attention, both rounding an f32 result once to the output
# dtype: bf16 outputs may differ by a bf16 ulp or two (7.8e-3 at |o| < 2),
# f32 outputs only by the order of the f32 sums
ATTN_ATOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# prefill logits (unit scale, f32) of 2 bf16 layers: a one-ulp change of a
# bf16 attention output moves later bf16 products and rounds on
LOGITS_ATOL = 0.1
PREFILL_BUCKETS = (16, 32, 64)
SERVE_PROMPTS = (5, 12, 16, 20, 31, 40, 57, 64)  # spans all three buckets
SERVE_MAX_NEW = 16
# gmm kernels vs plain products, f32 both, no TF32: sums of up to 5,000
# f32 products in another order, relative to the operands' scale
GMM_TOL = 1e-4
# model learning: pr2_lego_stack (Arm7: obs 23, act 7, horizon 100), a farm
# of 20 robots, the learner's ring of 200 trajectories. Every 5th goes to
# the val ring, so the train ring is full at 250: 12 batches of 20 and a
# last grant of 10
LEARN_ENV, LEARN_LANES, LEARN_TRAJS, LEARN_EPOCHS = (
    "pr2_lego_stack", 20, 250, 10)
# the learner's val ring: every 5th of 250 trajectories, 100 steps each
VAL_ROWS = 5000
# predict_assigned vs the all-member forward's selected rows, f32: the
# same three layers summed in another order by two kernels
ASSIGNED_ATOL = 1e-4
# gradients of the assigned predictor's loss, kernel route vs plain
# autograd, f32 both: the same products summed in another order (dW over
# a group's ~1,000 rows), relative to each gradient's scale
ASSIGNED_GRAD_TOL = 1e-4
# the inner step of the second-order check, as MB-MPO's inner_lr
INNER_STEP = 0.05
# imag_fused vs the plain fused step, f32 both (no TF32): six MLP layers
# summed in another order and CUDA's tanhf/expf against torch's, relative
# to the outputs' scale; the gradients through the Function likewise
IMAG_TOL = 1e-4
# policy improvement: AlgoConfig defaults, the policy of examples/pr2_arm.py
IMPROVE_STEPS = {"me-trpo": 3, "me-ppo": 2, "mb-mpo": 2}
POLICY_HIDDEN = 64
# ssd_chunked vs the plain scan, relative to the output's scale: f32 sums of
# up to 2·Q products in another order; the bf16 route also rounds the
# operands of its tensor-core products to bf16 (3e-3 to 4e-3 of scale in
# tests/test_torch_ssd.py's model of it) and its output to bf16
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
# Mamba2-2.7B at full width, 2 layers, f32: prefill(S) + decode(token S)
# against prefill(S + 1) is one function computed chunked and then
# stepwise; the kernel route against the plain one sums in another order
SSM_DECODE_TOL, SSM_ROUTE_TOL = 1e-3, 1e-4
SSM_CHECK_S = 200                    # two chunks, the second padded
SSM_BATCH, SSM_PROMPT, SSM_NEW = 4, 1024, 32
SSM_FORWARD_SEQ = 2048


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(log: str) -> dict:
    """Registers and spill bytes of each kernel of one library, from
    ``nvcc -Xptxas -v``'s report (empty when the library was not rebuilt):
    ``{kernel: [registers, spill store bytes, spill load bytes]}``."""
    out, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), *spills]
            name, spills = None, (0, 0)
    return out


def time_ms(fn, target_ms: float = 200.0) -> float:
    """Mean time of ``fn()`` on the card, by CUDA events over a run of
    launches sized to about ``target_ms``, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max((time.perf_counter() - t0) * 1e3, 1e-3)
    n = int(min(100, max(3, target_ms / once)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``n`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times between two CUDA events. The
    card then launches the kernels itself, so the host's cost of a launch,
    which at the MBRL shapes exceeds a kernel's run time (``time_ms``
    measures that), drops out; what remains is the kernels' own time and
    the graph's gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * n)


def profiled(run, tries: int = 3) -> tuple:
    """``run()`` under ``torch.profiler``: its CUDA kernel events and the
    wall ms of the run. A session can come back without the card's
    activity; such a session is run again, up to ``tries`` in all, and
    one that never shows a kernel raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels and sum(e.time_range.elapsed_us() for e in kernels) > 0:
            return kernels, wall_ms
    raise RuntimeError(f"profiler recorded no device time in {tries} "
                       "sessions")


# ---------------------------------------------------------------- phase 2

ATTN_CASES = [
    # name, B, Sq, Sk, Hq, Hkv, D, causal, window, dtype
    ("prefill_s16", 1, 16, 16, 32, 2, 128, True, 0, torch.bfloat16),
    ("prefill_s32", 1, 32, 32, 32, 2, 128, True, 0, torch.bfloat16),
    ("prefill_s64", 1, 64, 64, 32, 2, 128, True, 0, torch.bfloat16),
    ("edge_gqa2", 2, 128, 128, 4, 2, 64, True, 0, torch.bfloat16),
    ("edge_prefix_window", 1, 64, 192, 4, 1, 64, True, 64, torch.bfloat16),
    ("edge_noncausal", 1, 64, 64, 2, 2, 64, False, 0, torch.bfloat16),
    ("edge_untiled_s100", 1, 100, 100, 4, 2, 128, True, 0, torch.bfloat16),
    ("edge_f32", 2, 128, 128, 4, 2, 64, True, 0, torch.float32),
    ("long_s4096", 1, 4096, 4096, 32, 2, 128, True, 0, torch.bfloat16),
    ("long_s4096_noncausal", 1, 4096, 4096, 32, 2, 128, False, 0,
     torch.bfloat16),
]
MAIN_PATH_CASE = "prefill_s64"


def attention_bound_ms(q, k, v, mask) -> tuple:
    """Least time for the card: the larger of the bytes moved (q, k, v read
    once, o written once) over HBM bandwidth and the flops of the visible
    (query, key) pairs of this mask (2*D for QK^T, 2*D for PV) over the
    peak rate for the dtype."""
    B, _, Hq, D = q.shape
    flops = 4.0 * B * Hq * D * int(mask.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_attention(fa_ops, fa_ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, B, Sq, Sk, Hq, Hkv, D, causal, window, dt in ATTN_CASES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        q, k, v = rnd(B, Sq, Hq, D), rnd(B, Sk, Hkv, D), rnd(B, Sk, Hkv, D)
        kw = dict(causal=causal, window=window)
        got = fa_ops.attention(q, k, v, impl="cuda", **kw)
        torch.cuda.synchronize()
        want = fa_ops.attention(q, k, v, impl="ref", **kw)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= ATTN_ATOL[dt]:
            raise RuntimeError(f"attention kernel {name}: max abs err {err} "
                               f"> {ATTN_ATOL[dt]}")
        mask = fa_ref._mask(torch.arange(Sq, device="cuda") + Sk - Sq,
                            torch.arange(Sk, device="cuda"), causal, window)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if causal and not window and Sq == Sk:
            sdpa_kw = dict(is_causal=True)
        else:
            sdpa_kw = dict(attn_mask=mask)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=True, **sdpa_kw)
        lib_err = (library().transpose(1, 2).float()
                   - want.float()).abs().max().item()
        bound, bound_by = attention_bound_ms(q, k, v, mask)

        def kernel():
            return fa_ops.attention(q, k, v, impl="cuda", **kw)

        def plain():
            return fa_ops.attention(q, k, v, impl="ref", **kw)
        ms = device_ms(kernel)
        flops = 4.0 * B * Hq * D * int(mask.sum())
        rows[name] = {
            "shape": [B, Sq, Sk, Hq, Hkv, D], "causal": causal,
            "window": window, "dtype": str(dt).replace("torch.", ""),
            "max_abs_err": err, "atol": ATTN_ATOL[dt], "ms": ms,
            "tflops": flops / ms / 1e9, "plain_ms": device_ms(plain),
            "library_ms": device_ms(library), "library_max_abs_err": lib_err,
            "wall_ms": time_ms(kernel), "bound_ms": bound,
            "bound_by": bound_by}
        emit({"phase": "kernel_check", "kernel": "flash_attention_fwd",
              "case": name, **rows[name]})
    return rows


# ---------------------------------------------------------------- phase 3

# name, G, M, K, N of the forward product, operand layout: "fwd" (a x w),
# "fwd_bcast" (the first layer: one input read by every member), "dx"
# (dY x W^T), "dw" (X^T x dY), "dw_bcast" (X^T x dY of the first layer)
GMM_EQUAL_CASES = [
    ("train_l1_fwd", 5, 256, 30, 256, "fwd_bcast"),
    ("train_l2_fwd", 5, 256, 256, 256, "fwd"),
    ("train_l3_fwd", 5, 256, 256, 23, "fwd"),
    ("train_l1_dx", 5, 256, 30, 256, "dx"),
    ("train_l1_dw", 5, 256, 30, 256, "dw_bcast"),
    ("train_l2_dx", 5, 256, 256, 256, "dx"),
    ("train_l2_dw", 5, 256, 256, 256, "dw"),
    ("train_l3_dx", 5, 256, 256, 23, "dx"),
    ("train_l3_dw", 5, 256, 256, 23, "dw"),
    ("val_l1_fwd", 5, 5000, 30, 256, "fwd_bcast"),
    ("val_l2_fwd", 5, 5000, 256, 256, "fwd"),
    ("val_l3_fwd", 5, 5000, 256, 23, "fwd"),
    ("edge_g1", 1, 128, 64, 64, "fwd"),
    ("edge_m37_n23", 5, 37, 32, 23, "fwd"),
    ("edge_k1", 3, 70, 1, 33, "fwd"),
    ("edge_dx_m200", 3, 200, 130, 70, "dx"),
    ("edge_dw_bcast_m37", 3, 37, 30, 23, "dw_bcast"),
]
GMM_EQUAL_MAIN = "train_l2_fwd"
# name, G, M, K, N, group sizes (None: sampled members, as imagination's)
GMM_RAGGED_CASES = [
    ("assign_l1", 5, 5000, 30, 256, None),
    ("assign_l2", 5, 5000, 256, 256, None),
    ("assign_l3", 5, 5000, 256, 23, None),
    # test_kernels_interpret.py's edge shapes
    ("edge_empty_groups", 4, 64, 32, 48, (10, 0, 54, 0)),
    ("edge_one_group_owns_all", 3, 200, 130, 70, (200, 0, 0)),
    ("edge_straddling", 5, 37, 16, 16, (5, 8, 0, 20, 4)),
    ("edge_g1", 1, 128, 128, 128, (128,)),
    ("edge_thin_ends", 3, 300, 96, 40, (1, 298, 1)),
]
GMM_RAGGED_MAIN = "assign_l2"


def gmm_equal_operands(gen, G, M, K, N, layout):
    """The logical operands (a, b) of one product, laid out as the model
    learner hands them to the kernel."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.5
    if layout == "fwd":
        return rnd(G, M, K), rnd(G, K, N)
    if layout == "fwd_bcast":
        return rnd(M, K)[None].expand(G, M, K), rnd(G, K, N)
    if layout == "dx":
        return rnd(G, M, N), rnd(G, K, N).transpose(1, 2)
    if layout == "dw":
        return rnd(G, M, K).transpose(1, 2), rnd(G, M, N)
    if layout == "dw_bcast":
        return rnd(M, K)[None].expand(G, M, K).transpose(1, 2), rnd(G, M, N)
    raise ValueError(layout)


def gmm_bound_ms(flops: float, nbytes: float) -> tuple:
    """The larger of an f32-accurate product's tensor-core work (three TF32
    passes at the dense TF32 rate) and bytes over HBM: no f32 kernel on the
    card can beat both."""
    t_ops = 3 * flops / TF32_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _unique_bytes(t) -> int:
    """Bytes of a (G, R, C) operand read once: a broadcast one once."""
    n = t.numel() // t.shape[0] if t.stride(0) == 0 else t.numel()
    return n * t.element_size()


def _scaled_err(got, want) -> tuple:
    err = (got - want).abs().max().item()
    return err, GMM_TOL * max(1.0, want.abs().max().item())


def check_gmm(gmm_cuda, gmm_ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"equal": {}, "ragged": {}}
    for name, G, M, K, N, layout in GMM_EQUAL_CASES:
        a, b = gmm_equal_operands(gen, G, M, K, N, layout)
        got = gmm_cuda.gmm_equal(a, b)
        torch.cuda.synchronize()
        want = gmm_ref.grouped_matmul(a, b)
        err, tol = _scaled_err(got, want)
        if not err <= tol:
            raise RuntimeError(f"gmm_equal {name}: max abs err {err} > {tol}")
        flops = 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        bound, bound_by = gmm_bound_ms(
            flops, _unique_bytes(a) + _unique_bytes(b) + got.numel() * 4)
        plan = gmm_cuda.plan_equal(a.shape[0], a.shape[1], b.shape[2],
                                   a.shape[2])
        ms = device_ms(lambda: gmm_cuda.gmm_equal(a, b))
        rows["equal"][name] = {
            "shape": [G, M, K, N], "layout": layout,
            "product": [list(a.shape), list(b.shape)],
            "plan": {"bm": plan.bm, "bn": plan.bn, "split": plan.split,
                     "blocks": plan.blocks},
            "max_abs_err": err, "tol": tol, "ms": ms,
            "tflops": flops / ms / 1e9,
            "plain_ms": device_ms(lambda: gmm_ref.grouped_matmul(a, b)),
            "library_ms": device_ms(lambda: torch.bmm(a, b)),
            "wall_ms": time_ms(lambda: gmm_cuda.gmm_equal(a, b)),
            "bound_ms": bound, "bound_by": bound_by}
        emit({"phase": "gmm_check", "kernel": "gmm_equal", "case": name,
              **rows["equal"][name]})
    for name, G, M, K, N, sizes in GMM_RAGGED_CASES:
        if sizes is None:
            idx = torch.randint(0, G, (M,), generator=gen, device="cuda")
            gs = torch.bincount(idx, minlength=G).to(torch.int32)
        else:
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        lhs = torch.randn((M, K), generator=gen, device="cuda") * 0.5
        rhs = torch.randn((G, K, N), generator=gen, device="cuda") * 0.5
        dy = torch.randn((M, N), generator=gen, device="cuda") * 0.5
        offsets = gmm_ref.group_offsets(gs)
        rows["ragged"][name] = {}
        for product, row in check_ragged_products(gmm_cuda, gmm_ref, lhs, rhs,
                                                  dy, gs, offsets):
            if not row["max_abs_err"] <= row["tol"]:
                raise RuntimeError(f"gmm_ragged {name} {product}: max abs "
                                   f"err {row['max_abs_err']} > {row['tol']}")
            rows["ragged"][name][product] = row
            emit({"phase": "gmm_check", "kernel": "gmm_ragged", "case": name,
                  "product": product, "shape": [G, M, K, N],
                  "group_sizes": gs.tolist(), **row})
    return rows


def check_ragged_products(gmm_cuda, gmm_ref, lhs, rhs, dy, gs, offsets):
    """``gmm_ragged``'s three products on one case: the forward ``lhs x
    rhs``, ``dx = dy x rhs^T`` (the same kernel, rhs read transposed in
    place) and ``dW = T(lhs, dy)`` (``gmm_ragged_dw``), each against its
    plain version, with device times by CUDA-graph replay, the plan, the
    bound and ``torch._grouped_mm``'s time where it computes the same
    product in f32 within ``GMM_TOL`` (else None and its reason). Yields
    (product, row)."""
    M, K = lhs.shape
    G, _, N = rhs.shape
    rhs_t = rhs.transpose(1, 2)
    ends = offsets[1:].contiguous()
    used = int((gs > 0).sum())      # the weights a run has to read
    products = {
        "fwd": (lambda: gmm_cuda.gmm_ragged(lhs, rhs, offsets),
                lambda: gmm_ref.grouped_matmul(lhs, rhs, gs),
                lambda: torch._grouped_mm(lhs, rhs, offs=ends),
                M * K + used * K * N + M * N,
                gmm_cuda.plan_ragged(M, N, K)),
        "dx": (lambda: gmm_cuda.gmm_ragged(dy, rhs_t, offsets),
               lambda: gmm_ref.grouped_matmul(dy, rhs_t, gs),
               lambda: torch._grouped_mm(dy, rhs_t, offs=ends),
               M * N + used * K * N + M * K,
               gmm_cuda.plan_ragged(M, K, N)),
        "dw": (lambda: gmm_cuda.gmm_ragged_dw(lhs, dy, offsets),
               lambda: gmm_ref.ragged_transposed_matmul(lhs, dy, gs),
               lambda: torch._grouped_mm(lhs.t(), dy, offs=ends),
               M * K + M * N + G * K * N,
               gmm_cuda.plan_ragged_dw(G, M, K, N)),
    }
    for product, (kernel, plain, library, floats, plan) in products.items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        err, tol = _scaled_err(got, want)
        flops = 2.0 * M * K * N
        bound, bound_by = gmm_bound_ms(flops, floats * 4)
        ms = device_ms(kernel)
        library_ms, library_timing, library_error = grouped_mm_ms(library,
                                                                  want)
        yield product, {
            "plan": dataclasses.asdict(plan), "max_abs_err": err, "tol": tol,
            "ms": ms, "tflops": flops / ms / 1e9,
            "plain_ms": device_ms(plain), "library_ms": library_ms,
            "library_timing": library_timing, "library_error": library_error,
            "wall_ms": time_ms(kernel), "bound_ms": bound,
            "bound_by": bound_by}


def grouped_mm_ms(library, want) -> tuple:
    """(ms, how, None) of one ``torch._grouped_mm`` call that computes
    ``want`` within ``GMM_TOL`` (TF32 is off), or (None, None, why not):
    the card's torch may refuse f32, or strides that are not multiples of
    16 bytes. ``how`` is "graph" (device time by CUDA-graph replay, as the
    kernels') or, where the call cannot be captured because it reads the
    offsets back to the host, "events" (CUDA events around host-launched
    calls, as the kernels' ``wall_ms``). The port never calls it; it is
    the yardstick."""
    try:
        got = library()
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError, TypeError,
            ValueError) as e:
        return None, None, f"{type(e).__name__}: {str(e)[:200]}"
    if got.shape != want.shape or got.dtype != want.dtype:
        return None, None, f"returned {tuple(got.shape)} {got.dtype}"
    err, tol = _scaled_err(got, want)
    if not err <= tol:
        return None, None, f"max abs err {err} > {tol}"
    try:
        return device_ms(library), "graph", None
    except RuntimeError as e:
        if "capture" not in str(e):
            raise
        torch.cuda.synchronize()
        return time_ms(library), "events", None


def sweep_gmm_plans(gmm_cuda, gmm_ref) -> None:
    """Every tile and contraction split ``gmm.cu`` takes, at each product
    the model learner and its validation run: one line per product with
    the device ms of each, of the planner's choice and of the fastest,
    each result held to ``GMM_TOL``. It shows how far the planner's rule
    is from the best plan on this card."""
    lib = gmm_cuda._library()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, G, M, K, N, layout in GMM_EQUAL_CASES:
        if name.startswith("edge"):
            continue
        a, b = gmm_equal_operands(gen, G, M, K, N, layout)
        want = gmm_ref.grouped_matmul(a, b)
        Gp, Mp, Kp, Np = a.shape[0], a.shape[1], a.shape[2], b.shape[2]
        trans_a, a_gs = gmm_cuda._layout("a", a)
        trans_b, b_gs = gmm_cuda._layout("b", b)
        c = torch.empty((Gp, Mp, Np), device="cuda")
        times = {}
        for bm, bn in ((64, 64), (64, 32), (32, 64), (32, 32)):
            for split in range(1, min(gmm_cuda.MAX_SPLIT,
                                      max(-(-Kp // gmm_cuda.BK), 1)) + 1):
                def run():
                    err = lib.gmm_equal(
                        a.data_ptr(), b.data_ptr(), c.data_ptr(), Gp, Mp, Np,
                        Kp, trans_a, trans_b, a_gs, b_gs, bm, bn, split,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"gmm_equal {bm}x{bn}/{split}: "
                                           f"error {err}")
                run()
                torch.cuda.synchronize()
                err, tol = _scaled_err(c, want)
                if not err <= tol:
                    raise RuntimeError(f"gmm_equal {name} {bm}x{bn}/{split}: "
                                       f"max abs err {err} > {tol}")
                times[f"{bm}x{bn}/{split}"] = device_ms(run)
        plan = gmm_cuda.plan_equal(Gp, Mp, Np, Kp)
        chosen = f"{plan.bm}x{plan.bn}/{plan.split}"
        best = min(times, key=times.get)
        emit({"phase": "gmm_plan_sweep", "case": name, "plan": chosen,
              "plan_ms": times[chosen], "best": best, "best_ms": times[best],
              "ms": times})


def sweep_ragged_plans(gmm_cuda, gmm_ref) -> None:
    """The ragged kernels on every tile (and, for ``gmm_ragged_dw``, every
    split) ``gmm.cu`` takes, at the assigned predictor's three layers: one
    line per product with the device ms of each, of the planner's choice
    and of the fastest, each result held to ``GMM_TOL``."""
    lib = gmm_cuda._library()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, G, M, K, N, _ in GMM_RAGGED_CASES:
        if not name.startswith("assign"):
            continue
        idx = torch.randint(0, G, (M,), generator=gen, device="cuda")
        gs = torch.bincount(idx, minlength=G).to(torch.int32)
        offs = gmm_ref.group_offsets(gs)
        x = torch.randn((M, K), generator=gen, device="cuda") * 0.5
        w = torch.randn((G, K, N), generator=gen, device="cuda") * 0.5
        dy = torch.randn((M, N), generator=gen, device="cuda") * 0.5
        # product: (output, plain result, launch(bm, bn, split), splits,
        # the planner's choice)
        sweeps = {
            "fwd": (torch.empty((M, N), device="cuda"),
                    gmm_ref.grouped_matmul(x, w, gs),
                    lambda out, bm, bn, split: lib.gmm_ragged(
                        x.data_ptr(), w.data_ptr(), offs.data_ptr(),
                        out.data_ptr(), G, M, N, K, 0, K * N, bm, bn,
                        torch.cuda.current_stream().cuda_stream),
                    [1], gmm_cuda.plan_ragged(M, N, K)),
            "dx": (torch.empty((M, K), device="cuda"),
                   gmm_ref.grouped_matmul(dy, w.transpose(1, 2), gs),
                   lambda out, bm, bn, split: lib.gmm_ragged(
                       dy.data_ptr(), w.data_ptr(), offs.data_ptr(),
                       out.data_ptr(), G, M, K, N, 1, K * N, bm, bn,
                       torch.cuda.current_stream().cuda_stream),
                   [1], gmm_cuda.plan_ragged(M, K, N)),
            "dw": (torch.empty((G, K, N), device="cuda"),
                   gmm_ref.ragged_transposed_matmul(x, dy, gs),
                   lambda out, bm, bn, split: lib.gmm_ragged_dw(
                       x.data_ptr(), dy.data_ptr(), offs.data_ptr(),
                       out.data_ptr(), G, M, K, N, bm, bn, split,
                       torch.cuda.current_stream().cuda_stream),
                   range(1, gmm_cuda.MAX_DW_SPLIT + 1),
                   gmm_cuda.plan_ragged_dw(G, M, K, N)),
        }
        for product, (out, want, launch, splits, plan) in sweeps.items():
            times = {}
            for bm, bn in gmm_cuda.TILES:
                for split in splits:
                    def run():
                        err = launch(out, bm, bn, split)
                        if err:
                            raise RuntimeError(f"gmm_ragged {product} "
                                               f"{bm}x{bn}/{split}: error "
                                               f"{err}")
                    run()
                    torch.cuda.synchronize()
                    err, tol = _scaled_err(out, want)
                    if not err <= tol:
                        raise RuntimeError(
                            f"gmm_ragged {name} {product} {bm}x{bn}/{split}:"
                            f" max abs err {err} > {tol}")
                    times[f"{bm}x{bn}/{split}"] = device_ms(run)
            chosen = f"{plan.bm}x{plan.bn}/{getattr(plan, 'split', 1)}"
            best = min(times, key=times.get)
            emit({"phase": "gmm_plan_sweep", "kernel": "gmm_ragged",
                  "case": name, "product": product, "plan": chosen,
                  "plan_ms": times[chosen], "best": best,
                  "best_ms": times[best], "ms": times})


# name, K, B, obs, act, hidden, policy hidden, policy depth, group sizes
# (None: sampled members, as imagination draws them). The first three are
# the main path's: EnsembleConfig's defaults and examples/pr2_arm.py's
# policy at PolicyConfig's default depth, 23 -> 64 -> 64 -> 7.
IMAG_CASES = [
    ("rollout_b64", 5, 64, 23, 7, 256, POLICY_HIDDEN, 2, None),
    ("rollout_b4096", 5, 4096, 23, 7, 256, POLICY_HIDDEN, 2, None),
    ("mbmpo_member_k1_b64", 1, 64, 23, 7, 256, POLICY_HIDDEN, 2, None),
    # test_kernels_interpret.py's edge shapes, with its one-hidden-layer
    # policy
    ("edge_empty_groups", 4, 64, 3, 1, 96, 48, 1, (10, 0, 54, 0)),
    ("edge_one_group_owns_all", 3, 48, 3, 1, 96, 48, 1, (0, 48, 0)),
    ("edge_straddling_b37", 5, 37, 4, 2, 24, 12, 1, (5, 8, 0, 20, 4)),
    ("edge_k1_b20", 1, 20, 5, 2, 32, 16, 1, (20,)),
    ("edge_wide_300", 3, 70, 6, 3, 300, 20, 1, None),
]
IMAG_MAIN = "rollout_b64"


def imag_inputs(gen, K, B, obs, act, hid, phid, pdepth, sizes):
    """Members, normaliser, policy, rows, noise and member ids on the card,
    at the scales a trained model and policy give them."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    din = obs + act
    dims = [din, hid, hid, obs]
    members = {"w": [rnd(K, a, b, scale=2 * a ** -0.5)
                     for a, b in zip(dims[:-1], dims[1:])],
               "b": [rnd(K, b, scale=0.2) for b in dims[1:]]}
    norm = {"mu_in": rnd(din, scale=0.2), "sig_in": rnd(din).abs() + 0.5,
            "mu_out": rnd(obs, scale=0.1), "sig_out": rnd(obs).abs() + 0.5}
    pdims = [obs] + [phid] * pdepth + [act]
    pol = {"w": [rnd(a, b, scale=a ** -0.5)
                 for a, b in zip(pdims[:-1], pdims[1:])],
           "b": [rnd(b, scale=0.2) for b in pdims[1:]],
           "log_std": torch.full((act,), -0.5, device="cuda")}
    if sizes is None:
        idx = torch.randint(0, K, (B,), generator=gen, device="cuda")
    else:
        ids = torch.repeat_interleave(torch.arange(K, device="cuda"),
                                      torch.tensor(sizes, device="cuda"))
        idx = ids[torch.randperm(B, generator=gen, device="cuda")]
    return members, norm, pol, rnd(B, obs, scale=2), rnd(B, act), idx


def imag_bound_ms(members, norm, pol, s, eps, idx) -> tuple:
    """Least time for the card: the bytes that this run's rows need (rows,
    noise, offsets and outputs; the policy and the normaliser; the weights
    of the members that own a row) over HBM bandwidth, against the f32 FMAs
    of every row's policy head and its one member's MLP."""
    K = members["w"][0].shape[0]
    used = int((torch.bincount(idx, minlength=K) > 0).sum())
    per_member = sum(t[0].numel() for t in members["w"] + members["b"])
    small = sum(t.numel() for t in pol["w"] + pol["b"]
                + [pol["log_std"]] + list(norm.values()))
    B, obs, act = s.shape[0], s.shape[1], eps.shape[1]
    rows = B * (obs + act) + (K + 1) + B * (obs + 2 * act)
    nbytes = 4 * (rows + small + used * per_member)
    macs = sum(w.shape[0] * w.shape[1] for w in pol["w"]) + sum(
        w.shape[1] * w.shape[2] for w in members["w"])
    return gmm_bound_ms(2.0 * B * macs, nbytes)


def imag_plan(imag_cuda, members, pol, B) -> dict:
    """The planner's launch for these widths, with the shared memory that
    the kernel itself lays out, which must be the planner's."""
    dims = tuple([members["w"][0].shape[1]]
                 + [w.shape[2] for w in members["w"]])
    pdims = tuple([pol["w"][0].shape[0]] + [w.shape[1] for w in pol["w"]])
    plan = dataclasses.asdict(imag_cuda.plan_step(
        B, members["w"][0].shape[0], dims, pdims))
    plan["kernel_smem"] = imag_cuda.kernel_smem_bytes(
        plan["rows"], plan["cluster"], dims, pdims)
    if plan["kernel_smem"] != plan["smem"]:
        raise RuntimeError(f"imag_fused: the planner's shared memory "
                           f"{plan['smem']} is not the kernel's "
                           f"{plan['kernel_smem']}")
    return plan


def check_imag(imag_cuda, imag_ops, imag_ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = {}
    for name, *case in IMAG_CASES:
        members, norm, pol, s, eps, idx = imag_inputs(gen, *case)
        K, B, obs, act, hid, phid, pdepth, sizes = case
        order, offsets = imag_ops.sort_plan(idx, K)
        ss, es = s[order].contiguous(), eps[order].contiguous()

        def kernel():
            return imag_cuda.fused_step_sorted(members, norm, pol, ss, es,
                                               offsets)

        def plain():
            return imag_ref.fused_step(members, norm, pol, s, eps, idx)
        got = kernel()
        torch.cuda.synchronize()
        want = [v[order] for v in plain()]
        errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        tol = IMAG_TOL * max(1.0, max(w.abs().max().item() for w in want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (finite and max(errs) <= tol):
            raise RuntimeError(f"imag_fused {name}: max abs errs {errs} > "
                               f"{tol} (finite {finite})")
        bound, bound_by = imag_bound_ms(members, norm, pol, s, eps, idx)
        plan = imag_plan(imag_cuda, members, pol, B)
        rows[name] = {
            "shape": [K, B, obs, act, hid, phid, pdepth], "plan": plan,
            "group_sizes": torch.bincount(idx, minlength=K).tolist(),
            "max_abs_err": max(errs), "max_abs_err_s2_a_pre": errs,
            "tol": tol, "ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": None,  # no PyTorch call computes this function
            "wall_ms": time_ms(kernel), "bound_ms": bound,
            "bound_by": bound_by}
        emit({"phase": "imag_check", "kernel": "imag_fused", "case": name,
              **rows[name]})
    return rows


def check_imag_grads(imag_ops) -> dict:
    """The meta-gradient MB-MPO takes, at the rollout shape: a loss at a
    policy adapted by one inner gradient step, differentiated w.r.t. the
    policy, through the kernel's Function and through the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    name, *case = IMAG_CASES[0]
    members, norm, pol, s, eps, idx = imag_inputs(gen, *case)
    n = len(pol["w"])

    def tree(leaves):
        return {"w": leaves[:n], "b": leaves[n:2 * n], "log_std": leaves[-1]}
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in pol["w"] + pol["b"] + [pol["log_std"]]]
        s2, a, pre = imag_ops.fused_step(members, norm, tree(leaves), s, eps,
                                         idx, impl=impl)
        inner = torch.autograd.grad((s2 ** 2).mean() + (a * pre).mean(),
                                    leaves, create_graph=True)
        q = [x - 0.05 * g for x, g in zip(leaves, inner)]
        s2, a, pre = imag_ops.fused_step(members, norm, tree(q), s,
                                         eps.flip(0), idx.flip(0), impl=impl)
        outer = torch.autograd.grad((s2 ** 2).mean() + (pre ** 2).mean(),
                                    leaves)
        grads[impl] = (inner, outer)
    out = {}
    for order, key in ((0, "first_order"), (1, "second_order")):
        err = max((g - w).abs().max().item() for g, w in
                  zip(grads["cuda"][order], grads["ref"][order]))
        tol = IMAG_TOL * max(1.0, max(w.abs().max().item()
                                      for w in grads["ref"][order]))
        if not err <= tol:
            raise RuntimeError(f"imag_fused {key} gradient: max abs err "
                               f"{err} > {tol}")
        out[key] = {"max_abs_err": err, "tol": tol}
    return {"case": name, **out}


# ---------------------------------------------------------------- phase 4

def check_model(CONFIG, init_params, api) -> dict:
    cfg = dataclasses.replace(CONFIG, num_layers=2, name=CONFIG.name + "-l2")
    model = init_params(cfg, 0)
    S, plen = PREFILL_BUCKETS[-1], 50
    rng = np.random.default_rng(0)
    tokens = torch.zeros((1, S), dtype=torch.int32, device="cuda")
    tokens[0, :plen] = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, plen).astype(np.int32))
    prompt_len = torch.tensor([plen], dtype=torch.int32, device="cuda")
    kernel = api.build_serve_prefill(cfg, 1, S)
    plain = api.build_serve_prefill(cfg, 1, S, attn_impl="ref")
    lg_k, cache_k = kernel.fn(model, {"tokens": tokens}, prompt_len)
    lg_r, cache_r = plain.fn(model, {"tokens": tokens}, prompt_len)
    torch.cuda.synchronize()
    if lg_k.shape != (1, cfg.padded_vocab(1)) or lg_k.dtype != torch.float32:
        raise RuntimeError(f"prefill logits {tuple(lg_k.shape)} "
                           f"{lg_k.dtype}")
    if not bool(torch.isfinite(lg_k).all()):
        raise RuntimeError("prefill logits through the kernel not finite")
    err = (lg_k - lg_r).abs().max().item()
    if not err <= LOGITS_ATOL:
        raise RuntimeError(f"prefill logits kernel vs plain: max abs err "
                           f"{err} > {LOGITS_ATOL}")
    if not torch.equal(cache_k["k"][0], cache_r["k"][0]):
        raise RuntimeError("layer-0 keys differ (computed before attention)")
    out = {"config": cfg.name, "layers": cfg.num_layers, "bucket": S,
           "prompt_len": plen, "max_abs_err": err, "atol": LOGITS_ATOL,
           "logits_std": lg_r.std().item(),
           "argmax_equal": int(lg_k.argmax()) == int(lg_r.argmax())}
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 5

def serve(CONFIG, init_params, ParameterServer, WorldModelServer,
          fa_ops):
    cfg = CONFIG
    ps = ParameterServer()
    t0 = time.perf_counter()
    ps.push(init_params(cfg, 1).state_dict())
    init_s = time.perf_counter() - t0
    srv = WorldModelServer(cfg, param_server=ps, n_slots=4, max_seq=96,
                           prompt_buckets=PREFILL_BUCKETS)
    rng = np.random.default_rng(1)
    lengths = list(SERVE_PROMPTS)
    rng.shuffle(lengths)
    fa_ops.launches = 0
    t0 = time.perf_counter()
    rids = []
    for i, plen in enumerate(lengths):
        prompt = rng.integers(0, cfg.vocab_size, plen)
        rids.append(srv.submit(prompt, max_new=SERVE_MAX_NEW))
        srv.step()
        if i == len(lengths) // 2:  # a mid-run training push
            ps.push(init_params(cfg, 2).state_dict())
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_ops.launches
    stats = srv.stats()
    for rid in rids:
        toks = srv.result(rid)
        if toks.shape != (SERVE_MAX_NEW,):
            raise RuntimeError(f"request {rid} returned {toks.shape} tokens")
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            raise RuntimeError(f"request {rid} emitted ids outside the vocab")
    used = {srv.sched.bucket_for(n) for n in lengths}
    prefills = len(srv.sched.admit_order)
    checks = {
        "hot_swaps == 1": stats["hot_swaps"] == 1,
        "version == 2": stats["version"] == 2,
        "decode shapes == 1": stats["decode_compiles"] == 1,
        "prefill shapes <= buckets used":
            stats["prefill_compiles"] <= len(used),
        "every request prefilled once": prefills == len(lengths),
        "kernel launches == prefills * layers":
            launches == prefills * cfg.num_layers,
        "kernel launched": launches > 0,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"serve invariants failed: {failed}; stats "
                           f"{stats}, launches {launches}")
    return srv, {"config": cfg.name, "layers": cfg.num_layers,
            "requests": len(lengths), "max_new": SERVE_MAX_NEW,
            "prompt_lengths": lengths, "buckets_used": sorted(used),
            "attention_launches": launches, "prefills": prefills,
            "wall_s": wall, "init_params_s": init_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            **stats}


def profile_decode(srv, cfg, ticks: int = 3, tries: int = 3) -> dict:
    """Where a full-width decode tick's time goes, after the main path's
    counts are read: ``torch.profiler`` over ``ticks`` steps with every slot
    busy. Device time is the sum of kernel times; the busy share is that
    over the host wall time of the same steps."""
    rng = np.random.default_rng(3)
    for _ in range(srv.sched.n_slots):  # busy through every session
        srv.submit(rng.integers(0, cfg.vocab_size, 16),
                   max_new=tries * ticks + 3)
    srv.step()  # admit every slot + the first decode
    srv.step()

    def run():
        for _ in range(ticks):
            srv.step()
    kernels, wall_ms = profiled(run, tries)
    srv.run()
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"ticks": ticks, "slots_busy": srv.sched.n_slots,
            "wall_ms_per_tick": wall_ms / ticks,
            "device_ms_per_tick": device_ms / ticks,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_tick": len(kernels) / ticks,
            "top_kernels_ms_per_tick": [[n[:80], ms / ticks]
                                        for n, ms in top]}


# ---------------------------------------------------------------- phase 6

def model_learn(gmm_ops) -> tuple:
    """Algorithms 1-2 through the port's worker entry points on the card.
    Returns the learner, its model server and the phase's record."""
    from repro_torch.core.servers import DataServer, ParameterServer
    from repro_torch.core.workers import (DataCollectionWorker,
                                          ModelLearningWorker)
    from repro_torch.envs import make_env
    from repro_torch.mbrl import dynamics as DYN
    from repro_torch.mbrl import policy as PI

    env = make_env(LEARN_ENV)
    gen = torch.Generator(device="cuda").manual_seed(0)
    policy_server, model_server = ParameterServer(), ParameterServer()
    data = DataServer()
    policy_server.push(PI.init_policy(
        PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=64), gen))
    data.set_target(LEARN_TRAJS)
    collector = DataCollectionWorker(env, policy_server, data, None, seed=1,
                                     envs_per_step=LEARN_LANES)
    cfg = DYN.EnsembleConfig(env.obs_dim, env.act_dim)
    # early stop off: the ten epochs on the full ring all run and push
    learner = ModelLearningWorker(cfg, data, model_server, seed=2,
                                  max_trajs=200, early_stop=False)
    gmm_ops.equal_launches = gmm_ops.equal_bwd_launches = 0
    collect_ms, grants, fill_val = [], [], []
    while True:
        g = data.try_claim(0, LEARN_LANES)
        if g == 0:
            break
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collector.step(g)
        torch.cuda.synchronize()
        collect_ms.append((time.perf_counter() - t0) * 1e3)
        grants.append(g)
        fill_val.append(learner.step())
    buf = learner.buffer
    fill_shapes = (learner.compile_count(), learner.val_compile_count())
    nb, bs = DYN.ring_grid(cfg, buf.capacity)
    n_active = min(max(buf.size // bs, 1), nb)
    depth = len(learner.params["members"]["w"])
    epochs = []
    for _ in range(LEARN_EPOCHS):
        f0, b0 = gmm_ops.equal_launches, gmm_ops.equal_bwd_launches
        v0 = model_server.version
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = learner.step()
        torch.cuda.synchronize()
        epochs.append({
            "ms": (time.perf_counter() - t0) * 1e3, "val_loss": val,
            "train_loss": float(learner.last_train_loss),
            "launches_fwd": gmm_ops.equal_launches - f0,
            "launches_bwd": gmm_ops.equal_bwd_launches - b0,
            "version_step": model_server.version - v0})
    launches = (gmm_ops.equal_launches, gmm_ops.equal_bwd_launches)
    # per epoch: every minibatch runs the depth layers forward, each
    # layer's dW and dX backward (the first layer's dX too: jax.grad, and
    # so the port, differentiates the normaliser), and one masked
    # validation forward
    want_fwd, want_bwd = n_active * depth + depth, n_active * 2 * depth
    vals = [e["val_loss"] for e in epochs]
    checks = {
        "total_pushed == total_trajs": data.total_pushed == LEARN_TRAJS,
        "grants land exactly": sum(grants) == LEARN_TRAJS,
        "train ring full": buf.size == buf.capacity,
        "val ring full": buf.val_size == buf.val_capacity,
        "one train_epoch / val_loss shape while filling": fill_shapes ==
            (1, 1),
        "one train_epoch / val_loss shape on the full ring":
            (learner.compile_count(), learner.val_compile_count()) == (1, 1),
        "one model version per epoch":
            all(e["version_step"] == 1 for e in epochs),
        "gmm_equal launches per epoch as the code implies":
            all((e["launches_fwd"], e["launches_bwd"]) == (want_fwd, want_bwd)
                for e in epochs),
        "last val loss finite": bool(np.isfinite(vals[-1])),
        "val loss falls": vals[-1] < vals[0],
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"model_learn invariants failed: {failed}; "
                           f"epochs {epochs}, grants {grants}")
    return learner, model_server, {
        "env": LEARN_ENV, "obs_dim": env.obs_dim, "act_dim": env.act_dim,
        "horizon": env.horizon, "ensemble": dataclasses.asdict(cfg),
        "policy_hidden": 64, "envs_per_step": LEARN_LANES,
        "total_trajs": data.total_pushed, "grants": grants,
        "ring": [buf.capacity, buf.val_capacity], "grid": [nb, bs],
        "n_active": n_active, "collect_ms_per_batch": collect_ms,
        "fill_val_losses": fill_val, "epochs": epochs,
        "epoch_ms": [e["ms"] for e in epochs],
        "launches_per_epoch": [want_fwd, want_bwd],
        "gmm_equal_launches": launches[0] + launches[1],
        "gmm_equal_launches_fwd": launches[0],
        "gmm_equal_launches_bwd": launches[1],
        "model_version": model_server.version}


def profile_epoch(learner) -> dict:
    """Where an epoch's time goes, after the main path's counts are read:
    ``torch.profiler`` over one more epoch on the full ring. Device time is
    the sum of kernel times; the busy share is that over the epoch's wall
    time under the profiler."""
    kernels, wall_ms = profiled(learner.step)
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    device = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_ms, "device_ms": device,
            "device_busy_share": device / wall_ms, "kernels": len(kernels),
            "gmm_equal_ms": sum(ms for n, ms in by_name.items()
                                if "gmm_equal" in n),
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


# ---------------------------------------------------------------- phase 7

def assigned_predict(learner, model_server, gmm_ops) -> dict:
    """The consumer's call: the published φ predicts the val ring's
    transitions, rows assigned to sampled members, through gmm_ragged."""
    from repro_torch.mbrl import dynamics as DYN
    params, version = model_server.pull()
    vdata, vsize = learner.buffer.val_view()
    obs, act = vdata["obs"][:vsize], vdata["act"][:vsize]
    gen = torch.Generator(device="cuda").manual_seed(3)
    idx = DYN.sample_members(params, (vsize,), gen)
    gmm_ops.ragged_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = DYN.predict_assigned(params, obs, act, idx)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = gmm_ops.ragged_launches
    depth = len(params["members"]["w"])
    want = DYN.ensemble_forward(params, obs, act)[
        idx, torch.arange(vsize, device="cuda")]
    err = (pred - want).abs().max().item()
    checks = {
        "shape": tuple(pred.shape) == (vsize, obs.shape[1]),
        "finite": bool(torch.isfinite(pred).all()),
        "matches the selected all-member forward": err <= ASSIGNED_ATOL,
        "one gmm_ragged launch per layer": launches == depth,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"assigned_predict failed: {failed}; max abs err "
                           f"{err}, launches {launches}")
    return {"rows": vsize, "model_version": version,
            "member_counts": torch.bincount(idx, minlength=5).tolist(),
            "max_abs_err": err, "atol": ASSIGNED_ATOL,
            "gmm_ragged_launches": launches, "first_call_ms": wall,
            "ms": time_ms(lambda: DYN.predict_assigned(params, obs, act, idx)),
            "device_ms": device_ms(
                lambda: DYN.predict_assigned(params, obs, act, idx))}


def ragged_launches(gmm_ops) -> tuple:
    """(forward, dx, dW) launches of the ragged kernels so far."""
    return (gmm_ops.ragged_launches, gmm_ops.ragged_bwd_launches,
            gmm_ops.ragged_dw_launches)


def expected_ragged_launches(depth: int) -> dict:
    """(forward, dx, dW) launches of :func:`ragged_grads` at ``depth``
    layers, all of whose inputs need a gradient. First order: each layer's
    forward, then its dx and dW. Second order, a dx and a dW a layer in
    each of four backward passes, after two forwards: the inner loss's
    backward (dW too: a Function computes what its inputs need, whatever
    the caller asks for); then the outer gradient through the outer
    forward, through each inner dx = R(dy, W^T) (whose backward is R(g, W)
    and T(dy, g)), and through the inner forward, whose activations that
    dy reads."""
    return {"first_order": (depth, depth, depth),
            "second_order": (2 * depth, 4 * depth, 4 * depth)}


def ragged_grads(gmm_ops, predict, leaves, target, second_order: bool):
    """Gradients of ``mean((predict(obs, act, weights) - target) ** 2)``
    w.r.t. ``leaves = [obs, act, *weights]``, and the (forward, dx, dW)
    launches they took. ``second_order``: at the inputs moved by one
    inner gradient step, ``x - INNER_STEP * dl/dx`` with the graph kept,
    as MB-MPO's inner step, so the gradient runs through the backward."""
    obs, act, *weights = leaves

    def loss(o, a):
        return ((predict(o, a, weights) - target) ** 2).mean()
    before = ragged_launches(gmm_ops)
    if second_order:
        g_obs, g_act = torch.autograd.grad(loss(obs, act), (obs, act),
                                           create_graph=True)
        out = loss(obs - INNER_STEP * g_obs, act - INNER_STEP * g_act)
    else:
        out = loss(obs, act)
    grads = torch.autograd.grad(out, leaves)
    return grads, tuple(n - b for n, b in zip(ragged_launches(gmm_ops),
                                              before))


def assigned_predictor(DYN, gmm_ops, params, idx, impl):
    """``predict(obs, act, weights)``: the kernel route is the user's
    ``DYN.predict_assigned``; ``impl="ref"`` the same function with the
    plain ragged product (autograd through its gather)."""
    norm = params["norm"]

    def predict(obs, act, weights):
        depth = len(weights) // 2
        members = {"w": weights[:depth], "b": weights[depth:]}
        if impl == "cuda":
            return DYN.predict_assigned({**params, "members": members}, obs,
                                        act, idx)
        dyn = gmm_ops.ensemble_mlp_select(
            members, DYN._normalized_input(params, obs, act), idx, impl=impl)
        return obs + dyn * norm["sig_out"] + norm["mu_out"]
    return predict


def backward_cost(DYN, params, obs, act, idx) -> dict:
    """One backward of the assigned predictor's loss w.r.t. the inputs and
    every member weight, on one retained graph: device ms (the profiler's
    kernel time), ms a backward by CUDA events over repeats, and the peak
    memory it adds over what the forward left allocated. Only
    ``DYN.predict_assigned`` is called, so any tree's package serves."""
    depth = len(params["members"]["w"])
    leaves = [obs.detach().clone().requires_grad_(True),
              act.detach().clone().requires_grad_(True)] + [
        t.detach().clone().requires_grad_(True)
        for t in params["members"]["w"] + params["members"]["b"]]
    members = {"w": leaves[2:2 + depth], "b": leaves[2 + depth:]}
    pred = DYN.predict_assigned({**params, "members": members}, leaves[0],
                                leaves[1], idx)
    loss = ((pred - obs) ** 2).mean()

    def backward():
        return torch.autograd.grad(loss, leaves, retain_graph=True)
    backward()
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    backward()
    torch.cuda.synchronize()
    peak_added = torch.cuda.max_memory_allocated() - base
    kernels, wall_ms = profiled(backward)
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"rows": obs.shape[0], "depth": depth,
            "device_ms": sum(by_name.values()), "kernels": len(kernels),
            "profiled_wall_ms": wall_ms, "ms": time_ms(backward),
            "peak_added_bytes": peak_added,
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


def assigned_grad(learner, model_server, gmm_ops) -> dict:
    """Gradients through the assigned predictor on the published ensemble,
    over all of the val ring's rows with sampled members: first order,
    then through an MB-MPO-style inner step, by the kernels (forward, dx,
    dW) against autograd of the plain route; the launch counts the depth
    implies; then the cost of one backward."""
    from repro_torch.mbrl import dynamics as DYN
    params, version = model_server.pull()
    vdata, vsize = learner.buffer.val_view()
    obs, act = vdata["obs"][:vsize], vdata["act"][:vsize]
    target = vdata["next_obs"][:vsize]
    gen = torch.Generator(device="cuda").manual_seed(5)
    idx = DYN.sample_members(params, (vsize,), gen)
    depth = len(params["members"]["w"])
    want_launches = expected_ragged_launches(depth)

    def leaves():
        return [t.detach().clone().requires_grad_(True) for t in
                [obs, act] + params["members"]["w"] + params["members"]["b"]]
    gmm_ops.ragged_launches = gmm_ops.ragged_bwd_launches = 0
    gmm_ops.ragged_dw_launches = 0
    out, launches = {}, {}
    for key, second in (("first_order", False), ("second_order", True)):
        grads = {}
        for impl in ("cuda", "ref"):
            predict = assigned_predictor(DYN, gmm_ops, params, idx, impl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads[impl], n = ragged_grads(gmm_ops, predict, leaves(), target,
                                          second)
            torch.cuda.synchronize()
            if impl == "cuda":
                launches[key] = n
                wall = (time.perf_counter() - t0) * 1e3
        errs = [((g - w).abs().max().item(),
                 ASSIGNED_GRAD_TOL * max(1.0, w.abs().max().item()))
                for g, w in zip(grads["cuda"], grads["ref"])]
        out[key] = {"max_abs_err": max(e for e, _ in errs),
                    "worst_err_over_tol": max(e / t for e, t in errs),
                    "launches": launches[key], "wall_ms": wall,
                    "finite": all(bool(torch.isfinite(g).all())
                                  for g in grads["cuda"])}
    totals = ragged_launches(gmm_ops)
    checks = {
        "first-order gradients match the plain route":
            out["first_order"]["worst_err_over_tol"] <= 1.0,
        "second-order gradients match the plain route":
            out["second_order"]["worst_err_over_tol"] <= 1.0,
        "finite": all(o["finite"] for o in out.values()),
        "forward, dx and dW launches as the depth implies":
            all(launches[k] == want_launches[k] for k in launches),
        "no launch outside the two gradients":
            totals == tuple(map(sum, zip(*launches.values()))),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"assigned_grad failed: {failed}; {out}, "
                           f"expected launches {want_launches}")
    return {"rows": vsize, "model_version": version, "depth": depth,
            "inner_step": INNER_STEP, "tol": ASSIGNED_GRAD_TOL, **out,
            "expected_launches": want_launches,
            "gmm_ragged_launches": sum(totals),
            "gmm_ragged_launches_fwd": totals[0],
            "gmm_ragged_launches_bwd": totals[1],
            "gmm_ragged_launches_dw": totals[2],
            "backward": backward_cost(DYN, params, obs, act, idx)}


def backward_cost_of_tree(src: str) -> dict:
    """:func:`backward_cost` with ``repro_torch`` imported from ``src``, at
    the val ring's 5,000 rows and ``EnsembleConfig``'s widths on
    ``pr2_lego_stack`` (obs 23, act 7), random weights and inputs."""
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.mbrl import dynamics as DYN
    gen = torch.Generator(device="cuda").manual_seed(6)
    cfg = DYN.EnsembleConfig(23, 7)
    params = DYN.init_ensemble(cfg, gen)
    rows = VAL_ROWS
    obs = torch.randn((rows, cfg.obs_dim), generator=gen, device="cuda")
    act = torch.randn((rows, cfg.act_dim), generator=gen, device="cuda")
    idx = DYN.sample_members(params, (rows,), gen)
    return {"src": src, "module": DYN.__file__,
            **backward_cost(DYN, params, obs, act, idx)}


# ---------------------------------------------------------------- phase 8

def policy_improve(model_server, imag_ops) -> tuple:
    """Algorithm 3 through the port's entry points on the card: a policy
    improver per algorithm on the published ensemble. Returns the ME-TRPO
    worker and the phase's record."""
    from repro_torch.core.servers import ParameterServer
    from repro_torch.core.workers import PolicyImprovementWorker
    from repro_torch.envs import make_env
    from repro_torch.mbrl import algos as A
    from repro_torch.mbrl import policy as PI

    env = make_env(LEARN_ENV)
    pol_cfg = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    record, workers = {}, {}
    imag_ops.launches = 0
    for seed, (name, n_steps) in enumerate(IMPROVE_STEPS.items()):
        cfg = A.AlgoConfig(algo=name)
        algo = A.make_algo(cfg, pol_cfg, env.reward, env.reset_batch)
        policy_server = ParameterServer()
        worker = PolicyImprovementWorker(algo, policy_server, model_server,
                                         seed=10 + seed)
        want = cfg.imagine_horizon * (
            2 * cfg.n_models if name == "mb-mpo" else 1)
        steps = []
        for _ in range(n_steps):
            l0, v0 = imag_ops.launches, policy_server.version
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            did = worker.step()
            torch.cuda.synchronize()
            info = {k: (v.tolist() if v.dim() else v.item())
                    for k, v in worker.last_info.items()}
            steps.append({"did": did, "ms": (time.perf_counter() - t0) * 1e3,
                          "launches": imag_ops.launches - l0,
                          "version_step": policy_server.version - v0,
                          **info})
        returns = [st["imagined_return"] for st in steps]
        checks = {
            "every step ran": all(st["did"] for st in steps),
            f"{want} imag_fused launches per step":
                all(st["launches"] == want for st in steps),
            "one improve shape": worker.compile_count() == 1,
            "one policy version per step":
                all(st["version_step"] == 1 for st in steps),
            "finite imagined returns": bool(np.isfinite(returns).all()),
            "policy finite": all(bool(torch.isfinite(t).all()) for t in
                                 policy_server.pull()[0]["w"]),
        }
        if name == "me-trpo":
            checks["a TRPO step found"] = any(st["found"] for st in steps)
        failed = [c for c, ok in checks.items() if not ok]
        if failed:
            raise RuntimeError(f"policy_improve {name} failed: {failed}; "
                               f"steps {steps}")
        record[name] = {"config": dataclasses.asdict(cfg),
                        "launches_per_step": want, "steps": steps,
                        "step_ms": [st["ms"] for st in steps],
                        "policy_version": policy_server.version,
                        "model_version": model_server.version}
        workers[name] = worker
    launches = imag_ops.launches
    return workers["me-trpo"], {
        "env": LEARN_ENV, "policy_hidden": POLICY_HIDDEN,
        "policy_depth": pol_cfg.depth, "imag_fused_launches": launches,
        **record, "on_path_check": check_improved_rollout(
            workers["me-trpo"], model_server, env, imag_ops)}


def check_improved_rollout(worker, model_server, env, imag_ops) -> dict:
    """The kernel against the plain version on the main path's own tensors,
    after its counts are read: the improved ME-TRPO policy and the
    published ensemble, over one imagined horizon from the task's start
    states, each step's rows the kernel's previous output."""
    from repro_torch.mbrl import dynamics as DYN
    from repro_torch.utils.tree import tree_to
    cfg, pol = worker.algo.cfg, worker.state["policy"]
    phi = tree_to(model_server.pull()[0], "cuda")
    members, norm = phi["members"], phi["norm"]
    gen = torch.Generator(device="cuda").manual_seed(6)
    s = env.reset_batch(gen, cfg.imagine_batch)
    idx, eps = DYN.rollout_draws(phi, cfg.imagine_horizon, cfg.imagine_batch,
                                 env.act_dim, gen)
    err = 0.0
    with torch.no_grad():
        for h in range(cfg.imagine_horizon):
            got = imag_ops.fused_step(members, norm, pol, s, eps[h], idx[h])
            want = imag_ops.fused_step(members, norm, pol, s, eps[h],
                                       idx[h], impl="ref")
            scale = max(1.0, max(w.abs().max().item() for w in want))
            err = max(err, max((g - w).abs().max().item() / scale
                               for g, w in zip(got, want)))
            s = got[0]
    if not (bool(torch.isfinite(s).all()) and err <= IMAG_TOL):
        raise RuntimeError(f"imag_fused on the improved policy: max scaled "
                           f"err {err} > {IMAG_TOL}")
    return {"policy_widths": [w.shape[0] for w in pol["w"]]
            + [pol["w"][-1].shape[1]], "steps": cfg.imagine_horizon,
            "max_scaled_err": err, "tol": IMAG_TOL}


def profile_improve(worker) -> dict:
    """Where an ME-TRPO improve step's time goes, after the main path's
    counts are read: ``torch.profiler`` over one more step."""
    kernels, wall_ms = profiled(worker.step)
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    device = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"algo": "me-trpo", "wall_ms": wall_ms, "device_ms": device,
            "device_busy_share": device / wall_ms, "kernels": len(kernels),
            "imag_fused_ms": sum(ms for n, ms in by_name.items()
                                 if "imag_fused" in n),
            "top_kernels_ms": [[n[:80], ms] for n, ms in top]}


# ---------------------------------------------------------------- phase 3

# name, B, L, H, P, N, G, chunk, dtype, initial state, final state, dt
# scale (small: slow decay, so the carried state shows in y). The first
# two are the main path's: the prefill (final state out) and the stateless
# forward of Mamba2-2.7B.
SSD_CASES = [
    ("prefill_b4_l1024", 4, 1024, 80, 64, 128, 1, 128, torch.bfloat16,
     False, True, 1.0),
    ("forward_b4_l2048", 4, 2048, 80, 64, 128, 1, 128, torch.bfloat16,
     False, False, 1.0),
    ("state_in_out_l300", 2, 300, 8, 64, 128, 1, 128, torch.float32,
     True, True, 0.02),
    ("state_in_out_bf16", 1, 300, 8, 64, 128, 1, 128, torch.bfloat16,
     True, True, 0.02),
    # test_kernels_interpret.py's and test_kernels.py's cases, and L < chunk
    ("edge_l256_c64", 2, 256, 4, 32, 16, 1, 64, torch.float32,
     False, False, 1.0),
    ("edge_l100_g2_c32", 1, 100, 8, 16, 32, 2, 32, torch.float32,
     True, True, 0.1),
    ("edge_p64_n64_bf16", 2, 64, 4, 64, 64, 1, 64, torch.bfloat16,
     False, True, 1.0),
    ("edge_l20_lt_chunk", 1, 20, 4, 16, 8, 1, 32, torch.float32,
     True, True, 0.1),
]
SSD_MAIN = "prefill_b4_l1024"


def ssd_inputs(gen, B, L, H, P, N, G, dtype, with_state, dt_scale):
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x = rnd(B, L, H, P, scale=0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(B, L, H)) * dt_scale
    A = -torch.exp(rnd(H, scale=0.3))
    Bm = rnd(B, L, G, N, scale=0.3).to(dtype)
    C = rnd(B, L, G, N, scale=0.3).to(dtype)
    s0 = rnd(B, H, P, N, scale=0.5) if with_state else None
    return x, dt, A, Bm, C, s0


def ssd_bound_ms(x, dt, Bm, C, s0, want_state, chunk) -> tuple:
    """Least time for the card: the bytes the scan must move (x, dt, A, B,
    C and the initial state read once, y and the final state written once)
    over HBM bandwidth, against its products at x's dtype's peak rate: per
    head and chunk of Q steps, C·Bᵀ (2·Q²·N), the masked block times xs
    (2·Q²·P), C·stateᵀ and the state update (2·Q·P·N each)."""
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + H * 4
              + (Bm.numel() + C.numel()) * Bm.element_size()
              + (s0.numel() * 4 if s0 is not None else 0)
              + (B * H * P * N * 4 if want_state else 0))
    n_chunks = -(-L // chunk)
    flops = 2.0 * B * H * n_chunks * (chunk * chunk * (N + P)
                                      + 2 * chunk * P * N)
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def check_ssd(ssd_cuda, ssd_ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {}
    for name, B, L, H, P, N, G, Q, dt_, s_in, s_out, dts in SSD_CASES:
        x, dt, A, Bm, C, s0 = ssd_inputs(gen, B, L, H, P, N, G, dt_, s_in,
                                         dts)
        kw = dict(chunk=Q, initial_state=s0, return_final_state=s_out)

        def kernel():
            return ssd_cuda.ssd_chunked(x, dt, A, Bm, C, **kw)

        def plain():
            return ssd_ref.ssd_chunked(x, dt, A, Bm, C, **kw)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got, want = ((got, want) if s_out else ((got,), (want,)))
        abs_errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want)]
        scales = [w.float().abs().max().item() for w in want]
        errs = [e / max(1.0, sc) for e, sc in zip(abs_errs, scales)]
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if not (finite and max(errs) <= SSD_TOL[dt_]):
            raise RuntimeError(f"ssd_chunked {name}: scaled errs {errs} > "
                               f"{SSD_TOL[dt_]} (finite {finite})")
        bound, bound_by = ssd_bound_ms(x, dt, Bm, C, s0, s_out, Q)
        rows[name] = {
            "shape": [B, L, H, P, N, G, Q],
            "dtype": str(dt_).replace("torch.", ""),
            "initial_state": s_in, "final_state": s_out,
            "max_abs_err": max(abs_errs), "max_abs_err_y_state": abs_errs,
            "scale_y_state": scales, "scaled_err": max(errs),
            "tol": SSD_TOL[dt_],
            "ms": device_ms(kernel, n=10, reps=3),
            "plain_ms": device_ms(plain, n=3, reps=2),
            "library_ms": None,  # no PyTorch call computes this function
            "bound_ms": bound, "bound_by": bound_by,
            "plan": ssd_cuda.plan(dt_)}
        emit({"phase": "ssd_check", "kernel": "ssd_chunked", "case": name,
              **rows[name]})
    return rows


# ---------------------------------------------------------------- phase 9

def _scaled(got, want) -> float:
    return ((got.float() - want.float()).abs().max().item()
            / max(1.0, want.float().abs().max().item()))


def check_ssm_model(CONFIG, init_params, api, InputShape) -> dict:
    """Mamba2-2.7B at full width, cut to 2 layers, f32, through the port's
    entry points: prefill(S) then decode(token S) against the last logits
    of prefill(S + 1), and the kernel route against the plain scan."""
    cfg = dataclasses.replace(CONFIG, num_layers=2, dtype="float32",
                              name=CONFIG.name + "-l2-f32")
    model = init_params(cfg, 0)
    S, B = SSM_CHECK_S, 2
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)).cuda()

    def prefill(n, impl=None):
        return api.build(cfg, InputShape("p", n, B, "prefill"),
                         ssd_impl=impl).fn(model, {"tokens": tokens[:, :n]})
    dec = api.build(cfg, InputShape("d", S + 1, B, "decode"))
    lg, cache = prefill(S)
    lg_ref, cache_ref = prefill(S, "ref")
    route_err = max(_scaled(lg, lg_ref),
                    _scaled(cache["ssm"], cache_ref["ssm"]))
    lg_dec, cache = dec.fn(model, cache, tokens[:, S:])
    lg_full, _ = prefill(S + 1)
    torch.cuda.synchronize()
    decode_err = _scaled(lg_dec, lg_full)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (lg, lg_dec, lg_full, cache["ssm"]))
    if not (finite and route_err <= SSM_ROUTE_TOL
            and decode_err <= SSM_DECODE_TOL):
        raise RuntimeError(f"ssm_model_check: kernel vs plain {route_err} "
                           f"(tol {SSM_ROUTE_TOL}), decode vs prefill "
                           f"{decode_err} (tol {SSM_DECODE_TOL}), finite "
                           f"{finite}")
    out = {"config": cfg.name, "layers": cfg.num_layers, "batch": B,
           "prefill_len": S, "chunk": cfg.ssm_chunk,
           "kernel_vs_plain_scaled_err": route_err, "tol": SSM_ROUTE_TOL,
           "decode_vs_prefill_scaled_err": decode_err,
           "decode_tol": SSM_DECODE_TOL,
           "logits_std": lg_full.std().item(),
           "argmax_equal": bool(torch.equal(lg_dec.argmax(-1),
                                            lg_full.argmax(-1)))}
    del model, cache, cache_ref
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 10

def ssm_serve(CONFIG, init_params, api, InputShape, ssd_ops) -> tuple:
    """Lock-step serving of the full Mamba2-2.7B in bf16 through the port's
    entry points: prefill a batch of prompts, then greedy decode. Returns
    the model, the decode bundle, the cache and the next tokens (for the
    profile after the counts are read) and the phase's record."""
    cfg = CONFIG
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, n_new = SSM_BATCH, SSM_PROMPT, SSM_NEW
    rng = np.random.default_rng(5)
    pre = api.build(cfg, InputShape("p", S, B, "prefill"))
    dec = api.build(cfg, InputShape("d", S + n_new, B, "decode"))
    ssd_ops.launches = 0
    prefill_ms, launches_per_prefill = [], []
    for _ in range(2):  # a cold prefill, then a warm one with fresh prompts
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
        l0 = ssd_ops.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = pre.fn(model, {"tokens": tokens})
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None].to(
            torch.int32)
        tok.cpu()  # the first token is on the host: time to first token
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        launches_per_prefill.append(ssd_ops.launches - l0)
    finite = bool(torch.isfinite(logits).all())
    out_tokens, tick_ms = [tok], []
    for _ in range(n_new - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = dec.fn(model, cache, tok)
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None].to(
            torch.int32)
        tok.cpu()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        finite = finite and bool(torch.isfinite(logits).all())
        out_tokens.append(tok)
    launches = ssd_ops.launches
    toks = torch.cat(out_tokens, 1)
    checks = {
        f"{cfg.num_layers} ssd_chunked launches per prefill":
            launches_per_prefill == [cfg.num_layers] * 2,
        "no scan launch in decode": launches == 2 * cfg.num_layers,
        "one decode input shape": dec.fn.shape_count == 1,
        "one prefill input shape": pre.fn.shape_count == 1,
        "finite logits": finite,
        "tokens in the vocab": bool(((toks >= 0)
                                     & (toks < cfg.vocab_size)).all()),
        "index advanced": int(cache["index"]) == S + n_new - 1,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"ssm_serve failed: {failed}; launches "
                           f"{launches_per_prefill}, {launches}")
    ticks = sorted(tick_ms)
    record = {
        "config": cfg.name, "layers": cfg.num_layers, "batch": B,
        "prompt_len": S, "new_tokens": n_new, "dtype": cfg.dtype,
        "init_params_s": init_s, "prefill_ms_cold_warm": prefill_ms,
        "ttft_ms": prefill_ms[-1],
        "prefill_tokens_per_s": B * S / (prefill_ms[-1] / 1e3),
        "decode_tokens_per_s": B * len(tick_ms) / (sum(tick_ms) / 1e3),
        "tick_ms_p50": ticks[len(ticks) // 2],
        "tick_ms_p95": ticks[min(len(ticks) - 1,
                                 int(round(0.95 * (len(ticks) - 1))))],
        "ssd_launches": launches,
        "ssd_launches_per_prefill": launches_per_prefill,
        "decode_shapes": dec.fn.shape_count,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "tokens_row0": toks[0, :8].tolist()}
    return (model, dec, cache, tok), record


def profile_ssm_tick(model, dec, cache, tok) -> dict:
    """Where one full-depth decode tick's time goes, after the main path's
    counts are read."""
    kernels, wall_ms = profiled(lambda: dec.fn(model, cache, tok))
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device,
            "device_busy_share": device / wall_ms, "kernels": len(kernels)}


# ---------------------------------------------------------------- phase 11

def ssm_forward(model, LM, ssd_ops) -> dict:
    """The stateless forward and loss of the full Mamba2-2.7B (forward
    only), then ``torch.profiler`` over one more run for the scan's share
    of device time."""
    cfg = model.cfg
    B, S = SSM_BATCH, SSM_FORWARD_SEQ
    rng = np.random.default_rng(6)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
        for k in ("tokens", "labels")}
    ssd_ops.launches = 0
    ms = []
    with torch.no_grad():
        for _ in range(2):  # cold, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, c, _ = LM.loss_forward(cfg, model, batch)
            loss = (s / c).item()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = ssd_ops.launches
        if launches != 2 * cfg.num_layers or not np.isfinite(loss):
            raise RuntimeError(f"ssm_forward: {launches} ssd_chunked "
                               f"launches for 2 forwards, loss {loss}")
        kernels, wall_ms = profiled(
            lambda: LM.loss_forward(cfg, model, batch))
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    device = sum(by_name.values())
    ssd_ms = sum(v for n, v in by_name.items() if "ssd_chunked" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"config": cfg.name, "batch": B, "seq": S, "loss": loss,
            "ms_cold_warm": ms, "tokens_per_s": B * S / (ms[-1] / 1e3),
            "ssd_launches": launches,
            "ssd_launches_per_forward": launches // 2,
            "profiled_wall_ms": wall_ms, "device_ms": device,
            "device_busy_share": device / wall_ms, "ssd_ms": ssd_ms,
            "ssd_share_of_device": ssd_ms / device,
            "top_kernels_ms": [[n[:80], v] for n, v in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA
    from repro_torch.core.servers import ParameterServer
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.gmm import cuda as gmm_cuda
    from repro_torch.kernels.gmm import ops as gmm_ops
    from repro_torch.kernels.gmm import ref as gmm_ref
    from repro_torch.kernels.imag import cuda as imag_cuda
    from repro_torch.kernels.imag import ops as imag_ops
    from repro_torch.kernels.imag import ref as imag_ref
    from repro_torch.kernels.ssd import cuda as ssd_cuda
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import api
    from repro_torch.models import lm as LM
    from repro_torch.models.config import InputShape
    from repro_torch.models.lm import init_params
    from repro_torch.serve import WorldModelServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    sources = [fa_cuda.SOURCE, gmm_cuda.SOURCE, imag_cuda.SOURCE,
               ssd_cuda.SOURCE]
    t0 = time.perf_counter()
    built = build.build(sources)
    seconds = time.perf_counter() - t0
    hmma = {str(src.relative_to(ROOT)): build.count_sass(info["library"],
                                                         "HMMA")
            for src, info in built.items()}
    for src in sources:
        if not hmma[str(src.relative_to(ROOT))]:
            raise RuntimeError(f"{src.name}: no tensor-core (HMMA) "
                               "instruction in its library")
    emit({"phase": "build", "seconds": seconds,
          "sources": [str(s.relative_to(ROOT)) for s in sources],
          "hmma_instructions": hmma,
          "registers": {str(src.relative_to(ROOT)): ptxas_kernels(info["log"])
                        for src, info in built.items()},
          "ptxas": [line.strip() for info in built.values()
                    for line in info["log"].splitlines() if "Used" in line]})

    rows = check_attention(fa_ops, fa_ref)
    gmm_rows = check_gmm(gmm_cuda, gmm_ref)
    sweep_gmm_plans(gmm_cuda, gmm_ref)
    sweep_ragged_plans(gmm_cuda, gmm_ref)
    imag_rows = check_imag(imag_cuda, imag_ops, imag_ref)
    ssd_rows = check_ssd(ssd_cuda, ssd_ref)
    emit({"phase": "imag_grad_check", **check_imag_grads(imag_ops)})
    emit({"phase": "model_check", **check_model(CONFIG, init_params, api)})
    srv, served = serve(CONFIG, init_params, ParameterServer,
                        WorldModelServer, fa_ops)
    emit({"phase": "serve", **served})
    emit({"phase": "decode_profile", **profile_decode(srv, CONFIG)})
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    learner, model_server, learned = model_learn(gmm_ops)
    emit({"phase": "model_learn", **learned})
    emit({"phase": "epoch_profile", **profile_epoch(learner)})
    assigned = assigned_predict(learner, model_server, gmm_ops)
    emit({"phase": "assigned_predict", **assigned})
    grad = assigned_grad(learner, model_server, gmm_ops)
    emit({"phase": "assigned_grad", **grad})
    worker, improved = policy_improve(model_server, imag_ops)
    emit({"phase": "policy_improve", **improved})
    emit({"phase": "improve_profile", **profile_improve(worker)})
    del worker, learner, model_server
    gc.collect()
    torch.cuda.empty_cache()

    emit({"phase": "ssm_model_check",
          **check_ssm_model(MAMBA, init_params, api, InputShape)})
    (model, dec, cache, tok), ssm_served = ssm_serve(
        MAMBA, init_params, api, InputShape, ssd_ops)
    emit({"phase": "ssm_serve", **ssm_served})
    emit({"phase": "ssm_tick_profile",
          **profile_ssm_tick(model, dec, cache, tok)})
    del dec, cache
    ssm_fwd = ssm_forward(model, LM, ssd_ops)
    emit({"phase": "ssm_forward", **ssm_fwd})
    del model
    gc.collect()
    torch.cuda.empty_cache()

    main_row = rows[MAIN_PATH_CASE]
    eq, rg = (gmm_rows["equal"][GMM_EQUAL_MAIN],
              gmm_rows["ragged"][GMM_RAGGED_MAIN])
    im = imag_rows[IMAG_MAIN]
    sd = ssd_rows[SSD_MAIN]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": str(fa_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/pallas.py:71",
        "launches": served["attention_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "tflops": main_row["tflops"],
        "shape": MAIN_PATH_CASE}, {
        "name": "gmm_equal", "route": "cuda",
        "source": str(gmm_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/gmm/pallas.py:47",
        "launches": learned["gmm_equal_launches"],
        "launches_fwd": learned["gmm_equal_launches_fwd"],
        "launches_bwd": learned["gmm_equal_launches_bwd"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in gmm_rows["equal"].values()),
        "ms": eq["ms"], "plain_ms": eq["plain_ms"],
        "bound_ms": eq["bound_ms"], "bound_by": eq["bound_by"],
        "library_ms": eq["library_ms"], "tflops": eq["tflops"],
        "shape": GMM_EQUAL_MAIN}, {
        "name": "gmm_ragged", "route": "cuda",
        "source": str(gmm_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/gmm/pallas.py:104",
        "launches": assigned["gmm_ragged_launches"]
            + grad["gmm_ragged_launches"],
        "launches_fwd": assigned["gmm_ragged_launches"]
            + grad["gmm_ragged_launches_fwd"],
        "launches_bwd": grad["gmm_ragged_launches_bwd"],
        "launches_dw": grad["gmm_ragged_launches_dw"],
        "max_abs_err": max(r["max_abs_err"]
                           for case in gmm_rows["ragged"].values()
                           for r in case.values()),
        "ms": rg["fwd"]["ms"], "plain_ms": rg["fwd"]["plain_ms"],
        "bound_ms": rg["fwd"]["bound_ms"], "bound_by": rg["fwd"]["bound_by"],
        "library_ms": rg["fwd"]["library_ms"], "tflops": rg["fwd"]["tflops"],
        "dx_ms": rg["dx"]["ms"], "dx_bound_ms": rg["dx"]["bound_ms"],
        "dw_ms": rg["dw"]["ms"], "dw_bound_ms": rg["dw"]["bound_ms"],
        "dw_library_ms": rg["dw"]["library_ms"],
        "shape": GMM_RAGGED_MAIN}, {
        "name": "imag_fused", "route": "cuda",
        "source": str(imag_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/imag/pallas.py:97",
        "launches": improved["imag_fused_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in imag_rows.values()),
        "ms": im["ms"], "plain_ms": im["plain_ms"],
        "bound_ms": im["bound_ms"], "bound_by": im["bound_by"],
        "library_ms": im["library_ms"], "shape": IMAG_MAIN,
        "plan": im["plan"]}, {
        "name": "ssd_chunked", "route": "cuda",
        "source": str(ssd_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssd/pallas.py:68",
        "launches": ssm_served["ssd_launches"] + ssm_fwd["ssd_launches"],
        "launches_serve": ssm_served["ssd_launches"],
        "launches_forward": ssm_fwd["ssd_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows.values()),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": sd["library_ms"], "shape": SSD_MAIN,
        "plan": sd["plan"]}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main_backward_cost(src: str) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "assigned_backward_cost", "nvidia_smi": nvidia_smi(),
          **backward_cost_of_tree(src)})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--backward-cost":
        sys.exit(main_backward_cost(sys.argv[2]))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
