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
9. The engines, on the same configuration (``pr2_lego_stack``, the ensemble
   at ``EnsembleConfig`` defaults, ME-TRPO at ``AlgoConfig`` defaults, the
   policy of ``examples/pr2_arm.py``) with ``RunConfig(total_trajs=12,
   seed=0)``. ``event_run``: ``AsyncTrainer`` under the event engine.
   Asserts 120.0 s of robot time (12 × horizon 100 × dt 0.1), exactly 12
   trajectories, one input shape on both learners, each epoch's
   ``gmm_equal`` launches as ``model_learn`` counts them at that epoch's
   ring, 50 ``imag_fused`` launches per policy step and finite eval
   returns; reports the model epochs, policy steps and wall seconds of the
   run, and the host wall seconds in each worker's ``step`` (and the
   recorder's evals), each call ending in ``torch.cuda.synchronize()`` so
   that its device work counts with it. A second event run, with the same
   checks and no synchronising, gives the engine's own wall time
   (``unsynchronised``). ``sequential_run``: ``SequentialTrainer`` on the
   same configuration in rounds of 4 rollouts (so it collects the same 12
   trajectories), its other arguments at their defaults: the same checks,
   a robot time above its collection time, and above the event run's (the
   paper's Fig. 2). ``quickstart``: ``examples/torch_quickstart.main()``
   on the card (pendulum, 3 members of hidden 64, a policy of 32, 48 × 40
   imagination): 120.0 s of robot time and the same launch checks,
   ``imag_fused`` at 40 launches a step.
   The threads engine, on the same configuration: ``threads_paced``,
   ``AsyncTrainer(mode="threads")`` with ``RunConfig(total_trajs=12,
   seed=0, pace_collection=True, collect_speed=10.0)``, so each trajectory
   takes 1.0 s of wall time; each role on its own CUDA stream, its steps
   timed on the host without synchronising. Asserts exactly 12
   trajectories, wall time at least the 12 s of collection (pacing held),
   a model version and a policy step, one input shape on both learners,
   each epoch's ``gmm_equal`` launches as its ring implies and 50
   ``imag_fused`` launches a step; reports the wall / collection ratio
   (the paper: near 1), policy steps (per trajectory, beside
   ``event_run``'s), model epochs and the final versions.
   ``ckpt_roundtrip``: that run's trained ensemble and policy (and a bf16
   copy) through ``checkpoint.io`` under ``build/`` and back onto the
   card, bit-equal. ``threads_fleet``: unpaced, 3 collectors of 5 robots
   on 12 trajectories, the same checks and a partial grant.
   ``threads_profile``: a short unpaced threads run under
   ``torch.profiler``: the device's busy share over the run's wall time
   and the share of kernel time that overlaps a kernel on another stream
   (reported only). ``stream_handoff``: a push on one stream after a
   ~0.1 s kernel, pulled and drained on another, must give the pushed
   values; the unchanged ``pull_if_newer`` runs under
   ``torch.cuda.set_sync_debug_mode("error")``. ``model_free``: the
   model-free PPO baseline, two iterations on the card: finite returns,
   the trace's time as accounted. ``threads_paced`` also gives the
   device's busy share by ``nvidia-smi``'s ``utilization.gpu``, sampled
   every 200 ms over the run (``UtilSampler``).
   The procs engine, on the same configuration: ``procs_paced``,
   ``AsyncTrainer(mode="procs")`` with ``threads_paced``'s ``RunConfig``,
   held until the policy child is past one step: each collector, the model and the policy worker a spawned process with
   a CUDA context of its own, the kernels built by the parent before it
   spawns them. Asserts exactly 12 trajectories, no restart, the parent
   launching no kernel, the model child's ``gmm_equal`` and the policy
   child's ``imag_fused`` launches (50 a step, and 50 in the one
   ``improve`` the policy child runs as a warm-up before its first step,
   reported apart) on the card as each child reports them in its
   heartbeat, and the collection window (from the
   first policy a collector can pull to the fleet's exit) at least the
   collection time; reports the wall time, the window, both over the
   collection time, policy steps a trajectory beside ``threads_paced``'s
   and ``event_run``'s, model epochs, and the device's busy share by
   ``UtilSampler`` beside ``threads_paced``'s. ``procs_restart``: the
   same run, the model child SIGKILLed after the first snapshot that holds
   a trained model while at least ``min_warmup_trajs`` trajectories are
   still to come; it must come back from that snapshot or a later one and
   train on them past its republished snapshot, with exactly 12
   trajectories.
   ``procs_fleet``: 3 collectors of 5 robots, unpaced, exactly 12
   trajectories with a partial grant, both kernels launched.
   The tcp control plane and the chaos tier, on the same configuration:
   ``threads_tcp``, ``threads_paced`` with every store behind a loopback
   ``ControlPlane`` (``transport="tcp"``): exactly 12 trajectories,
   unchanged pulls that moved zero array bytes by the client's counter,
   50 ``imag_fused`` launches a policy step with at least one step,
   ``gmm_equal`` launches; reports the wall / collection ratio, policy
   steps and the host milliseconds of a changed and of an unchanged pull.
   ``procs_tcp_join``: ``procs_paced`` over tcp, with one collector joining
   the live run from this process through the plane's address
   (``join_as_collectors``): exactly 12 trajectories, at least one of them
   the joiner's under an id past the fleet's, no restart, the children's
   launches from their heartbeats and none in the parent. ``chaos_run``:
   ``procs_paced`` with two collectors over the file-backed stores under a
   seeded ``FaultPlan`` (seed 0: 5 faults, at most 2 kills a role;
   ``max_restarts=3``) injected by ``ChaosSupervisor`` with an
   ``InvariantMonitor`` watching, inside a ``ResourceAuditor`` baseline and
   audit: zero violations, zero leaks, at least 3 faults across all three
   role families, exactly 12 trajectories, and each restarted learner's
   last incarnation at work with its kernel's launches; reports each
   fault's time, each respawn's seconds to its first heartbeat and first
   work, and the wall time.
10. ``ssm_model_check``: Mamba2-2.7B at full width, cut to 2 layers, f32:
   prefill(S) then decode(token S) against prefill(S + 1), and the kernel
   route against the plain scan.
11. ``ssm_serve``: lock-step serving of the full 64-layer Mamba2-2.7B in
   bf16: batch 4, 1,024-token prompts, 32 greedy tokens. Asserts 64
   ``ssd_chunked`` launches per prefill, one decode input shape and finite
   logits; reports prefill, time to first token, decode tokens/s, tick
   latencies and peak memory. Then ``ssm_tick_profile``:
   ``torch.profiler`` over one more tick.
12. ``ssm_forward``: the stateless ``loss_forward`` at batch 4, 2,048
   tokens, forward only: 64 launches, tokens/s, the scan's share of
   device time.
13. ``kernels``: one entry per kernel, as the port's records expect;
   ``gmm_equal`` and ``imag_fused`` also give their ``event_run``,
   ``threads_paced``, ``procs_paced``, ``threads_tcp``, ``procs_tcp_join``
   and ``chaos_run`` launches.

Each kernel's launches are counted from 0 just before the phase that
drives its path (``serve``, ``model_learn``, ``assigned_predict``,
``assigned_grad``, ``policy_improve``, each engine run of ``event_run``,
``sequential_run``, ``quickstart``, ``threads_paced``, ``threads_fleet``,
``threads_profile``, ``procs_paced``, ``procs_restart``, ``procs_fleet``,
``threads_tcp``, ``procs_tcp_join``, ``chaos_run``,
``ssm_serve``, ``ssm_forward``) and
read just after it (the procs phases' children count from 0 in their own
processes and report in their heartbeats); comparison launches never
count. The line before the
last is the card's name and power limit from ``nvidia-smi``; the last is
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
import shutil
import subprocess
import sys
import threading
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
# the engines (event_run, sequential_run): RunConfig(total_trajs=12, seed=0)
ENGINE_TRAJS = 12
# SequentialTrainer's rounds: 4 rollouts each, so that it collects the
# same 12 trajectories as the event run and its extra robot time is its
# training alone
SEQ_ROLLOUTS = 4
# the threads engine: paced, 10 s of robot time a trajectory (horizon 100
# x dt 0.1) in 1.0 s of wall time, so the 12 trajectories take >= 12 s
THREADS_SPEED = 10.0
# unpaced, three farms of five robots: grants of 5, 5 and a partial 2
THREADS_FLEET = dict(n_collectors=3, envs_per_collector=5)
THREADS_PROFILE_TRAJS = 12
# ~0.1 s of the card's clock, queued before a push on the pusher's stream
HANDOFF_SLEEP_CYCLES = 200_000_000
# the model-free baseline: two iterations of 4 trajectories
MODEL_FREE_TRAJS = 8
# the procs engine's paced run and restart: threads_paced's configuration,
# the run held until the policy child is past one step (its start-up and
# warm-up can outlast the 12 s of collection, and then its steps would
# launch no kernel); its fleet: threads_fleet's, with both learners past a
# step so that both kernels launch in their children
PROCS_PACED = dict(total_trajs=ENGINE_TRAJS, pace_collection=True,
                   collect_speed=THREADS_SPEED, min_final_policy_version=2)
# the restart: snapshots every second, so that the first trained one
# comes early in the collection
PROCS_RESTART = dict(PROCS_PACED, snapshot_every_s=1.0)
# a restarted model child that has not trained this long after the kill
# fails the phase instead of holding the run open
RESTART_TRAIN_S = 120.0
PROCS_FLEET = dict(total_trajs=ENGINE_TRAJS, min_final_model_version=1,
                   min_final_policy_version=2)
# the route the procs children must report: on the card each launches its
# kernels ("cuda"); children on the CPU run the plain versions ("plain")
# and launch nothing
CHILD_ROUTE = "cuda"
# the chaos run: procs_paced's configuration with two collectors, under the
# micro soak profile's fault plan (5 faults, at most 2 kills a role) and
# restart budget, from this seed
CHAOS_SEED = 0
CHAOS_PLAN = dict(n_collectors=2, n_faults=5, max_kills_per_role=2)
CHAOS_RUN = dict(n_collectors=2, max_restarts=3)
# nvidia-smi's utilization.gpu (the share of each sample period in which a
# kernel ran), sampled this often over an engine run
SMI_SAMPLE_MS = 200


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
    # the quickstart's ensemble (pendulum, obs 3, act 1, hidden 64, 3
    # members): minibatches of 256 rows, a val ring of 10,000
    ("quickstart_train_l1_fwd", 3, 256, 4, 64, "fwd_bcast"),
    ("quickstart_train_l2_fwd", 3, 256, 64, 64, "fwd"),
    ("quickstart_train_l3_fwd", 3, 256, 64, 3, "fwd"),
    ("quickstart_train_l1_dx", 3, 256, 4, 64, "dx"),
    ("quickstart_train_l1_dw", 3, 256, 4, 64, "dw_bcast"),
    ("quickstart_train_l2_dx", 3, 256, 64, 64, "dx"),
    ("quickstart_train_l2_dw", 3, 256, 64, 64, "dw"),
    ("quickstart_train_l3_dx", 3, 256, 64, 3, "dx"),
    ("quickstart_train_l3_dw", 3, 256, 64, 3, "dw"),
    ("quickstart_val_l1_fwd", 3, 10000, 4, 64, "fwd_bcast"),
    ("quickstart_val_l2_fwd", 3, 10000, 64, 64, "fwd"),
    ("quickstart_val_l3_fwd", 3, 10000, 64, 3, "fwd"),
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
        if name.startswith(("edge", "quickstart")):
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
    # the quickstart's step: pendulum, 3 members of hidden 64, policy
    # 3 -> 32 -> 32 -> 1, 48 imagined starts
    ("quickstart_b48", 3, 48, 3, 1, 64, 32, 2, None),
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

def epoch_gmm_launches(learner) -> tuple:
    """The ``gmm_equal`` launches (forward, backward) of one epoch on the
    learner's ring as it now stands: every active minibatch runs the depth
    layers forward, each layer's dW and dX backward (the first layer's dX
    too: jax.grad, and so the port, differentiates the normaliser), and
    one masked validation forward."""
    from repro_torch.mbrl import dynamics as DYN
    nb, bs = DYN.ring_grid(learner.cfg, learner.buffer.capacity)
    n_active = min(max(learner.buffer.size // bs, 1), nb)
    depth = len(learner.params["members"]["w"])
    return n_active * depth + depth, n_active * 2 * depth


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
    want_fwd, want_bwd = epoch_gmm_launches(learner)
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


# ---------------------------------------------------------------- phase 9

def engine_parts():
    """The engines' configuration: pr2_lego_stack, the ensemble at
    ``EnsembleConfig`` defaults, ME-TRPO at ``AlgoConfig`` defaults and the
    policy of ``examples/pr2_arm.py``, as ``model_learn`` and
    ``policy_improve`` run them."""
    from repro_torch.envs import make_env
    from repro_torch.mbrl import algos as A
    from repro_torch.mbrl import dynamics as DYN
    from repro_torch.mbrl import policy as PI
    env = make_env(LEARN_ENV)
    ens = DYN.EnsembleConfig(env.obs_dim, env.act_dim)
    pol = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    acfg = A.AlgoConfig(algo="me-trpo")
    return env, ens, acfg, A.make_algo(acfg, pol, env.reward,
                                       env.reset_batch)


def time_workers(trainer, gmm_ops, sync: bool) -> dict:
    """Wrap the trainer's worker instances' ``step`` and its recorder's
    ``record`` to count and time each call on the host's clock. With
    ``sync`` each call also ends in ``torch.cuda.synchronize()``, so the
    seconds of a worker include its device work (and the run loses the
    overlap of one step's kernels with the next step's host code);
    without it they are the host's seconds alone and the run's own wall
    time stands. Each model epoch also records its ``gmm_equal`` launches
    beside the count its ring implies (exact under the threads engine too:
    only the model worker launches ``gmm_equal``)."""
    stats = {k: {"calls": 0, "work": 0, "s": 0.0}
             for k in ("collect", "model", "policy", "eval")}
    lock = threading.Lock()     # a fleet's collectors share one record
    epochs = []
    workers = [("collect", c) for c in getattr(trainer, "collectors",
                                                [trainer.collector])]
    workers += [("model", trainer.model_worker),
                ("policy", trainer.policy_worker),
                ("eval", trainer.recorder)]
    for kind, obj in workers:
        name = "record" if kind == "eval" else "step"

        def timed(*args, _call=getattr(obj, name), _kind=kind):
            f0, b0 = gmm_ops.equal_launches, gmm_ops.equal_bwd_launches
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _call(*args)
            if sync:
                torch.cuda.synchronize()
            with lock:
                st = stats[_kind]
                st["calls"] += 1
                st["s"] += time.perf_counter() - t0
                st["work"] += out is not None and out is not False
            if _kind == "model" and out is not None:
                epochs.append({
                    "launches": [gmm_ops.equal_launches - f0,
                                 gmm_ops.equal_bwd_launches - b0],
                    "want": list(epoch_gmm_launches(trainer.model_worker)),
                    "ring": trainer.model_worker.buffer.size})
            return out
        setattr(obj, name, timed)
    return {"workers": stats, "epochs": epochs}


def drive_engine(name, run, gmm_ops, imag_ops, *, sync: bool) -> dict:
    """``run(hook)`` builds one trainer, hands it to ``hook`` before it
    runs, runs it through its entry point and returns the trace. The
    launch counts go to 0 just before ``run`` and are read just after.
    Asserts one input shape on both learners, the ``gmm_equal`` launches
    of every epoch, ``imag_fused``'s H launches a policy step, robot time
    = collected trajectories x horizon x dt plus the synchronous engines'
    training time, and finite eval returns."""
    made = []

    def hook(trainer):
        made.append((trainer, time_workers(trainer, gmm_ops, sync)))
    gmm_ops.equal_launches = gmm_ops.equal_bwd_launches = 0
    imag_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = run(hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gmm = gmm_ops.equal_launches + gmm_ops.equal_bwd_launches
    imag = imag_ops.launches
    (trainer, timing), = made
    env, model, policy = (trainer.env, trainer.model_worker,
                          trainer.policy_worker)
    horizon = policy.algo.cfg.imagine_horizon
    epochs, workers = timing["epochs"], timing["workers"]
    robot, trajs = trace[-1]["time"], trace[-1]["trajs"]
    collect_s = trajs * env.horizon * env.dt
    checks = {
        "finite eval returns": all(np.isfinite(r["eval_return"])
                                   for r in trace),
        "one train_epoch shape": model.compile_count() == 1,
        "one improve shape": policy.compile_count() == 1,
        "every epoch's gmm_equal launches as its ring implies":
            all(e["launches"] == e["want"] for e in epochs),
        "gmm_equal launches = the epochs' sum":
            gmm == sum(sum(e["want"]) for e in epochs),
        "one epoch recorded per model epoch": len(epochs) == model.epochs,
        f"imag_fused launches = policy steps x {horizon}":
            imag == policy.steps * horizon > 0,
        "trajectories = the data server's":
            trainer.data_server.total_pushed == trajs,
    }
    if hasattr(trainer, "collectors"):
        # the async engine: robot time is the collection time (Fig. 2)
        checks[f"robot time = {trajs} x {env.horizon} x {env.dt} s"] = \
            abs(robot - collect_s) <= 1e-9
    else:
        # a synchronous engine: collection, then training on the clock
        checks["robot time above the collection time"] = robot > collect_s
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{name} failed: {failed}; epochs {epochs}, "
                           f"trace {trace}")
    busy = sum(w["s"] for w in workers.values())
    return {
        "engine": type(trainer).__name__, "synchronised_steps": sync,
        "trajs": trajs, "robot_time_s": robot, "collection_time_s": collect_s,
        "wall_s": wall, "model_epochs": model.epochs,
        "policy_steps": policy.steps, "evals": len(trace),
        "worker_wall_s": {k: w["s"] for k, w in workers.items()},
        "worker_share": {k: w["s"] / wall for k, w in workers.items()},
        "engine_other_s": wall - busy, "worker_calls": workers,
        "gmm_equal_launches": gmm, "imag_fused_launches": imag,
        "launches_per_epoch": sorted({tuple(e["want"]) for e in epochs}),
        "eval_returns": [r["eval_return"] for r in trace],
        "trace_time": [r["time"] for r in trace]}


def engine_run(name, trainer_cls, gmm_ops, imag_ops, *, sync=True,
               **kw) -> dict:
    """One engine through its entry point on the card:
    ``RunConfig(total_trajs=ENGINE_TRAJS, seed=0)`` on ``engine_parts``,
    checked by ``drive_engine``; every engine must end at exactly
    ``ENGINE_TRAJS`` trajectories."""
    from repro_torch.core import RunConfig
    env, ens, acfg, algo = engine_parts()

    def run(hook):
        trainer = trainer_cls(env, ens, algo,
                              RunConfig(total_trajs=ENGINE_TRAJS, seed=0),
                              **kw)
        hook(trainer)
        return trainer.run()
    rec = drive_engine(name, run, gmm_ops, imag_ops, sync=sync)
    if rec["trajs"] != ENGINE_TRAJS:
        raise RuntimeError(f"{name}: {rec['trajs']} trajectories, not "
                           f"{ENGINE_TRAJS}")
    return {"env": LEARN_ENV, "ensemble": dataclasses.asdict(ens),
            "algo": dataclasses.asdict(acfg), "policy_hidden": POLICY_HIDDEN,
            "total_trajs": ENGINE_TRAJS, "trainer_kw": kw, **rec}


def quickstart(gmm_ops, imag_ops, **main_kw) -> dict:
    """``examples/torch_quickstart.main(**main_kw)`` (on the card when
    called with no arguments), its table captured and its trainer checked
    by ``drive_engine`` without synchronising its steps: the run must end
    at its trajectories x horizon x dt of robot time, and print it."""
    import contextlib
    import importlib.util
    import io
    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    printed = io.StringIO()

    def run(hook):
        def hooked(*args, _cls=mod.AsyncTrainer, **kw):
            trainer = _cls(*args, **kw)
            hook(trainer)
            return trainer
        mod.AsyncTrainer = hooked
        with contextlib.redirect_stdout(printed):
            return mod.main(**main_kw)
    rec = drive_engine("quickstart", run, gmm_ops, imag_ops, sync=False)
    lines = printed.getvalue().splitlines()
    want = f"total simulated robot time: {rec['robot_time_s']} s"
    if not any(ln.startswith(want) for ln in lines):
        raise RuntimeError(f"quickstart: no line {want!r} in {lines}")
    return {**rec, "printed": lines}


# ------------------------------------------------------ phase 9, threads

def threads_run(name, gmm_ops, imag_ops, rc_kw: dict, **trainer_kw) -> tuple:
    """``AsyncTrainer(mode="threads")`` on ``engine_parts`` through its entry
    point, ``RunConfig(seed=0, **rc_kw)``; its workers' steps timed on the
    host without synchronising (a device-wide synchronise would couple the
    role streams). The launch counts go to 0 just before ``run`` and are
    read just after. Asserts exactly ``total_trajs`` trajectories, split
    over the fleet as the collectors counted them, trace times relative
    and monotone, finite eval returns and, for the learners that worked,
    one input shape, each epoch's ``gmm_equal`` launches as its ring
    implies and 50 ``imag_fused`` launches a policy step. Returns the
    trainer and the record."""
    from repro_torch.core import AsyncTrainer, RunConfig
    env, ens, acfg, algo = engine_parts()
    rc = RunConfig(seed=0, **rc_kw)
    trainer = AsyncTrainer(env, ens, algo, rc, mode="threads", **trainer_kw)
    timing = time_workers(trainer, gmm_ops, sync=False)
    gmm_ops.equal_launches = gmm_ops.equal_bwd_launches = 0
    imag_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gmm = gmm_ops.equal_launches + gmm_ops.equal_bwd_launches
    imag = imag_ops.launches
    model, policy = trainer.model_worker, trainer.policy_worker
    horizon = policy.algo.cfg.imagine_horizon
    epochs, workers = timing["epochs"], timing["workers"]
    per = [c.collected for c in trainer.collectors]
    times = [r["time"] for r in trace]
    rc = trainer.run_cfg
    collect_s = (-(-rc.total_trajs // (rc.n_collectors
                                       * rc.envs_per_collector))
                 * env.horizon * env.dt / rc.collect_speed)
    checks = {
        f"exactly {rc.total_trajs} trajectories":
            trainer.data_server.total_pushed == rc.total_trajs
            and trace[-1]["trajs"] == rc.total_trajs,
        "trajectories per collector sum to the total":
            sum(per) == rc.total_trajs,
        "trace times relative and monotone":
            times == sorted(times) and 0.0 <= times[0]
            and times[-1] <= wall,
        "finite eval returns": all(np.isfinite(r["eval_return"])
                                   for r in trace),
        "at most one train_epoch shape": model.compile_count() <= 1,
        "at most one improve shape": policy.compile_count() <= 1,
        "every epoch's gmm_equal launches as its ring implies":
            all(e["launches"] == e["want"] for e in epochs),
        "gmm_equal launches = the epochs' sum":
            gmm == sum(sum(e["want"]) for e in epochs),
        "one epoch recorded per model epoch": len(epochs) == model.epochs,
        f"imag_fused launches = policy steps x {horizon}":
            imag == policy.steps * horizon,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{name} failed: {failed}; per collector {per}, "
                           f"epochs {epochs}, trace {trace}")
    return trainer, {
        "engine": "AsyncTrainer", "mode": "threads", "env": LEARN_ENV,
        "run_config": {k: getattr(rc, k) for k in (
            "total_trajs", "collect_speed", "pace_collection",
            "n_collectors", "envs_per_collector")},
        "trajs": trace[-1]["trajs"], "trajs_per_collector": per,
        "wall_s": wall, "collection_time_s": collect_s,
        "wall_over_collection": wall / collect_s,
        "model_epochs": model.epochs, "policy_steps": policy.steps,
        "policy_steps_per_traj": policy.steps / rc.total_trajs,
        "model_version": trainer.model_server.version,
        "policy_version": trainer.policy_server.version,
        "evals": len(trace), "worker_wall_s": {k: w["s"]
                                               for k, w in workers.items()},
        "worker_calls": workers, "gmm_equal_launches": gmm,
        "imag_fused_launches": imag,
        "launches_per_epoch": sorted({tuple(e["want"]) for e in epochs}),
        "shapes": [model.compile_count(), policy.compile_count()],
        "eval_returns": [r["eval_return"] for r in trace],
        "trace_time": times}


def threads_paced(gmm_ops, imag_ops, **trainer_kw) -> tuple:
    """The paper's claim on the wall clock: 12 paced trajectories, each
    10 s of robot time in 1.0 s of wall time. Beyond ``threads_run``'s
    checks: wall time at least the collection time, and both learners
    worked."""
    trainer, rec = threads_run(
        "threads_paced", gmm_ops, imag_ops,
        dict(total_trajs=ENGINE_TRAJS, pace_collection=True,
             collect_speed=THREADS_SPEED), **trainer_kw)
    checks = {
        "wall time >= collection time (pacing held)":
            rec["wall_s"] >= rec["collection_time_s"],
        "a model version": rec["model_version"] >= 1 and rec["model_epochs"]
            >= 1,
        "a policy step": rec["policy_steps"] >= 1,
        "one train_epoch / improve shape": rec["shapes"] == [1, 1],
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"threads_paced failed: {failed}; {rec}")
    return trainer, rec


def threads_fleet(gmm_ops, imag_ops, **trainer_kw) -> dict:
    """Unpaced, three collectors of five robots on 12 trajectories: the
    grants are 5, 5 and a partial 2, so one collector's count is not a
    multiple of 5."""
    _, rec = threads_run("threads_fleet", gmm_ops, imag_ops,
                         dict(total_trajs=ENGINE_TRAJS), **THREADS_FLEET,
                         **trainer_kw)
    lanes = THREADS_FLEET["envs_per_collector"]
    if not any(n % lanes for n in rec["trajs_per_collector"]):
        raise RuntimeError(f"threads_fleet: no partial grant in "
                           f"{rec['trajs_per_collector']}")
    return rec


class UtilSampler:
    """``nvidia-smi --query-gpu=utilization.gpu -lms SMI_SAMPLE_MS`` in the
    background while a run lasts: the mean of its samples is the device's
    busy share over the run by the card's own utilization counter (every
    process's kernels, so it reads the procs engine's children too). The
    process is stopped and waited for on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", f"-lms={SMI_SAMPLE_MS}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self.samples = [int(x) for x in out.split() if x.isdigit()]

    def record(self) -> dict:
        if not self.samples:
            raise RuntimeError("nvidia-smi gave no utilization sample")
        return {"device_busy_share_smi": float(np.mean(self.samples)) / 100,
                "smi_samples": len(self.samples),
                "smi_sample_ms": SMI_SAMPLE_MS,
                "smi_method": "mean of nvidia-smi utilization.gpu samples"}


def procs_run(name, gmm_ops, imag_ops, rc_kw: dict, supervisor=None,
              joined=None, chaos=False, **trainer_kw) -> tuple:
    """``AsyncTrainer(mode="procs")`` on ``engine_parts`` through its entry
    point, ``RunConfig(seed=0, **rc_kw)``: each collector, the model and
    the policy worker a spawned process with a CUDA context of its own. The
    parent's launch counts go to 0 just before ``run`` and must still be 0
    after it (the parent launches nothing); each child's counts start at 0
    in its own process and come back in its heartbeat. Asserts exactly
    ``total_trajs`` trajectories, relative and monotone trace times,
    finite eval returns and adopted params, the model child on the card
    with ``gmm_equal`` launches and one ``train_epoch`` shape, the policy
    child with 50 ``imag_fused`` launches a step and 50 in each warm-up
    (its heartbeat reports the warm-up's launches apart), the collectors
    with no launch. Children on the CPU (``CHILD_ROUTE`` "plain") must
    launch nothing. ``joined()``, when given, is the trajectories that
    joined collectors contributed, counted with the fleet's. Under
    ``chaos`` a collector killed between a push and its next heartbeat
    leaves that trajectory out of its reported work, and a policy child
    killed in its warm-up never reports it, so those two counts are
    bounds there. The kernels line takes every launch of the run, the
    warm-ups' included. Returns the trainer and the record, with the
    device's busy share over the run by ``UtilSampler``."""
    from repro_torch.core import AsyncTrainer, RunConfig
    from repro_torch.mbrl import policy as PI
    from repro_torch.utils.tree import tree_leaves
    env, ens, acfg, algo = engine_parts()
    pol = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    ckpt = ROOT / "build" / f"{name}_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    rc = RunConfig(seed=0, ckpt_dir=str(ckpt), **rc_kw)
    trainer = AsyncTrainer(env, ens, algo, rc, mode="procs", algo_cfg=acfg,
                           pol_cfg=pol, supervisor=supervisor, **trainer_kw)
    gmm_ops.equal_launches = gmm_ops.equal_bwd_launches = 0
    imag_ops.launches = 0
    torch.cuda.synchronize()
    try:
        with UtilSampler() as smi:
            t0 = time.perf_counter()
            trace = trainer.run()
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    parent = [gmm_ops.equal_launches, gmm_ops.equal_bwd_launches,
              imag_ops.launches]
    info, rc = trainer.proc_info, trainer.run_cfg
    kids = info["children"]
    model, policy = kids["model"], kids["policy"]
    # a child's launches in its steps: all of them less its warm-up's
    steps = {r: {k: n - k_["warmup_launches"][k]
                 for k, n in k_["launches"].items()}
             for r, k_ in kids.items()}
    warm = policy["warmup_launches"]
    collectors = [kids[f"collector:{i}"] for i in range(rc.n_collectors)]
    horizon = acfg.imagine_horizon
    times = [r["time"] for r in trace]
    joined_n = joined() if joined is not None else 0
    fleet_n = sum(c["work"] for c in collectors) + joined_n
    card = CHILD_ROUTE == "cuda"
    warmups = info["restarts"]["policy"] + 1
    checks = {
        f"exactly {rc.total_trajs} trajectories":
            info["trajs"] == rc.total_trajs
            and trace[-1]["trajs"] == rc.total_trajs,
        "collectors' trajectories sum to the total":
            (fleet_n <= rc.total_trajs) if chaos
            else fleet_n == rc.total_trajs,
        "trace times relative and monotone":
            times == sorted(times) and 0.0 <= times[0]
            and times[-1] <= wall,
        "finite eval returns": all(np.isfinite(r["eval_return"])
                                   for r in trace),
        "finite adopted params": all(
            bool(torch.isfinite(t).all()) for t in
            tree_leaves(trainer.model_worker.params)
            + tree_leaves(trainer.policy_worker.state["policy"])),
        "the parent launched no kernel": parent == [0, 0, 0],
        f"every child on the {CHILD_ROUTE} route": all(
            k["route"] == CHILD_ROUTE for k in kids.values()),
        "the model child launched gmm_equal": (
            steps["model"]["gmm_equal"] > 0
            and steps["model"]["gmm_equal_bwd"] > 0) if card
            else model["work"] > 0,
        "one train_epoch shape": model["compile_count"] == 1,
        f"imag_fused launches in the policy steps = steps x {horizon}":
            steps["policy"]["imag_fused"]
            == (policy["work"] * horizon if card else 0)
            and policy["work"] > 0,
        f"imag_fused launches in each policy warm-up = {horizon}": (
            warm["imag_fused"] % horizon == 0
            and horizon <= warm["imag_fused"] <= warmups * horizon
            if chaos else warm["imag_fused"] == warmups * horizon)
            if card else warm["imag_fused"] == 0,
        "only the policy child warms up": not any(
            n for r, k_ in kids.items() if r != "policy"
            for n in k_["warmup_launches"].values()),
        "collectors launch no kernel": not any(
            n for c in collectors for n in c["launches"].values()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{name} failed: {failed}; proc_info {info}, "
                           f"parent launches {parent}, trace {trace}")
    tl = info["timeline"]
    collect_s = (-(-rc.total_trajs // (rc.n_collectors
                                       * rc.envs_per_collector))
                 * env.horizon * env.dt / rc.collect_speed)
    window = tl["collection_done_s"] - tl["policy_ready_s"]
    return trainer, {
        "engine": "AsyncTrainer", "mode": "procs", "env": LEARN_ENV,
        "run_config": {k: getattr(rc, k) for k in (
            "total_trajs", "collect_speed", "pace_collection",
            "n_collectors", "envs_per_collector", "min_final_model_version",
            "min_final_policy_version", "snapshot_every_s")},
        "trajs": info["trajs"],
        "trajs_per_collector": [c["work"] for c in collectors],
        "joined_trajs": joined_n,
        "wall_s": wall, "collection_time_s": collect_s,
        "wall_over_collection": wall / collect_s,
        "timeline": tl, "collection_window_s": window,
        "window_over_collection": window / collect_s,
        "model_epochs": model["work"], "policy_steps": policy["work"],
        "policy_steps_per_traj": policy["work"] / rc.total_trajs,
        "s_per_step": {r: k["work_s"] / k["work"] if k["work"] else None
                       for r, k in kids.items()},
        "model_version": info["model_version"],
        "policy_version": info["policy_version"],
        "restarts": info["restarts"], "evals": len(trace),
        "policy_warmup_s": policy["warmup_s"],
        "children": kids, "gmm_equal_launches": sum(
            k["launches"]["gmm_equal"] + k["launches"]["gmm_equal_bwd"]
            for k in kids.values()),
        "imag_fused_launches": sum(k["launches"]["imag_fused"]
                                   for k in kids.values()),
        "imag_fused_warmup_launches": warm["imag_fused"],
        **smi.record(),
        "eval_returns": [r["eval_return"] for r in trace],
        "trace_time": times}


def procs_paced(gmm_ops, imag_ops) -> dict:
    """``threads_paced``'s run on the procs engine: 12 trajectories of 1.0
    s of wall time each, the run held until the policy child is past one
    step. Beyond ``procs_run``'s checks: no restart, the
    collection window at least the collection time, a model version and a
    policy step."""
    _, rec = procs_run("procs_paced", gmm_ops, imag_ops, PROCS_PACED)
    checks = {
        "no restart": not any(rec["restarts"].values()),
        "collection window >= collection time (pacing held)":
            rec["collection_window_s"] >= rec["collection_time_s"] - 0.05,
        "a model version": rec["model_version"] >= 1
            and rec["model_epochs"] >= 1,
        "a policy step": rec["policy_steps"] >= 1,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"procs_paced failed: {failed}; {rec}")
    return rec


def procs_restart(gmm_ops, imag_ops) -> dict:
    """The paced run again, the model child SIGKILLed right after the
    first snapshot that holds a trained model, if at least
    ``min_warmup_trajs`` trajectories are still to be pushed: those reach
    only the restarted child, which trains on nothing else (the dead one's
    ring dies with it). Once the killed child is reaped, the supervisor
    asks for a model version two past its last: the restarted child's
    republished snapshot, then an epoch of its own. Asserts one model
    restart and none other, the restarted child resumed from that snapshot
    or a later one and trained (``procs_run``'s one ``train_epoch`` shape
    is the new incarnation's), and exactly the target's trajectories."""
    import os
    import signal

    from repro_torch.core import Supervisor

    class KillModelAfterSnapshot(Supervisor):
        killed = None

        def on_snapshot(self, step):
            tr = self.trainer
            rc, srv = tr.run_cfg, tr._proc_servers["model"]
            pushed = tr._proc_servers["data"].total_pushed
            if self.killed is not None or srv.version < 1 or \
                    pushed > rc.total_trajs - rc.min_warmup_trajs:
                return
            proc = tr._procs["model"]
            os.kill(proc.pid, signal.SIGKILL)
            proc.join(timeout=30)
            self.killed = {"snapshot_step": step - 1,
                           "model_version": srv.version,
                           "trajs_pushed": pushed,
                           "at_s": time.monotonic() - tr._proc_channels.t0}
            rc.min_final_model_version = srv.version + 2

        def on_tick(self):
            if self.killed is not None and time.monotonic() \
                    - self.trainer._proc_channels.t0 - self.killed["at_s"] \
                    > RESTART_TRAIN_S:
                raise RuntimeError(
                    f"procs_restart: no model version "
                    f"{self.trainer.run_cfg.min_final_model_version} "
                    f"{RESTART_TRAIN_S} s after the kill {self.killed}")

    sup = KillModelAfterSnapshot()
    _, rec = procs_run("procs_restart", gmm_ops, imag_ops, PROCS_RESTART,
                       supervisor=sup)
    killed, model = sup.killed, rec["children"]["model"]
    checks = {
        "the model child was killed": killed is not None,
        "one model restart, no other": rec["restarts"] == {
            **{r: 0 for r in rec["restarts"]}, "model": 1},
        "resumed from the snapshot before the kill or a later one":
            killed is not None
            and model["resumed_step"] >= killed["snapshot_step"],
        "the restarted child trained past its republished snapshot":
            killed is not None
            and rec["model_version"] >= killed["model_version"] + 2,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"procs_restart failed: {failed}; {killed}, "
                           f"{rec}")
    return {**rec, "killed": killed}


def procs_fleet(gmm_ops, imag_ops) -> dict:
    """``threads_fleet``'s 3 collectors of 5 robots, unpaced, as processes:
    12 trajectories exactly, a partial grant, both learners past a step."""
    _, rec = procs_run("procs_fleet", gmm_ops, imag_ops, PROCS_FLEET,
                       **THREADS_FLEET)
    lanes = THREADS_FLEET["envs_per_collector"]
    if not any(n % lanes for n in rec["trajs_per_collector"]):
        raise RuntimeError(f"procs_fleet: no partial grant in "
                           f"{rec['trajs_per_collector']}")
    if any(rec["restarts"].values()):
        raise RuntimeError(f"procs_fleet: restarts {rec['restarts']}")
    return rec


class PullMeter:
    """Wraps one ``TcpParameterServer``'s ``pull_if_newer``: each call's
    outcome (changed or not), the array bytes it moved by the client's own
    counter, and its host milliseconds. One thread pulls each store in the
    threads engine (the collector the policy, the policy worker the
    model), so a call's counter delta is its own."""

    def __init__(self, srv):
        self.rows = []
        call = srv.pull_if_newer

        def metered(version):
            b0 = srv.array_bytes_received
            t0 = time.perf_counter()
            value, ver = call(version)
            self.rows.append((value is not None,
                              srv.array_bytes_received - b0,
                              (time.perf_counter() - t0) * 1e3))
            return value, ver
        srv.pull_if_newer = metered
        self.codec_bytes = lambda: sum(srv.codec.nbytes)

    def record(self) -> dict:
        changed = [r for r in self.rows if r[0]]
        same = [r for r in self.rows if not r[0]]
        return {"changed": len(changed), "unchanged": len(same),
                "changed_bytes": [b for _, b, _ in changed][:3],
                "unchanged_bytes": sum(b for _, b, _ in same),
                "codec_bytes": self.codec_bytes() if changed else None,
                "changed_ms_p50": float(np.median([m for *_, m in changed]))
                if changed else None,
                "unchanged_ms_p50": float(np.median([m for *_, m in same]))
                if same else None}


def threads_tcp(gmm_ops, imag_ops, **trainer_kw) -> dict:
    """``threads_paced``'s run with every store behind a loopback
    ``ControlPlane`` (``RunConfig(transport="tcp")``), through its entry
    point: the workers pull and push over TCP. Asserts exactly
    ``total_trajs`` trajectories (the plane's count, kept in ``net_info``
    when the trainer closes its plane), unchanged pulls that moved zero
    array bytes and changed ones that moved the codec's bytes (the
    client's counter), 50 ``imag_fused`` launches a policy step with at
    least one step, and each epoch's ``gmm_equal`` launches as its ring
    implies. Reports the wall / collection ratio, the policy steps and the
    host milliseconds of a changed and of an unchanged pull."""
    from repro_torch.core import AsyncTrainer, RunConfig
    env, ens, acfg, algo = engine_parts()
    rc = RunConfig(seed=0, total_trajs=ENGINE_TRAJS, pace_collection=True,
                   collect_speed=THREADS_SPEED, transport="tcp")
    trainer = AsyncTrainer(env, ens, algo, rc, mode="threads", **trainer_kw)
    timing = time_workers(trainer, gmm_ops, sync=False)
    meters = {"policy": PullMeter(trainer.policy_server),
              "model": PullMeter(trainer.model_server)}
    gmm_ops.equal_launches = gmm_ops.equal_bwd_launches = 0
    imag_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gmm = gmm_ops.equal_launches + gmm_ops.equal_bwd_launches
    imag = imag_ops.launches
    model, policy = trainer.model_worker, trainer.policy_worker
    horizon = policy.algo.cfg.imagine_horizon
    epochs = timing["epochs"]
    pulls = {k: m.record() for k, m in meters.items()}
    net = trainer.net_info
    collect_s = rc.total_trajs * env.horizon * env.dt / rc.collect_speed
    checks = {
        f"exactly {rc.total_trajs} trajectories":
            net["trajs"] == rc.total_trajs
            and trace[-1]["trajs"] == rc.total_trajs
            and trainer.collector.collected == rc.total_trajs,
        "the plane is closed after the run": trainer._plane is None,
        "unchanged pulls moved zero array bytes": all(
            p["unchanged"] > 0 and p["unchanged_bytes"] == 0
            for p in pulls.values()),
        "changed pulls moved the codec's bytes": all(
            p["changed"] > 0 and set(p["changed_bytes"])
            == {p["codec_bytes"]} for p in pulls.values()),
        "wall time >= collection time (pacing held)": wall >= collect_s,
        "a policy step": policy.steps >= 1,
        f"imag_fused launches = policy steps x {horizon}":
            imag == policy.steps * horizon,
        "every epoch's gmm_equal launches as its ring implies":
            all(e["launches"] == e["want"] for e in epochs) and gmm > 0
            and gmm == sum(sum(e["want"]) for e in epochs),
        "at most one train_epoch / improve shape":
            model.compile_count() <= 1 and policy.compile_count() <= 1,
        "finite eval returns": all(np.isfinite(r["eval_return"])
                                   for r in trace),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"threads_tcp failed: {failed}; net {net}, "
                           f"pulls {pulls}, trace {trace}")
    return {"engine": "AsyncTrainer", "mode": "threads", "transport": "tcp",
            "env": LEARN_ENV, "trajs": net["trajs"], "net_info": net,
            "wall_s": wall, "collection_time_s": collect_s,
            "wall_over_collection": wall / collect_s,
            "model_epochs": model.epochs, "policy_steps": policy.steps,
            "policy_steps_per_traj": policy.steps / rc.total_trajs,
            "pulls": pulls, "gmm_equal_launches": gmm,
            "imag_fused_launches": imag,
            "eval_returns": [r["eval_return"] for r in trace]}


def join_on_attach():
    """A ``Supervisor`` that, once the procs run's plane is up (``attach``),
    joins it from a thread of this process as one more collector through
    ``repro_torch.net.join_as_collectors``, on the trainer's device."""
    from repro_torch.core import Supervisor

    class JoinOnAttach(Supervisor):
        def attach(self, trainer):
            super().attach(trainer)
            from repro_torch.net import join_as_collectors
            self.ids, self.error = {}, None
            addr, dev = trainer.net_info["addr"], trainer.device

            def body():
                try:
                    join_as_collectors(addr, device=dev,
                                       per_collector=self.ids)
                except BaseException as e:  # noqa: BLE001 — re-raised
                    self.error = e
            self.thread = threading.Thread(target=body, daemon=True,
                                           name="joiner")
            self.thread.start()

        def joined(self) -> int:
            self.thread.join(timeout=60)
            if self.thread.is_alive():
                raise RuntimeError("the joiner did not end with the run")
            if self.error is not None:
                raise RuntimeError("the joiner failed") from self.error
            return sum(self.ids.values())
    return JoinOnAttach()


def procs_tcp_join(gmm_ops, imag_ops, **trainer_kw) -> dict:
    """``procs_paced`` over the tcp transport, its children dialling a
    loopback ``ControlPlane``, and one collector joining the live run
    through the plane's address (``join_as_collectors``). Beyond
    ``procs_run``'s checks (exactly the target's trajectories, the
    children's kernel launches from their heartbeats, none in the parent):
    the joiner contributed at least one trajectory under an id past the
    fleet's, and no child restarted."""
    joiner = join_on_attach()
    _, rec = procs_run("procs_tcp_join", gmm_ops, imag_ops,
                       dict(PROCS_PACED, transport="tcp"),
                       supervisor=joiner, joined=lambda: joiner.joined(),
                       **trainer_kw)
    n = rec["run_config"]["n_collectors"]
    checks = {
        "the joiner contributed": rec["joined_trajs"] >= 1,
        "under ids past the fleet's": bool(joiner.ids)
            and min(joiner.ids) >= n,
        "no restart": not any(rec["restarts"].values()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"procs_tcp_join failed: {failed}; joiner "
                           f"{joiner.ids}, {rec}")
    return {**rec, "transport": "tcp",
            "joined": {str(k): v for k, v in joiner.ids.items()}}


def hold_for_restarted_learners():
    """A ``Supervisor`` for the chaos run. On each learner's crash-restart
    it asks for a store version two past the one at the respawn (the
    restarted child's republished snapshot, then a step of its own), so
    the run cannot end before a restarted learner works; it records, for
    every restart, the seconds from the respawn to the child's first
    heartbeat and to its first unit of work (a trajectory, an epoch or a
    policy step); and it fails the run if a restarted learner has not
    worked ``RESTART_TRAIN_S`` after its respawn."""
    from repro_torch.core import Supervisor
    from repro_torch.core.workers import heartbeat_slot

    class HoldForRestartedLearners(Supervisor):
        def attach(self, trainer):
            super().attach(trainer)
            self.respawns = []

        def on_spawn(self, role, proc, resume):
            if not resume:
                return
            tr = self.trainer
            for r in self.respawns:
                if r["role"] == role and not r.get("superseded"):
                    r["superseded"] = True   # it died in its turn
            rec = {"role": role, "t": time.monotonic(),
                   "at_s": time.monotonic() - tr._proc_channels.t0,
                   "first_beat_s": None, "first_work_s": None}
            if role in ("model", "policy"):
                need = tr._proc_servers[role].version + 2
                attr = f"min_final_{role}_version"
                setattr(tr.run_cfg, attr,
                        max(getattr(tr.run_cfg, attr), need))
                rec["min_final_version"] = need
            self.respawns.append(rec)

        def on_tick(self):
            tr = self.trainer
            now = time.monotonic()
            for r in self.respawns:
                if r.get("superseded") or r["first_work_s"] is not None:
                    continue
                slot = tr._proc_channels.control.read(heartbeat_slot(
                    r["role"], tr.run_cfg.n_collectors))
                if r["first_beat_s"] is None and slot["beat"] > r["t"]:
                    r["first_beat_s"] = slot["beat"] - r["t"]
                if slot["work"] > 0:
                    r["first_work_s"] = now - r["t"]
                elif r["role"] in ("model", "policy") and \
                        now - r["t"] > RESTART_TRAIN_S:
                    raise RuntimeError(
                        f"chaos_run: the restarted {r['role']} child "
                        f"has not worked {RESTART_TRAIN_S} s after its "
                        f"respawn {r}")

        def report(self):
            return [{k: v for k, v in r.items() if k != "t"}
                    for r in self.respawns]
    return HoldForRestartedLearners()


def chaos_run(gmm_ops, imag_ops, **trainer_kw) -> dict:
    """``procs_paced``'s configuration with two collectors over the
    file-backed stores, under ``SupervisorChain(ChaosSupervisor(
    FaultPlan.generate(CHAOS_SEED, **CHAOS_PLAN)), InvariantMonitor(),
    HoldForRestartedLearners())`` with ``max_restarts=3``, inside a
    ``ResourceAuditor`` baseline / audit (the parent's CUDA context and
    the resource tracker opened before the baseline by ``warmup_ipc``).
    Beyond ``procs_run``'s checks: zero violations, zero leaks, at least 3
    faults injected across all three role families, and each restarted
    learner's last incarnation worked and (on the card) launched its
    kernel in its own steps. Reports each fault's seconds into the run,
    each respawn's seconds to its first heartbeat and first work, and the
    run's wall time."""
    from repro_torch.chaos import (ChaosSupervisor, FaultPlan,
                                   InvariantMonitor, ResourceAuditor)
    from repro_torch.chaos.audit import warmup_ipc
    from repro_torch.chaos.faults import role_family
    from repro_torch.core import SupervisorChain
    plan = FaultPlan.generate(CHAOS_SEED, **CHAOS_PLAN)
    chaos, monitor = ChaosSupervisor(plan), InvariantMonitor()
    hold = hold_for_restarted_learners()
    warmup_ipc(str(trainer_kw.get("device", "cuda")))
    auditor = ResourceAuditor()
    auditor.baseline()
    trainer, rec = procs_run(
        "chaos_run", gmm_ops, imag_ops, dict(PROCS_PACED, **CHAOS_RUN),
        supervisor=SupervisorChain(chaos, monitor, hold), chaos=True,
        **trainer_kw)
    t0 = trainer._proc_channels.t0
    # the trainer keeps its last children's process handles (two pipe
    # descriptors each) for inspection until it is dropped
    del trainer
    audit = auditor.audit()
    faults = chaos.report()
    families = sorted({role_family(f["role"]) for f in faults["injected"]})
    kids = rec["children"]
    kernel = {"model": "gmm_equal", "policy": "imag_fused"}
    restarted = {}
    for role, k in kernel.items():
        if rec["restarts"][role]:
            last = kids[role]
            restarted[role] = {
                "last_work": last["last_work"],
                "last_step_launches": last["last_launches"][k]
                - last["last_warmup_launches"][k]}
    card = CHILD_ROUTE == "cuda"
    checks = {
        "no invariant violation": monitor.violations == [],
        "no leaked resource": audit["ok"],
        ">= 3 faults injected": faults["n_injected"] >= 3,
        "faults across all three role families":
            families == ["collector", "model", "policy"],
        "a learner restarted": bool(restarted),
        "each restarted learner worked and launched its kernel": all(
            r["last_work"] > 0 and (r["last_step_launches"] > 0 if card
                                    else r["last_step_launches"] == 0)
            for r in restarted.values()),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"chaos_run failed: {failed}; violations "
                           f"{monitor.violations}, audit {audit}, faults "
                           f"{faults}, restarted {restarted}, {rec}")
    return {**rec, "plan": {"seed": CHAOS_SEED, **CHAOS_PLAN},
            "faults": [{**{k: f[k] for k in ("kind", "role", "at", "arg",
                                              "progress")},
                        "t_s": f["t_monotonic"] - t0}
                       for f in faults["injected"]],
            "skipped": faults["skipped"], "families": families,
            "respawns": hold.report(), "restarted_learners": restarted,
            "monitor": monitor.report()["stats"], "audit": audit}


def stream_intervals(trace_path: Path) -> list:
    """(start µs, end µs, stream) of every kernel in a chrome trace."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"))
            for e in events if e.get("cat") == "kernel" and "dur" in e]


def overlap_stats(intervals) -> dict:
    """The union of the kernel intervals (device busy), and the kernel
    time during which a kernel on another stream also ran, by a sweep
    over the interval ends."""
    points = sorted([(a, 1, s) for a, b, s in intervals]
                    + [(b, -1, s) for a, b, s in intervals],
                    key=lambda p: (p[0], p[1]))
    active, union, overlap, last = {}, 0.0, 0.0, None
    for t, d, s in points:
        live = [k for k, n in active.items() if n > 0]
        if last is not None and live:
            union += t - last
            if len(live) > 1:
                overlap += (t - last) * len(live)
        active[s] = active.get(s, 0) + d
        last = t
    total = sum(b - a for a, b, _ in intervals)
    by_stream = {}
    for a, b, s in intervals:
        by_stream[str(s)] = by_stream.get(str(s), 0.0) + (b - a) / 1e3
    return {"kernels": len(intervals), "kernel_ms": total / 1e3,
            "busy_ms": union / 1e3,
            "overlap_share": overlap / total if total else 0.0,
            "span_ms": (max(b for _, b, _ in intervals)
                        - min(a for a, _, _ in intervals)) / 1e3,
            "kernel_ms_by_stream": by_stream}


def threads_profile(gmm_ops, imag_ops, tries: int = 3, **trainer_kw) -> dict:
    """One short unpaced threads run (``THREADS_PROFILE_TRAJS``
    trajectories) under ``torch.profiler`` with CUDA activity, its trace
    exported to ``build/``: the device's busy share over the run's wall
    window (the union of kernel intervals over the host's wall time), and
    the share of kernel time that overlaps a kernel on another stream.
    Reported, not asserted; a session without kernels is run again, with
    CPU activity added (a larger trace)."""
    from torch.profiler import ProfilerActivity, profile
    path = ROOT / "build" / "threads_profile.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    for i in range(tries):
        activities = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if i else [])
        with profile(activities=activities) as prof:
            trainer, rec = threads_run(
                "threads_profile", gmm_ops, imag_ops,
                dict(total_trajs=THREADS_PROFILE_TRAJS), **trainer_kw)
        prof.export_chrome_trace(str(path))
        intervals = stream_intervals(path)
        path.unlink()
        if intervals:
            stats = overlap_stats(intervals)
            wall_ms = rec["wall_s"] * 1e3
            return {"total_trajs": THREADS_PROFILE_TRAJS, "wall_ms": wall_ms,
                    "activities": [str(a) for a in activities],
                    "device_busy_share": stats["busy_ms"] / wall_ms,
                    "busy_share_of_kernel_span":
                        stats["busy_ms"] / stats["span_ms"],
                    "streams": len(stats["kernel_ms_by_stream"]), **stats,
                    "model_epochs": rec["model_epochs"],
                    "policy_steps": rec["policy_steps"]}
    raise RuntimeError(f"threads_profile: no kernel in {tries} sessions")


def stream_handoff(ParameterServer, DataServer) -> dict:
    """Push on one stream and pull on another, a ~0.1 s kernel
    (``torch.cuda._sleep``) queued on the pusher's stream before the
    values it pushes: the puller's reads must see the pushed values (they
    read freed NaN-filled memory if the pull does not wait for the push's
    event). The same for a ``DataServer`` batch and its ``drain``. Then the
    unchanged ``pull_if_newer`` under ``torch.cuda.set_sync_debug_mode
    ("error")``, which raises on any host sync."""
    dev = torch.device("cuda")
    n = 1 << 24
    gen = torch.Generator(device=dev).manual_seed(7)
    src = torch.randn(n, generator=gen, device=dev)
    want = src * 2 + 1
    push_s, pull_s = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    params, data = ParameterServer(), DataServer()
    with torch.cuda.stream(push_s):
        junk = torch.full((4 * n,), float("nan"), device=dev)
        del junk                # the pusher's pool now holds NaNs
        torch.cuda._sleep(HANDOFF_SLEEP_CYCLES)
        version = params.push({"w": src * 2 + 1})
        batch = {"obs": (src * 2 + 1).reshape(4, -1)}
        data.push_batch(batch, 4)
        del batch
    t0 = time.perf_counter()
    with torch.cuda.stream(pull_s):
        got, ver = params.pull_if_newer(0)
        out = got["w"] * 1.0
        lanes = data.drain()
        drained = torch.cat([lane["obs"] for lane in lanes]) * 1.0
    pull_ms = (time.perf_counter() - t0) * 1e3
    del got, lanes
    torch.cuda.synchronize()
    checks = {"pulled values equal the pushed ones": torch.equal(out, want),
              "drained values equal the pushed ones":
                  torch.equal(drained, want),
              "the pull handed over version 1": ver == version == 1}
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        unchanged = [params.pull_if_newer(ver)[0] for _ in range(1000)]
        unchanged_us = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    checks["the unchanged pull hands out nothing, with no host sync"] = \
        all(v is None for v in unchanged)
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"stream_handoff failed: {failed}")
    return {"elements": n, "sleep_cycles": HANDOFF_SLEEP_CYCLES,
            "pull_and_drain_host_ms": pull_ms,
            "unchanged_pull_us": unchanged_us, "checks": list(checks)}


def ckpt_roundtrip(trainer) -> dict:
    """The trained ensemble and policy of a run's servers, with their
    versions and a bf16 copy of the policy, saved by
    ``checkpoint.io.save_pytree`` under ``build/`` and restored onto the
    card: every leaf bit-equal, of its dtype, on the card."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.utils.tree import tree_map
    model, mv = trainer.model_server.pull()
    policy, pv = trainer.policy_server.pull()
    dev = torch.device("cuda")
    tree = {"model": model, "model_version": torch.tensor(mv, device=dev),
            "policy": policy, "policy_version": torch.tensor(pv, device=dev),
            "policy_bf16": tree_map(lambda t: t.to(torch.bfloat16), policy)}
    path = ROOT / "build" / "ckpt_roundtrip"
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        ckpt_io.save_pytree(path, tree, step=mv, keep=2)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        out, step = ckpt_io.restore(path, tree)
        restore_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(f.stat().st_size for f in path.rglob("*")
                     if f.is_file())
    finally:
        shutil.rmtree(path, ignore_errors=True)
    pairs = list(zip(ckpt_io.flatten(tree), ckpt_io.flatten(out)))
    bad = [i for i, (a, b) in enumerate(pairs)
           if not (b.is_cuda and a.dtype == b.dtype and torch.equal(
               a.to(b.device), b))]
    if bad or step != mv:
        raise RuntimeError(f"ckpt_roundtrip: leaves {bad} differ, step "
                           f"{step} for version {mv}")
    return {"leaves": len(pairs), "bytes": nbytes, "step": step,
            "model_version": mv, "policy_version": pv, "save_ms": save_ms,
            "restore_ms": restore_ms}


def model_free(device=None) -> dict:
    """The model-free PPO baseline on the card: ``ModelFreeTrainer`` on the
    engines' env and policy, two iterations of 4 trajectories and 10 PPO
    steps. Asserts finite returns, the trajectories, and the trace's time
    as the reference accounts it (collection plus a policy-step time per
    PPO step)."""
    from repro_torch.core import RunConfig
    from repro_torch.envs import make_env
    from repro_torch.mbrl import policy as PI
    from repro_torch.mbrl.model_free import ModelFreeTrainer
    env = make_env(LEARN_ENV)
    pol = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    rc = RunConfig(total_trajs=MODEL_FREE_TRAJS, seed=0)
    trainer = ModelFreeTrainer(env, pol, rc, algo="ppo", trajs_per_iter=4,
                               device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_iter = 4 * env.horizon * env.dt + 10 * rc.policy_step_time
    want_t = [per_iter * (i + 1) for i in range(len(trace))]
    checks = {
        "finite eval returns": all(np.isfinite(r["eval_return"])
                                   for r in trace),
        "trajectories 4 an iteration": [r["trajs"] for r in trace]
            == [4 * (i + 1) for i in range(len(trace))],
        "time = collection + PPO steps x policy_step_time":
            all(abs(r["time"] - t) <= 1e-9 for r, t in zip(trace, want_t)),
        "on the trainer's device": all(
            t.device.type == trainer.device.type
            for t in trainer.params["w"]),
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"model_free failed: {failed}; {trace}")
    return {"env": LEARN_ENV, "algo": "ppo", "policy_hidden": POLICY_HIDDEN,
            "iterations": trainer.iterations, "wall_s": wall,
            "trace": trace}

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


# ---------------------------------------------------------------- phase 10

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


# ---------------------------------------------------------------- phase 11

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


# ---------------------------------------------------------------- phase 12

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
    from repro_torch.core import AsyncTrainer, SequentialTrainer
    from repro_torch.core.servers import DataServer, ParameterServer
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

    event = engine_run("event_run", AsyncTrainer, gmm_ops, imag_ops)
    own = engine_run("event_run", AsyncTrainer, gmm_ops, imag_ops,
                     sync=False)
    emit({"phase": "event_run", **event, "unsynchronised": {
        k: own[k] for k in (
            "wall_s", "worker_wall_s", "worker_share", "engine_other_s",
            "robot_time_s", "trajs", "model_epochs", "policy_steps",
            "gmm_equal_launches", "imag_fused_launches")}})
    seq = engine_run("sequential_run", SequentialTrainer, gmm_ops, imag_ops,
                     n_rollouts=SEQ_ROLLOUTS)
    if not seq["robot_time_s"] > event["robot_time_s"]:
        raise RuntimeError(f"sequential_run: robot time "
                           f"{seq['robot_time_s']} s is not above the "
                           f"async run's {event['robot_time_s']} s")
    emit({"phase": "sequential_run", **seq,
          "robot_time_over_event_run": seq["robot_time_s"]
          / event["robot_time_s"]})
    qs = quickstart(gmm_ops, imag_ops)
    if qs["robot_time_s"] != 120.0:
        raise RuntimeError(f"quickstart: robot time {qs['robot_time_s']} "
                           "s, not 120.0")
    emit({"phase": "quickstart", **qs})
    gc.collect()
    torch.cuda.empty_cache()

    with UtilSampler() as smi:
        paced_trainer, paced = threads_paced(gmm_ops, imag_ops)
    paced.update(smi.record())
    emit({"phase": "threads_paced", **paced,
          "policy_steps_per_traj_event_run":
              event["policy_steps"] / event["trajs"]})
    emit({"phase": "ckpt_roundtrip", **ckpt_roundtrip(paced_trainer)})
    del paced_trainer
    emit({"phase": "threads_fleet", **threads_fleet(gmm_ops, imag_ops)})
    emit({"phase": "threads_profile", **threads_profile(gmm_ops, imag_ops)})
    emit({"phase": "stream_handoff",
          **stream_handoff(ParameterServer, DataServer)})
    emit({"phase": "model_free", **model_free()})
    gc.collect()
    torch.cuda.empty_cache()

    procs = procs_paced(gmm_ops, imag_ops)
    emit({"phase": "procs_paced", **procs,
          "threads_paced": {k: paced[k] for k in (
              "wall_s", "wall_over_collection", "policy_steps",
              "policy_steps_per_traj", "model_epochs",
              "device_busy_share_smi")},
          "policy_steps_per_traj_event_run":
              event["policy_steps"] / event["trajs"]})
    emit({"phase": "procs_restart", **procs_restart(gmm_ops, imag_ops)})
    emit({"phase": "procs_fleet", **procs_fleet(gmm_ops, imag_ops)})
    tcp = threads_tcp(gmm_ops, imag_ops)
    emit({"phase": "threads_tcp", **tcp,
          "threads_paced": {k: paced[k] for k in (
              "wall_s", "wall_over_collection", "policy_steps",
              "model_epochs")}})
    joined = procs_tcp_join(gmm_ops, imag_ops)
    emit({"phase": "procs_tcp_join", **joined})
    chaos = chaos_run(gmm_ops, imag_ops)
    emit({"phase": "chaos_run", **chaos})

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
        "launches_event_run": event["gmm_equal_launches"],
        "launches_threads_run": paced["gmm_equal_launches"],
        "launches_procs_run": procs["gmm_equal_launches"],
        "launches_threads_tcp": tcp["gmm_equal_launches"],
        "launches_procs_tcp_join": joined["gmm_equal_launches"],
        "launches_chaos_run": chaos["gmm_equal_launches"],
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
        "launches_event_run": event["imag_fused_launches"],
        "launches_threads_run": paced["imag_fused_launches"],
        "launches_procs_run": procs["imag_fused_launches"],
        "launches_threads_tcp": tcp["imag_fused_launches"],
        "launches_procs_tcp_join": joined["imag_fused_launches"],
        "launches_chaos_run": chaos["imag_fused_launches"],
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
