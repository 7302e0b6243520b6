#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device`` / ``build``: the card, then every kernel built from the
   sources in this checkout (one ``nvcc`` per source, all at once), with
   the tensor-core (``HMMA``) instructions of each library counted by
   ``cuobjdump -sass``, and in ``gmm.cu``'s also the warpgroup products
   (``HGMMA``) and the TMA loads (``UTMALDG``) of its bf16 route; the
   phase fails if any of the four has no ``HMMA`` or ``gmm.cu`` no
   ``HGMMA`` or ``UTMALDG``.
2. ``kernel_check``: the flash-attention kernel against its plain PyTorch
   version on the card at the serving path's shapes, at the world
   model's head dims (32, and 24 in the D = 32 build), at Zamba2-7B's
   prefill (head dim 112 in the D = 128 build), at Seamless-M4T-medium's
   encoder (no mask) and cross-attention (Sq = 64 and Sq = 257 over 256
   keys, no mask), at Phi-3-vision-4.2B's prefill (head dim 96 in the
   D = 128 build) and at edge shapes (one at Sq > Sk, Sk ragged to the
   kv tile),
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
   plain version at the Mamba2-2.7B and Zamba2-7B prefill shapes (bf16,
   final state out), at the stateless forward's, with a state in and out,
   and at edge
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
   ``role_mesh``: the role-mesh path (``core/roles.py``). The split of the
   local cards (one card: the shared fallback and its warning, printed
   first as ``role_mesh_split``); the model learner at ``model_learn``'s
   ensemble sharded over a stand-in mesh of four entries of the card
   (``launch.mesh.make_mesh(4, device="cuda:0")``) against one device on
   its trajectories, 4 epochs on the reference's test grid (a ring of 12)
   and on the full ring: losses and val losses within the reference's own
   bound (rtol 2e-5, atol 1e-6), the leaves within it or within
   ``LEAF_CONTROL_FACTOR`` times the drift of one device whose minibatch
   rows are reversed, each shard's ``gmm_equal`` launches as its rows
   imply, then the small ring wrapped with one input shape; the policy
   improver at ``policy_improve``'s shapes through
   ``PolicyImprovementWorker(mesh=)`` (ME-TRPO, its imagination sharded
   by ``configure_mesh``) against one device: two steps' imagined returns
   and pushed policy within the bound, each shard's ``imag_fused``
   launches; the same sharded rollout on the legacy step (``gmm_ragged``,
   its first step within the bound, the rollout's gap reported, each
   shard's launches) and ``row_coupling``: whether the ragged products'
   and the policy's rows change with the rows beside them (the ragged
   ones must not); a pull onto the placement and 32
   unchanged pulls under ``torch.cuda.set_sync_debug_mode("error")``: no
   copy; a paced threads-mode ``AsyncTrainer(mesh=..., role_ratios=(1, 2,
   1))`` on the stand-in mesh at the engines' configuration (12
   trajectories exactly, two model shards) and, with three cards or more,
   on the real split (else a line saying why not); the dry run's GLM-4-9B
   weight bytes within 1% of the allocator's. At most 90 s.
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
13. The transformer world model's path. ``dense_lockstep``: lock-step
   serving of the full 40-layer GLM-4-9B in bf16 through ``api.build``
   at ``examples/serve_world_model.py``'s shape (batch 8, 48-token
   prompts, the cache grown to 65 slots, 16 greedy decodes), then the
   int8 KV cache fed the same tokens: 40 flash launches a prefill, none
   in decode; reports time to first token, decode tokens/s, the serving
   path's peak memory (init_params' apart), and the int8 run's largest
   logit gap to the fp run and its greedy agreement. Then the kernel's
   prefill against the plain attention's and the decodes from either
   cache: within ``LOGITS_ATOL`` at 2 layers of the full width, within
   ``LOCKSTEP_FULL_ATOL`` at all 40. ``lm_train``: ``api.build(...,
   "train")`` on ``examples/train_world_model.py``'s ``wm-100m``, 50 steps
   over ``DynamicsTokenStream``'s first 4 batches: the loss halves; no
   flash launch (the step trains through the plain attention by design).
   ``wm_mbrl``: ``WorldModelDynamics`` at ``WMConfig`` defaults (head dim
   32) fitted on 6 pendulum trajectories for 12 epochs (its predict MSE
   below 0.3x its start), then 3 ME-TRPO ``improve`` steps at
   ``AlgoConfig`` defaults through ``predict_fn``: 100 flash launches a
   step (50 imagined steps × 2 layers), finite imagined returns, and the
   kernel prefill against the plain one within ``LOGITS_ATOL``.
14. The moe and hybrid LM families. ``moe_check``: ``gmm_ragged``'s bf16
   route against the looped plain product (``ref.grouped_matmul_looped``)
   at the dropless MoE's shapes (Moonlight-16B-A3B's decode and prefill,
   Mixtral-8x7B's prefill, up and down products) and at the edge shapes,
   within ``GMM_BF16_TOL`` (one bf16 ulp), with the ``route`` its launch
   took (``cuda.py``'s counts by route), which must be the one
   ``plan_ragged_bf16`` names (the six MoE rows must take the TMA and
   ``wgmma`` one), device times of the kernel, of the earlier ``mma.sync``
   route (``gmm_ragged_bf16``) forced at the same shape (``ms_mma_sync``, held to the same
   tolerance), of every tile of the TMA route (``tile_ms``), the plain
   loop and ``torch._grouped_mm`` in bf16, and the bound.
   ``moe_lockstep``: the
   full 48-layer Moonlight-16B-A3B in bf16 in lock step (batch 8, 64-token
   prompts, 16 decodes, fp and int8 caches): 48 flash and 144 bf16
   ``gmm_ragged`` launches a prefill, 144 of the latter a decode, all on
   the ``wgmma`` route, and ``moe_tick_profile``: three more decode ticks
   under ``torch.profiler``, their device time and the bf16
   ``gmm_ragged`` kernels' part by kernel name, none ``mma.sync``; then at
   a 2-layer cut, the kernels against the plain experts (bf16) and against
   every plain route (f32) within ``LOGITS_ATOL``, and every plain route in
   bf16 reported with the tokens rerouted at near-ties. Where the bf16
   experts' run reroutes a token (an ulp of the kernel's output tipping a
   near-tie), the held comparison replays the kernel run's expert choices
   into the plain run; the unreplayed error and the rerouted tokens are
   reported beside it. ``moe_serve``:
   ``serve``'s run on Moonlight at 16 of its 48 layers, 3 bf16
   ``gmm_ragged`` launches a layer in every prefill and decode tick, all
   on the ``wgmma`` route.
   ``hybrid_lockstep``: the full 81-layer Zamba2-7B in bf16 in lock step
   (batch 4, 256-token prompts, 16 decodes): 14 flash (head dim 112, the
   128 build) and 81 ``ssd_chunked`` launches a prefill, none in decode;
   at a 7-layer cut, kernels against the plain attention and scan in f32
   within ``LOGITS_ATOL`` and in bf16 within ``HYBRID_BF16_ATOL``.
   ``moe_train``: 10 ``api.build(..., "train")`` steps on Moonlight's
   2-layer cut at full width in bf16 (1.81 B parameters, batch 8 × 64, 4
   seeded batches cycled): the loss falls, losses and gradient norms are
   finite, no launch of flash attention or of ``gmm_ragged`` on any route
   (the step trains through the plain attention and the looped plain
   expert product by design); step ms, peak memory, then
   ``torch.profiler`` over one more step (device time, top kernels) with
   the Adam update and the step's looped expert products (forward and
   backward, recorded from a step) replayed under it for their shares;
   then, on the trained weights, the cut's prefill and decodes at the
   lock-step shape, the experts through the TMA and ``wgmma`` kernel
   against the looped plain product (near-ties replayed), within
   ``LOGITS_ATOL``, the launches counted. ``hybrid_train``: the same on
   Zamba2's 7-layer cut (0.98 B, batch 4 × 256), no flash or
   ``ssd_chunked`` launch in the steps; the trained cut through both
   kernels against the plain routes within ``HYBRID_BF16_ATOL``.
15. The encoder-decoder and vision families. ``encdec_lockstep``: the
   whole Seamless-M4T-medium (12 + 12 layers) in bf16 in lock step
   (batch 8, 256 seeded frame embeddings, 64-token prompts, 16 greedy
   decodes): 36 flash launches a prefill (12 encoder self-attentions
   without the mask, 12 causal decoder self-attentions, 12
   cross-attentions), none in decode; at a 2 + 2-layer cut the kernel
   prefill and decodes against the plain attention within
   ``LOGITS_ATOL``. ``encdec_train``: 10 ``api.build(..., "train")``
   steps at that cut on 4 cycled batches: the loss falls, no flash launch
   (the plain route by design). ``vlm_lockstep``: the whole 32-layer
   Phi-3-vision-4.2B in bf16 (batch 8, 512-token prompts whose first 64
   positions are seeded ``patch_embeds``, 16 decodes, the fp and then the
   int8 cache): 32 flash launches a prefill, none in decode, the int8
   run's logit gap and greedy agreement; at a 2-layer cut the kernel
   against the plain attention within ``LOGITS_ATOL``, and the first-token
   logits with and without the patches apart by more than that.
16. ``kernels``: one entry per kernel, as the port's records expect;
   ``gmm_equal`` and ``imag_fused`` also give their ``event_run``,
   ``threads_paced``, ``procs_paced``, ``threads_tcp``, ``procs_tcp_join``,
   ``chaos_run`` and ``role_mesh`` launches (``gmm_ragged`` its
   ``role_mesh`` ones); flash attention its ``dense_lockstep``,
   ``lm_train``, ``wm_mbrl``, ``moe_lockstep``, ``moe_serve``,
   ``hybrid_lockstep``, ``encdec_lockstep``, ``encdec_train`` and
   ``vlm_lockstep`` launches and its times at the world model's prefill
   shape (``wm_path``), Zamba2-7B's (``hybrid_path``), Seamless's three
   (``encdec_path``) and Phi-3-vision's (``vlm_path``); ``ssd_chunked``
   its ``hybrid_lockstep`` launches and its times at Zamba2-7B's prefill
   (``hybrid_path``);
   ``gmm_ragged_bf16``, the bf16 route on its own, its ``moe_lockstep``
   and ``moe_serve`` launches, its planned route (``kernel_route``) and
   ``mma.sync`` time beside its own, and both at its other MoE shapes.
   The train phases' launches (0 in the steps) and those of their trained
   cuts' comparisons stand beside each kernel's (flash attention,
   ``gmm_ragged_bf16``, ``ssd_chunked``).

Each kernel's launches are counted from 0 just before the phase that
drives its path (``serve``, ``model_learn``, ``assigned_predict``,
``assigned_grad``, ``policy_improve``, each engine run of ``event_run``,
``sequential_run``, ``quickstart``, ``threads_paced``, ``threads_fleet``,
``threads_profile``, ``procs_paced``, ``procs_restart``, ``procs_fleet``,
``threads_tcp``, ``procs_tcp_join``, ``chaos_run``,
``role_mesh`` (each of its sharded runs),
``ssm_serve``, ``ssm_forward``, ``dense_lockstep``, ``lm_train``,
``wm_mbrl``, ``moe_lockstep``, ``moe_serve``, ``hybrid_lockstep``,
``moe_train``, ``hybrid_train`` (and each one's trained comparison),
``encdec_lockstep``, ``encdec_train``, ``vlm_lockstep``) and read just
after it (the procs phases' children count from 0 in their own
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

import contextlib
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
# the role_mesh phase: a stand-in mesh of four entries of the card (the
# counterpart of the reference's forced host devices). Four epochs of the
# sharded model learner against four on one device, and sharded against
# one-device imagination, held to the reference's own bound between the
# two (tests/_mesh_impl.py:211-225). Then 8 more trajectories wrap the
# small ring. The threads run splits the mesh (1, 2, 1): two model shards
ROLE_MESH_ENTRIES, ROLE_MESH_EPOCHS, ROLE_MESH_WRAP_TRAJS = 4, 4, 8
# the reference's test grid at the learner's ensemble: 12 trajectories in a
# ring of 12 (1,000 train rows: 3 minibatches of 256 an epoch, as the
# reference's 48 rows make 3 of 16)
ROLE_MESH_SMALL_TRAJS = 12
# Adam divides each gradient by its running scale, so a near-zero gradient
# element's rounding moves its leaf by a share of the learning rate: one
# device whose minibatch rows are merely reversed drifts 4-9x the
# reference's bound at these grids on the H100, the sharded learner
# 1.5-1.6x as far as that (PERF.md). The leaves are held to the bound, or
# to this many times the reordering's drift
LEAF_CONTROL_FACTOR = 4
MESH_RTOL, MESH_ATOL = 2e-5, 1e-6
ROLE_MESH_PULLS = 32
# ME-TRPO steps of the sharded policy improver against one device
ROLE_MESH_IMPROVE_STEPS = 2
ROLE_RATIOS = (1, 2, 1)
ROLE_MESH_LIMIT_S = 90.0
# the dry run's GLM-4-9B weight bytes against the allocator's count
DRYRUN_BYTES_RTOL = 0.01


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
    # head dims below 64: the world model's (32, WMConfig's defaults; 24,
    # its examples'), the second in the D = 32 build with its tail zeroed
    ("wm_prefill_b64_s4", 64, 4, 4, 4, 4, 32, True, 0, torch.bfloat16),
    ("d32_s64", 1, 64, 64, 32, 2, 32, True, 0, torch.bfloat16),
    ("d32_s64_f32", 1, 64, 64, 32, 2, 32, True, 0, torch.float32),
    ("d24_s64", 1, 64, 64, 32, 2, 24, True, 0, torch.bfloat16),
    ("d24_s64_f32", 1, 64, 64, 32, 2, 24, True, 0, torch.float32),
    ("d32_s4096", 1, 4096, 4096, 32, 2, 32, True, 0, torch.bfloat16),
    ("d32_s4096_f32", 1, 4096, 4096, 32, 2, 32, True, 0, torch.float32),
    ("d24_s4096", 1, 4096, 4096, 32, 2, 24, True, 0, torch.bfloat16),
    ("d24_s4096_f32", 1, 4096, 4096, 32, 2, 24, True, 0, torch.float32),
    # Zamba2-7B's shared attention at hybrid_lockstep's prefill: head dim
    # 112 in the D = 128 build, its tail zeroed
    ("zamba2_prefill_s256", 4, 256, 256, 32, 32, 112, True, 0,
     torch.bfloat16),
    # Seamless-M4T-medium at encdec_lockstep's prefill: the encoder's
    # self-attention without the mask, the decoder's cross-attention of its
    # 64-token prompt over the 256 frames, and the reference's consistency
    # shape, Sq = Sk + 1, where no output row may shift by Sk - Sq
    ("seamless_encoder_s256", 8, 256, 256, 16, 16, 64, False, 0,
     torch.bfloat16),
    ("seamless_cross_q64_k256", 8, 64, 256, 16, 16, 64, False, 0,
     torch.bfloat16),
    ("seamless_cross_q257_k256", 8, 257, 256, 16, 16, 64, False, 0,
     torch.bfloat16),
    # Phi-3-vision-4.2B at vlm_lockstep's prefill: head dim 96 in the
    # D = 128 build
    ("phi3v_prefill_s512", 8, 512, 512, 32, 32, 96, True, 0,
     torch.bfloat16),
    ("edge_cross_sq150_sk100", 2, 150, 100, 4, 2, 64, False, 0,
     torch.bfloat16),
]
MAIN_PATH_CASE = "prefill_s64"
WM_PATH_CASE = "wm_prefill_b64_s4"
HYBRID_ATTN_CASE = "zamba2_prefill_s256"
ENCDEC_ATTN_CASES = ("seamless_encoder_s256", "seamless_cross_q64_k256",
                     "seamless_cross_q257_k256")
VLM_ATTN_CASE = "phi3v_prefill_s512"


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
        elif not causal and not window:
            sdpa_kw = {}  # every key visible: no mask to read
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


def _scaled_err(got, want, tol: float = GMM_TOL) -> tuple:
    err = (got.float() - want.float()).abs().max().item()
    return err, tol * max(1.0, want.float().abs().max().item())


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


def grouped_mm_ms(library, want, tol: float = GMM_TOL) -> tuple:
    """(ms, how, None) of one ``torch._grouped_mm`` call that computes
    ``want`` within ``tol`` (TF32 is off), or (None, None, why not):
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
    err, bound = _scaled_err(got, want, tol)
    if not err <= bound:
        return None, None, f"max abs err {err} > {bound}"
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
    one masked validation forward; on a role mesh, each shard all of that
    on its block of the rows."""
    from repro_torch.core.roles import num_shards
    from repro_torch.mbrl import dynamics as DYN
    nb, bs = DYN.ring_grid(learner.cfg, learner.buffer.capacity)
    n_active = min(max(learner.buffer.size // bs, 1), nb)
    depth = len(learner.params["members"]["w"])
    n = num_shards(learner._batch_shard)
    return n * (n_active * depth + depth), n * n_active * 2 * depth


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
    plain ragged product (autograd through its loop over the groups)."""
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

# ------------------------------------------------------------- role_mesh
class PerShardLaunches:
    """While active, every call of ``module.name`` records how far the
    launch counters read by ``read()`` grew across it, call ``i`` to shard
    ``i % shards``: the sharded loops call the per-shard function in shard
    order, one thread at a time. A measurement of this script only; the
    wrappers of the kernels count as they always do."""

    def __init__(self, module, name: str, read, shards: int):
        self.module, self.name, self.read = module, name, read
        self.by_shard = [dict.fromkeys(read(), 0) for _ in range(shards)]
        self.calls = 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def counted(*args, **kw):
            before = self.read()
            out = self.orig(*args, **kw)
            shard = self.by_shard[self.calls % len(self.by_shard)]
            for k, v in self.read().items():
                shard[k] += v - before[k]
            self.calls += 1
            return out
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def mesh_gap(got, want) -> dict:
    """Largest absolute gap between two trees (or lists of floats) and
    the largest gap over ``MESH_RTOL * |want| + MESH_ATOL``: within the
    reference's bound when that ratio is at most 1."""
    from repro_torch.utils.tree import tree_leaves
    worst, ratio = 0.0, 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = torch.as_tensor(g).double(), torch.as_tensor(w).double()
        d = (g.to(w.device) - w).abs()
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (MESH_RTOL * w.abs()
                                       + MESH_ATOL)).max()))
    return {"max_abs": worst, "over_bound": ratio}


def leaf_gaps(got, want) -> dict:
    """``mesh_gap`` of each leaf of two ensembles, by its path."""
    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from paths(v, f"{prefix}{k}.")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from paths(v, f"{prefix}{i}.")
        else:
            yield prefix[:-1], tree
    want = dict(paths(want))
    return {k: mesh_gap(v, want[k]) for k, v in paths(got)}


def sharded_against_single(cfg, trajs, max_trajs, mesh, gmm_ops) -> dict:
    """``ROLE_MESH_EPOCHS`` epochs of a model learner sharded over ``mesh``
    against the same learner on one device: the same trajectories, the
    same seed (so the same init and index draws). Each sharded epoch's
    ``gmm_equal`` launches are recorded by shard."""
    from repro_torch.core import roles as ROLES
    from repro_torch.core.servers import DataServer, ParameterServer
    from repro_torch.core.workers import ModelLearningWorker
    from repro_torch.mbrl import dynamics as DYN
    n = ROLES.num_shards(ROLES.batch_sharded(mesh))

    def gmm():
        return {"fwd": gmm_ops.equal_launches,
                "bwd": gmm_ops.equal_bwd_launches}
    runs = {}
    for name, m in (("single", None), ("sharded", mesh), ("reordered", None)):
        ds, ms = DataServer(), ParameterServer()
        w = ModelLearningWorker(cfg, ds, ms, seed=3, max_trajs=max_trajs,
                                early_stop=False, min_trajs=1,
                                burst=len(trajs), mesh=m,
                                device=ROLES.home_device(mesh))
        if name == "reordered":
            # the control: one device, the same draws, each minibatch's
            # rows in reverse order (the same math, other sums)
            w.index_source = (lambda nb, b, size, w=w:
                              w._draw_indices(nb, b, size).flip(1))
        for t in trajs:
            ds.push(t)
        if m is not None:   # the main path's counts from 0
            gmm_ops.equal_launches = gmm_ops.equal_bwd_launches = 0
        per_shard = PerShardLaunches(DYN, "value_and_grad", gmm, n)
        epochs = []
        for _ in range(ROLE_MESH_EPOCHS):
            c0 = gmm()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (per_shard if m is not None else contextlib.nullcontext()):
                vloss = w.step()
            torch.cuda.synchronize()
            c1 = gmm()
            epochs.append({"ms": (time.perf_counter() - t0) * 1e3,
                           "val_loss": vloss,
                           "train_loss": float(w.last_train_loss),
                           "launches": [c1["fwd"] - c0["fwd"],
                                        c1["bwd"] - c0["bwd"]]})
        runs[name] = {"worker": w, "data": ds, "epochs": epochs,
                      "by_shard": per_shard.by_shard}
    single, sharded = runs["single"], runs["sharded"]
    control = runs["reordered"]
    buf = sharded["worker"].buffer
    nb, bs = DYN.ring_grid(cfg, buf.capacity)
    n_active = min(max(buf.size // bs, 1), nb)
    depth = len(single["worker"].params["members"]["w"])
    losses = {k: mesh_gap([e[k] for e in sharded["epochs"]],
                          [e[k] for e in single["epochs"]])
              for k in ("train_loss", "val_loss")}
    leaves = leaf_gaps(sharded["worker"].params, single["worker"].params)
    one = single["worker"].buffer
    return {
        "sharded": sharded["worker"], "data": sharded["data"],
        "same_ring": (buf.capacity, buf.val_capacity) == (one.capacity,
                                                          one.val_capacity),
        "record": {
            "ring": [buf.capacity, buf.val_capacity], "grid": [nb, bs],
            "n_active": n_active, "adam_steps": ROLE_MESH_EPOCHS * n_active,
            "loss_gaps": losses, "params_gap": mesh_gap(
                sharded["worker"].params, single["worker"].params),
            "worst_leaves": dict(sorted(
                leaves.items(), key=lambda kv: -kv[1]["over_bound"])[:3]),
            "reordered_control": {
                "loss_gaps": {k: mesh_gap([e[k] for e in control["epochs"]],
                                          [e[k] for e in single["epochs"]])
                              for k in ("train_loss", "val_loss")},
                "params_gap": mesh_gap(control["worker"].params,
                                       single["worker"].params)},
            "gmm_equal_launches_by_shard": sharded["by_shard"],
            "epochs_single": single["epochs"],
            "epochs_sharded": sharded["epochs"],
            "epoch_ms_single": [e["ms"] for e in single["epochs"]],
            "epoch_ms_sharded": [e["ms"] for e in sharded["epochs"]],
            "gmm_equal_launches": sum(sum(e["launches"])
                                      for e in sharded["epochs"])},
        "launches_as_implied":
            all(sum(s.values()) == ROLE_MESH_EPOCHS * n_active * 3 * depth
                for s in sharded["by_shard"])
            and all(e["launches"] == [n * (n_active * depth + depth),
                                      n * n_active * 2 * depth]
                    for e in sharded["epochs"])}


def role_mesh_learner(learner, gmm_ops, mesh) -> dict:
    """The model learner sharded over ``mesh`` (a stand-in mesh of the
    card) against one device, at the ``model_learn`` phase's ensemble, on
    its trajectories (its train and val rings cut into trajectories). On
    the reference's test grid (``ROLE_MESH_SMALL_TRAJS`` trajectories in a
    ring of as many, a few minibatches an epoch, tests/_mesh_impl.py) and
    on the full ring (64 minibatches an epoch) the losses and val losses
    are held to the reference's bound; the leaves to that bound or to
    ``LEAF_CONTROL_FACTOR`` times the drift of a control, one device whose
    minibatch rows are reversed (Adam carries the order of any sum into
    the leaves). The small ring then wraps under ``ROLE_MESH_WRAP_TRAJS``
    more and trains on, one input shape throughout."""
    from repro_torch.core import roles as ROLES
    from repro_torch.envs import make_env

    train, _ = learner.buffer.train_view()
    val, _ = learner.buffer.val_view()
    h = make_env(LEARN_ENV).horizon
    rows = {k: torch.cat([train[k], val[k]]) for k in train}
    trajs = [{k: v[i * h:(i + 1) * h] for k, v in rows.items()}
             for i in range(rows["obs"].shape[0] // h)]
    n = ROLES.num_shards(ROLES.batch_sharded(mesh))
    small = sharded_against_single(learner.cfg,
                                   trajs[:ROLE_MESH_SMALL_TRAJS],
                                   ROLE_MESH_SMALL_TRAJS, mesh, gmm_ops)
    full = sharded_against_single(learner.cfg, trajs, learner.max_trajs,
                                  mesh, gmm_ops)
    # the wrap: more trajectories than the small ring holds
    sharded = small["sharded"]
    for t in trajs[-ROLE_MESH_WRAP_TRAJS:]:
        small["data"].push(t)
    g0 = gmm_ops.equal_launches + gmm_ops.equal_bwd_launches
    wrap_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded.step()
        torch.cuda.synchronize()
        wrap_ms.append((time.perf_counter() - t0) * 1e3)
    wrap = gmm_ops.equal_launches + gmm_ops.equal_bwd_launches - g0
    storage, _ = sharded.buffer.train_view()
    s, f = small["record"], full["record"]
    checks = {
        "reference grid: losses and val losses within the reference's "
        "bound": all(g["over_bound"] <= 1.0 for g in
                     s["loss_gaps"].values()),
        "full ring: losses and val losses within the reference's bound":
            all(g["over_bound"] <= 1.0 for g in f["loss_gaps"].values()),
        "every leaf within the reference's bound, or within "
        f"{LEAF_CONTROL_FACTOR} times one device's drift under a reordering":
            all(r["params_gap"]["over_bound"] <= max(
                1.0, LEAF_CONTROL_FACTOR
                * r["reordered_control"]["params_gap"]["over_bound"])
                for r in (s, f)),
        "gmm_equal launches on every shard, as its rows imply":
            small["launches_as_implied"] and full["launches_as_implied"],
        "the rings of both learners alike (no capacity rounded up)":
            small["same_ring"] and full["same_ring"],
        "the ring wrapped": sharded.buffer._written > sharded.buffer.capacity,
        "one train_epoch / val_loss shape while the ring wraps":
            (sharded.compile_count(), sharded.val_compile_count()) == (1, 1),
        "the ring stays in its shards":
            all(isinstance(v, ROLES.RowShards) and len(v.shards) == n
                for v in storage.values()),
    }
    return {"checks": checks, "shards": n, "reference_grid": s,
            "full_ring": f, "wrap_epoch_ms": wrap_ms,
            "wrap_gmm_equal_launches": wrap,
            "gmm_equal_launches": s["gmm_equal_launches"]
                + f["gmm_equal_launches"] + wrap}


def role_mesh_improver(model_params, gmm_ops, imag_ops, mesh) -> dict:
    """The policy improver at the ``policy_improve`` phase's shapes (ME-TRPO,
    64 starts, horizon 50, its ensemble, a policy of its width) through the
    engine's entry point, ``PolicyImprovementWorker(mesh=)``: its
    imagination sharded over ``mesh`` by ``configure_mesh``, against the
    same worker on one device, same seed, same pulls. Each of
    ``ROLE_MESH_IMPROVE_STEPS`` steps' imagined return and the pushed
    policy are held to the reference's bound, and each shard's
    ``imag_fused`` launches recorded. Then the sharded algorithm's rollout
    on the legacy step (``gmm_ragged``) against one device on one draw: its
    first step held to the bound, the whole rollout's gap reported, and
    beside it ``role_mesh_row_coupling``, which reads where the two
    differ."""
    from repro_torch.core import roles as ROLES
    from repro_torch.core.servers import ParameterServer
    from repro_torch.core.workers import PolicyImprovementWorker
    from repro_torch.envs import make_env
    from repro_torch.mbrl import algos as A
    from repro_torch.mbrl import policy as PI

    env = make_env(LEARN_ENV)
    cfg = A.AlgoConfig(algo="me-trpo")
    pol_cfg = PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=POLICY_HIDDEN)
    model_server = ParameterServer()
    model_server.push(model_params)
    n = ROLES.num_shards(ROLES.batch_sharded(mesh))
    H, B = cfg.imagine_horizon, cfg.imagine_batch

    def fused():
        return {"launches": imag_ops.launches}

    def ragged():
        return {"launches": gmm_ops.ragged_launches}
    runs = {}
    for name, m in (("single", None), ("sharded", mesh)):
        algo = A.make_algo(cfg, pol_cfg, env.reward, env.reset_batch)
        server = ParameterServer()
        worker = PolicyImprovementWorker(algo, server, model_server, seed=7,
                                         mesh=m, device=ROLES.home_device(
                                             mesh))
        if m is not None:   # the main path's counts from 0
            imag_ops.launches = 0
        steps = []
        per = PerShardLaunches(A, "_rollout_with_logp", fused, n)
        with (per if m is not None else contextlib.nullcontext()):
            for _ in range(ROLE_MESH_IMPROVE_STEPS):
                l0 = imag_ops.launches
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                did = worker.step()
                torch.cuda.synchronize()
                steps.append({
                    "did": did, "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": imag_ops.launches - l0,
                    "imagined_return":
                        float(worker.last_info["imagined_return"]),
                    "found": bool(worker.last_info["found"])})
        runs[name] = {"worker": worker, "policy": server.pull()[0],
                      "steps": steps, "by_shard": per.by_shard,
                      "sharding": algo._batch_sharding}
    single, sharded = runs["single"], runs["sharded"]

    # the legacy step through the same sharded rollout, on one draw
    algo, worker = sharded["worker"].algo, sharded["worker"]
    gen = torch.Generator(device=ROLES.home_device(mesh)).manual_seed(4)
    draws = algo.draw(model_params, gen)
    pol = worker.state["policy"]
    one = single["worker"].algo
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = one._rollout(model_params, pol, draws, None, shard=True,
                        fused=False)
    torch.cuda.synchronize()
    legacy_single_ms = (time.perf_counter() - t0) * 1e3
    gmm_ops.ragged_launches = 0         # the main path's counts from 0
    with PerShardLaunches(A, "_rollout_with_logp", ragged, n) as legacy:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = algo._rollout(model_params, pol, draws, None, shard=True,
                            fused=False)
        torch.cuda.synchronize()
        legacy_ms = (time.perf_counter() - t0) * 1e3
    legacy_launches = gmm_ops.ragged_launches
    # (obs, pre, rew): the first step is obs[1], pre[0], rew[0]
    legacy_rec = {
        "gap": mesh_gap(list(got), list(want)),
        "first_step_gap": mesh_gap([got[1][0], got[0][1], got[2][0]],
                                   [want[1][0], want[0][1], want[2][0]]),
        "finite": all(bool(torch.isfinite(v).all()) for v in got),
        "launches_by_shard": [s["launches"] for s in legacy.by_shard],
        "launches_sharded": legacy_launches,
        "ms_single": legacy_single_ms, "ms_sharded": legacy_ms}
    coupling = role_mesh_row_coupling(model_params, pol, draws, mesh)

    returns = mesh_gap([s["imagined_return"] for s in sharded["steps"]],
                       [s["imagined_return"] for s in single["steps"]])
    checks = {
        "improver: the worker configured the algorithm's mesh":
            sharded["sharding"] is not None and single["sharding"] is None,
        "improver: every step ran, one improve shape":
            all(s["did"] for r in runs.values() for s in r["steps"])
            and all(r["worker"].compile_count() == 1
                    for r in runs.values()),
        "improver: sharded imagined returns and pushed policy within the "
        "reference's bound":
            returns["over_bound"] <= 1.0
            and mesh_gap(sharded["policy"],
                         single["policy"])["over_bound"] <= 1.0,
        "improver: every shard launches imag_fused H times a step":
            sharded["by_shard"] == [{"launches": H * ROLE_MESH_IMPROVE_STEPS}]
            * n and all(s["launches"] == n * H for s in sharded["steps"])
            and all(s["launches"] == H for s in single["steps"]),
        "legacy: the first sharded step within the reference's bound":
            legacy_rec["first_step_gap"]["over_bound"] <= 1.0
            and legacy_rec["finite"],
        "legacy: every shard launches gmm_ragged H times a layer":
            legacy_rec["launches_by_shard"] == [3 * H] * n
            and legacy_launches == n * 3 * H,
        "row coupling: gmm_ragged's rows do not depend on their groups' "
        "row counts": coupling["predict_assigned"]["rows_changed"] == 0,
    }
    return {"checks": checks, "shape": [B, H], "shards": n,
            "steps_single": single["steps"],
            "steps_sharded": sharded["steps"],
            "imagined_return_gap": returns,
            "policy_gap": mesh_gap(sharded["policy"], single["policy"]),
            "imag_fused_launches_by_shard":
                [s["launches"] for s in sharded["by_shard"]],
            "legacy": legacy_rec, "row_coupling": coupling,
            "imag_fused_launches": sum(s["launches"]
                                       for s in sharded["steps"]),
            "gmm_ragged_launches": legacy_launches}


def role_mesh_row_coupling(model_params, pol, draws, mesh) -> dict:
    """Where a sharded legacy rollout parts from one device: the first
    step's two calls on all the starts against each shard's block of them.
    ``predict_assigned`` (three ``gmm_ragged`` products, each shard's
    groups holding fewer rows) is given the whole batch's actions, so only
    the ragged products' row counts differ; the policy's sample
    (``sample_with_logp``, plain matmuls) is read the same way. Counts the
    rows that are not bit-equal, and the largest gap."""
    from repro_torch.core import roles as ROLES
    from repro_torch.mbrl import dynamics as DYN
    from repro_torch.mbrl import policy as PI

    s, eps, members = draws["s0"], draws["eps"][0], draws["members"][0]
    slices = ROLES.shard_slices(ROLES.batch_sharded(mesh), s.shape[0])
    a, pre, _ = PI.sample_with_logp(pol, s, eps)
    whole = {"policy": pre,
             "predict_assigned": DYN.predict_assigned(model_params, s, a,
                                                      members)}
    parts = {"policy": [], "predict_assigned": []}
    for _, lo, hi in slices:
        parts["policy"].append(PI.sample_with_logp(pol, s[lo:hi],
                                                   eps[lo:hi])[1])
        parts["predict_assigned"].append(DYN.predict_assigned(
            model_params, s[lo:hi], a[lo:hi], members[lo:hi]))
    out = {}
    for k, w in whole.items():
        g = torch.cat(parts[k])
        diff = (g - w).abs()
        out[k] = {"rows_changed": int((diff.amax(1) > 0).sum()),
                  "max_abs": float(diff.max())}
    out["rows"] = [s.shape[0], [hi - lo for _, lo, hi in slices]]
    out["group_rows_whole"] = torch.bincount(
        members, minlength=DYN.n_members(model_params)).tolist()
    return out


def role_mesh_pulls(model_params, mesh) -> dict:
    """A pull onto the placement ``replicated(mesh)``: the stored tensors
    themselves when they already live there; then ``ROLE_MESH_PULLS``
    unchanged pulls with that ``sharding=`` under
    ``torch.cuda.set_sync_debug_mode("error")``, counting copies."""
    from repro_torch.core import roles as ROLES
    from repro_torch.core import servers as SRV
    from repro_torch.utils.tree import tree_leaves
    ps = SRV.ParameterServer()
    ver = ps.push(model_params)
    repl = ROLES.replicated(mesh)
    val, got = ps.pull_if_newer(0, sharding=repl)
    stored, _ = ps.pull()
    same = got == ver and all(a is b for a, b in zip(tree_leaves(val),
                                                     tree_leaves(stored)))
    copies = []
    orig = SRV.tree_to
    SRV.tree_to = lambda *a: copies.append(a) or orig(*a)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        unchanged = [ps.pull_if_newer(ver, sharding=repl)
                     for _ in range(ROLE_MESH_PULLS)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        SRV.tree_to = orig
    us = (time.perf_counter() - t0) * 1e6 / ROLE_MESH_PULLS
    checks = {
        "an already-placed pull hands out the stored tensors": same,
        f"{ROLE_MESH_PULLS} unchanged pulls: no value, no copy, no "
        "allocation, no sync": all(v is None and g == ver
                                   for v, g in unchanged)
            and not copies and torch.cuda.memory_allocated() == mem0,
    }
    return {"checks": checks, "pulls": ROLE_MESH_PULLS,
            "copies": len(copies), "unchanged_pull_us": us}


def role_mesh(CONFIG, init_params, learner, model_server, gmm_ops,
              imag_ops) -> dict:
    """The role-mesh path on the card: the split of the local cards, the
    sharded model learner and imagination on a stand-in mesh of
    ``ROLE_MESH_ENTRIES`` entries of the card against one device, the
    placement-aware pulls, a threads-mode ``AsyncTrainer`` on that mesh
    split ``ROLE_RATIOS`` (and on the real split where the host has three
    cards), and the dry run's weight bytes against the allocator's."""
    import warnings

    from repro_torch.core import roles as ROLES
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.models.config import INPUT_SHAPES

    t_phase = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        local = ROLES.split_roles(make_local_mesh())
    local_warnings = [str(w.message) for w in caught]
    n_cards = torch.cuda.device_count()
    print(json.dumps({"phase": "role_mesh_split",
                      "cards": n_cards, **local.describe()}), flush=True)
    mesh = make_mesh(ROLE_MESH_ENTRIES, device="cuda:0")
    model_params, _ = model_server.pull()

    learned = role_mesh_learner(learner, gmm_ops, mesh)
    improved = role_mesh_improver(model_params, gmm_ops, imag_ops, mesh)
    pulls = role_mesh_pulls(model_params, mesh)
    gc.collect()
    torch.cuda.empty_cache()

    trainer, threads = threads_run(
        "role_mesh_threads", gmm_ops, imag_ops,
        dict(total_trajs=ENGINE_TRAJS, pace_collection=True,
             collect_speed=THREADS_SPEED),
        mesh=mesh, role_ratios=ROLE_RATIOS)
    roles = trainer.roles
    storage = (trainer.model_worker.buffer.train_view()[0]
               if trainer.model_worker.buffer is not None else {})
    threads.update({
        "roles": roles.describe(),
        "model_shards": ROLES.num_shards(trainer.model_worker._batch_shard),
        "ring_shards": sorted({len(v.shards) for v in storage.values()})})
    del trainer
    if n_cards >= 3:
        real_trainer, real = threads_run(
            "role_mesh_real_split", gmm_ops, imag_ops,
            dict(total_trajs=ENGINE_TRAJS, pace_collection=True,
                 collect_speed=THREADS_SPEED),
            mesh=make_local_mesh(), role_ratios=ROLE_RATIOS)
        real["roles"] = real_trainer.roles.describe()
        del real_trainer
    else:
        real = {"run": False, "why": f"{n_cards} card(s): a real split "
                "needs one card a role (3), so it would be the shared "
                "fallback, the same path as the stand-in run above"}
        print(json.dumps({"phase": "role_mesh_real_split", **real}),
              flush=True)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    glm = init_params(CONFIG, 0)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - a0
    del glm
    gc.collect()
    torch.cuda.empty_cache()
    dry = dryrun.step_bytes(CONFIG, INPUT_SHAPES["prefill_32k"])
    dry_roles = dryrun.dryrun_roles(make_local_mesh(), verbose=False)
    seconds = time.perf_counter() - t_phase

    checks = {
        **learned.pop("checks"), **improved.pop("checks"),
        **pulls.pop("checks"),
        "the local cards split as split_roles says": n_cards >= 3
            or (local.shared and any("shared sub-meshes" in w
                                     for w in local_warnings)),
        "threads run on the stand-in mesh: a real (1, 2, 1) split":
            not roles.shared and roles.describe()["model"] == [2],
        "threads run: the sharded learner and improver worked":
            threads["model_epochs"] >= 1 and threads["policy_steps"] >= 1
            and threads["gmm_equal_launches"] > 0
            and threads["imag_fused_launches"] > 0
            and threads["ring_shards"] == [threads["model_shards"]],
        "the dry run's weight bytes within 1% of the allocator's":
            abs(dry["weights"] - allocated) <= DRYRUN_BYTES_RTOL * allocated,
        f"the phase within {ROLE_MESH_LIMIT_S} s":
            seconds <= ROLE_MESH_LIMIT_S,
    }
    failed = [name for name, ok in checks.items() if not ok]
    record = {
        "cards": n_cards, "local_split": local.describe(),
        "local_warnings": local_warnings, "dryrun_roles": dry_roles,
        "stand_in_mesh": ROLE_MESH_ENTRIES, "learner": learned,
        "improver": improved, "pulls": pulls, "threads": threads,
        "real_split": real,
        "glm4_9b_weights": {"dryrun_bytes": dry["weights"],
                            "allocated_bytes": allocated,
                            "gap": dry["weights"] / allocated - 1.0},
        "seconds": seconds, "checks": sorted(checks)}
    if failed:
        raise RuntimeError(f"role_mesh failed: {failed}; {record}")
    return record


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
    from repro_torch.core.roles import num_shards
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
    # a role mesh's policy shards each run the horizon on their rows
    horizon = (policy.algo.cfg.imagine_horizon
               * num_shards(policy.algo._batch_sharding))
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

        def metered(version, **kw):
            b0 = srv.array_bytes_received
            t0 = time.perf_counter()
            value, ver = call(version, **kw)
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
    # Zamba2-7B's mamba layers at hybrid_lockstep's prefill (112 heads,
    # P 64, N 64, final state out)
    ("zamba2_prefill_b4_l256", 4, 256, 112, 64, 64, 1, 128, torch.bfloat16,
     False, True, 1.0),
]
SSD_MAIN = "prefill_b4_l1024"
HYBRID_SSD_CASE = "zamba2_prefill_b4_l256"


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


# ---------------------------------------------------------------- phase 13

LOCKSTEP = dict(batch=8, prompt=48, new=16)   # examples/serve_world_model.py
# kernel vs plain logits through all 40 bf16 layers: the kernel rounds P
# to bf16 where the plain version keeps it in f32, one bf16 ulp of some
# attention outputs that 40 layers compound (about 0.11 at the prefill
# and 0.13 over the decodes on an H100, logits of std 1.0 and at most
# 4.9); LOGITS_ATOL holds at 2 layers
LOCKSTEP_FULL_ATOL = 0.25
# examples/train_world_model.py's --big model, its batch and sequence
LM_TRAIN_CFG = dict(name="wm-100m", family="dense", num_layers=12,
                    d_model=768, num_heads=12, num_kv_heads=4, d_ff=3072,
                    vocab_size=8192)
# 50 steps over the stream's first 4 batches (each token seen ~12 times);
# on fresh batches each of the 8,192 tokens is seen only ~3 times in 50
# steps (labels equal tokens: an identity to learn token by token), too
# few for the loss to halve
LM_TRAIN = dict(batch=8, seq=64, steps=50, batches=4)
WM_TRAJS, WM_EPOCHS, WM_IMPROVE_STEPS = 6, 12, 3
WM_MSE_RATIO = 0.3    # tests/test_wm_dynamics.py's bar


def _greedy(logits, cfg):
    return torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None].to(
        torch.int32)


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def _decode_run(dec, model, cache, tok, cfg, n_new, feed=None):
    """``n_new`` lock-step decodes from ``tok``: greedy, or fed ``feed``'s
    tokens. Each tick ends with its token on the host. Returns the logits,
    the tokens fed after the first and the tick times."""
    logits_seq, tokens, tick_ms = [], [], []
    for i in range(n_new):
        t0 = time.perf_counter()
        logits, cache = dec.fn(model, cache, tok)
        nxt = _greedy(logits, cfg)
        nxt.cpu()
        tick_ms.append(_ms_since(t0))
        logits_seq.append(logits)
        tok = nxt if feed is None else feed[i]
        tokens.append(nxt)
    return logits_seq, tokens, tick_ms, cache


def lockstep_vs_plain(cfg, model, api, InputShape, tokens, n_new,
                      plain=None, extra=None):
    """The comparison: the lock-step prefill through the kernels and
    through the plain routes ``plain`` names (``api.build``'s ``*_impl``;
    the plain attention by default), and ``n_new`` decodes from each cache
    fed the same greedy tokens (each decode on its own route of the moe
    experts). ``extra`` joins the prompt in the prefill's batch (frame or
    patch embeddings). Returns the largest logit differences (prefill,
    decode) and the plain prefill's logits."""
    plain = {"attn_impl": "ref"} if plain is None else plain
    B, S = tokens.shape
    shape = InputShape("p", S, B, "prefill")
    batch = {"tokens": tokens, **(extra or {})}
    runs = []
    for kw in ({}, plain):
        dec = api.build(cfg, InputShape("d", S + n_new, B, "decode"),
                        gmm_impl=kw.get("gmm_impl"))
        lg, cache = api.build(cfg, shape, **kw).fn(model, batch)
        runs.append((lg, api.grow_cache(cache, S + n_new + 1), dec))
    (lg_k, cache_k, dec_k), (lg_r, cache_r, dec_r) = runs
    tok = _greedy(lg_k, cfg)
    k_logits, k_tokens, _, _ = _decode_run(dec_k, model, cache_k, tok, cfg,
                                           n_new)
    r_logits, _, _, _ = _decode_run(dec_r, model, cache_r, tok, cfg, n_new,
                                    feed=k_tokens)
    return ((lg_k - lg_r).abs().max().item(),
            max((a - b).abs().max().item()
                for a, b in zip(k_logits, r_logits)), lg_r)


def _counts(counters: dict) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}


def _since(counters: dict, before: dict) -> dict:
    return {name: n - before[name] for name, n in _counts(counters).items()}


def _kv_bytes(cache) -> int:
    return sum(cache[k].numel() * cache[k].element_size()
               for k in ("k", "v", "k_scale", "v_scale", "pos")
               if k in cache)


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def lockstep_serving(cfg, init_params, api, InputShape, counters, B, S,
                     n_new, kv_int8: bool, extra=None) -> tuple:
    """Lock-step serving of ``cfg`` at full size through ``api.build``: two
    prefills (cold, warm) of a batch of ``B`` random ``S``-token prompts
    (with ``extra``'s tensors, frame or patch embeddings, in the batch),
    the cache grown, ``n_new`` greedy decodes; with ``kv_int8`` the int8
    cache's prefill and decodes fed the fp run's tokens. The counts in
    ``counters`` go to 0 just before and are read just after. Returns the
    model, the prompt and the readings."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, 3)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()  # from here: the serving path
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    batch = {"tokens": tokens, **(extra or {})}
    shape = InputShape("p", S, B, "prefill")
    pre = api.build(cfg, shape)
    dec = api.build(cfg, InputShape("d", S + n_new, B, "decode"))
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    prefill_ms, per_prefill = [], []
    for _ in range(2):  # cold, then warm
        c0 = _counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg0, cache = pre.fn(model, batch)
        tok = _greedy(lg0, cfg)
        tok.cpu()  # the first token on the host: time to first token
        prefill_ms.append(_ms_since(t0))
        per_prefill.append(_since(counters, c0))
    cache = api.grow_cache(cache, S + n_new + 1)
    c0 = _counts(counters)
    logits, toks, tick_ms, cache = _decode_run(dec, model, cache, tok, cfg,
                                               n_new)
    decode_launches = _since(counters, c0)
    out = {"tokens": tokens, "logits": logits, "new_tokens": toks,
           "cache": cache, "first": tok}
    int8 = None
    if kv_int8:
        c0 = _counts(counters)
        _, cache_q = api.build(cfg, shape, kv_int8=True).fn(model, batch)
        int8_prefill = _since(counters, c0)
        cache_q = api.grow_cache(cache_q, S + n_new + 1)
        c0 = _counts(counters)
        q_logits, _, q_tick_ms, cache_q = _decode_run(
            dec, model, cache_q, tok, cfg, n_new, feed=toks)
        int8 = {"prefill_launches": int8_prefill,
                "decode_launches": _since(counters, c0),
                "max_logit_gap": max((a - b).abs().max().item()
                                     for a, b in zip(q_logits, logits)),
                "greedy_agreement": float(np.mean(
                    [bool(torch.equal(_greedy(a, cfg), b))
                     for a, b in zip(q_logits, toks)])),
                "decode_tokens_per_s": B * n_new / (sum(q_tick_ms) / 1e3),
                "finite": all(bool(torch.isfinite(t).all())
                              for t in q_logits),
                "index": int(cache_q["index"]),
                "dtype": str(cache_q["k"].dtype),
                "kv_bytes": _kv_bytes(cache_q)}
    torch.cuda.synchronize()
    launches = _counts(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ticks = sorted(tick_ms)
    readings = {
        "config": cfg.name, "layers": cfg.num_layers, "batch": B,
        "prompt_len": S, "new_tokens": n_new, "dtype": cfg.dtype,
        "params_b": sum(t.numel() for t in model.parameters()) / 1e9,
        "init_params_s": init_s, "init_params_peak_mem_gb": init_peak,
        "prefill_ms_cold_warm": prefill_ms, "ttft_ms": prefill_ms[-1],
        "decode_tokens_per_s": B * n_new / (sum(tick_ms) / 1e3),
        "tick_ms_p50": ticks[len(ticks) // 2], "tick_ms_max": ticks[-1],
        "peak_mem_gb": peak, "kv_bytes": _kv_bytes(cache),
        "launches": launches,
        "launches_per_prefill": per_prefill,
        "launches_decode": decode_launches,
        "decode_shapes": dec.fn.shape_count, "int8": int8}
    return model, out, readings


def lockstep_checks(name, cfg, out, readings, per_prefill, per_decode):
    """The lock-step phases' shared invariants: the kernels' launches a
    prefill and over the decodes, finite logits, tokens in the vocab, one
    decode shape a cache kind, the index advanced."""
    n_new = readings["new_tokens"]
    toks = torch.cat([out["first"]] + out["new_tokens"], 1)
    want_decode = {k: n * n_new for k, n in per_decode.items()}
    checks = {
        f"launches per prefill {per_prefill}":
            readings["launches_per_prefill"] == [per_prefill] * 2,
        f"launches per decode {per_decode}":
            readings["launches_decode"] == want_decode,
        "finite logits": all(bool(torch.isfinite(t).all())
                             for t in out["logits"]),
        "tokens in the vocab": bool(((toks >= 0)
                                     & (toks < cfg.vocab_size)).all()),
        "index advanced": int(out["cache"]["index"])
            == readings["prompt_len"] + n_new,
    }
    int8 = readings["int8"]
    if int8 is not None:
        checks.update({
            "int8 launches as fp": int8["prefill_launches"] == per_prefill
                and int8["decode_launches"] == want_decode,
            "int8 cache finite and advanced": int8["finite"]
                and int8["index"] == readings["prompt_len"] + n_new
                and int8["dtype"] == "torch.int8",
            "one decode shape a cache kind": readings["decode_shapes"] == 2})
    else:
        checks["one decode shape"] = readings["decode_shapes"] == 1
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{name} failed: {failed}; {readings}")
    readings["tokens_row0"] = toks[0, :8].tolist()


def dense_lockstep(CONFIG, init_params, api, InputShape, fa_ops) -> dict:
    """Lock-step serving of the full 40-layer GLM-4-9B in bf16 through
    ``api.build`` (``lockstep_serving``): ``serve_world_model.py``'s shape
    (batch 8, 48-token prompts), the cache grown to 65 slots, 16 greedy
    decodes; then the same with the int8 cache, fed the fp run's tokens:
    40 flash launches a prefill, none in decode. The comparisons, after
    the counts are read: the kernel's prefill against the plain
    attention's and the decodes from either cache, at all 40 layers
    within ``LOCKSTEP_FULL_ATOL`` and at 2 layers within
    ``LOGITS_ATOL``."""
    cfg = CONFIG
    B, S, n_new = (LOCKSTEP[k] for k in ("batch", "prompt", "new"))
    model, out, readings = lockstep_serving(
        cfg, init_params, api, InputShape, {"flash": (fa_ops, "launches")},
        B, S, n_new, True)
    lockstep_checks("dense_lockstep", cfg, out, readings,
                    {"flash": cfg.num_layers}, {"flash": 0})
    tokens = out["tokens"]
    prefill_err, decode_err, lg_ref = lockstep_vs_plain(
        cfg, model, api, InputShape, tokens, n_new)
    del model, out
    _free()
    cut = dataclasses.replace(cfg, num_layers=2, name=cfg.name + "-l2")
    cut_model = init_params(cut, 3)
    cut_prefill_err, cut_decode_err, _ = lockstep_vs_plain(
        cut, cut_model, api, InputShape, tokens, n_new)
    del cut_model
    _free()
    checks = {
        "2 layers: prefill and decode logits kernel vs plain within "
        "LOGITS_ATOL": max(cut_prefill_err, cut_decode_err) <= LOGITS_ATOL,
        "40 layers: prefill and decode logits kernel vs plain within "
        "LOCKSTEP_FULL_ATOL": max(prefill_err, decode_err)
            <= LOCKSTEP_FULL_ATOL,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dense_lockstep failed: {failed}; errors "
                           f"{cut_prefill_err} {cut_decode_err} (2 layers),"
                           f" {prefill_err} {decode_err}")
    return {**readings, "cache_slots": S + n_new + 1,
            "prefill_max_abs_err": prefill_err,
            "decode_max_abs_err": decode_err, "atol": LOCKSTEP_FULL_ATOL,
            "l2_prefill_max_abs_err": cut_prefill_err,
            "l2_decode_max_abs_err": cut_decode_err, "l2_atol": LOGITS_ATOL,
            "logits_std": lg_ref.std().item(),
            "logits_max_abs": lg_ref.abs().max().item()}


def lm_train(ModelConfig, init_params, api, InputShape, LM, adam,
             DynamicsTokenStream, fa_ops) -> dict:
    """``api.build(..., "train")`` on ``train_world_model.py``'s ``wm-100m``
    in bf16 at its ``lr``: 50 steps over ``DynamicsTokenStream``'s first 4
    batches (made before the run), where the loss must halve. The step
    trains through the plain attention by design (the kernel is
    forward-only, as the reference's has no backward), so the kernel is
    launched no time."""
    cfg = ModelConfig(**LM_TRAIN_CFG)
    B, S, steps = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"]
    stream = DynamicsTokenStream(cfg.vocab_size, S, B, seed=0)
    bundle = api.build(cfg, InputShape("t", S, B, "train"))
    batches = [stream.batch_at(i) for i in range(LM_TRAIN["batches"])]
    model = init_params(cfg, 0)
    n_params = sum(p.numel() for p in model.parameters())
    opt_state = adam(cfg.lr).init(LM.trainable(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = 0
    losses, gnorms, step_ms = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        model, opt_state, m = bundle.fn(model, opt_state,
                                        batches[i % len(batches)])
        losses.append(float(m["loss"]))
        step_ms.append(_ms_since(t0))
        gnorms.append(float(m["gnorm"]))
    launches = fa_ops.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, opt_state
    checks = {
        "loss halved": losses[-1] < 0.5 * losses[0],
        "finite": bool(np.isfinite(losses + gnorms).all()),
        "no flash launch (plain attention by design)": launches == 0,
        "one train input shape": bundle.fn.shape_count == 1,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"lm_train failed: {failed}; losses "
                           f"{losses[0]} -> {losses[-1]}, launches "
                           f"{launches}")
    warm = sorted(step_ms[1:])
    out = {"config": cfg.name, "params_m": n_params / 1e6,
           "dtype": cfg.dtype, "batch": B, "seq": S, "steps": steps,
           "lr": cfg.lr, "microbatches": bundle.num_microbatches,
           "batches_cycled": LM_TRAIN["batches"],
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses_every_10": losses[::10], "gnorm_last": gnorms[-1],
           "step_ms_first": step_ms[0], "step_ms_p50": warm[len(warm) // 2],
           "tokens_per_s": B * S / (warm[len(warm) // 2] / 1e3),
           "peak_mem_gb": peak, "attention_launches": launches}
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    return out


def wm_mbrl(LM, fa_ops) -> dict:
    """The transformer world model in the paper's algorithm: pendulum with
    ``WMConfig`` defaults (head dim 32), 6 trajectories, the normaliser
    fitted, 12 ``train_epoch``s (the predict MSE must fall below 0.3x),
    then 3 ME-TRPO ``improve`` steps at ``AlgoConfig`` defaults through
    ``predict_fn``: one kernel prefill per imagined step and layer."""
    from repro_torch.envs import make_env
    from repro_torch.mbrl import policy as PI
    from repro_torch.mbrl.algos import AlgoConfig, make_algo
    from repro_torch.mbrl.wm_dynamics import WMConfig, WorldModelDynamics
    env = make_env("pendulum")
    wm = WorldModelDynamics(WMConfig(env.obs_dim, env.act_dim), 0)
    nl = wm.mcfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    pol = PI.init_policy(PI.PolicyConfig(env.obs_dim, env.act_dim, hidden=8),
                         gen)
    trajs = [env.rollout(PI.sample_action, pol, generator=gen)
             for _ in range(WM_TRAJS)]
    obs, act, nobs = (torch.cat([t[k] for t in trajs])
                      for k in ("obs", "act", "next_obs"))
    wm.update_normalizer(torch.cat([obs, nobs]))

    def mse():
        pred = wm.predict(obs[:64], act[:64])
        return float(((pred - nobs[:64]) ** 2).mean())

    fa_ops.launches = 0
    before = mse()
    t0 = time.perf_counter()
    for _ in range(WM_EPOCHS):
        loss = wm.train_epoch(obs, act, nobs, generator=gen)
    train_s = time.perf_counter() - t0
    train_launches = fa_ops.launches - nl
    after = mse()
    acfg = AlgoConfig()
    algo = make_algo(acfg, PI.PolicyConfig(env.obs_dim, env.act_dim),
                     env.reward, env.reset_batch,
                     predict_fn=wm.predict_fn())
    state = algo.init(gen)
    improve_ms, returns, per_improve = [], [], []
    for _ in range(WM_IMPROVE_STEPS):
        l0 = fa_ops.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = algo.improve(state, wm.params, generator=gen)
        returns.append(float(info["imagined_return"]))
        improve_ms.append(_ms_since(t0))
        per_improve.append(fa_ops.launches - l0)
    launches = fa_ops.launches

    # the comparison: the kernel prefill of imagined prompts vs the plain
    prompt = torch.cat([wm.tok_obs(obs[:64], wm.norm, 0),
                        wm.tok_act(act[:64])], 1)
    lg_k, _ = LM.make_prefill(wm.mcfg)(wm.params, {"tokens": prompt})
    lg_r, _ = LM.make_prefill(wm.mcfg, attn_impl="ref")(
        wm.params, {"tokens": prompt})
    err = (lg_k - lg_r).abs().max().item()
    checks = {
        f"MSE below {WM_MSE_RATIO}x its start": after < WM_MSE_RATIO * before,
        "no flash launch in training (plain attention)": train_launches == 0,
        f"{acfg.imagine_horizon * nl} flash launches per improve":
            per_improve == [acfg.imagine_horizon * nl] * WM_IMPROVE_STEPS,
        "finite imagined returns": bool(np.isfinite(returns).all()),
        "steps": int(state["steps"]) == WM_IMPROVE_STEPS,
        "prefill logits kernel vs plain within LOGITS_ATOL":
            err <= LOGITS_ATOL,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"wm_mbrl failed: {failed}; mse {before} -> "
                           f"{after}, launches {per_improve}, err {err}")
    return {"env": "pendulum", "head_dim": wm.mcfg.hd,
            "d_model": wm.mcfg.d_model, "layers": nl, "bins": wm.cfg.bins,
            "rows": int(obs.shape[0]), "epochs": WM_EPOCHS,
            "train_s": train_s, "token_loss": loss, "mse_before": before,
            "mse_after": after, "mse_ratio": after / before,
            "imagine_batch": acfg.imagine_batch,
            "imagine_horizon": acfg.imagine_horizon,
            "improve_ms": improve_ms, "imagined_returns": returns,
            "attention_launches": launches,
            "launches_per_improve": per_improve,
            "prefill_max_abs_err": err, "atol": LOGITS_ATOL}


# ---------------------------------------------------------------- phase 14

# the bf16 ragged kernel vs the looped plain product: both sum exact bf16
# products in f32 and round once to bf16, so an output may round to the
# other bf16 neighbour of the f32 sum and no further: one bf16 ulp (2^-7)
# of the output's scale
GMM_BF16_TOL = 2.0 ** -7
# torch._grouped_mm, the yardstick timed beside the kernel, is held only to
# the reference's bf16 tolerance before its time is kept
GMM_BF16_LIBRARY_TOL = 5e-2
# the dropless MoE's products: name, experts, tokens, top-k, K, N; each
# token's top-k experts drawn at random, as an untrained router spreads
# them. Moonlight-16B-A3B (d 2,048, 64 experts of 1,408) at moe_lockstep's
# decode (8 tokens) and prefill (8 x 64), Mixtral-8x7B (d 4,096, 8 of
# 14,336) at a prefill of 2,048 tokens; "up" is (T*k, d) x (E, d, f) (we1
# and we3), "down" (T*k, f) x (E, f, d) (we2)
MOE_GMM_CASES = [
    ("moonlight_decode_up", 64, 8, 6, 2048, 1408),
    ("moonlight_decode_down", 64, 8, 6, 1408, 2048),
    ("moonlight_prefill_up", 64, 512, 6, 2048, 1408),
    ("moonlight_prefill_down", 64, 512, 6, 1408, 2048),
    ("mixtral_prefill_up", 8, 2048, 2, 4096, 14336),
    ("mixtral_prefill_down", 8, 2048, 2, 14336, 4096),
]
MOE_GMM_MAIN = "moonlight_prefill_up"
# Moonlight-16B-A3B in lock step: the dense phase's batch, 64-token prompts
MOE_LOCKSTEP = dict(batch=8, prompt=64, new=16)
MOE_CUT_LAYERS = 2
# moe_serve's depth: Moonlight's full width, 16 of its 48 layers, so that
# the pushed second copy fits beside the first (~20 GB each)
MOE_SERVE_LAYERS = 16
# Zamba2-7B in lock step; the cut keeps one group of 6 and a tail of 1
HYBRID_LOCKSTEP = dict(batch=4, prompt=256, new=16)
HYBRID_CUT_LAYERS = 7
# the 7-layer cut's logits, bf16 kernels vs the plain attention and scan:
# the flash kernel rounds P to bf16 and the scan's bf16 route its operands,
# by design, and 7 layers carry that on (0.28 at the prefill and 0.36 over
# 16 decodes on an H100, logits of std 1.0, where the same cut in f32
# agrees to 1.1e-4 through both kernels' f32 routes)
HYBRID_BF16_ATOL = 0.5


def routed_sizes(gen, experts: int, tokens: int, top_k: int) -> list:
    """Rows an expert for ``tokens`` tokens that each pick ``top_k``
    distinct experts at random, as a host list (sums to tokens x top_k)."""
    picks = torch.rand((tokens, experts), generator=gen,
                       device="cuda").argsort(-1)[:, :top_k]
    return torch.bincount(picks.reshape(-1), minlength=experts).tolist()


# the bf16 gmm_ragged kernels by route: gmm.cu's TMA and wgmma kernel, and
# the earlier mma.sync one (neither name is a part of the other)
BF16_GMM_KERNELS = (("tma_wgmma", "gmm_ragged_bf16_wgmma_tc"),
                    ("mma_sync", "gmm_ragged_bf16_tc"))


def bf16_gmm_by_route(kernels) -> dict:
    """The bf16 ``gmm_ragged`` kernels among profiler events, by route: how
    many ran and their device ms."""
    out = {route: {"kernels": 0, "ms": 0.0} for route, _ in BF16_GMM_KERNELS}
    for e in kernels:
        for route, fn in BF16_GMM_KERNELS:
            if fn in e.name:
                out[route]["kernels"] += 1
                out[route]["ms"] += e.time_range.elapsed_us() / 1e3
    return out


def launched_route(gmm_cuda, fn) -> str:
    """The route of the one bf16 ``gmm_ragged`` launch that ``fn()``
    makes, from ``cuda.py``'s counts by route."""
    before = (gmm_cuda.bf16_wgmma_launches, gmm_cuda.bf16_mma_sync_launches)
    fn()
    ran = (gmm_cuda.bf16_wgmma_launches - before[0],
           gmm_cuda.bf16_mma_sync_launches - before[1])
    routes = {(1, 0): gmm_cuda.ROUTE_WGMMA, (0, 1): gmm_cuda.ROUTE_MMA_SYNC}
    if ran not in routes:
        raise RuntimeError(f"gmm_ragged bf16: one call made (wgmma, "
                           f"mma.sync) launches {ran}")
    return routes[ran]


def check_moe_gmm(gmm_cuda, gmm_ref) -> dict:
    """``gmm_ragged``'s bf16 route at the MoE's shapes and at the edge
    shapes, each against ``ref.grouped_matmul_looped`` within
    ``GMM_BF16_TOL`` of the output's scale, on the route
    ``plan_ragged_bf16`` names (the MoE's rows must take the TMA and
    ``wgmma`` one; the route a row reports is the kernel that
    ``gmm_ragged`` launched, by ``cuda.py``'s counts by route), with device times of the kernel, of the
    ``mma.sync`` route forced through ``cuda._gmm_ragged_bf16`` at the same
    shape, of every tile of the TMA route at the MoE's shapes (each held
    to the same tolerance), of the plain loop and of ``torch._grouped_mm``
    in bf16, and the least time (bf16 tensor-core work or the bytes: the
    rows, the weights of the experts used, the output)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [(name, G, None, T, k, K, N)
             for name, G, T, k, K, N in MOE_GMM_CASES]
    cases += [("edge_" + name, G, sizes, None, None, K, N)
              for name, G, M, K, N, sizes in GMM_RAGGED_CASES
              if name.startswith("edge")]
    rows = {}
    for name, G, sizes, T, k, K, N in cases:
        if sizes is None:
            sizes = routed_sizes(gen, G, T, k)
        sizes = list(sizes)
        M = sum(sizes)
        lhs = (torch.randn((M, K), generator=gen, device="cuda")
               * 0.5).bfloat16()
        rhs = (torch.randn((G, K, N), generator=gen, device="cuda")
               * K ** -0.5).bfloat16()
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        offsets = gmm_ref.group_offsets(gs)
        ends = offsets[1:].contiguous()

        plan = gmm_cuda.plan_ragged_bf16(M, N, K, G)
        if not name.startswith("edge") and plan.route != \
                gmm_cuda.ROUTE_WGMMA:
            raise RuntimeError(f"gmm_ragged bf16 {name}: planned route "
                               f"{plan.route}, not {gmm_cuda.ROUTE_WGMMA}")

        def kernel():
            return gmm_cuda.gmm_ragged(lhs, rhs, offsets)

        def on_plan(p):
            return lambda: gmm_cuda._gmm_ragged_bf16(lhs, rhs, offsets, p)

        def plain():
            return gmm_ref.grouped_matmul_looped(lhs, rhs, sizes)
        want = plain()
        mma_plan = gmm_cuda._bf16_mma_sync_plan(M, N, K)
        tiles = {} if name.startswith("edge") else {
            f"{bm}x{bn}x{st}": gmm_cuda._bf16_tma_plan(M, N, G, bm, bn, st)
            for bm, bn, st in gmm_cuda.BF16_TILES}
        errs = {}
        for what, fn in [("planned", kernel),
                         ("mma_sync", on_plan(mma_plan))] + [
                             (t, on_plan(p)) for t, p in tiles.items()]:
            got = fn()
            torch.cuda.synchronize()
            errs[what], tol = _scaled_err(got, want, GMM_BF16_TOL)
            if got.dtype != torch.bfloat16 or not errs[what] <= tol:
                raise RuntimeError(f"gmm_ragged bf16 {name} ({what}): "
                                   f"{got.dtype}, max abs err "
                                   f"{errs[what]} > {tol}")
        route = launched_route(gmm_cuda, kernel)
        if route != plan.route:
            raise RuntimeError(f"gmm_ragged bf16 {name}: launched the "
                               f"{route} kernel, planned {plan.route}")
        err = errs["planned"]
        used = sum(1 for n in sizes if n > 0)
        flops = 2.0 * M * K * N
        nbytes = 2.0 * (M * K + used * K * N + M * N)
        t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        ms = device_ms(kernel)
        ms_mma_sync = device_ms(on_plan(mma_plan))
        library_ms, library_timing, library_error = grouped_mm_ms(
            lambda: torch._grouped_mm(lhs, rhs, offs=ends), want,
            GMM_BF16_LIBRARY_TOL)
        rows[name] = {
            "shape": [G, M, K, N], "experts_used": used,
            "route": route, "plan": dataclasses.asdict(plan),
            "max_abs_err": err, "tol": tol, "ms": ms,
            "tflops": flops / ms / 1e9,
            "ms_mma_sync": ms_mma_sync,
            "max_abs_err_mma_sync": errs["mma_sync"],
            "plan_mma_sync": dataclasses.asdict(mma_plan),
            "mma_sync_over_planned": ms_mma_sync / ms,
            "tile_ms": {t: device_ms(on_plan(p)) for t, p in tiles.items()},
            "tile_max_abs_err": {t: errs[t] for t in tiles},
            "plain_ms": device_ms(plain),
            "library_ms": library_ms, "library_timing": library_timing,
            "library_error": library_error,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit({"phase": "moe_check", "kernel": "gmm_ragged_bf16",
              "case": name, "group_sizes_head": sizes[:8], **rows[name]})
        del lhs, rhs, got, want
    torch.cuda.empty_cache()
    return rows


class ExpertChoices:
    """Records the expert choices of every ``moe._route`` call made inside
    the ``with`` block (a measurement hook; the model is not changed):
    ``raw`` as the router returns them, ``idx`` sorted. ``replay`` maps a
    call's index to the (T, k) choices it takes instead of its own: it
    keeps its router's probabilities, and its combine weights are those
    probabilities at the given experts, renormalised, as ``_route``
    computes them at its own."""

    def __init__(self, M, replay=None):
        self.M, self.route, self.idx, self.raw = M, M._route, [], []
        self.replay = replay or {}

    def __enter__(self):
        def route(cfg, router, h):
            probs, w, idx = self.route(cfg, router, h)
            forced = self.replay.get(len(self.raw))
            if forced is not None:
                idx = forced
                w = probs.gather(-1, idx)
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            self.raw.append(idx)
            self.idx.append(torch.sort(idx, -1).values)
            return probs, w, idx
        self.M._route = route
        return self

    def __exit__(self, *exc):
        self.M._route = self.route


def kernel_plain_calls(layers: int, n_new: int) -> list:
    """(kernel call, plain call) index pairs of the ``moe._route`` calls
    that ``lockstep_vs_plain`` makes, one a layer a forward: the kernel
    run's prefill, the plain run's, the kernel run's decodes, the plain
    run's."""
    prefill = [(i, layers + i) for i in range(layers)]
    decode = [(2 * layers + j, 2 * layers + n_new * layers + j)
              for j in range(n_new * layers)]
    return prefill + decode


def moe_cut_comparisons(cfg, init_params, api, InputShape, tokens, n_new,
                        M) -> dict:
    """The moe path's kernel-vs-plain comparisons at a 2-layer cut of the
    full width, prefill and decodes: (1) bf16, the experts through the
    kernel against the looped plain product, the attention through the
    kernel in both, so that both runs route alike; (2) f32, every kernel
    (flash attention and ``gmm_ragged`` on their f32 routes) against every
    plain version; both held to ``LOGITS_ATOL``. (3) bf16, every kernel
    against every plain version, reported only: there the attention's
    bf16 rounding of P moves the router's logits, some tokens pick another
    expert at a near-tie, and those rows' logits move by O(1); the tokens
    whose expert set differs are counted, layer by layer at the prefill
    and in all over the decodes. In (1) the expert kernel may round an
    output to the other bf16 neighbour of the plain product's, which can
    tip a near-tie too: if any token is rerouted there, the comparison is
    run again with the kernel run's expert choices replayed into the plain
    run, and that is the error held; the first run's error and its
    rerouted tokens are kept beside it."""
    cut = dataclasses.replace(cfg, num_layers=MOE_CUT_LAYERS,
                              name=f"{cfg.name}-l{MOE_CUT_LAYERS}")
    out = {}
    for name, dtype, plain in (
            ("bf16_experts", "bfloat16", {"gmm_impl": "ref"}),
            ("f32_all", "float32", {"attn_impl": "ref", "gmm_impl": "ref"}),
            ("bf16_all", "bfloat16", {"attn_impl": "ref",
                                      "gmm_impl": "ref"})):
        run_cfg = dataclasses.replace(cut, dtype=dtype)
        model = init_params(run_cfg, 3)
        out[name] = moe_cut_comparison(run_cfg, model, api, InputShape,
                                       tokens, n_new, M, plain,
                                       replay=name == "bf16_experts")
        del model
        _free()
    return out


def moe_cut_comparison(cut, model, api, InputShape, tokens, n_new, M,
                       plain, replay: bool) -> dict:
    """One of ``moe_cut_comparisons``' runs on ``model`` (a cut of
    ``cut.num_layers`` layers): the kernels against the plain routes
    ``plain`` names, the tokens rerouted at the prefill layer by layer and
    over the decodes; with ``replay``, a rerouted run is run again with
    the kernel run's expert choices replayed into the plain run, and that
    error is the one returned (the first run's kept beside it)."""
    layers = cut.num_layers
    with ExpertChoices(M) as choices:
        pre, dec, _ = lockstep_vs_plain(cut, model, api, InputShape, tokens,
                                        n_new, plain=plain)
    pairs = kernel_plain_calls(layers, n_new)
    if len(choices.idx) != 2 * len(pairs):
        raise RuntimeError(f"moe comparison: {len(choices.idx)} routes, "
                           f"not {2 * len(pairs)}")
    moved = [int((choices.idx[k] != choices.idx[p]).any(-1).sum())
             for k, p in pairs]
    out = {"prefill_max_abs_err": pre, "decode_max_abs_err": dec,
           "prefill_tokens_rerouted": moved[:layers],
           "decode_tokens_rerouted": sum(moved[layers:]),
           "replayed": False}
    if replay and any(moved):
        forced = {p: choices.raw[k] for k, p in pairs}
        with ExpertChoices(M, forced) as again:
            pre_r, dec_r, _ = lockstep_vs_plain(cut, model, api, InputShape,
                                                tokens, n_new, plain=plain)
        if [again.raw[k].tolist() for k, _ in pairs] != \
                [choices.raw[k].tolist() for k, _ in pairs]:
            raise RuntimeError("moe comparison: the kernel run routed "
                               "otherwise when run again")
        out.update(prefill_max_abs_err=pre_r, decode_max_abs_err=dec_r,
                   replayed=True, unreplayed={"prefill_max_abs_err": pre,
                                              "decode_max_abs_err": dec})
    return out


def moe_lockstep(CONFIG, init_params, api, InputShape, fa_ops,
                 gmm_ops, M) -> dict:
    """Lock-step serving of the full 48-layer Moonlight-16B-A3B in bf16
    (~56 GB of weights): batch 8, 64-token prompts, 16 greedy decodes, fp
    and int8 caches; each forward runs 48 flash prefills (none in decode)
    and 3 x 48 bf16 ``gmm_ragged`` launches, every one on the TMA and
    ``wgmma`` route (``cuda.py``'s count of that route's launches). Then,
    after the counts are read and the model freed,
    ``moe_cut_comparisons``."""
    from repro_torch.kernels.gmm import cuda as gmm_cuda
    cfg = CONFIG
    B, S, n_new = (MOE_LOCKSTEP[k] for k in ("batch", "prompt", "new"))
    counters = {"flash": (fa_ops, "launches"),
                "gmm_ragged_bf16": (gmm_ops, "ragged_bf16_launches"),
                "gmm_ragged_bf16_wgmma": (gmm_cuda, "bf16_wgmma_launches")}
    model, out, readings = lockstep_serving(
        cfg, init_params, api, InputShape, counters, B, S, n_new, True)
    per_forward = 3 * cfg.num_layers
    gmm = {"gmm_ragged_bf16": per_forward,
           "gmm_ragged_bf16_wgmma": per_forward}
    lockstep_checks("moe_lockstep", cfg, out, readings,
                    {"flash": cfg.num_layers, **gmm}, {"flash": 0, **gmm})
    readings["moe_tick_profile"] = profile_moe_tick(cfg, model, api,
                                                    InputShape, out)
    tokens = out["tokens"]
    del model, out
    _free()
    errs = moe_cut_comparisons(cfg, init_params, api, InputShape, tokens,
                               n_new, M)
    held = [e for name in ("bf16_experts", "f32_all")
            for e in (errs[name]["prefill_max_abs_err"],
                      errs[name]["decode_max_abs_err"])]
    if not max(held) <= LOGITS_ATOL:
        raise RuntimeError(f"moe_lockstep: {MOE_CUT_LAYERS} layers, logits "
                           f"kernel vs plain {errs} > {LOGITS_ATOL}")
    return {**readings, "gmm_launches_per_forward": per_forward,
            f"l{MOE_CUT_LAYERS}_kernel_vs_plain": errs,
            "atol": LOGITS_ATOL}


def profile_moe_tick(cfg, model, api, InputShape, out,
                     ticks: int = 3, tries: int = 3) -> dict:
    """Where a lock-step decode tick of the moe run goes, after its counts
    are read: ``torch.profiler`` over ``ticks`` more greedy decodes from
    the run's cache (grown to hold every try). Device time is the sum of
    kernel times, the bf16 ``gmm_ragged`` kernels' part split out by name
    and by route: it must all be the TMA and ``wgmma`` kernel's, none the
    ``mma.sync`` one's. The busy share is device over host wall time."""
    B = out["tokens"].shape[0]
    cap = out["cache"]["k"].shape[2]
    dec = api.build(cfg, InputShape("d", int(out["cache"]["index"]), B,
                                    "decode"))
    state = {"cache": api.grow_cache(out["cache"], cap + tries * ticks),
             "tok": out["new_tokens"][-1]}

    def run():
        for _ in range(ticks):
            logits, state["cache"] = dec.fn(model, state["cache"],
                                            state["tok"])
            state["tok"] = _greedy(logits, cfg)
            state["tok"].cpu()
    kernels, wall_ms = profiled(run, tries)
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_route = bf16_gmm_by_route(kernels)
    if not by_route["tma_wgmma"]["kernels"] or \
            by_route["mma_sync"]["kernels"]:
        raise RuntimeError(f"moe_tick_profile: bf16 gmm_ragged kernels by "
                           f"route {by_route}, not all tma_wgmma")
    gmm = sum(v["ms"] for v in by_route.values())
    return {"ticks": ticks, "batch": B,
            "wall_ms_per_tick": wall_ms / ticks,
            "device_ms_per_tick": device / ticks,
            "gmm_ragged_bf16_ms_per_tick": gmm / ticks,
            "gmm_ragged_bf16_by_route": by_route,
            "gmm_share_of_device": gmm / device,
            "device_busy_share": device / wall_ms,
            "kernels_per_tick": len(kernels) / ticks}


def moe_serve(CONFIG, init_params, ParameterServer, WorldModelServer,
              fa_ops, gmm_ops) -> dict:
    """The serve tier (``serve``'s run: 4 slots, 8 requests of mixed
    lengths, one push) on Moonlight at full width and ``MOE_SERVE_LAYERS``
    layers, bf16: every request answered, the push picked up, one decode
    shape, and 3 bf16 ``gmm_ragged`` launches a layer in every prefill and
    every decode tick, all on the TMA and ``wgmma`` route."""
    from repro_torch.kernels.gmm import cuda as gmm_cuda
    cfg = dataclasses.replace(CONFIG, num_layers=MOE_SERVE_LAYERS,
                              name=f"{CONFIG.name}-l{MOE_SERVE_LAYERS}")
    torch.cuda.reset_peak_memory_stats()
    gmm_ops.ragged_bf16_launches = 0
    gmm_cuda.bf16_wgmma_launches = 0
    srv, served = serve(cfg, init_params, ParameterServer, WorldModelServer,
                        fa_ops)
    launches = gmm_ops.ragged_bf16_launches
    wgmma = gmm_cuda.bf16_wgmma_launches
    want = 3 * cfg.num_layers * (served["prefills"] + served["decode_ticks"])
    del srv
    _free()
    if launches != want or wgmma != want:
        raise RuntimeError(f"moe_serve: {launches} gmm_ragged bf16 launches,"
                           f" {wgmma} of them tma_wgmma, not {want} (3 a "
                           f"layer a forward)")
    return {**served, "gmm_ragged_bf16_launches": launches,
            "gmm_ragged_bf16_wgmma_launches": wgmma}


def hybrid_lockstep(CONFIG, init_params, api, InputShape, fa_ops,
                    ssd_ops, LM) -> dict:
    """Lock-step serving of the full 81-layer Zamba2-7B in bf16 (~14 GB):
    batch 4, 256-token prompts, 16 greedy decodes; a prefill runs the
    shared block's attention 14 times through the flash kernel (head dim
    112 in the 128 build) and 81 ``ssd_chunked`` scans, a decode neither.
    Then, after the counts are read and the model freed, the kernels'
    prefill and decodes against the plain attention and scan at a 7-layer
    cut (a group of 6 and a tail of 1): in f32 (both kernels' f32 routes)
    within ``LOGITS_ATOL``, in bf16 within ``HYBRID_BF16_ATOL``."""
    cfg = CONFIG
    B, S, n_new = (HYBRID_LOCKSTEP[k] for k in ("batch", "prompt", "new"))
    counters = {"flash": (fa_ops, "launches"),
                "ssd_chunked": (ssd_ops, "launches")}
    model, out, readings = lockstep_serving(
        cfg, init_params, api, InputShape, counters, B, S, n_new, False)
    n_inv = LM.n_shared_invocations(cfg)
    lockstep_checks("hybrid_lockstep", cfg, out, readings,
                    {"flash": n_inv, "ssd_chunked": cfg.num_layers},
                    {"flash": 0, "ssd_chunked": 0})
    tokens = out["tokens"]
    del model, out
    _free()
    errs = {}
    for dtype, atol in (("float32", LOGITS_ATOL),
                        ("bfloat16", HYBRID_BF16_ATOL)):
        cut = dataclasses.replace(cfg, num_layers=HYBRID_CUT_LAYERS,
                                  dtype=dtype,
                                  name=f"{cfg.name}-l{HYBRID_CUT_LAYERS}")
        cut_model = init_params(cut, 3)
        pre, dec, lg_ref = lockstep_vs_plain(
            cut, cut_model, api, InputShape, tokens, n_new,
            plain={"attn_impl": "ref", "ssd_impl": "ref"})
        del cut_model
        _free()
        errs[dtype] = {"prefill_max_abs_err": pre, "decode_max_abs_err": dec,
                       "atol": atol, "logits_std": lg_ref.std().item()}
        if not max(pre, dec) <= atol:
            raise RuntimeError(f"hybrid_lockstep: {HYBRID_CUT_LAYERS} layers"
                               f" {dtype}, logits kernel vs plain {pre} "
                               f"{dec} > {atol}")
    return {**readings, "shared_invocations": n_inv, "head_dim": cfg.hd,
            f"l{HYBRID_CUT_LAYERS}_kernel_vs_plain": errs}


# the moe and hybrid train steps: Moonlight's 2-layer cut at the lock-step
# batch, Zamba2's 7-layer cut at the hybrid's; 10 steps on 4 seeded
# batches, cycled (the loss must fall), then the trained cut's prefill and
# decodes through the kernels against the plain routes
MOE_TRAIN = dict(batch=8, seq=64, steps=10, batches=4)
HYBRID_TRAIN = dict(batch=4, seq=256, steps=10, batches=4)


class LoopedProducts:
    """Records each call of ``ref.grouped_matmul_looped`` made inside the
    ``with`` block (a measurement hook; the products are unchanged): its
    operands, detached, and its group sizes. ``replay()`` runs every
    recorded product again with its backward (``dx`` and ``dW``, as the
    train step asks for both), the slice writes' autograd included."""

    def __init__(self, gmm_ref):
        self.ref, self.looped, self.calls = gmm_ref, \
            gmm_ref.grouped_matmul_looped, []

    def __enter__(self):
        def looped(lhs, rhs, group_sizes):
            self.calls.append((lhs.detach(), rhs.detach(),
                               group_sizes.clone()))
            return self.looped(lhs, rhs, group_sizes)
        self.ref.grouped_matmul_looped = looped
        return self

    def __exit__(self, *exc):
        self.ref.grouped_matmul_looped = self.looped

    def replay(self):
        for lhs, rhs, sizes in self.calls:
            a = lhs.requires_grad_(True)
            w = rhs.requires_grad_(True)
            out = self.looped(a, w, sizes)
            torch.autograd.grad(out, (a, w), torch.ones_like(out))
            a.requires_grad_(False)
            w.requires_grad_(False)


def _device_ms(kernels) -> float:
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def _top_kernels(kernels, n: int = 8) -> list:
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:80], ms] for name, ms in top]


def train_cut(cfg, api, InputShape, LM, adam, init_params, spec, counters,
              seed: int) -> tuple:
    """``api.build(cfg, InputShape(..., "train"))`` at full width on
    ``spec``'s batch: ``spec["steps"]`` steps over ``spec["batches"]``
    seeded batches (labels equal to tokens), cycled, the counts in
    ``counters`` at 0 just before and read just after. Returns the bundle,
    the model, its optimizer state, the batches and the readings."""
    B, S, steps = (spec[k] for k in ("batch", "seq", "steps"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(spec["batches"]):
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        batches.append({"tokens": tokens, "labels": tokens})
    bundle = api.build(cfg, InputShape("t", S, B, "train"))
    model = init_params(cfg, 0)
    n_params = sum(p.numel() for p in model.parameters())
    opt_state = adam(cfg.lr).init(LM.trainable(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    losses, gnorms, step_ms = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        model, opt_state, m = bundle.fn(model, opt_state,
                                        batches[i % len(batches)])
        losses.append(float(m["loss"]))
        step_ms.append(_ms_since(t0))
        gnorms.append(float(m["gnorm"]))
    launches = _counts(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = sorted(step_ms[1:])
    readings = {
        "config": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
        "params_b": n_params / 1e9, "batch": B, "seq": S, "steps": steps,
        "lr": cfg.lr, "microbatches": bundle.num_microbatches,
        "batches_cycled": spec["batches"], "losses": losses,
        "gnorms": gnorms, "step_ms_first": step_ms[0],
        "step_ms_p50": warm[len(warm) // 2],
        "tokens_per_s": B * S / (warm[len(warm) // 2] / 1e3),
        "peak_mem_gb": peak, "launches": launches}
    return bundle, model, opt_state, batches, readings


def train_checks(name, readings, shape_count: int):
    """The train phases' shared checks: the loss falls, losses and
    gradient norms are finite, no kernel launched in the steps (the plain
    routes by design), one input shape."""
    losses, launches = readings["losses"], readings["launches"]
    checks = {
        "loss fell": losses[-1] < losses[0],
        "finite": bool(np.isfinite(losses + readings["gnorms"]).all()),
        "no kernel launch in the steps (plain routes by design)":
            not any(launches.values()),
        "one train input shape": shape_count == 1,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"{name} failed: {failed}; losses {losses}, "
                           f"launches {launches}")


def profile_train_step(bundle, model, opt_state, batch, LM, adam,
                       parts=None) -> tuple:
    """Where one more train step's time goes: ``torch.profiler`` over it
    (device time, busy share, the top kernels by name; a profile that
    comes back empty steps again); then the
    optimizer's part, the Adam update and the add replayed on the step's
    leaves with f32 gradients (the state is not advanced, the leaves not
    written), and each of ``parts``' (name -> a replay) under the profiler
    too. Shares are of the step's device time and of its wall time.
    Returns the model, its state and the readings."""
    state = {"model": model, "opt": opt_state}

    def step():
        state["model"], state["opt"], _ = bundle.fn(state["model"],
                                                     state["opt"], batch)
    kernels, wall_ms = profiled(step)
    device = _device_ms(kernels)
    leaves = LM.trainable(state["model"])
    grads = {n: torch.full_like(t, 1e-3, dtype=torch.float32)
             for n, t in leaves.items()}
    opt = adam(bundle.cfg.lr)

    def optimizer():
        with torch.no_grad():
            updates, _ = opt.update(grads, state["opt"], leaves)
            for n, t in leaves.items():
                (t + updates[n]).to(t.dtype)
    out = {"step_wall_ms": wall_ms, "step_device_ms": device,
           "device_busy_share": device / wall_ms,
           "kernels_per_step": len(kernels),
           "top_kernels_ms": _top_kernels(kernels)}
    for name, run in [("optimizer", optimizer)] + list((parts or {}).items()):
        k, w = profiled(run)
        out[name] = {"device_ms": _device_ms(k), "wall_ms": w,
                     "kernels": len(k),
                     "share_of_step_device": _device_ms(k) / device,
                     "share_of_step_wall": w / wall_ms}
    del grads
    return state["model"], state["opt"], out


def moe_train(CONFIG, init_params, api, InputShape, LM, adam, fa_ops,
              gmm_ops, gmm_ref, M) -> dict:
    """``api.build(..., "train")`` on Moonlight-16B-A3B's
    ``MOE_CUT_LAYERS``-layer cut at full width in bf16: ``MOE_TRAIN``'s 10
    steps over 4 seeded batches, cycled. The step trains through the plain
    attention and the experts' looped plain product by design (the
    kernels are forward-only, as the reference's have no backward): the
    loss falls, nothing is launched of flash attention or of the ragged
    product's kernels (f32, and bf16 on either route). Then
    ``profile_train_step`` over one more step, with the looped expert
    products of one recorded step (forward and backward) replayed as a
    part. Then, on the weights so trained (12 steps or more), the cut's
    prefill and decodes at ``MOE_LOCKSTEP``, the experts through the TMA
    and ``wgmma`` kernel against the looped plain product and the
    attention through the kernel in both (``moe_cut_comparison``'s run
    (1), near-ties replayed), within ``LOGITS_ATOL``, with the kernels'
    launches counted."""
    from repro_torch.kernels.gmm import cuda as gmm_cuda
    cfg = dataclasses.replace(CONFIG, num_layers=MOE_CUT_LAYERS,
                              name=f"{CONFIG.name}-l{MOE_CUT_LAYERS}")
    counters = {"flash": (fa_ops, "launches"),
                "gmm_ragged": (gmm_ops, "ragged_launches"),
                "gmm_ragged_bf16": (gmm_ops, "ragged_bf16_launches"),
                "gmm_ragged_bf16_wgmma": (gmm_cuda, "bf16_wgmma_launches"),
                "gmm_ragged_bf16_mma_sync": (gmm_cuda,
                                             "bf16_mma_sync_launches")}
    bundle, model, opt_state, batches, readings = train_cut(
        cfg, api, InputShape, LM, adam, init_params, MOE_TRAIN, counters, 5)
    train_checks("moe_train", readings, bundle.fn.shape_count)
    with LoopedProducts(gmm_ref) as products:   # one more step, recorded
        model, opt_state, _ = bundle.fn(model, opt_state, batches[0])
    if len(products.calls) != 3 * cfg.num_layers:
        raise RuntimeError(f"moe_train: {len(products.calls)} looped "
                           f"products a step, not {3 * cfg.num_layers}")
    model, opt_state, profile = profile_train_step(
        bundle, model, opt_state, batches[1], LM, adam,
        {"expert_products": products.replay})
    del opt_state, bundle, products
    _free()
    B, S, n_new = (MOE_LOCKSTEP[k] for k in ("batch", "prompt", "new"))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    counts = {k: v for k, v in counters.items() if k != "gmm_ragged"}
    for mod, attr in counts.values():
        setattr(mod, attr, 0)
    err = moe_cut_comparison(cfg, model, api, InputShape, tokens, n_new, M,
                             {"gmm_impl": "ref"}, replay=True)
    launches = _counts(counts)
    del model
    _free()
    runs = 2 if err["replayed"] else 1
    gmm = runs * 3 * cfg.num_layers * (1 + n_new)
    want = {"flash": runs * 2 * cfg.num_layers, "gmm_ragged_bf16": gmm,
            "gmm_ragged_bf16_wgmma": gmm, "gmm_ragged_bf16_mma_sync": 0}
    if launches != want:
        raise RuntimeError(f"moe_train: trained cut's comparison launched "
                           f"{launches}, not {want}")
    held = max(err["prefill_max_abs_err"], err["decode_max_abs_err"])
    if not held <= LOGITS_ATOL:
        raise RuntimeError(f"moe_train: trained {MOE_CUT_LAYERS} layers, "
                           f"logits kernel vs plain {err} > {LOGITS_ATOL}")
    return {**readings, "looped_products_per_step": 3 * cfg.num_layers,
            "profile": profile,
            "trained_kernel_vs_plain": {**err, "atol": LOGITS_ATOL,
                                        "batch": B, "prompt": S,
                                        "new_tokens": n_new},
            "trained_comparison_launches": launches}


def hybrid_train(CONFIG, init_params, api, InputShape, LM, adam, fa_ops,
                 ssd_ops) -> dict:
    """``api.build(..., "train")`` on Zamba2-7B's ``HYBRID_CUT_LAYERS``-layer
    cut at full width in bf16: ``HYBRID_TRAIN``'s 10 steps over 4 seeded
    batches, cycled, through the plain attention and scan by design: the
    loss falls, neither flash attention nor ``ssd_chunked`` is launched.
    Then ``profile_train_step`` over one more step. Then, on the trained
    weights, the cut's prefill and decodes at ``HYBRID_LOCKSTEP`` through
    both kernels against the plain attention and scan
    (``lockstep_vs_plain``) within ``HYBRID_BF16_ATOL``, the kernels'
    launches counted."""
    cfg = dataclasses.replace(CONFIG, num_layers=HYBRID_CUT_LAYERS,
                              name=f"{CONFIG.name}-l{HYBRID_CUT_LAYERS}")
    counters = {"flash": (fa_ops, "launches"),
                "ssd_chunked": (ssd_ops, "launches")}
    bundle, model, opt_state, batches, readings = train_cut(
        cfg, api, InputShape, LM, adam, init_params, HYBRID_TRAIN, counters,
        6)
    train_checks("hybrid_train", readings, bundle.fn.shape_count)
    model, opt_state, profile = profile_train_step(
        bundle, model, opt_state, batches[1], LM, adam)
    del opt_state, bundle
    _free()
    B, S, n_new = (HYBRID_LOCKSTEP[k] for k in ("batch", "prompt", "new"))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    pre, dec, lg_ref = lockstep_vs_plain(
        cfg, model, api, InputShape, tokens, n_new,
        plain={"attn_impl": "ref", "ssd_impl": "ref"})
    launches = _counts(counters)
    del model
    _free()
    want = {"flash": LM.n_shared_invocations(cfg),
            "ssd_chunked": cfg.num_layers}
    if launches != want:
        raise RuntimeError(f"hybrid_train: trained cut's comparison "
                           f"launched {launches}, not {want}")
    if not max(pre, dec) <= HYBRID_BF16_ATOL:
        raise RuntimeError(f"hybrid_train: trained {HYBRID_CUT_LAYERS} "
                           f"layers, logits kernel vs plain {pre} {dec} > "
                           f"{HYBRID_BF16_ATOL}")
    return {**readings, "shared_invocations": LM.n_shared_invocations(cfg),
            "profile": profile,
            "trained_kernel_vs_plain": {
                "prefill_max_abs_err": pre, "decode_max_abs_err": dec,
                "atol": HYBRID_BF16_ATOL, "logits_std": lg_ref.std().item(),
                "batch": B, "prompt": S, "new_tokens": n_new},
            "trained_comparison_launches": launches}


# ---------------------------------------------------------------- phase 15

# Seamless-M4T-medium: batch 8, 256 frames of the stubbed audio frontend,
# 64-token prompts, 16 decodes; its 2 + 2-layer cut for the comparisons and
# the train step (10 steps on 4 cycled batches; the loss must fall)
ENCDEC_LOCKSTEP = dict(batch=8, frames=256, prompt=64, new=16)
ENCDEC_CUT_LAYERS = 2
ENCDEC_TRAIN = dict(batch=8, seq=64, steps=10, batches=4)
# Phi-3-vision-4.2B: batch 8, 512-token prompts whose first 512 // 8 = 64
# positions are patch embeddings (the reference's n_patch), 16 decodes
VLM_LOCKSTEP = dict(batch=8, prompt=512, new=16)
VLM_CUT_LAYERS = 2


def _embeds(B, rows, d, seed):
    """Seeded bf16 frame or patch embeddings ``(B, rows, d)`` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, rows, d), generator=gen, device="cuda").to(
        torch.bfloat16)


def encdec_lockstep(CONFIG, api, InputShape, fa_ops, E) -> dict:
    """Lock-step serving of the whole Seamless-M4T-medium (12 encoder + 12
    decoder layers) in bf16 through ``api.build``
    (``lockstep_serving``): batch 8, 256 seeded frame embeddings, 64-token
    prompts, the self cache grown for 16 greedy decodes. A prefill
    launches the flash kernel 36 times (12 encoder self-attentions without
    the mask, 12 causal decoder self-attentions, 12 cross-attentions of 64
    queries over 256 keys without the mask), a decode none (its attention
    is plain, as in the reference). Then, after the counts are read, the
    kernel's prefill and decodes against the plain attention's at a 2 +
    2-layer cut of the full width within ``LOGITS_ATOL``."""
    cfg = CONFIG
    B, F, S, n_new = (ENCDEC_LOCKSTEP[k]
                      for k in ("batch", "frames", "prompt", "new"))
    frames = {"enc_embeds": _embeds(B, F, cfg.d_model, 11)}
    model, out, readings = lockstep_serving(
        cfg, E.init_params, api, InputShape, {"flash": (fa_ops, "launches")},
        B, S, n_new, False, extra=frames)
    per_prefill = E._enc_layers(cfg) + 2 * cfg.num_layers
    lockstep_checks("encdec_lockstep", cfg, out, readings,
                    {"flash": per_prefill}, {"flash": 0})
    cross = out["cache"]["cross_k"]
    if tuple(cross.shape[1:3]) != (B, F):
        raise RuntimeError(f"encdec_lockstep: cross cache {tuple(cross.shape)}"
                           f" is not over the {F} frames")
    tokens = out["tokens"]
    del model, out
    _free()
    cut = dataclasses.replace(cfg, num_layers=ENCDEC_CUT_LAYERS,
                              encoder_layers=ENCDEC_CUT_LAYERS,
                              name=f"{cfg.name}-l{ENCDEC_CUT_LAYERS}")
    cut_model = E.init_params(cut, 3)
    pre, dec, lg_ref = lockstep_vs_plain(cut, cut_model, api, InputShape,
                                         tokens, n_new, extra=frames)
    del cut_model
    _free()
    if not max(pre, dec) <= LOGITS_ATOL:
        raise RuntimeError(f"encdec_lockstep: {ENCDEC_CUT_LAYERS} + "
                           f"{ENCDEC_CUT_LAYERS} layers, logits kernel vs "
                           f"plain {pre} {dec} > {LOGITS_ATOL}")
    return {**readings, "encoder_layers": E._enc_layers(cfg),
            "frames": F, "head_dim": cfg.hd,
            f"l{ENCDEC_CUT_LAYERS}_prefill_max_abs_err": pre,
            f"l{ENCDEC_CUT_LAYERS}_decode_max_abs_err": dec,
            "atol": LOGITS_ATOL, "logits_std": lg_ref.std().item()}


def encdec_train(CONFIG, api, InputShape, LM, E, adam, fa_ops) -> dict:
    """``api.build(..., "train")`` on Seamless-M4T-medium's 2 + 2-layer cut
    at full width in bf16: 10 steps over 4 seeded batches (random frames,
    tokens, labels equal to tokens), cycled; the loss must fall. The step
    trains through the plain attention by design (the kernel is
    forward-only, as the reference's has no backward), so the kernel is
    launched no time."""
    cfg = dataclasses.replace(CONFIG, num_layers=ENCDEC_CUT_LAYERS,
                              encoder_layers=ENCDEC_CUT_LAYERS,
                              name=f"{CONFIG.name}-l{ENCDEC_CUT_LAYERS}")
    B, S, steps = (ENCDEC_TRAIN[k] for k in ("batch", "seq", "steps"))
    gen = torch.Generator(device="cuda").manual_seed(5)
    batches = []
    for i in range(ENCDEC_TRAIN["batches"]):
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda", dtype=torch.int32)
        batches.append({"tokens": tokens, "labels": tokens,
                        "enc_embeds": _embeds(B, S, cfg.d_model, 20 + i)})
    bundle = api.build(cfg, InputShape("t", S, B, "train"))
    model = E.init_params(cfg, 0)
    opt_state = adam(cfg.lr).init(LM.trainable(model))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = 0
    losses, step_ms = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        model, opt_state, m = bundle.fn(model, opt_state,
                                        batches[i % len(batches)])
        losses.append(float(m["loss"]))
        step_ms.append(_ms_since(t0))
    launches = fa_ops.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    gnorm = float(m["gnorm"])
    del model, opt_state, bundle
    _free()
    checks = {
        "loss fell": losses[-1] < losses[0],
        "finite": bool(np.isfinite(losses + [gnorm]).all()),
        "no flash launch (plain attention by design)": launches == 0,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"encdec_train failed: {failed}; losses "
                           f"{losses}, launches {launches}")
    warm = sorted(step_ms[1:])
    return {"config": cfg.name, "dtype": cfg.dtype, "batch": B, "seq": S,
            "steps": steps, "lr": cfg.lr,
            "batches_cycled": ENCDEC_TRAIN["batches"], "losses": losses,
            "gnorm_last": gnorm, "step_ms_first": step_ms[0],
            "step_ms_p50": warm[len(warm) // 2], "peak_mem_gb": peak,
            "attention_launches": launches}


def vlm_lockstep(CONFIG, init_params, api, InputShape, fa_ops) -> dict:
    """Lock-step serving of the whole 32-layer Phi-3-vision-4.2B in bf16
    (``lockstep_serving``): batch 8, 512-token prompts whose first 64
    positions are seeded patch embeddings, 16 greedy decodes, with the fp
    cache and then the int8 cache fed the same tokens: 32 flash launches a
    prefill (head dim 96 in the D = 128 build), none in decode. Then,
    after the counts are read, at a 2-layer cut of the full width: the
    kernel's prefill and decodes against the plain attention's within
    ``LOGITS_ATOL``, and the first-token logits of the batch with patches
    against the same tokens without them, which must differ (the frontend
    is on the path)."""
    cfg = CONFIG
    B, S, n_new = (VLM_LOCKSTEP[k] for k in ("batch", "prompt", "new"))
    patches = {"patch_embeds": _embeds(B, S // 8, cfg.d_model, 12)}
    model, out, readings = lockstep_serving(
        cfg, init_params, api, InputShape, {"flash": (fa_ops, "launches")},
        B, S, n_new, True, extra=patches)
    lockstep_checks("vlm_lockstep", cfg, out, readings,
                    {"flash": cfg.num_layers}, {"flash": 0})
    tokens = out["tokens"]
    del model, out
    _free()
    cut = dataclasses.replace(cfg, num_layers=VLM_CUT_LAYERS,
                              name=f"{cfg.name}-l{VLM_CUT_LAYERS}")
    cut_model = init_params(cut, 3)
    pre, dec, lg_ref = lockstep_vs_plain(cut, cut_model, api, InputShape,
                                         tokens, n_new, extra=patches)
    prefill = api.build(cut, InputShape("p", S, B, "prefill")).fn
    with_p, _ = prefill(cut_model, {"tokens": tokens, **patches})
    without, _ = prefill(cut_model, {"tokens": tokens})
    patch_gap = (with_p - without).abs().max().item()
    del cut_model
    _free()
    checks = {
        f"{VLM_CUT_LAYERS} layers: prefill and decode logits kernel vs "
        "plain within LOGITS_ATOL": max(pre, dec) <= LOGITS_ATOL,
        "patch_embeds move the first-token logits": patch_gap > LOGITS_ATOL,
    }
    failed = [c for c, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"vlm_lockstep failed: {failed}; errors {pre} "
                           f"{dec}, patch gap {patch_gap}")
    return {**readings, "n_patch": S // 8, "head_dim": cfg.hd,
            f"l{VLM_CUT_LAYERS}_prefill_max_abs_err": pre,
            f"l{VLM_CUT_LAYERS}_decode_max_abs_err": dec,
            "atol": LOGITS_ATOL, "logits_std": lg_ref.std().item(),
            "patch_logit_gap": patch_gap}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.configs.mamba2_2_7b import CONFIG as MAMBA
    from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as MOONLIGHT
    from repro_torch.configs.phi3_vision_4_2b import CONFIG as PHI3V
    from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS
    from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2
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
    from repro_torch.models import encdec as E
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    from repro_torch.data.synthetic import DynamicsTokenStream
    from repro_torch.models.config import InputShape, ModelConfig
    from repro_torch.models.lm import init_params
    from repro_torch.optim.optimizers import adam
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
    hopper = {op: build.count_sass(built[gmm_cuda.SOURCE]["library"], op)
              for op in ("HGMMA", "UTMALDG")}
    if not all(hopper.values()):
        raise RuntimeError(f"gmm.cu: no wgmma (HGMMA) or TMA load "
                           f"(UTMALDG) in its library: {hopper}")
    emit({"phase": "build", "seconds": seconds,
          "sources": [str(s.relative_to(ROOT)) for s in sources],
          "hmma_instructions": hmma,
          "gmm_hopper_instructions": hopper,
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
    meshed = role_mesh(CONFIG, init_params, learner, model_server, gmm_ops,
                       imag_ops)
    emit({"phase": "role_mesh", **meshed})
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

    lockstep = dense_lockstep(CONFIG, init_params, api, InputShape, fa_ops)
    emit({"phase": "dense_lockstep", **lockstep})
    trained = lm_train(ModelConfig, init_params, api, InputShape, LM, adam,
                       DynamicsTokenStream, fa_ops)
    emit({"phase": "lm_train", **trained})
    wm = wm_mbrl(LM, fa_ops)
    emit({"phase": "wm_mbrl", **wm})
    gc.collect()
    torch.cuda.empty_cache()

    moe_rows = check_moe_gmm(gmm_cuda, gmm_ref)
    moe = moe_lockstep(MOONLIGHT, init_params, api, InputShape, fa_ops,
                       gmm_ops, MOE)
    emit({"phase": "moe_lockstep", **moe})
    moe_served = moe_serve(MOONLIGHT, init_params, ParameterServer,
                           WorldModelServer, fa_ops, gmm_ops)
    emit({"phase": "moe_serve", **moe_served})
    hybrid = hybrid_lockstep(ZAMBA2, init_params, api, InputShape, fa_ops,
                             ssd_ops, LM)
    emit({"phase": "hybrid_lockstep", **hybrid})
    moe_trained = moe_train(MOONLIGHT, init_params, api, InputShape, LM, adam,
                            fa_ops, gmm_ops, gmm_ref, MOE)
    emit({"phase": "moe_train", **moe_trained})
    hybrid_trained = hybrid_train(ZAMBA2, init_params, api, InputShape, LM,
                                  adam, fa_ops, ssd_ops)
    emit({"phase": "hybrid_train", **hybrid_trained})
    encdec = encdec_lockstep(SEAMLESS, api, InputShape, fa_ops, E)
    emit({"phase": "encdec_lockstep", **encdec})
    encdec_trained = encdec_train(SEAMLESS, api, InputShape, LM, E, adam,
                                  fa_ops)
    emit({"phase": "encdec_train", **encdec_trained})
    vlm = vlm_lockstep(PHI3V, init_params, api, InputShape, fa_ops)
    emit({"phase": "vlm_lockstep", **vlm})

    main_row = rows[MAIN_PATH_CASE]
    wm_row = rows[WM_PATH_CASE]
    eq, rg = (gmm_rows["equal"][GMM_EQUAL_MAIN],
              gmm_rows["ragged"][GMM_RAGGED_MAIN])
    im = imag_rows[IMAG_MAIN]
    sd = ssd_rows[SSD_MAIN]
    mg = moe_rows[MOE_GMM_MAIN]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": str(fa_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/pallas.py:71",
        "launches": served["attention_launches"],
        "launches_dense_lockstep": lockstep["launches"]["flash"],
        "launches_lm_train": trained["attention_launches"],
        "launches_wm_mbrl": wm["attention_launches"],
        "launches_moe_lockstep": moe["launches"]["flash"],
        "launches_moe_serve": moe_served["attention_launches"],
        "launches_hybrid_lockstep": hybrid["launches"]["flash"],
        "launches_moe_train": moe_trained["launches"]["flash"],
        "launches_moe_train_trained_comparison":
            moe_trained["trained_comparison_launches"]["flash"],
        "launches_hybrid_train": hybrid_trained["launches"]["flash"],
        "launches_hybrid_train_trained_comparison":
            hybrid_trained["trained_comparison_launches"]["flash"],
        "launches_encdec_lockstep": encdec["launches"]["flash"],
        "launches_encdec_train": encdec_trained["attention_launches"],
        "launches_vlm_lockstep": vlm["launches"]["flash"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "tflops": main_row["tflops"],
        "shape": MAIN_PATH_CASE,
        "wm_path": {k: wm_row[k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} | {"case": WM_PATH_CASE},
        "hybrid_path": {k: rows[HYBRID_ATTN_CASE][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} | {"case": HYBRID_ATTN_CASE},
        "encdec_path": {case: {k: rows[case][k] for k in (
            "shape", "causal", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} for case in ENCDEC_ATTN_CASES},
        "vlm_path": {k: rows[VLM_ATTN_CASE][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err")} | {"case": VLM_ATTN_CASE}}, {
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
        "launches_role_mesh": meshed["learner"]["gmm_equal_launches"]
            + meshed["threads"]["gmm_equal_launches"],
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
        "launches_role_mesh": meshed["improver"]["gmm_ragged_launches"],
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
        "name": "gmm_ragged_bf16", "route": "cuda",
        "source": str(gmm_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/gmm/pallas.py:104",
        "launches": moe["launches"]["gmm_ragged_bf16"],
        "launches_tma_wgmma": moe["launches"]["gmm_ragged_bf16_wgmma"],
        "launches_moe_serve": moe_served["gmm_ragged_bf16_launches"],
        "launches_moe_train": moe_trained["launches"]["gmm_ragged_bf16"],
        "launches_moe_train_trained_comparison":
            moe_trained["trained_comparison_launches"]["gmm_ragged_bf16"],
        "max_abs_err": max(r["max_abs_err"] for r in moe_rows.values()),
        "ms": mg["ms"], "plain_ms": mg["plain_ms"],
        "bound_ms": mg["bound_ms"], "bound_by": mg["bound_by"],
        "library_ms": mg["library_ms"], "tflops": mg["tflops"],
        "kernel_route": mg["route"], "ms_mma_sync": mg["ms_mma_sync"],
        "shape": MOE_GMM_MAIN,
        "other_shapes": {name: {k: r[k] for k in (
            "shape", "route", "ms", "ms_mma_sync", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for name, r in moe_rows.items()
            if not name.startswith("edge") and name != MOE_GMM_MAIN}}, {
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
        "launches_role_mesh": meshed["improver"]["imag_fused_launches"]
            + meshed["threads"]["imag_fused_launches"],
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
        "launches_hybrid_lockstep": hybrid["launches"]["ssd_chunked"],
        "launches_hybrid_train": hybrid_trained["launches"]["ssd_chunked"],
        "launches_hybrid_train_trained_comparison":
            hybrid_trained["trained_comparison_launches"]["ssd_chunked"],
        "max_abs_err": max(r["max_abs_err"] for r in ssd_rows.values()),
        "ms": sd["ms"], "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"], "bound_by": sd["bound_by"],
        "library_ms": sd["library_ms"], "shape": SSD_MAIN,
        "plan": sd["plan"],
        "hybrid_path": {k: ssd_rows[HYBRID_SSD_CASE][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "scaled_err")} | {"case": HYBRID_SSD_CASE}}]})
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
