#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device`` / ``build``: the card, then every kernel built from the
   sources in this checkout (one ``nvcc`` per source, all at once).
2. ``kernel_check``: each kernel against its plain PyTorch version on the
   card at the serving path's shapes and at edge shapes, with times of the
   kernel, the plain version and one PyTorch library call, and the least
   time the card could take.
3. ``model_check``: GLM-4-9B at full width, cut to 2 layers; prefill logits
   through the kernel against the same through the plain attention.
4. ``serve``: ``WorldModelServer`` on the full 40-layer GLM-4-9B with a
   ``ParameterServer``, mixed prompt lengths and a mid-run push; asserts
   the serving invariants and that every prefill went through the kernel.
   Then ``decode_profile``: ``torch.profiler`` over a few full-width decode
   ticks (device time, busy share, kernels per tick), after the counts of
   the main path are read.
5. ``kernels``: one entry per kernel, as the port's records expect.

The line before the last is the card's name and power limit from
``nvidia-smi``; the last is ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero and prints no result. It
imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
        rows[name] = {
            "shape": [B, Sq, Sk, Hq, Hkv, D], "causal": causal,
            "window": window, "dtype": str(dt).replace("torch.", ""),
            "max_abs_err": err, "atol": ATTN_ATOL[dt],
            "ms": time_ms(lambda: fa_ops.attention(q, k, v, impl="cuda",
                                                   **kw)),
            "plain_ms": time_ms(lambda: fa_ops.attention(q, k, v,
                                                         impl="ref", **kw)),
            "library_ms": time_ms(library), "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": bound_by}
        emit({"phase": "kernel_check", "kernel": "flash_attention_fwd",
              "case": name, **rows[name]})
    return rows


# ---------------------------------------------------------------- phase 3

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


# ---------------------------------------------------------------- phase 4

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


def profile_decode(srv, cfg, ticks: int = 3) -> dict:
    """Where a full-width decode tick's time goes, after the main path's
    counts are read: ``torch.profiler`` over ``ticks`` steps with every slot
    busy. Device time is the sum of kernel self times; the busy share is
    that over the host wall time of the same steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(3)
    for _ in range(srv.sched.n_slots):
        srv.submit(rng.integers(0, cfg.vocab_size, 16), max_new=ticks + 3)
    srv.step()  # admit every slot + the first decode
    srv.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    srv.run()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not kernels or device_ms <= 0:
        raise RuntimeError("profiler recorded no device time")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.glm4_9b import CONFIG
    from repro_torch.core.servers import ParameterServer
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import cuda as fa_cuda
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models import api
    from repro_torch.models.lm import init_params
    from repro_torch.serve import WorldModelServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    sources = [fa_cuda.SOURCE]
    t0 = time.perf_counter()
    built = build.build(sources)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [str(s.relative_to(ROOT)) for s in sources],
          "ptxas": [line.strip() for info in built.values()
                    for line in info["log"].splitlines() if "Used" in line]})

    rows = check_attention(fa_ops, fa_ref)
    emit({"phase": "model_check", **check_model(CONFIG, init_params, api)})
    srv, served = serve(CONFIG, init_params, ParameterServer,
                        WorldModelServer, fa_ops)
    emit({"phase": "serve", **served})
    emit({"phase": "decode_profile", **profile_decode(srv, CONFIG)})

    main_row = rows[MAIN_PATH_CASE]
    emit({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": str(fa_cuda.SOURCE.relative_to(ROOT)),
        "replaces": "src/repro/kernels/flash_attention/pallas.py:71",
        "launches": served["attention_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"], "shape": MAIN_PATH_CASE}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
