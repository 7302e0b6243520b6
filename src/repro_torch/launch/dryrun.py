"""One-card dry run: the port of ``repro/launch/dryrun.py``.

The reference lowers and compiles every (architecture x input shape) step
against the TPU pod's production meshes and records the compiler's
numbers. Its one-card counterpart here is an audit that allocates nothing:
parameters, optimizer state and caches are made on PyTorch's ``meta``
device, and only their sizes are read. For every arch id and every shape
of ``INPUT_SHAPES`` it records

* ``params`` and ``active_params`` (the reference's ``param_count`` /
  ``active_param_count``);
* the bytes the step holds in its arguments: the weights, the Adam state
  (two f32 moments a parameter) for ``train``, the batch, and the KV or
  state cache for ``prefill`` / ``decode`` (int8 with ``--kv-int8``);
  activations are not counted;
* whether those bytes fit on one card of ``--card-gb`` GB (10^9 bytes),
  and the deepest cut at full width that fits (``num_layers`` cut, every
  width kept), the way ``chip_smoke.py`` cuts Moonlight by hand.

``long_500k`` is skipped where the reference skips it. The reference's
compile times, ``cost_analysis`` and HLO collective bytes have no
counterpart on one card: eager PyTorch compiles nothing and one card has no
collective; each record says so (``not_measured``).

Usage::

  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--kv-int8] [--out results.json]
  python -m repro_torch.launch.dryrun --roles [--mesh-shape 16,16]

``--roles`` reports the async-MBRL role split (core/roles.py) of the local
cards, or of a stand-in mesh of ``--mesh-shape`` (``--multi-pod``: the
reference's 2 x 16 x 16) with every entry ``--device`` (default the CPU):
pure bookkeeping, nothing allocated.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.models.config import INPUT_SHAPES

NOT_MEASURED = ("compile time, cost_analysis and HLO collective bytes: "
                "eager PyTorch compiles no step and one card runs no "
                "collective; FLOPs per step come with the bench's roofline")
_META = torch.device("meta")


def _params(cfg):
    from repro_torch.models import api
    return api._mod(cfg).init_params(cfg, 0, device=_META)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def param_count(cfg) -> int:
    """Every parameter of ``cfg``'s model, counted on the meta device."""
    return sum(t.numel() for t in _params(cfg).parameters())


def active_param_count(cfg) -> int:
    """Params touched per token (MoE: top_k of num_experts experts), by
    the reference's formula."""
    total = param_count(cfg)
    if cfg.family != "moe" or not cfg.num_experts:
        return total
    expert = cfg.num_layers * 3 * cfg.d_model * cfg.d_ff * cfg.num_experts
    return total - expert + expert * cfg.top_k // cfg.num_experts


def step_bytes(cfg, shape, *, kv_int8: bool = False) -> dict:
    """The bytes the step of ``shape`` holds in its arguments, by part."""
    from repro_torch.models import api
    params = _params(cfg)
    weights = _nbytes(params.parameters())
    B, S = shape.global_batch, shape.seq_len
    embed = 2 * cfg.d_model              # one bf16 embedding row
    out = {"weights": weights, "adam": 0, "batch": 0, "cache": 0}
    if shape.kind == "train":
        out["adam"] = 2 * 4 * sum(t.numel() for t in params.parameters())
        out["batch"] = 2 * 4 * B * S     # int32 tokens and labels
    else:
        out["batch"] = 4 * B * (S if shape.kind == "prefill" else 1)
    if cfg.family == "encdec":
        out["batch"] += embed * B * S    # the encoder's frame embeddings
    elif cfg.modality == "vision" and shape.kind != "decode":
        out["batch"] += embed * B * (S // 8)
    if shape.kind != "train":
        mod = api._mod(cfg)
        kw = {} if cfg.family == "encdec" else {"kv_int8": kv_int8}
        cache = mod.init_cache(cfg, B, S, device=_META, **kw)
        out["cache"] = _nbytes(v for v in cache.values()
                               if isinstance(v, torch.Tensor))
    out["total"] = sum(out.values())
    return out


def deepest_fitting_cut(cfg, shape, limit: int, *,
                        kv_int8: bool = False) -> int:
    """The most layers (every width kept) whose step bytes fit in
    ``limit``; 0 when not even one layer does. Bytes grow with depth, so a
    bisection finds it."""
    def fits(n):
        cut = dataclasses.replace(cfg, num_layers=n)
        return step_bytes(cut, shape, kv_int8=kv_int8)["total"] <= limit
    lo, hi = 0, cfg.num_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def dryrun_one(arch: str, shape_name: str, *, kv_int8: bool = False,
               card_gb: float = 80.0, verbose: bool = True) -> dict:
    arch_n = registry.normalize(arch)
    shape = INPUT_SHAPES[shape_name]
    long_ctx = shape_name == "long_500k"
    rec = {"arch": arch_n, "shape": shape_name, "mesh": "1 card",
           "ok": False}
    if long_ctx and registry.LONG_CONTEXT[arch_n] == "skip":
        rec["skipped"] = "long_500k inapplicable (see DESIGN.md)"
        return rec
    try:
        cfg = registry.get_config(arch_n, long_context=long_ctx)
        limit = int(card_gb * 1e9)
        nbytes = step_bytes(cfg, shape, kv_int8=kv_int8)
        rec.update(
            ok=True, kind=shape.kind, kv_int8=kv_int8,
            params=param_count(cfg), active_params=active_param_count(cfg),
            bytes=nbytes, card_gb=card_gb, fits=nbytes["total"] <= limit,
            num_layers=cfg.num_layers,
            deepest_fitting_layers=deepest_fitting_cut(
                cfg, shape, limit, kv_int8=kv_int8),
            not_measured=NOT_MEASURED)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
        rec["traceback"] = traceback.format_exc()[-1500:]
    if verbose:
        status = "OK " if rec.get("ok") else ("SKIP" if "skipped" in rec
                                              else "FAIL")
        gb = rec.get("bytes", {}).get("total", 0) / 1e9
        print(f"[{status}] {arch_n:24s} {shape_name:12s} {gb:10.2f} GB "
              f"fits={rec.get('fits', '-')} "
              f"layers={rec.get('deepest_fitting_layers', '-')}"
              f"/{rec.get('num_layers', '-')}", flush=True)
        if "error" in rec:
            print("   ", rec["error"][:300], flush=True)
    return rec


def stand_in_mesh(shape, device="cpu"):
    """A mesh of ``shape`` whose every entry is ``device``, with the
    reference's axis names: ("data",), ("data", "model") or ("pod", "data",
    "model")."""
    import numpy as np

    from repro_torch.core.roles import Mesh
    shape = tuple(int(n) for n in shape)
    axes = {1: ("data",), 2: ("data", "model"),
            3: ("pod", "data", "model")}[len(shape)]
    devs = np.empty(int(np.prod(shape)), dtype=object)
    devs[:] = [torch.device(device)] * devs.size
    return Mesh(devs.reshape(shape), axes)


def dryrun_roles(mesh=None, *, ratios=(1, 2, 1), n_collectors: int = 1,
                 envs_per_collector: int = 1, device=None,
                 verbose: bool = True) -> dict:
    """Role-split sanity for the async MBRL path: split ``mesh`` (default:
    the local cards, or ``device``'s one-entry mesh) into collector / model
    / policy sub-meshes (core/roles.py) and report their shapes and the
    placements the workers run on, how a collector fleet of
    ``n_collectors`` spreads round-robin over the collector sub-mesh, and
    how many simulated robots it runs when each collector farms
    ``envs_per_collector`` lanes. Nothing is allocated."""
    from repro_torch.core.roles import (batch_sharded, collector_sharding,
                                        replicated, split_roles)
    from repro_torch.launch.mesh import make_local_mesh
    if mesh is None:
        mesh = make_local_mesh(device)
    roles = split_roles(mesh, ratios=tuple(ratios))
    fleet = {f"collector:{i}": str(collector_sharding(roles.collector,
                                                      i).device)
             for i in range(n_collectors)}
    rec = {"mesh": "x".join(str(n) for n in mesh.devices.shape),
           "ratios": list(ratios), "roles": roles.describe(),
           "model_batch_sharding":
               str(batch_sharded(roles.model, roles.axis)),
           "policy_param_sharding": str(replicated(roles.policy)),
           "n_collectors": n_collectors,
           "envs_per_collector": envs_per_collector,
           "sim_robots_total": n_collectors * envs_per_collector,
           "fleet_devices": fleet,
           "collector_devices_total": int(roles.collector.devices.size)}
    if verbose:
        print(json.dumps(rec, indent=1))
    return rec


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-int8", action="store_true",
                    help="prefill/decode: the int8 KV cache")
    ap.add_argument("--card-gb", type=float, default=80.0,
                    help="one card's memory in GB (10^9 bytes)")
    ap.add_argument("--roles", action="store_true",
                    help="report the async-MBRL role split and exit")
    ap.add_argument("--role-ratios", default="1,2,1")
    ap.add_argument("--n-collectors", type=int, default=4,
                    help="with --roles: report the fleet's round-robin "
                         "device assignment on the collector sub-mesh")
    ap.add_argument("--envs-per-collector", type=int, default=1,
                    help="with --roles: report the fleet's total "
                         "simulated-robot count when each collector "
                         "farms B env lanes")
    ap.add_argument("--mesh-shape", default=None,
                    help="with --roles: a stand-in mesh of this shape "
                         "(e.g. 16,16) instead of the local cards")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --roles: the stand-in mesh 2,16,16")
    ap.add_argument("--device", default=None,
                    help="with --roles: the device of a stand-in mesh's "
                         "entries (default cpu), or of the local mesh")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--resume", action="store_true",
                    help="skip combos already present in --out")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.roles:
        shape = ("2,16,16" if args.multi_pod else args.mesh_shape)
        mesh = None if shape is None else stand_in_mesh(
            shape.split(","), args.device or "cpu")
        return dryrun_roles(mesh, ratios=tuple(
            int(x) for x in args.role_ratios.split(",")),
            n_collectors=args.n_collectors,
            envs_per_collector=args.envs_per_collector, device=args.device)

    archs = registry.ARCH_IDS if (args.all or not args.arch) \
        else [registry.normalize(args.arch)]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    out_path = Path(args.out)
    results, done = [], set()
    if args.resume and out_path.exists():
        results = json.loads(out_path.read_text())
        done = {(r["arch"], r["shape"]) for r in results
                if r.get("ok") or "skipped" in r}
    for a in archs:
        for s in shapes:
            if (a, s) in done:
                continue
            rec = dryrun_one(a, s, kv_int8=args.kv_int8,
                             card_gb=args.card_gb)
            results = [r for r in results
                       if not (r["arch"] == rec["arch"]
                               and r["shape"] == rec["shape"])]
            results.append(rec)
            out_path.write_text(json.dumps(results, indent=1))
    n_ok = sum(1 for r in results if r.get("ok"))
    n_skip = sum(1 for r in results if "skipped" in r)
    print(f"\n{n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed -> {out_path}")
    return results


if __name__ == "__main__":
    main()
