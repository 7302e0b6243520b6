"""CLI demo of the serving tier on the reduced world model.

    PYTHONPATH=src python -m repro_torch.serve [--requests 12] [--n-slots 4]

Submits a stream of random-token requests with mixed prompt lengths, serves
them with continuous batching, hot-swaps the model once mid-run (simulating
a training push), and prints the server stats as JSON. Runs on the GPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.servers import ParameterServer
from repro_torch.models.lm import init_params
from repro_torch.serve import WorldModelServer


def main(argv=None, *, device=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve",
                                 description=__doc__)
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    server_params = ParameterServer()
    server_params.push(
        init_params(cfg, 2 * args.seed, device=device).state_dict())
    srv = WorldModelServer(cfg, param_server=server_params, device=device,
                           n_slots=args.n_slots, max_seq=args.max_seq)

    rng = np.random.default_rng(args.seed)
    rids = []
    for i in range(args.requests):
        plen = int(rng.integers(4, srv.sched.buckets[-1] + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        rids.append(srv.submit(prompt, max_new=args.max_new))
        srv.step()
        if i == args.requests // 2:  # a mid-run training push
            server_params.push(init_params(cfg, 2 * args.seed + 1,
                                           device=device).state_dict())
    srv.run()

    for rid in rids[:3]:
        print(f"request {rid}: {srv.result(rid).tolist()}")
    print(json.dumps(srv.stats(), indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
