"""World-model serving tier (port of ``repro/serve``): continuous batching,
paged KV cache, live hot-swap.

    submit() -> RequestQueue (bounded, BackpressureError)
            -> Scheduler (continuous batching over a PagedKVPool)
            -> pull_if_newer (hot-swap between decode ticks)
"""
from repro_torch.serve.kv_pool import PagedKVPool
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.serve.server import RequestQueue, WorldModelServer

__all__ = ["PagedKVPool", "Request", "RequestQueue", "Scheduler",
           "WorldModelServer"]
