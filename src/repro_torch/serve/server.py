"""WorldModelServer: the user-facing serving tier (port of
``repro/serve/server.py``).

Wires a bounded :class:`RequestQueue` (blocking submit, descriptive
``BackpressureError``), the continuous-batching
:class:`~repro_torch.serve.scheduler.Scheduler` over its paged KV pool, and
live hot-swap: between decode ticks the server runs one
``ParameterServer.pull_if_newer(version)``. The unchanged path is a lock and
an int compare with no copy; a version change repoints the model's
parameters at the pushed tensors (``load_state_dict(assign=True)``, no copy
on the same device) and the very next tick decodes with them. Caches
survive the swap untouched.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.servers import BackpressureError
from repro_torch.models.lm import LM
from repro_torch.serve.scheduler import Request, Scheduler


class RequestQueue:
    """Bounded FIFO admission queue. ``submit`` blocks up to ``timeout``
    seconds for space, then raises :class:`BackpressureError`."""

    def __init__(self, maxsize: int = 64, submit_timeout: float = 0.0):
        self.maxsize = int(maxsize)
        self.submit_timeout = float(submit_timeout)
        self._dq = collections.deque()
        self._cv = threading.Condition()

    def submit(self, req: Request, timeout: Optional[float] = None) -> None:
        timeout = self.submit_timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._cv:
            while len(self._dq) >= self.maxsize:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise BackpressureError(
                        f"serve request queue full ({self.maxsize} "
                        f"waiting) after {timeout:.1f}s: the decode loop "
                        f"is not draining admissions fast enough — scale "
                        f"n_slots / the page pool, or shed load")
                self._cv.wait(left)
            self._dq.append(req)

    def pop(self) -> Request:
        with self._cv:
            req = self._dq.popleft()
            self._cv.notify_all()
            return req

    def peek(self) -> Optional[Request]:
        with self._cv:
            return self._dq[0] if self._dq else None

    def __len__(self) -> int:
        with self._cv:
            return len(self._dq)


class WorldModelServer:
    """Continuous-batching world-model inference with live hot-swap.

    Construct with either fixed ``params`` (an ``LM``) or a
    ``param_server`` (any object with ``pull()`` / ``pull_if_newer(version)``
    holding ``LM.state_dict()``s). With a param server, every ``step()``
    begins with a version-gated pull.
    """

    def __init__(self, cfg, *, params: Optional[LM] = None,
                 param_server=None, device=None, n_slots: int = 4,
                 max_seq: int = 96, page_len: int = 16, n_pages: int = None,
                 prompt_buckets=(16, 32, 64), queue_maxsize: int = 64,
                 submit_timeout: float = 0.0):
        if (params is None) == (param_server is None):
            raise ValueError("pass exactly one of params= / param_server=")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sched = Scheduler(cfg, n_slots=n_slots, max_seq=max_seq,
                               page_len=page_len, n_pages=n_pages,
                               prompt_buckets=prompt_buckets,
                               device=self.device)
        self.queue = RequestQueue(queue_maxsize, submit_timeout)
        self.param_server = param_server
        self.version = -1
        self.swaps = 0
        self.swap_seconds: List[float] = []
        self.model = params
        if params is not None:
            if params.device != self.device:
                raise ValueError(f"params are on {params.device}, the "
                                 f"server runs on {self.device}")
            self.version = 0
        else:
            val, ver = param_server.pull()
            if val is None:
                raise ValueError("param_server has no pushed value yet")
            self._set_params(val, ver)
        self._rid = 0
        self._results: Dict[int, np.ndarray] = {}

    # -- params / hot-swap -------------------------------------------------

    def _set_params(self, state, ver: int) -> None:
        state = {k: v.to(self.device) for k, v in state.items()}
        if self.model is None:
            self.model = LM.from_state_dict(self.cfg, state)
        else:
            self.model.load_state_dict(state, assign=True)
        self.version = ver

    def maybe_swap(self) -> bool:
        """One version-gated pull. Unchanged version: no copy, no sync.
        Newer version: repoint the weights; in-flight requests pick it up on
        the very next decode tick."""
        if self.param_server is None:
            return False
        t0 = time.perf_counter()
        val, ver = self.param_server.pull_if_newer(self.version)
        if val is None:
            return False
        self._set_params(val, ver)
        self.swap_seconds.append(time.perf_counter() - t0)
        self.swaps += 1
        return True

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt, max_new: int,
               timeout: Optional[float] = None) -> int:
        """Enqueue one request; returns its rid. Raises ValueError for
        requests that could NEVER be served (too-long prompt, budget beyond
        pool capacity) and BackpressureError when the queue stays full past
        the timeout."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        bucket = self.sched.bucket_for(prompt.size)
        if bucket is None:
            raise ValueError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prefill bucket {self.sched.buckets[-1]}")
        budget = prompt.size + int(max_new)
        if budget > self.sched.pool.s_cache:
            raise ValueError(
                f"budget {budget} tokens exceeds pool capacity "
                f"{self.sched.pool.s_cache}")
        if self.sched.pool.pages_for(budget) > self.sched.pool.n_pages:
            raise ValueError(
                f"budget {budget} tokens needs more pages than the pool "
                f"holds ({self.sched.pool.n_pages})")
        rid = self._rid
        self._rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=int(max_new),
                      bucket=bucket, submitted_s=time.perf_counter())
        self.queue.submit(req, timeout=timeout)
        return rid

    def step(self) -> int:
        """One serving round: hot-swap check, then one scheduler tick.
        Returns how many requests finished this step."""
        self.maybe_swap()
        finished = self.sched.tick(self.model, self.queue)
        for req in finished:
            self._results[req.rid] = np.asarray(req.tokens, np.int32)
        return len(finished)

    @property
    def pending(self) -> bool:
        return len(self.queue) > 0 or self.sched.busy

    def run(self, max_ticks: int = 100_000) -> int:
        """Drain queue + slots; returns ticks used. Every request has a
        bounded budget, so this terminates unless the scheduler stops making
        progress (then: RuntimeError)."""
        n = 0
        while self.pending:
            if n >= max_ticks:
                raise RuntimeError(f"serve run not drained after {n} ticks")
            before = (len(self.queue), self.sched.tokens_out)
            self.step()
            n += 1
            if (len(self.queue), self.sched.tokens_out) == before:
                raise RuntimeError(
                    "serve tick made no progress (queue head can never "
                    "fit? — submit() validation should have caught this)")
        return n

    def result(self, rid: int) -> np.ndarray:
        return self._results[rid]

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        ticks = self.sched.tick_seconds
        lat = sorted(dt for dt, _ in ticks)
        tok = sum(n for _, n in ticks)
        wall = sum(dt for dt, _ in ticks)

        def pct(p):
            return lat[min(len(lat) - 1, int(p * len(lat)))] if lat else 0.0

        cc = self.sched.compile_counts()
        return {
            "tokens_generated": self.sched.tokens_out,
            "decode_ticks": len(ticks),
            "tokens_per_s": (tok / wall) if wall > 0 else 0.0,
            "p50_ms_per_token": pct(0.50) * 1e3,
            "p95_ms_per_token": pct(0.95) * 1e3,
            "hot_swaps": self.swaps,
            "hotswap_stall_ms": (np.mean(self.swap_seconds) * 1e3
                                 if self.swap_seconds else 0.0),
            "decode_compiles": cc["decode"],
            "prefill_compiles": cc["prefill"],
            "admit_compiles": cc["admit"],
            "version": self.version,
        }
