"""Continuous-batching scheduler: admit into free slots, decode every tick
(port of ``repro/serve/scheduler.py``).

    tick := [admit queue head while it fits] ->
            [decode all active slots]        ->
            [emit one token per slot, retire finished]

Admission is strictly FIFO with head-of-line blocking: a request that does
not fit (no free slot, or too few free pages) blocks everything behind it.
Prompts right-pad into a fixed set of PREFILL BUCKETS, so the decode step
sees one input shape forever and each bucket's prefill one shape.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.serve.kv_pool import PagedKVPool


@dataclasses.dataclass
class Request:
    """One generation request: ``prompt`` token ids in, ``tokens`` out
    (greedy continuation, exactly ``max_new`` long)."""
    rid: int
    prompt: np.ndarray
    max_new: int
    bucket: int = -1
    slot: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    admitted_s: float = 0.0
    done_s: float = 0.0

    @property
    def budget(self) -> int:
        """Token slots this request may ever occupy (drives paging)."""
        return len(self.prompt) + self.max_new

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new


class Scheduler:
    """Owns the step functions, the KV pool and the slot<->request binding.
    Parameters are passed into every tick; versioning and hot-swap live one
    level up in WorldModelServer."""

    def __init__(self, cfg, *, n_slots: int, max_seq: int,
                 page_len: int = 16, n_pages: int = None,
                 prompt_buckets=(16, 32, 64), device=None):
        buckets = tuple(sorted(set(int(b) for b in prompt_buckets)))
        if not buckets:
            raise ValueError("need at least one prompt bucket")
        if buckets[-1] > max_seq:
            raise ValueError(f"largest bucket {buckets[-1]} exceeds "
                             f"max_seq {max_seq}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.buckets = buckets
        self.n_slots = n_slots
        self.dec = api.build_serve_decode(cfg, n_slots, max_seq,
                                          device=self.device)
        self.pre = {b: api.build_serve_prefill(cfg, 1, b, device=self.device)
                    for b in buckets}
        self.pool = PagedKVPool(cfg, n_slots=n_slots, max_seq=max_seq,
                                page_len=page_len, n_pages=n_pages,
                                device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self._tok = np.zeros((n_slots, 1), np.int32)
        self._act = np.zeros((n_slots,), bool)
        self.ticks = 0
        self.tokens_out = 0
        self.admit_order: List[int] = []
        self.tick_seconds: List[tuple] = []  # (seconds, n_active)

    # -- admission ---------------------------------------------------------

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return None

    def fits(self, req: Request) -> bool:
        return self.pool.can_admit(req.budget)

    def _admit(self, params, req: Request) -> None:
        b = req.bucket
        batch = np.zeros((1, b), np.int32)
        batch[0, :len(req.prompt)] = req.prompt
        plen = torch.tensor([len(req.prompt)], dtype=torch.int32,
                            device=self.device)
        logits, pre_cache = self.pre[b].fn(
            params, {"tokens": torch.from_numpy(batch).to(self.device)}, plen)
        slot = self.pool.admit(pre_cache, req.budget)
        req.slot = slot
        req.admitted_s = time.perf_counter()
        self.admit_order.append(req.rid)
        self.slot_req[slot] = req
        t0 = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
        req.tokens.append(t0)
        self.tokens_out += 1
        self._tok[slot, 0] = t0
        self._act[slot] = True

    def _retire(self, req: Request) -> None:
        req.done_s = time.perf_counter()
        self.pool.retire(req.slot)
        self.slot_req[req.slot] = None
        self._act[req.slot] = False

    # -- the tick ----------------------------------------------------------

    def tick(self, params, queue) -> List[Request]:
        """One scheduler round. Returns the requests finished this tick.
        ``queue`` needs ``__len__``, ``peek()`` and ``pop()``."""
        self.ticks += 1
        finished: List[Request] = []
        while len(queue) and self.fits(queue.peek()):
            req = queue.pop()
            self._admit(params, req)
            if req.done:  # max_new == 1: satisfied by the prefill logits
                self._retire(req)
                finished.append(req)
        if not self._act.any():
            return finished

        t0 = time.perf_counter()
        logits, self.pool.cache = self.dec.fn(
            params, self.pool.cache,
            torch.from_numpy(self._tok).to(self.device),
            torch.from_numpy(self._act).to(self.device))
        nxt = torch.argmax(logits[:, :self.cfg.vocab_size], -1).to(
            torch.int32).cpu().numpy()  # host sync point
        n_active = int(self._act.sum())
        self.tick_seconds.append((time.perf_counter() - t0, n_active))

        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            req.tokens.append(int(nxt[slot]))
            self.tokens_out += 1
            self._tok[slot, 0] = nxt[slot]
            if req.done:
                self._retire(req)
                finished.append(req)
        return finished

    @property
    def busy(self) -> bool:
        return any(r is not None for r in self.slot_req)

    def compile_counts(self) -> dict:
        """Distinct input shapes per step function: the eager counterpart
        of the reference's trace counts."""
        return {
            "decode": self.dec.fn.shape_count,
            "prefill": sum(b.fn.shape_count for b in self.pre.values()),
            "admit": self.pool.admit_compiles,
        }
