"""Paged KV pool: static-shape slot storage + page-ledger admission
(port of ``repro/serve/kv_pool.py``).

* STORAGE is slot-dense: one cache allocated at ``(n_slots, max_seq)`` by
  ``lm.init_cache_slots`` whose shapes never change as requests churn.
  Admission copies a prefilled single-request cache into a slot row,
  overwriting every per-slot field (k, v, pos, index), so no stale tenant
  state survives.
* ACCOUNTING is paged: a fixed pool of ``n_pages`` pages of ``page_len``
  token slots. A request holds ``ceil((prompt + max_new) / page_len)``
  pages for its whole lifetime, so admission can be refused on page
  exhaustion with slots free, and ``free + held == n_pages`` always.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch import resolve_device
from repro_torch.models import lm as LM
from repro_torch.models.api import ShapeCounted, grow_cache


def _admit_update(pool, pre, slot: int):
    """Copy one prefilled request cache (B=1, any bucket length) into pool
    slot ``slot`` in place, grown to pool capacity first."""
    pre = grow_cache(pre, pool["k"].shape[2])
    pool["k"][:, slot:slot + 1].copy_(pre["k"])
    pool["v"][:, slot:slot + 1].copy_(pre["v"])
    pool["pos"][slot:slot + 1].copy_(pre["pos"])
    pool["index"][slot:slot + 1].copy_(pre["index"])
    return pool


class PagedKVPool:
    """Fixed page pool + per-request page tables over slot-dense storage.
    ``cache`` is the live decode cache handed to the serve decode each
    tick; slots and pages are host-side bookkeeping."""

    def __init__(self, cfg, *, n_slots: int, max_seq: int,
                 page_len: int = 16, n_pages: int = None, device=None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.page_len = int(page_len)
        self.cache = LM.init_cache_slots(cfg, n_slots, max_seq,
                                         device=resolve_device(device))
        self.s_cache = self.cache["k"].shape[2]
        full = n_slots * self.pages_for(self.s_cache)
        self.n_pages = full if n_pages is None else int(n_pages)
        self._free_pages = list(range(self.n_pages))
        self._free_slots = list(range(n_slots))
        self._page_table: Dict[int, Tuple[int, ...]] = {}
        self._admit = ShapeCounted(_admit_update)

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_len)

    def can_admit(self, budget_tokens: int) -> bool:
        """One free slot AND enough free pages for the request's whole
        token budget (prompt + max_new), held until retirement."""
        return (bool(self._free_slots)
                and self.pages_for(budget_tokens) <= len(self._free_pages))

    def admit(self, pre_cache, budget_tokens: int) -> int:
        """Claim a slot + pages and copy the prefilled cache in. Returns
        the slot id. Callers check :meth:`can_admit` first."""
        if budget_tokens > self.s_cache:
            raise ValueError(
                f"request budget {budget_tokens} tokens exceeds pool "
                f"capacity {self.s_cache}")
        need = self.pages_for(budget_tokens)
        if not self._free_slots:
            raise RuntimeError("no free decode slot")
        if need > len(self._free_pages):
            raise RuntimeError(
                f"page pool exhausted: need {need}, "
                f"free {len(self._free_pages)}/{self.n_pages}")
        slot = self._free_slots.pop(0)
        self._page_table[slot] = tuple(self._free_pages[:need])
        del self._free_pages[:need]
        self.cache = self._admit(self.cache, pre_cache, slot)
        return slot

    def retire(self, slot: int) -> None:
        """Free a slot's pages. Storage needs no cleanup: the next admission
        overwrites the slot row, and decode never writes inactive slots."""
        self._free_pages.extend(self._page_table.pop(slot))
        self._free_slots.append(slot)

    def accounting(self) -> Tuple[int, int]:
        """(free_pages, held_pages); their sum must equal n_pages."""
        held = sum(len(p) for p in self._page_table.values())
        return len(self._free_pages), held

    @property
    def admit_compiles(self) -> int:
        """Distinct admission shapes seen (the reference counts traces)."""
        return self._admit.shape_count
