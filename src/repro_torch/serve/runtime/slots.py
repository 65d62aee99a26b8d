"""Slotted/paged decode-cache manager.

A *slot* is one row of the batched engine step (nothing is carried for
stateless vision forwards). The manager owns the slot lifecycle — FREE ->
OCCUPIED on admit, OCCUPIED -> FREE on evict — and accounts capacity in
pages of ``page_tokens`` positions: a request reserves
``ceil(min(tokens, max_len) / page_tokens)`` pages on admission and
touches them as its position advances.

A data-parallel mesh of ``dp`` devices owns the slots in contiguous
blocks: the physical slot count is padded up to the next multiple of
``dp``, pad slots are never admitted, and device *d* owns
``[d*block, (d+1)*block)``. A ragged ``num_slots % dp`` costs idle slots,
not an error.

Counters (`repro_torch.obs.trace`): ``serve.admits``, ``serve.evicts``,
``serve.pages_reserved``, ``serve.pages_released``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional

from repro_torch.obs import trace as obs


class CapacityError(RuntimeError):
    """A request can never fit (prompt longer than the cache)."""


@dataclasses.dataclass
class Slot:
    """Lifecycle record for one row."""
    sid: int
    rid: Optional[int] = None        # occupying request, None == FREE
    pages_reserved: int = 0
    pages_used: int = 0
    pos: int = 0

    @property
    def free(self) -> bool:
        return self.rid is None


class SlotManager:
    def __init__(self, num_slots: int, max_len: int, *, dp: int = 1,
                 page_tokens: int = 16):
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} must be >= 1")
        if page_tokens < 1:
            raise ValueError(f"page_tokens={page_tokens} must be >= 1")
        self.real = num_slots
        self.dp = max(int(dp), 1)
        self.block = -(-num_slots // self.dp)     # slots per device
        self.phys = self.block * self.dp
        self.max_len = max_len
        self.page_tokens = page_tokens
        self.pages_per_slot = -(-max_len // page_tokens)
        self.capacity_pages = self.real * self.pages_per_slot
        self.slots: List[Slot] = [Slot(i) for i in range(self.real)]
        self._free: List[int] = list(range(self.real))  # sorted ascending

    def _pages_for(self, tokens: int) -> int:
        return -(-min(max(tokens, 1), self.max_len) // self.page_tokens)

    def check_fits(self, prompt_len: int):
        if prompt_len > self.max_len:
            raise CapacityError(
                f"prompt length {prompt_len} exceeds max_len="
                f"{self.max_len}: request can never fit its cache pages")

    def admit(self, rid: int, reserve_tokens: int) -> int:
        """Allocate the lowest free slot (deterministic placement); the
        caller guarantees one is free."""
        sid = self._free.pop(0)
        s = self.slots[sid]
        s.rid = rid
        s.pages_reserved = self._pages_for(reserve_tokens)
        s.pages_used = 0
        s.pos = 0
        obs.counter("serve.admits").add(1)
        obs.counter("serve.pages_reserved").add(s.pages_reserved)
        return sid

    def advance(self, sid: int, pos: int):
        s = self.slots[sid]
        s.pos = pos
        s.pages_used = min(self._pages_for(pos), s.pages_reserved)

    def evict(self, sid: int) -> Slot:
        s = self.slots[sid]
        if s.rid is None:
            raise ValueError(f"evicting free slot {sid}")
        obs.counter("serve.evicts").add(1)
        obs.counter("serve.pages_released").add(s.pages_reserved)
        out = dataclasses.replace(s)
        s.rid = None
        s.pages_reserved = s.pages_used = s.pos = 0
        bisect.insort(self._free, sid)
        return out

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active(self) -> List[Slot]:
        """Occupied slots in ascending sid order."""
        return [s for s in self.slots if not s.free]

    def occupancy(self) -> float:
        return (self.real - len(self._free)) / self.real

    def device_occupancy(self) -> List[float]:
        """Fraction of each device's ``block`` physical slots doing real
        work (a pad or free slot is an idle cluster core)."""
        busy = [0] * self.dp
        for s in self.slots:
            if not s.free:
                busy[s.sid // self.block] += 1
        return [b / self.block for b in busy]
