"""KV-cache managers: slot + memory accounting for the serving fleet.

The serving control plane (:mod:`.scheduler`) never branches on cache
layout: every (group, replica) owns one :class:`KVCacheManager` that
answers the same questions — can this context ever fit? can it be
reserved now? grow it? release it? how much headroom is left for the
router? This slice ports the dense layout, :class:`DenseSlotCache`:
``max_batch`` per-request slots, each implicitly reserving a full
``max_len`` context, so ``try_extend`` never fails and preemption never
triggers. The paged pool (``PagePool`` / ``PagedKVCache``) comes with
the paged slice.

Managers are pure host accounting; the device tensors stay in the
engine.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PageError", "KVCacheManager", "DenseSlotCache"]


class PageError(RuntimeError):
    """Cache accounting violation (double / foreign free, overdraw)."""


class KVCacheManager:
    """Slot + memory accounting for one (group, replica)'s KV cache.

    ``lengths`` mirrors each slot's context length on the host so the
    control plane never reads a device scalar.
    """

    n_slots: int
    lengths: np.ndarray  # [n_slots] int64 host context lengths

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError("need n_slots > 0")
        self.n_slots = n_slots
        self.slots: list[int | None] = [None] * n_slots  # rid per slot
        self.lengths = np.zeros(n_slots, np.int64)

    # -- capacity queries ------------------------------------------------
    def free_slots(self) -> int:
        return self.slots.count(None)

    def capacity_weight(self) -> int:
        """Router headroom weight (zero = full, attracts no new mass)."""
        raise NotImplementedError

    def fits(self, length: int) -> bool:
        """Could a ``length``-entry context EVER fit (empty replica)?"""
        raise NotImplementedError

    def can_reserve(self, length: int) -> bool:
        """Is a slot + memory for ``length`` entries available right now?"""
        raise NotImplementedError

    # -- lifecycle -------------------------------------------------------
    def reserve(self, rid: int, length: int) -> int:
        """Claim a slot plus memory covering ``length`` context entries
        (``length == 0``: the slot only — failover re-placement grows the
        memory lazily through :meth:`try_extend`). Returns the slot."""
        raise NotImplementedError

    def try_extend(self, rid: int, slot: int, length: int) -> bool:
        """Grow ``rid``'s claim to cover ``length`` entries. False = out
        of memory right now (the scheduler then preempts)."""
        raise NotImplementedError

    def release(self, rid: int, slot: int | None) -> None:
        """Return the slot and every entry owned by ``rid``."""
        raise NotImplementedError

    # -- introspection ---------------------------------------------------
    def held(self, rid: int) -> int:
        """Memory units (slots) currently owned by ``rid``."""
        raise NotImplementedError

    def check_conservation(self) -> None:
        """Raise unless free + allocated is exactly the capacity."""
        raise NotImplementedError

    # shared slot bookkeeping
    def _take_slot(self, rid: int) -> int:
        idx = self.slots.index(None)
        self.slots[idx] = rid
        self.lengths[idx] = 0
        return idx

    def _drop_slot(self, rid: int, slot: int | None) -> None:
        if slot is not None and self.slots[slot] == rid:
            self.slots[slot] = None
            self.lengths[slot] = 0


class DenseSlotCache(KVCacheManager):
    """The slot-stacked dense layout as a cache manager.

    Every slot implicitly reserves a ``max_len`` context, so memory can
    never run out mid-decode: ``try_extend`` only asserts the
    submit-time bound.
    """

    def __init__(self, n_slots: int, max_len: int):
        super().__init__(n_slots)
        self.max_len = max_len

    def capacity_weight(self) -> int:
        return self.free_slots()

    def fits(self, length: int) -> bool:
        return length <= self.max_len

    def can_reserve(self, length: int) -> bool:
        return length <= self.max_len and self.free_slots() > 0

    def reserve(self, rid: int, length: int) -> int:
        if not self.can_reserve(length):
            raise PageError(f"dense reserve of {length} entries refused")
        return self._take_slot(rid)

    def try_extend(self, rid: int, slot: int, length: int) -> bool:
        if length > self.max_len:
            raise PageError(
                f"rid {rid}: context {length} exceeds max_len {self.max_len} "
                "(submit should have rejected this request)"
            )
        return True

    def release(self, rid: int, slot: int | None) -> None:
        self._drop_slot(rid, slot)

    def held(self, rid: int) -> int:
        return sum(1 for r in self.slots if r == rid)

    def check_conservation(self) -> None:
        if self.free_slots() + sum(r is not None for r in self.slots) != self.n_slots:
            raise PageError("dense slot table corrupted")
