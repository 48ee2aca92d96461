"""KV-cache managers: slot + memory accounting for the serving fleet.

The serving control plane (:mod:`.scheduler`) never branches on cache
layout: every (group, replica) owns one :class:`KVCacheManager` that
answers the same questions — can this context ever fit? can it be
reserved now? grow it? release it? how much headroom is left for the
router? Two implementations, as in the JAX package:

* :class:`DenseSlotCache` — ``max_batch`` per-request slots, each
  implicitly reserving a full ``max_len`` context, so ``try_extend``
  never fails and preemption never triggers.
* :class:`PagedKVCache` — a :class:`PagePool` of fixed-size pages plus
  the per-slot block tables that name them. Reservations are
  ``ceil(context / page_size)`` pages, growth can fail (the scheduler
  then preempts the youngest resident), and the router weight is free
  pages instead of free slots.

Managers are pure host accounting; the device tensors stay in the
engine, apart from the paged manager's device copy of its block table.

Invariants: conservation (``free + allocated == capacity``) and
exclusivity (a page or slot has at most one owner; double and foreign
frees raise instead of corrupting the pool).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "PageError",
    "PagePool",
    "KVCacheManager",
    "DenseSlotCache",
    "PagedKVCache",
    "kv_page_bytes",
]


def kv_page_bytes(
    page_size: int,
    n_kv_heads: int,
    head_dim: int,
    n_layers: int,
    kv_dtype: str = "float32",
) -> int:
    """Bytes one page costs across the K and V pools of every layer.

    int8 pages carry one fp32 scale per page row per pool, so an int8
    page costs ``page_size * (n_kv_heads * head_dim + 4)`` bytes per pool
    per layer instead of ``page_size * n_kv_heads * head_dim * itemsize``.
    """
    dtype = getattr(torch, kv_dtype)
    per_pool = page_size * n_kv_heads * head_dim * dtype.itemsize
    if dtype == torch.int8:
        per_pool += page_size * 4  # fp32 per-row scale
    return 2 * n_layers * per_pool


class PageError(RuntimeError):
    """Cache accounting violation (double / foreign free, overdraw)."""


@dataclasses.dataclass
class PagePool:
    """Fixed-size page allocator for one replica's KV pool.

    Pages are plain indices into the device pool tensors; index
    ``n_pages`` (one past the end) is the reserved scratch page and is
    never handed out.
    """

    n_pages: int
    page_size: int

    def __post_init__(self) -> None:
        if self.n_pages <= 0 or self.page_size <= 0:
            raise ValueError("need n_pages > 0 and page_size > 0")
        # LIFO free list, lowest indices first: allocation order is
        # deterministic, so seeded serving runs reproduce.
        self._free: list[int] = list(range(self.n_pages - 1, -1, -1))
        self._owner: dict[int, int] = {}  # page -> rid

    @property
    def scratch(self) -> int:
        return self.n_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._owner)

    def blocks_for(self, length: int) -> int:
        """Pages needed to hold ``length`` cache entries (min 1)."""
        return max(1, -(-int(length) // self.page_size))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, rid: int) -> list[int]:
        if n > len(self._free):
            raise PageError(f"pool overdraw: want {n}, have {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owner[p] = rid
        return pages

    def free(self, pages: list[int], rid: int) -> None:
        for p in pages:
            owner = self._owner.get(p)
            if owner is None:
                raise PageError(f"double free of page {p} (rid {rid})")
            if owner != rid:
                raise PageError(f"foreign free of page {p}: owned by {owner}, freed by {rid}")
            del self._owner[p]
            self._free.append(p)

    def check_conservation(self) -> None:
        """Raise unless free + allocated is exactly the pool, disjointly."""
        free = set(self._free)
        used = set(self._owner)
        if len(free) != len(self._free):
            raise PageError("free list contains duplicates")
        if free & used:
            raise PageError(f"pages both free and owned: {sorted(free & used)}")
        if free | used != set(range(self.n_pages)):
            missing = set(range(self.n_pages)) - (free | used)
            raise PageError(f"pages leaked: {sorted(missing)}")


class KVCacheManager:
    """Slot + memory accounting for one (group, replica)'s KV cache.

    ``lengths`` mirrors each slot's context length on the host so the
    control plane and the chunked-prefill offsets never read a device
    scalar.
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

    def rollback(self, rid: int, slot: int, n: int) -> None:
        """Un-write the last ``n`` entries of ``rid``'s context (the
        rejected draft rows of a speculative round). Host accounting only:
        the device rows stay written but lie past the length mirror, which
        every consumer reads positions from, and the next call re-writes
        them before anything attends them. Dense: a length decrement;
        paged: that plus freeing the tail pages the shorter context no
        longer touches."""
        raise NotImplementedError

    def release(self, rid: int, slot: int | None) -> None:
        """Return the slot and every entry owned by ``rid``."""
        raise NotImplementedError

    # -- introspection ---------------------------------------------------
    def held(self, rid: int) -> int:
        """Memory units (pages / slots) currently owned by ``rid``."""
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

    def _check_rollback(self, rid: int, slot: int, n: int) -> None:
        if self.slots[slot] != rid:
            raise PageError(f"rollback of slot {slot} not owned by rid {rid}")
        if n < 0 or n > self.lengths[slot]:
            raise PageError(
                f"rid {rid}: rollback of {n} entries from a {self.lengths[slot]}-entry context"
            )

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

    def rollback(self, rid: int, slot: int, n: int) -> None:
        self._check_rollback(rid, slot, n)
        self.lengths[slot] -= n

    def release(self, rid: int, slot: int | None) -> None:
        self._drop_slot(rid, slot)

    def held(self, rid: int) -> int:
        return sum(1 for r in self.slots if r == rid)

    def check_conservation(self) -> None:
        if self.free_slots() + sum(r is not None for r in self.slots) != self.n_slots:
            raise PageError("dense slot table corrupted")


class PagedKVCache(KVCacheManager):
    """Page-pool accounting plus the block tables that address it.

    Owns the host block table ``[n_slots, nb_max]`` (rows of physical
    page ids, scratch-padded) and a device copy on ``device``, an int32
    tensor refreshed only when a row changes (page alloc or free), so
    the decode loop reuses one tensor.

    A context of zero entries holds zero pages, whichever way it got
    there: ``reserve(rid, 0)``, ``rollback`` to length 0, and
    ``try_extend(rid, slot, 0)`` alike. (The JAX package's
    ``try_extend`` allocates one page for length 0; the serving path
    never asks for it — every ``ensure_capacity`` needs at least one
    entry — so the token streams are the same.)
    """

    def __init__(
        self, n_slots: int, max_len: int, page_size: int, n_pages: int,
        kv_dtype: str | None = None, table_buffers: int = 2,
        device: str | torch.device = "cpu",
    ):
        super().__init__(n_slots)
        self.max_len = max_len
        # Page dtype for introspection and page math only: accounting is
        # in pages, whatever an entry costs.
        self.kv_dtype = kv_dtype
        self.pool = PagePool(n_pages, page_size)
        self.page_size = page_size
        self.nb_max = -(-max_len // page_size)  # block-table row width
        self.pages: dict[int, list[int]] = {}  # rid -> physical pages
        self.block_table = np.full((n_slots, self.nb_max), n_pages, np.int32)
        # Snapshot ring behind the device copy: each refresh copies the
        # working table into the next host buffer, so a call still in
        # flight that reads an earlier snapshot (zero-copy on the CPU)
        # never sees it change. The engine sizes it to its ring depth + 1.
        if table_buffers < 2:
            raise ValueError("table_buffers must be >= 2 (double buffering)")
        self.table_buffers = table_buffers
        self._snapshots = [
            np.full((n_slots, self.nb_max), n_pages, np.int32) for _ in range(table_buffers)
        ]
        self._snap_idx = 0
        self._bt_dev: torch.Tensor | None = None  # device copy, None = stale
        self.device = torch.device(device)

    # -- capacity --------------------------------------------------------
    def capacity_weight(self) -> int:
        # A replica with no free slot is full regardless of free pages.
        return 0 if self.free_slots() == 0 else self.pool.free_pages

    def fits(self, length: int) -> bool:
        return length <= self.max_len and self.pool.blocks_for(length) <= self.pool.n_pages

    def can_reserve(self, length: int) -> bool:
        return (
            self.fits(length)
            and self.free_slots() > 0
            and self.pool.can_alloc(self.pool.blocks_for(length))
        )

    # -- lifecycle -------------------------------------------------------
    def reserve(self, rid: int, length: int) -> int:
        if length > 0 and not self.pool.can_alloc(self.pool.blocks_for(length)):
            raise PageError(f"paged reserve of {length} entries refused")
        slot = self._take_slot(rid)
        self.pages[rid] = self.pool.alloc(self.pool.blocks_for(length), rid) if length > 0 else []
        self._set_row(slot, self.pages[rid])
        return slot

    def try_extend(self, rid: int, slot: int, length: int) -> bool:
        held = self.pages.setdefault(rid, [])
        need = self.pool.blocks_for(length) if length > 0 else 0
        if need > self.nb_max:
            raise PageError(
                f"rid {rid}: context {length} exceeds the block-table row ({self.nb_max} pages)"
            )
        grown = False
        while len(held) < need:
            if not self.pool.can_alloc(1):
                if grown:
                    self._set_row(slot, held)
                return False
            held.extend(self.pool.alloc(1, rid))
            grown = True
        if grown:
            self._set_row(slot, held)
        return True

    def rollback(self, rid: int, slot: int, n: int) -> None:
        self._check_rollback(rid, slot, n)
        new_len = int(self.lengths[slot]) - n
        self.lengths[slot] = new_len
        if n == 0:
            return
        held = self.pages.get(rid, [])
        need = self.pool.blocks_for(new_len) if new_len > 0 else 0
        if len(held) > need:
            tail = held[need:]
            del held[need:]
            self.pool.free(tail, rid)
            self._set_row(slot, held)

    def release(self, rid: int, slot: int | None) -> None:
        held = self.pages.pop(rid, [])
        if held:
            self.pool.free(held, rid)
        if slot is not None and self.slots[slot] == rid:
            # Freed lanes must never alias live pages: scratch the row.
            self._set_row(slot, [])
        self._drop_slot(rid, slot)

    # -- block tables ----------------------------------------------------
    def _set_row(self, slot: int, pages: list[int]) -> None:
        row = self.block_table[slot]
        row[:] = self.pool.scratch
        row[: len(pages)] = pages
        self._bt_dev = None

    def device_block_table(self) -> torch.Tensor:
        """The block table on ``device`` as int32, refreshed only after a
        row changed. Each refresh rotates to the next snapshot buffer
        before copying the working table."""
        if self._bt_dev is None:
            self._snap_idx = (self._snap_idx + 1) % self.table_buffers
            buf = self._snapshots[self._snap_idx]
            np.copyto(buf, self.block_table)
            self._bt_dev = torch.from_numpy(buf).to(self.device)
        return self._bt_dev

    # -- introspection ---------------------------------------------------
    def held(self, rid: int) -> int:
        return len(self.pages.get(rid, ()))

    def check_conservation(self) -> None:
        self.pool.check_conservation()
        held = [p for pages in self.pages.values() for p in pages]
        if len(held) != len(set(held)):
            raise PageError("page owned by two requests")
        if self.pool.used_pages != len(held):
            raise PageError(
                f"pool accounts {self.pool.used_pages} pages but managers hold {len(held)}"
            )
        # Working rows name exactly their rid's pages (scratch-padded), and
        # the snapshot behind the live device copy matches the working
        # table: a stale one would let a later call read freed pages.
        for slot, rid in enumerate(self.slots):
            row = self.block_table[slot]
            pages = self.pages.get(rid, []) if rid is not None else []
            if list(row[: len(pages)]) != pages or not (row[len(pages):] == self.pool.scratch).all():
                raise PageError(f"block-table row {slot} does not match rid {rid}'s pages")
        if self._bt_dev is not None:
            live = self._snapshots[self._snap_idx]
            if not np.array_equal(live, self.block_table):
                raise PageError(
                    "live device block-table snapshot is stale "
                    "(working table changed without invalidation)"
                )
