"""Paged KV cache for the serving engine.

The port of :mod:`distkeras_tpu.serving.cache`.  ``TransformerLM``'s decode
cache is *request-shaped*: one contiguous ``[batch, max_len, heads,
head_dim]`` buffer per request batch.  A serving engine admitting and
retiring requests mid-flight needs the vLLM formulation instead: K/V live in
fixed **pools of pages** shared by every slot, and each slot owns a small
*page table* mapping its logical context chunks to physical pages.
Admission allocates pages, retirement frees them — the pools themselves
never change shape or storage, so every decode step sees the same tensors.

Layout::

    k_pages, v_pages : [num_layers, num_pages, page_size, heads, head_dim]
                       (tensors on the engine's device)
    tables           : [num_slots, pages_per_slot] int32 (host, numpy)

Physical page 0 is a reserved **scratch page**: unallocated table entries
and inactive slots point at it, so masked-off lanes of the decode step write
garbage there instead of corrupting live pages.  Attention masks by position
(``key_pos <= pos``), so scratch garbage is never read.

The engine updates the pools in place (as the reference donates them
through its jitted step); this class owns the *bookkeeping*: free-list,
per-slot tables, alloc/free, all host-side.
"""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.parallel.mesh import resolve_device

__all__ = ["PagedKVCache", "append_rows", "rollback_rows"]


# ------------------------------------------------------- device pool writes
#
# The two functions below are the device-side companions to the host-side
# bookkeeping: they scatter token rows into (or out of) the pools through a
# slot's page table, in place.  ``append_rows`` generalises the decode step's
# one-row write to the ``m``-row window a speculative verify feeds;
# ``rollback_rows`` erases the rejected suffix of that window so the pools
# only ever hold accepted-token K/V between engine iterations.


def _physical(tables, pos, m: int, page_size: int):
    """Logical positions ``pos + 0 .. pos + m-1`` of each slot ``[slots,
    m]`` and the physical pages holding them (clamped table lookups)."""
    pages_per_slot = tables.shape[1]
    offs = torch.arange(m, device=pos.device)[None, :]
    logical = pos[:, None].long() + offs
    page_ix = torch.clamp(logical // page_size, 0, pages_per_slot - 1)
    phys = torch.gather(tables.long(), 1, page_ix)
    return offs, logical, phys


def append_rows(pool, layer, tables, pos, rows):
    """Scatter ``rows [slots, m, heads, head_dim]`` into ``pool`` at logical
    positions ``pos + 0 .. pos + m-1`` of each slot, through ``tables
    [slots, pages_per_slot]``, in place; returns ``pool``.  Positions at or
    past a slot's capacity (``pages_per_slot * page_size``) are redirected
    to the scratch page, so a speculative window overhanging the end of
    context can never clobber another slot's pages."""
    page_size = pool.shape[2]
    _, logical, phys = _physical(tables, pos, rows.shape[1], page_size)
    phys = torch.where(logical < tables.shape[1] * page_size, phys, 0)
    pool[layer, phys, logical % page_size] = rows.to(pool.dtype)
    return pool


def rollback_rows(pool, layer, tables, pos, count, m):
    """Zero the rejected suffix of an ``m``-row verify window: rows
    ``pos + count .. pos + m-1`` of each slot, in place; returns ``pool``.
    Kept rows (and overhang past capacity) are redirected to the scratch
    page, where the zero-write is harmless.  Attention masks ``key_pos <=
    pos`` and every later write window starts at the live position, so
    stale rows would be overwritten before they could be attended — zeroing
    them keeps the pools' invariant ("only accepted tokens between
    iterations") checkable."""
    page_size = pool.shape[2]
    offs, logical, phys = _physical(tables, pos, m, page_size)
    rejected = (offs >= count[:, None]) & (logical < tables.shape[1] * page_size)
    phys = torch.where(rejected, phys, 0)
    zeros = torch.zeros((pos.shape[0], m) + tuple(pool.shape[3:]), dtype=pool.dtype,
                        device=pool.device)
    pool[layer, phys, logical % page_size] = zeros
    return pool


class PagedKVCache:
    """Page-table bookkeeping plus the pooled K/V buffers.

    ``pages_per_slot`` rows of the table bound each slot's context to
    ``pages_per_slot * page_size`` tokens; ``num_pages`` bounds the fleet of
    pages (default: enough for every slot at full context, plus the scratch
    page — i.e. no over-subscription unless the caller asks for it).
    The pools are allocated on ``device``: the card by default (raising
    without one); pass ``device="cpu"`` for the CPU.
    """

    def __init__(self, *, num_layers, num_slots, page_size, pages_per_slot,
                 heads, head_dim, num_pages=None, dtype=torch.float32, device="cuda"):
        if page_size < 1 or pages_per_slot < 1 or num_slots < 1:
            raise ValueError("page_size, pages_per_slot, num_slots must be >= 1")
        self.num_layers = int(num_layers)
        self.num_slots = int(num_slots)
        self.page_size = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        if num_pages is None:
            num_pages = num_slots * pages_per_slot + 1  # +1 scratch
        if num_pages < 2:
            raise ValueError("need at least one real page beyond scratch")
        self.num_pages = int(num_pages)
        shape = (self.num_layers, self.num_pages, self.page_size,
                 int(heads), int(head_dim))
        device = resolve_device(device)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)
        # host-side: table rows point at scratch (page 0) until allocated
        self.tables = np.zeros((self.num_slots, self.pages_per_slot), np.int32)
        # LIFO free list over physical pages 1..num_pages-1 (0 = scratch)
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._owned = {s: [] for s in range(self.num_slots)}

    # ------------------------------------------------------------- queries

    def pages_needed(self, length: int) -> int:
        """Pages required to hold ``length`` tokens of context."""
        return -(-int(length) // self.page_size)  # ceil div

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def max_context(self) -> int:
        """Tokens a single slot can hold: its table rows times page size."""
        return self.pages_per_slot * self.page_size

    # ------------------------------------------------------- alloc / free

    def alloc(self, slot: int, n: int) -> None:
        """Give ``slot`` ``n`` physical pages (admission).  Raises when the
        pool is dry or the slot's table would overflow — the engine checks
        :meth:`can_alloc` first, so hitting either is a bookkeeping bug."""
        owned = self._owned[slot]
        if len(owned) + n > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {len(owned)}+{n} pages exceeds table size "
                f"{self.pages_per_slot}"
            )
        if n > len(self._free):
            raise ValueError(f"page pool dry: want {n}, have {len(self._free)}")
        for _ in range(n):
            page = self._free.pop()
            self.tables[slot, len(owned)] = page
            owned.append(page)

    def free(self, slot: int) -> int:
        """Return every page ``slot`` owns to the pool (retirement); the
        slot's table rows point back at scratch.  Returns the count freed."""
        owned = self._owned[slot]
        n = len(owned)
        while owned:
            self._free.append(owned.pop())
        self.tables[slot, :] = 0
        return n
