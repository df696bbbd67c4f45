"""Slot-indexed cache for the continuous-batching serve engine.

The port's copy of ``repro.serve.kvcache``. One preallocated cache
(``model.init_cache(batch, max_seq)``) backs a fixed pool of ``batch``
decode *slots*; the serve engine advances every slot with a single
``decode_step`` per token. :class:`SlotCache` owns the cache plus the
per-leaf batch-axis map (dense KV leaves are ``(L, B, S, KVH, hd)``, the
ssm state leaves ``(NG, B, H, ...)``: the slot axis is 1 in both),
discovered structurally by comparing ``init_cache(1)`` with
``init_cache(2)`` shapes on the ``meta`` device (the hybrid family's group
Mamba2 states ``(NG, ke, B, ...)`` have it at 2).

JAX's slot writers are jitted with donation; here every slot operation
writes the pool's tensors in place:

* :meth:`SlotCache.view`        — a batch-1 view of one slot, which prefill
  fills in place (the admission path: no copy of the slot).
* :meth:`SlotCache.write_prefill` — copy a batch-1 cache into one slot.
* :meth:`SlotCache.reset_slot`  — scrub a slot back to the initial cache.
* :meth:`SlotCache.read_slot`   — a batch-1 copy of one slot (tests).

The **paged** variant (:class:`PagedSlotCache`) keeps KV rows in fixed-size
pages drawn from one shared pool, with a slot→page table: a slot holds
only ``ceil(rows_written / page_size)`` pages, and its pages return to the
free list (:class:`PagePool`) the moment its request retires. The decode
step reads a dense view gathered through the table (``index_select``) and
the stepped view is scattered back (``index_copy_``); both are plain
indexing, as ``jnp.take`` and ``.at[].set`` are in the JAX package. Leaves
with no rows to page (recurrent state) stay dense per slot.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Cache = Tuple[torch.Tensor, ...]


def cache_bytes(cache: Cache) -> int:
    """Total bytes held by a cache (sum over leaves of size x itemsize)."""
    return sum(t.numel() * t.element_size() for t in cache)


def trim_report(cache: Cache) -> Dict[str, float]:
    """Human-readable cache footprint: leaf count + total GB."""
    return {"n_leaves": len(cache), "total_gb": cache_bytes(cache) / 1e9}


def _varying_axis(a, b, what: str):
    """The one axis along which two leaf shapes differ (None if none)."""
    cands = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
    if not cands:
        return None
    if len(cands) > 1:
        raise ValueError(f"ambiguous {what} axis for cache leaf {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    return cands[0]


def batch_axes(model, max_seq: int) -> Tuple:
    """Per-leaf batch-axis index of ``model.init_cache``'s leaves: the one
    axis whose length changes between ``init_cache(1, max_seq)`` and
    ``init_cache(2, max_seq)`` (shapes only, on the ``meta`` device). A leaf
    with no such axis maps to ``None`` (shared between slots)."""
    s1 = model.init_cache(1, max_seq, device="meta")
    s2 = model.init_cache(2, max_seq, device="meta")
    return tuple(_varying_axis(a, b, "batch") for a, b in zip(s1, s2))


class SlotCache:
    """A fixed pool of ``batch`` decode slots over one shared cache.

    ``cache`` is the live pair of tensors handed to ``decode_step``, which
    writes it in place.
    """

    def __init__(self, model, batch: int, max_seq: int):
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.axes = batch_axes(model, max_seq)
        self.cache = model.init_cache(batch, max_seq)

    def view(self, slot: int) -> Cache:
        """``slot``'s rows as a batch-1 cache that aliases the pool: what is
        written into it lands in the pool."""
        return tuple(t if ax is None else t.narrow(ax, slot, 1)
                     for t, ax in zip(self.cache, self.axes))

    def write_prefill(self, slot: int, one_cache: Cache) -> None:
        """Copy a batch-1 cache (``init_cache(1, max_seq)`` layout) into
        ``slot``'s rows of the pool."""
        for dst, src, ax in zip(self.view(slot), one_cache, self.axes):
            if ax is not None:
                dst.copy_(src)

    def reset_slot(self, slot: int) -> None:
        """Scrub ``slot`` back to the initial cache state (KV zeros, fresh
        ssm state). Not needed on the serve path: admission's prefill
        overwrites a slot's ssm state whole, and a slot's KV rows past its
        prompt are never read unmasked (see
        :class:`repro_torch.serve.engine.Engine`)."""
        self.write_prefill(slot, self.model.init_cache(1, self.max_seq))

    def read_slot(self, slot: int) -> Cache:
        """``slot`` as a batch-1 copy (tests and introspection)."""
        return tuple(t.clone() for t in self.view(slot))


def init_slots(model, batch: int, max_seq: int) -> SlotCache:
    """Allocate the serve engine's slot pool: one shared
    ``model.init_cache(batch, max_seq)`` plus its slot-axis map."""
    return SlotCache(model, batch, max_seq)


# ---------------------------------------------------------------------------
# Paged slot cache: fixed-size pages from a shared pool + slot→page table
# ---------------------------------------------------------------------------


def seq_axes(model, s_a: int = 8, s_b: int = 16) -> Tuple:
    """Per-leaf sequence-axis index of ``model.init_cache``'s leaves, found
    like :func:`batch_axes` by varying ``max_seq`` instead of ``batch``
    (shapes only, on the ``meta`` device). Leaves whose shape does not
    track ``max_seq`` (the ssm family's recurrent state) map to ``None``:
    they have no rows to page."""
    sa = model.init_cache(1, s_a, device="meta")
    sb = model.init_cache(1, s_b, device="meta")
    return tuple(_varying_axis(a, b, "sequence") for a, b in zip(sa, sb))


class OutOfPages(RuntimeError):
    """The shared KV page pool has no free page for a required allocation."""


class PagePool:
    """Deterministic host-side free-list allocator over ``n_pages`` pages.

    The free list is a LIFO stack seeded so the first allocations hand out
    pages 0, 1, 2, … and a freed page is the next one reused, so paged
    serving replays bit for bit. Invariants: :meth:`alloc` never returns a
    page that is already held, :meth:`free` rejects pages that are not held
    (double free), and ``n_free + n_held == n_pages`` at every point.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"page pool needs >= 1 page, got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._held: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_held(self) -> int:
        return len(self._held)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(
                f"all {self.n_pages} KV pages are allocated; retire a "
                "request or build the cache with more pool_pages")
        page = self._free.pop()
        if page in self._held:  # allocator corruption — never expected
            raise AssertionError(f"free list handed out held page {page}")
        self._held.add(page)
        return page

    def free(self, page: int) -> None:
        if page not in self._held:
            raise ValueError(f"page {page} is not currently allocated (double free?)")
        self._held.remove(page)
        self._free.append(page)


class PagedSlotCache:
    """A paged drop-in for :class:`SlotCache`: KV rows live in fixed-size
    pages drawn from one shared pool, and each slot maps to its pages
    through a table (host copy ``table_host``, device copy ``table``).

    * ``pool_pages`` (default ``batch * ceil(max_seq / page_size)``, full
      provisioning) bounds the *resident* KV footprint: a slot allocates
      pages as rows are written (:meth:`ensure_rows`).
    * A leaf of the pool is the model's leaf with the slot and
      sequence axes replaced by ``(pool_pages + 1, page_size)``; the last
      page is the *zero page*, which every unallocated table entry points
      at and nothing ever writes. So :meth:`gather_dense` — one
      ``index_select`` through the table — reads zeros wherever a row has
      no page, as a contiguous cache reads its initial zeros: the view is
      **bitwise** a :class:`SlotCache` holding the same writes.
    * :meth:`scatter_dense` writes a stepped view back into the slots'
      allocated pages only (one ``index_copy_``; the zero page and free
      pages are never written).
    * :meth:`write_prefill` writes a prefilled batch-1 cache (of any length
      up to ``max_seq``) into the slot's pages, zeros past its rows.

    Only the leaves whose sequence axis follows their slot axis are paged
    (every KV layout of the port). The others (the hybrid family's Mamba2
    states) stay dense per slot, as the reference keeps them: the pool
    holds the leaf repeated along its slot axis, :meth:`write_prefill`
    writes it at the slot, :meth:`gather_dense` passes it through (the
    decode step then updates it in place) and :meth:`scatter_dense` writes
    a stepped copy back. A model with no ``max_seq``-scaling leaf (the ssm
    family) is refused.
    """

    def __init__(self, model, batch: int, max_seq: int, page_size: int, *,
                 pool_pages: Optional[int] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if not 1 <= page_size <= max_seq:
            raise ValueError(f"page_size must be in [1, max_seq={max_seq}], got {page_size}")
        self.batch = batch
        self.max_seq = max_seq
        self.page_size = page_size
        self.pages_per_slot = -(-max_seq // page_size)
        if pool_pages is None:
            pool_pages = batch * self.pages_per_slot
        if pool_pages < self.pages_per_slot:
            raise ValueError(f"pool_pages={pool_pages} cannot hold even one full slot "
                             f"({self.pages_per_slot} pages)")
        self.pool_pages = pool_pages
        self._zero_page = pool_pages  # unallocated table entries point here

        shapes = model.init_cache(1, max_seq, device="meta")
        self._b_ax = batch_axes(model, max_seq)
        s_axes = seq_axes(model)
        self._paged = []
        for shp, b_ax, s_ax in zip(shapes, self._b_ax, s_axes):
            if s_ax is None or b_ax is None:
                self._paged.append(False)
                continue
            if s_ax != b_ax + 1:
                raise NotImplementedError(
                    "paged cache needs the sequence axis immediately after the slot axis; "
                    f"leaf {tuple(shp.shape)} has batch axis {b_ax} and sequence axis {s_ax}")
            self._paged.append(True)
        if not any(self._paged):
            raise ValueError("model cache has no max_seq-scaling leaves to page; use the "
                             "contiguous SlotCache")
        template = model.init_cache(1, max_seq)
        # the zero page stands for the initial cache, so the initial KV must
        # be zeros
        if any(leaf.any() for leaf, paged in zip(template, self._paged) if paged):
            raise ValueError("pageable cache leaf has a nonzero template; the paged "
                             "gather's zero page for unallocated rows assumes KV zeros")
        pool = []
        for leaf, b_ax, paged in zip(template, self._b_ax, self._paged):
            if not paged:  # dense per slot (a leaf with no slot axis is shared)
                pool.append(leaf if b_ax is None else
                            leaf.repeat_interleave(batch, dim=b_ax).contiguous())
                continue
            shp = list(leaf.shape)
            shp[b_ax], shp[b_ax + 1] = pool_pages + 1, page_size
            pool.append(torch.zeros(shp, dtype=leaf.dtype, device=leaf.device))
        self.pool: Cache = tuple(pool)
        self.device = template[0].device
        self.table_host = np.full((batch, self.pages_per_slot), self._zero_page, np.int64)
        self.allocator = PagePool(pool_pages)
        self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
        self._sync_table()

    def _sync_table(self) -> None:
        """Copy the host table to the device, with the index pair the
        scatter uses: the flat (slot, page-of-slot) positions that hold a
        page, and those pages."""
        flat = self.table_host.reshape(-1)
        held = np.flatnonzero(flat != self._zero_page)
        self.table = torch.as_tensor(self.table_host, device=self.device)
        self._held_src = torch.as_tensor(held, device=self.device)
        self._held_dst = torch.as_tensor(flat[held], device=self.device)

    # -------------------- pool <-> dense views --------------------
    def gather_dense(self) -> Cache:
        """The dense ``init_cache(batch, max_seq)`` view of the pool, each
        paged leaf gathered through the table (rows without a page read the
        zero page); a dense-per-slot leaf is the pool's own tensor."""
        B, P, ps, S = self.batch, self.pages_per_slot, self.page_size, self.max_seq
        flat = self.table.reshape(-1)
        out = []
        for p, b_ax, paged in zip(self.pool, self._b_ax, self._paged):
            if not paged:
                out.append(p)
                continue
            g = p.index_select(b_ax, flat)  # (..., B*P, ps, ...)
            g = g.reshape(g.shape[:b_ax] + (B, P * ps) + g.shape[b_ax + 2:])
            if P * ps != S:
                g = g.narrow(b_ax + 1, 0, S).contiguous()
            out.append(g)
        return tuple(out)

    def scatter_dense(self, dense: Cache) -> None:
        """Write a (stepped) dense view back into the slots' allocated
        pages. Rows without a page are dropped: the engine backs every row
        a decode step writes (:meth:`ensure_rows`) first. A dense-per-slot
        leaf is copied back whole (nothing to do when the view is the
        pool's own tensor, which the decode step updated in place)."""
        B, P, ps, S = self.batch, self.pages_per_slot, self.page_size, self.max_seq
        for p, d, b_ax, paged in zip(self.pool, dense, self._b_ax, self._paged):
            if not paged:
                if d is not p:
                    p.copy_(d)
                continue
            if P * ps != S:
                pad = list(d.shape)
                pad[b_ax + 1] = P * ps - S
                d = torch.cat([d, d.new_zeros(pad)], dim=b_ax + 1)
            d = d.reshape(d.shape[:b_ax] + (B * P, ps) + d.shape[b_ax + 2:])
            p.index_copy_(b_ax, self._held_dst, d.index_select(b_ax, self._held_src).to(p.dtype))

    # -------------------- host-side page accounting --------------------
    def pages_needed(self, rows: int) -> int:
        """Pages required to back ``rows`` cache rows."""
        return -(-max(rows, 0) // self.page_size)

    def pages_held(self, slot: int) -> int:
        return len(self._slot_pages[slot])

    def ensure_rows(self, slot: int, rows: int) -> int:
        """Allocate pages so rows ``[0, rows)`` of ``slot`` are backed.
        Returns the number of pages newly allocated. Raises
        :class:`OutOfPages` when the pool is exhausted (the engine's
        reservation-based admission makes this unreachable in serving)."""
        if rows > self.max_seq:
            raise ValueError(f"slot {slot} needs {rows} rows but max_seq={self.max_seq}")
        held = self._slot_pages[slot]
        need = self.pages_needed(rows)
        grew = 0
        while len(held) < need:
            page = self.allocator.alloc()
            self.table_host[slot, len(held)] = page
            held.append(page)
            grew += 1
        if grew:
            self._sync_table()
        return grew

    def free_slot(self, slot: int) -> None:
        """Return all of ``slot``'s pages to the free list (at retirement)."""
        for page in self._slot_pages[slot]:
            self.allocator.free(page)
        self._slot_pages[slot] = []
        self.table_host[slot, :] = self._zero_page
        self._sync_table()

    # -------------------- SlotCache-compatible surface --------------------
    def write_prefill(self, slot: int, one_cache: Cache) -> None:
        """Install a prefilled batch-1 cache into ``slot``: its rows
        ``[0, n)`` (``n`` its sequence length, at most ``max_seq``) and
        zeros after them, into every page the slot holds; rows past the
        slot's pages are dropped; and its dense-per-slot leaves at the slot.
        The caller backs the prompt's rows with :meth:`ensure_rows` first."""
        held = self._slot_pages[slot]
        ps = self.page_size
        ids = torch.as_tensor(held, device=self.device)
        for p, o, b_ax, paged in zip(self.pool, one_cache, self._b_ax, self._paged):
            if not paged:
                if b_ax is not None:
                    p.narrow(b_ax, slot, 1).copy_(o)
                continue
            if not held:
                continue
            shp = list(o.shape)
            n = min(shp[b_ax + 1], len(held) * ps)
            shp[b_ax], shp[b_ax + 1] = len(held), ps
            chunk = p.new_zeros(shp)
            flat = chunk.view(shp[:b_ax] + [len(held) * ps] + shp[b_ax + 2:])
            flat.narrow(b_ax, 0, n).copy_(o.select(b_ax, 0).narrow(b_ax, 0, n))
            p.index_copy_(b_ax, ids, chunk)

    def read_slot(self, slot: int) -> Cache:
        """``slot`` as a batch-1 copy of the dense view (tests)."""
        return tuple(t.narrow(ax, slot, 1).clone()
                     for t, ax in zip(self.gather_dense(), self._b_ax))


def init_paged_slots(model, batch: int, max_seq: int, page_size: int, *,
                     pool_pages: Optional[int] = None) -> PagedSlotCache:
    """Allocate a paged slot pool (see :class:`PagedSlotCache`)."""
    return PagedSlotCache(model, batch, max_seq, page_size, pool_pages=pool_pages)
