"""Host-side page allocator for the paged KV cache (a copy of
``repro/serve/kv/pool.py``; its validation mode runs
``repro_torch.analysis.paging``).

The device arrays hold ``n_pages + 1`` pages per cache leaf; this module
owns *which request holds which page*.  All accounting is exact: a page is
either on the free list or held by exactly one slot, ``free`` of a page
that is not held raises, and reuse order is deterministic (LIFO — the most
recently freed page is reallocated first, which keeps traces and tests
reproducible and is friendly to whatever allocator cache sits below).

The extra page at index ``n_pages`` is the **null page**: page-table
entries beyond a slot's allocation point at it, so the decode program's
scatter-writes from freed or still-prefilling batch rows land in a
sacrificial page instead of corrupting a neighbour's KV.  It is never
allocated and never counted.
"""

from __future__ import annotations


class PoolExhausted(RuntimeError):
    """Raised when an allocation asks for more pages than are free."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` tokens (ceil division)."""
    if n_tokens < 0:
        raise ValueError(f"negative token count {n_tokens}")
    return -(-n_tokens // page_size)


class PagePool:
    """Exact accounting for ``n_pages`` fixed-size KV pages.

    ``alloc(n)`` pops ``n`` page ids (all-or-nothing: raises
    :class:`PoolExhausted` without side effects when fewer are free),
    ``free(pages)`` returns them.  ``null_page`` is the sacrificial page
    id (``== n_pages``); device cache leaves are sized ``n_pages + 1`` on
    the page axis to hold it.
    """

    def __init__(self, n_pages: int, page_size: int) -> None:
        if n_pages < 1:
            raise ValueError("need at least one page")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.null_page = n_pages
        # LIFO free list; start ordered so page 0 is allocated first
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._held: set[int] = set()
        self.peak_used = 0

    # -- queries ---------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._held)

    @property
    def token_capacity(self) -> int:
        """Total resident-token bound of the pool."""
        return self.n_pages * self.page_size

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    # -- transitions -----------------------------------------------------------
    def alloc(self, n: int) -> list[int]:
        if n < 0:
            raise ValueError(f"negative page count {n}")
        if n > len(self._free):
            raise PoolExhausted(
                f"asked for {n} pages with {len(self._free)} free "
                f"(pool: {self.n_pages} x {self.page_size} tokens)"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._held.update(pages)
        self.peak_used = max(self.peak_used, len(self._held))
        return pages

    def free(self, pages: "list[int]") -> None:
        for page in pages:
            if page not in self._held:
                raise ValueError(
                    f"freeing page {page} that is not held "
                    "(double free or foreign page)"
                )
            self._held.discard(page)
            self._free.append(page)

    def check_leaks(self) -> None:
        """Raise if accounting ever drifted (a test/debug hook)."""
        if len(self._free) + len(self._held) != self.n_pages:
            raise AssertionError(
                f"page accounting drift: {len(self._free)} free + "
                f"{len(self._held)} held != {self.n_pages}"
            )


class PageTable:
    """Per-slot page lists and resident-token lengths over a :class:`PagePool`.

    The table is the indirection the paged decode program reads K/V
    through: :meth:`array` materialises it as the ``(n_slots, max_pages)``
    int32 operand (entries beyond a slot's allocation point at the null
    page), and the engine re-uploads it only when an admission, append or
    eviction changed it (:attr:`version`).

    ``lengths[slot]`` tracks tokens actually resident (for stranded /
    fragmentation stats); the capacity of a slot is
    ``len(pages[slot]) * page_size``.
    """

    def __init__(
        self,
        n_slots: int,
        max_pages: int,
        pool: PagePool,
        validate: bool = False,
    ) -> None:
        if max_pages < 1:
            raise ValueError("max_pages must be >= 1")
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.pool = pool
        #: run :meth:`check_invariants` after every mutation — the runtime
        #: assertion mode of the ``repro_torch.analysis.paging`` sanitizer
        self.validate = validate
        self._pages: list[list[int]] = [[] for _ in range(n_slots)]
        self.lengths: list[int] = [0] * n_slots
        #: bumped on every page-list mutation — consumers (the engine's
        #: decode operand) cache ``array()`` per version, so steady-state
        #: decode steps don't rebuild or re-upload an unchanged table
        self.version = 0
        self._array_cache: tuple[int, "object"] | None = None

    # -- views -----------------------------------------------------------------
    def array(self):
        """(n_slots, max_pages) int32 page-id operand (null-page filled);
        cached until the next page-list mutation."""
        import numpy as np

        if self._array_cache is not None and (
            self._array_cache[0] == self.version
        ):
            return self._array_cache[1]
        out = np.full(
            (self.n_slots, self.max_pages), self.pool.null_page, np.int32
        )
        for slot, pages in enumerate(self._pages):
            out[slot, : len(pages)] = pages
        out.setflags(write=False)
        self._array_cache = (self.version, out)
        return out

    def slot_pages(self, slot: int) -> "list[int]":
        return list(self._pages[slot])

    def capacity(self, slot: int) -> int:
        """Tokens the slot's allocated pages can hold."""
        return len(self._pages[slot]) * self.pool.page_size

    def pages_needed(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.pool.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pool.can_alloc(self.pages_needed(n_tokens))

    # -- transitions -----------------------------------------------------------
    def alloc_slot(self, slot: int, n_tokens: int) -> "list[int]":
        """Give a fresh slot pages for ``n_tokens`` tokens (admission)."""
        if self._pages[slot]:
            raise ValueError(f"slot {slot} already holds pages")
        n = self.pages_needed(n_tokens)
        if n > self.max_pages:
            raise ValueError(
                f"{n_tokens} tokens need {n} pages "
                f"> max_pages {self.max_pages}"
            )
        pages = self.pool.alloc(n)
        self._pages[slot] = pages
        self.lengths[slot] = n_tokens
        self.version += 1
        self._check()
        return pages

    def ensure(self, slot: int, n_tokens: int) -> "list[int]":
        """Append pages until the slot holds capacity for ``n_tokens``;
        returns the newly allocated page ids (may be empty).  Raises
        :class:`PoolExhausted` (no partial allocation) when the pool
        cannot cover the growth — the engine's preemption hook."""
        need = self.pages_needed(n_tokens) - len(self._pages[slot])
        if self.pages_needed(n_tokens) > self.max_pages:
            raise ValueError(
                f"{n_tokens} tokens exceed the slot's max_pages "
                f"({self.max_pages} x {self.pool.page_size})"
            )
        added = self.pool.alloc(max(need, 0))
        if added:
            self._pages[slot].extend(added)
            self.version += 1
        self.lengths[slot] = n_tokens
        self._check()
        return added

    def free_slot(self, slot: int) -> int:
        """Evict: return every page to the pool; returns how many."""
        pages = self._pages[slot]
        n = len(pages)
        self.pool.free(pages)
        self._pages[slot] = []
        self.lengths[slot] = 0
        if n:
            self.version += 1
        self._check()
        return n

    # -- invariants --------------------------------------------------------------
    def _check(self) -> None:
        if self.validate:
            self.check_invariants()

    def check_invariants(self) -> None:
        """Prove the table safe for the paged scatter/gather programs:
        pool accounting exact, held pages exactly the union of slot page
        lists, and the ``repro_torch.analysis.paging`` static checks (no page
        aliasing, no out-of-range ids, page counts cover lengths) clean.
        Raises :class:`repro_torch.analysis.paging.PageAliasError` otherwise —
        the runtime assertion mode behind ``validate=True``."""
        from repro_torch.analysis.paging import PageAliasError, check_page_table

        self.pool.check_leaks()
        held: set[int] = set()
        for slot, pages in enumerate(self._pages):
            for page in pages:
                if page in held:
                    break  # reported precisely by check_page_table below
                held.add(page)
        if held != self.pool._held:
            raise PageAliasError(
                f"table/pool drift: table rows name {sorted(held)} but the "
                f"pool holds {sorted(self.pool._held)}"
            )
        problems = [
            d for d in check_page_table(self)
            if d.severity in ("error", "warning")
        ]
        if problems:
            raise PageAliasError("; ".join(str(d) for d in problems))

    # -- stats -----------------------------------------------------------------
    @property
    def resident_tokens(self) -> int:
        return sum(self.lengths)

    @property
    def allocated_tokens(self) -> int:
        return sum(len(p) for p in self._pages) * self.pool.page_size

    @property
    def stranded_pct(self) -> float:
        """Allocated-but-unused token capacity as a % of allocation —
        with paging only the tail of each slot's *last page* can strand,
        vs the tail of a whole ``max_len`` slot in the contiguous layout."""
        alloc = self.allocated_tokens
        if not alloc:
            return 0.0
        return 100.0 * (alloc - self.resident_tokens) / alloc

    @property
    def partial_pages(self) -> int:
        """Allocated pages that are not completely filled."""
        ps = self.pool.page_size
        return sum(
            1
            for pages, length in zip(self._pages, self.lengths)
            if pages and length % ps
        )

    @property
    def fragmentation_pct(self) -> float:
        """Partially filled pages as a % of allocated pages."""
        used = self.pool.used_pages
        if not used:
            return 0.0
        return 100.0 * self.partial_pages / used

    def stats(self) -> dict:
        pool = self.pool
        return {
            "page_size": pool.page_size,
            "n_pages": pool.n_pages,
            "used_pages": pool.used_pages,
            "free_pages": pool.free_pages,
            "peak_used_pages": pool.peak_used,
            "utilization_pct": 100.0 * pool.used_pages / pool.n_pages,
            "resident_tokens": self.resident_tokens,
            "token_capacity": pool.token_capacity,
            "stranded_pct": self.stranded_pct,
            "partial_pages": self.partial_pages,
            "fragmentation_pct": self.fragmentation_pct,
        }
