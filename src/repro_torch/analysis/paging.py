"""Page-aliasing sanitizer for the paged-KV scatter/gather programs (a copy
of ``repro/analysis/paging.py``).

The paged decode program scatter-writes K/V through the ``(n_slots,
max_pages)`` page-table operand.  Its safety argument is entirely a
property of that operand: if no two live batch rows name the same page,
the scatter cannot cross-corrupt requests, and if every freed row is
all-null, writes from dead rows land in the sacrificial null page.  This
module proves those properties *statically on the operand* — no device
execution — and backs the cheap runtime assertion mode of
``repro_torch.serve.kv.PageTable(validate=True)``.

Checks (codes):

* ``page-range``      — a page id outside ``[0, n_pages]`` indexes out of
                        the device cache's page axis (error).
* ``page-alias``      — one non-null page named by two live rows (or twice
                        in one row): scatter-writes collide (error).
* ``freed-slot-write`` — a non-live row still names a real page: a decode
                        write from that row lands in a page another
                        request may now own (error).
* ``page-hole``       — a real page after a null entry in a live row: the
                        gather walks a prefix, so pages after the hole are
                        unreachable (warning).
* ``page-count``      — a live row's page count can't hold its resident
                        length (warning; with ``lengths`` provided).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic


def _as_table(table: Any) -> tuple[np.ndarray, int, int | None, list[int] | None]:
    """Normalise a ``PageTable`` or raw array into (array, null_page,
    page_size, lengths)."""
    if hasattr(table, "array") and hasattr(table, "pool"):
        return (
            np.asarray(table.array()),
            int(table.pool.null_page),
            int(table.pool.page_size),
            list(table.lengths),
        )
    return np.asarray(table), -1, None, None


def check_page_table(
    table: Any,
    live_slots: Iterable[int] | None = None,
    null_page: int | None = None,
    page_size: int | None = None,
    lengths: Sequence[int] | None = None,
    program: str = "page-table",
) -> list[Diagnostic]:
    """Statically verify the page-table operand of a paged-KV program.

    ``table`` is a ``repro_torch.serve.kv.PageTable`` (null page, page size and
    lengths read off it) or the raw ``(n_slots, max_pages)`` int array (then
    ``null_page`` is required).  ``live_slots`` restricts which rows are
    expected to hold pages — rows outside it must be all-null; ``None``
    treats every row with any real page as live (pure aliasing check).
    """
    arr, np_null, np_psize, np_lengths = _as_table(table)
    if null_page is None:
        null_page = np_null
    if null_page < 0:
        raise ValueError("null_page required with a raw page-table array")
    page_size = page_size if page_size is not None else np_psize
    lengths = lengths if lengths is not None else np_lengths
    if arr.ndim != 2:
        raise ValueError(f"page table must be 2-D, got shape {arr.shape}")

    diags: list[Diagnostic] = []
    n_slots = arr.shape[0]
    live = (
        set(int(s) for s in live_slots)
        if live_slots is not None
        else {s for s in range(n_slots) if (arr[s] != null_page).any()}
    )

    bad = (arr < 0) | (arr > null_page)
    for slot, col in zip(*np.nonzero(bad)):
        diags.append(Diagnostic(
            pass_name="paging", code="page-range", severity="error",
            program=program, subject=f"slot{slot}[{col}]",
            message=(
                f"page id {int(arr[slot, col])} outside [0, {null_page}] "
                "indexes past the device cache's page axis"
            ),
        ))

    owner: dict[int, tuple[int, int]] = {}
    for slot in range(n_slots):
        row = arr[slot]
        real = row != null_page
        if slot not in live:
            if real.any():
                first = int(np.nonzero(real)[0][0])
                diags.append(Diagnostic(
                    pass_name="paging", code="freed-slot-write",
                    severity="error", program=program,
                    subject=f"slot{slot}",
                    message=(
                        f"freed/inactive slot {slot} still names page "
                        f"{int(row[first])}; its decode writes must land "
                        "in the null page"
                    ),
                ))
            continue
        # live row: real-page prefix, then null padding — a hole makes the
        # pages after it unreachable by the length-bounded gather
        if real.any():
            last_real = int(np.nonzero(real)[0][-1])
            holes = np.nonzero(~real[: last_real + 1])[0]
            if holes.size:
                diags.append(Diagnostic(
                    pass_name="paging", code="page-hole", severity="warning",
                    program=program,
                    subject=f"slot{slot}[{int(holes[0])}]",
                    message=(
                        f"null entry at position {int(holes[0])} precedes "
                        f"real page at {last_real} in live slot {slot}"
                    ),
                ))
        for col in np.nonzero(real)[0]:
            page = int(row[col])
            if page in owner:
                oslot, ocol = owner[page]
                diags.append(Diagnostic(
                    pass_name="paging", code="page-alias", severity="error",
                    program=program,
                    subject=f"page{page}:slot{oslot}+slot{slot}",
                    message=(
                        f"page {page} named by slot {oslot}[{ocol}] and "
                        f"slot {slot}[{int(col)}] — concurrent scatter-"
                        "writes collide"
                    ),
                ))
            else:
                owner[page] = (slot, int(col))
        if lengths is not None and page_size:
            n_real = int(real.sum())
            need = -(-int(lengths[slot]) // page_size)
            if n_real < need:
                diags.append(Diagnostic(
                    pass_name="paging", code="page-count", severity="warning",
                    program=program, subject=f"slot{slot}",
                    message=(
                        f"slot {slot} holds {n_real} pages but its "
                        f"{int(lengths[slot])} resident tokens need {need}"
                    ),
                ))
    return diags


class PageAliasError(AssertionError):
    """Raised by ``PageTable.check_invariants`` when the operand is unsafe."""


def assert_page_table(table: Any, **kwargs: Any) -> None:
    """Raise :class:`PageAliasError` on any error-severity finding."""
    errors = [
        d for d in check_page_table(table, **kwargs) if d.severity == "error"
    ]
    if errors:
        raise PageAliasError(
            "; ".join(str(d) for d in errors)
        )
