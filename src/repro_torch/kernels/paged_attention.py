"""Paged decode/extend attention over the block-paged KV pool (the port of
``repro/kernels/paged_attention.py``).

Slot ``b``'s logical position ``t`` lives in pool page
``pages[b, t // page_size]`` at row ``t % page_size``; table entries past a
slot's allocation point at the shared *null page* (index ``n_pages``, the
last pool row), whose garbage rows the mask ``t <= index + s`` always hides.

* :func:`paged_attention` — the wrapper of the fused CUDA kernel
  (``csrc/paged_attention.cu``, replacing ``paged_attention_pallas``),
  whose page walk is split across CTAs by :func:`split_plan`, on the walk
  :func:`paged_route` picks (MLA's latent pool on wgmma, or the split walk);
* :func:`paged_attention_torch` — its plain version, operation for
  operation the reference's ``paged_attention_xla`` (page gather, then
  dense masked softmax), used for CPU tensors and as the kernel's yardstick;
* the page plumbing shared with the model and the serve engine:
  :func:`gather_kv_pages`, :func:`scatter_token_pages`,
  :func:`scatter_chunk_pages` (with :func:`chunk_scatter_plan`),
  :func:`insert_pages`.  The scatters write
  into the pool in place (the reference returns a new array).

Pool layouts: GQA ``(P_total, KH, page_size, D)``; MLA latent
``(P_total, 1, page_size, r)`` with its rope pool ``(P_total, 1,
page_size, dr)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build

_NEG = -1e30

#: the split plan aims at this many CTAs per SM, in splits of at least
#: SPLIT_MIN_POSITIONS positions (and SPLIT_MIN_ELEMS K/V elements of one
#: kv head, so a split's fixed cost stays small beside its loads) and at
#: most MAX_PAGES_PER_SPLIT pages (the page ids a CTA keeps in shared
#: memory, 4 bytes each); a longer table takes more splits
SPLIT_CTAS_PER_SM = 4
SPLIT_MIN_POSITIONS = 32
SPLIT_MIN_ELEMS = 8192
MAX_PAGES_PER_SPLIT = 1024
#: the workspace holds this many partials per (split, query row): the
#: kernel's position groups of a CTA at most (its warps); the C entry
#: point checks the workspace against what its launch needs
WORKSPACE_GROUPS = 4
#: the kernel's walks, by the code the C entry point takes: the split walk
#: (the CUDA cores, or mma.sync for bf16 GQA up to 128 dims, picked by the
#: kernel from shapes) and the latent walk (MLA on wgmma)
ROUTES = ("split", "latent")
#: the latent walk: query rows a CTA (wgmma's M), the widest latent and
#: rope rows it stages, one position group a CTA, and its split plan's
#: CTAs an SM and shortest split (a split's partial of a 64-row tile, 128
#: KB at a 512-wide latent, costs as much to write as 128 positions of
#: latent and rope rows cost to read).  One CTA fills an SM's shared
#: memory, so two an SM are two waves if every split is live; but the plan
#: covers the table's width, and the live positions (the lengths, which a
#: shape-only plan does not see) often reach a part of it, whose splits
#: then share the SMs (a 16-token chunk from position 384 in a 1024-wide
#: table on the H100: scripts/paged_variants.py latent_one_cta_an_sm).  A
#: plan that one CTA an SM covers in one split keeps it: that split writes
#: its rows itself and no merge runs.
LATENT_ROWS = 64
LATENT_MAX_DIM = 512
LATENT_MAX_ROPE = 64
LATENT_GROUPS = 1
LATENT_CTAS_PER_SM = 2
LATENT_MIN_POSITIONS = 128


# -- page-table plumbing --------------------------------------------------------


def gather_kv_pages(pool: torch.Tensor, pages: torch.Tensor, seq_axis: int) -> torch.Tensor:
    """``pool`` (P_total, ..., page_size @ seq_axis, ...), ``pages``
    (B, max_pages) -> (B, ..., max_pages * page_size @ seq_axis, ...)."""
    blocks = pool[pages.long()]  # (B, max_pages, ..., page_size, ...)
    blocks = torch.movedim(blocks, 1, seq_axis)  # max_pages before page_size
    return blocks.flatten(seq_axis, seq_axis + 1)


def scatter_token_pages(
    pool: torch.Tensor,
    val: torch.Tensor,
    pages: torch.Tensor,
    index: torch.Tensor,
    seq_axis: int,
) -> torch.Tensor:
    """Write each row's new token into its current page, in place.

    ``val`` is the token slice with the sequence axis squeezed out (GQA
    (B, KH, D)); ``index`` (B,) the logical write position.  The page
    column is clamped into the table, as the reference's
    ``take_along_axis(..., mode="clip")``; rows whose entry is the null page
    write into the sacrificial page.
    """
    ps = pool.shape[seq_axis]
    index = index.long()
    col = torch.clamp(index // ps, 0, pages.shape[1] - 1)
    pid = torch.gather(pages.long(), 1, col[:, None])[:, 0]
    idx = (pid,) + (slice(None),) * (seq_axis - 1) + (index % ps,)
    pool[idx] = val.to(pool.dtype)
    return pool


class ChunkScatter(NamedTuple):
    """Where the tokens of an S-token chunk land in a page pool: token
    ``(b, i)`` goes to row ``off[b, i]`` of page ``pid[b, i]``, with the
    value of token ``(src_row, src_token)[b, i]`` (itself, unless a later
    write of the token-by-token loop lands on the same pool row)."""

    pid: torch.Tensor  # (B, S) int64
    off: torch.Tensor  # (B, S) int64
    src_row: torch.Tensor  # (B, S) int64
    src_token: torch.Tensor  # (B, S) int64


def chunk_scatter_plan(
    pages: torch.Tensor, index: torch.Tensor, s: int, page_size: int, pool_pages: int
) -> ChunkScatter:
    """The pool rows an S-token chunk at positions ``index + i`` (B,) is
    written to, through the page table ``pages`` (B, max_pages) of a pool of
    ``pool_pages`` pages (the null page included): the page ids of all S
    positions in one gather, the column clamped into the table as
    :func:`scatter_token_pages` clamps it; null-page entries write into the
    sacrificial page.  Where two writes meet one pool row (a clamped
    column, rows sharing the null page) the token-by-token loop leaves the
    last one, token ``i`` outer and row ``b`` inner; every writer of such a
    row takes that last value, so the scatter does not depend on the order
    ``index_put_`` applies duplicates in.  It depends only on the table and
    the positions, so one plan serves every layer's K and V."""
    b = pages.shape[0]
    dev = pages.device
    pos = index.long()[:, None] + torch.arange(s, device=dev)  # (B, S)
    col = torch.clamp(pos // page_size, 0, pages.shape[1] - 1)
    pid = torch.gather(pages.long(), 1, col)
    off = pos % page_size
    order = torch.arange(s, device=dev)[None, :] * b + torch.arange(b, device=dev)[:, None]
    target = pid * page_size + off
    last = torch.full((pool_pages * page_size,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, target.reshape(-1), order.reshape(-1), "amax")
    winner = last[target]
    return ChunkScatter(pid, off, winner % b, winner // b)


def scatter_chunk_pages(
    pool: torch.Tensor,
    val: torch.Tensor,
    pages: torch.Tensor,
    index: torch.Tensor,
    seq_axis: int,
    plan: ChunkScatter | None = None,
) -> torch.Tensor:
    """Write an S-token ``extend`` chunk (chunk axis at ``seq_axis``) into
    each row's page list, in place: token ``i`` lands at position
    ``index + i``.  One vectorised scatter (one ``index_put_``) with the
    writes of :func:`scatter_token_pages` token by token; ``plan`` is
    :func:`chunk_scatter_plan` of ``pages`` and ``index`` (made here when
    not given)."""
    if plan is None:
        plan = chunk_scatter_plan(
            pages, index, val.shape[seq_axis], pool.shape[seq_axis], pool.shape[0]
        )
    rows = torch.movedim(val, seq_axis, 1)[plan.src_row, plan.src_token]  # (B, S, ...)
    torch.movedim(pool, seq_axis, 1)[plan.pid, plan.off] = rows.to(pool.dtype)
    return pool


def insert_pages(
    pool: torch.Tensor, b1: torch.Tensor, page_ids: torch.Tensor, seq_axis: int
) -> torch.Tensor:
    """Write a prefilled batch-1 slot cache into the pool as whole pages,
    in place.  ``pool`` (L, P_total, ..., page_size, ...), ``b1``
    (L, 1, ..., S, ...) with ``S == max_pages * page_size``; ``page_ids``
    (max_pages,) is the slot's page list, null-page entries absorbing the
    unallocated tail.  ``seq_axis`` is the per-layer position (batch
    leading), as from ``repro_torch.models.attention.cache_seq_axes``."""
    ps = pool.shape[seq_axis + 1]
    x = b1.squeeze(1)  # (L, ..., S, ...): seq back at seq_axis
    shp = x.shape
    x = x.reshape(shp[:seq_axis] + (shp[seq_axis] // ps, ps) + shp[seq_axis + 1:])
    x = torch.movedim(x, seq_axis, 1)  # (L, max_pages, ..., ps, ...)
    pool[:, page_ids.long()] = x.to(pool.dtype)
    return pool


# -- the plain version: page gather, then dense masked softmax -------------------


def paged_attention_torch(
    q: torch.Tensor,  # (B, H, S, Dk) — S=1 decode, S>1 extend
    k_pool: torch.Tensor,  # (P_total, KH, page_size, Dk)
    v_pool: torch.Tensor,  # (P_total, KH, page_size, Dv)
    pages: torch.Tensor,  # (B, max_pages) int32 page table
    index: torch.Tensor,  # (B,) first new-token position per slot
    *,
    q_rope: torch.Tensor | None = None,  # MLA: (B, H, S, Dr)
    kr_pool: torch.Tensor | None = None,  # MLA: (P_total, 1, page_size, Dr)
    scale: float | None = None,
) -> torch.Tensor:
    b, h, s, dk = q.shape
    kh = k_pool.shape[1]
    g = h // kh
    dv = v_pool.shape[-1]
    k_view = gather_kv_pages(k_pool, pages, seq_axis=2).float()  # (B, KH, T, Dk)
    v_view = gather_kv_pages(v_pool, pages, seq_axis=2).float()
    smax = k_view.shape[2]
    qpos = index.long()[:, None] + torch.arange(s, device=q.device)  # (B, S)
    qg = q.reshape(b, kh, g, s, dk).float()
    if q_rope is None:
        # division (not multiply-by-reciprocal), as the reference, to stay
        # bit-identical with the contiguous decode path
        qg = qg * scale if scale is not None else qg / (dk ** 0.5)
        sc = torch.einsum("bkgqd,bktd->bkgqt", qg, k_view)
    else:
        if scale is None:
            scale = 1.0 / (dk ** 0.5)
        qr = q_rope.reshape(b, kh, g, s, -1).float()
        kr_view = gather_kv_pages(kr_pool, pages, seq_axis=2).float()
        sc = (
            torch.einsum("bkgqd,bktd->bkgqt", qg, k_view)
            + torch.einsum("bkgqd,bktd->bkgqt", qr, kr_view)
        ) * scale
    valid = (
        torch.arange(smax, device=q.device)[None, None, None, None, :]
        <= qpos[:, None, None, :, None]
    )
    sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v_view)
    return o.reshape(b, h, s, dv).to(q.dtype)


# -- the CUDA kernel's wrapper ----------------------------------------------------


class SplitPlan(NamedTuple):
    """How the kernel walks the pages: ``n_splits`` runs of
    ``pages_per_split`` whole pages, each a CTA per (slot, kv head)."""

    pages_per_split: int
    n_splits: int


def split_plan(
    b: int, kh: int, max_pages: int, page_size: int, dk: int, dv: int, sms: int, *,
    ctas_per_sm: int = SPLIT_CTAS_PER_SM, min_positions: int = SPLIT_MIN_POSITIONS,
    min_elems: int = SPLIT_MIN_ELEMS, max_pages_per_split: int = MAX_PAGES_PER_SPLIT,
) -> SplitPlan:
    """The kernel's split plan, from shapes alone (never from ``index`` or
    ``pages``, so a CUDA graph captures the call as it stands): enough
    splits for ``ctas_per_sm`` CTAs on each of the card's ``sms`` SMs over
    the ``b * kh`` (slot, kv head) pairs, none shorter than its minimum nor
    longer than ``max_pages_per_split``; any table length is covered."""
    want = -(-ctas_per_sm * sms // (b * kh))
    min_positions = max(min_positions, -(-min_elems // (dk + dv)))
    min_pages = -(-min_positions // page_size)
    pages = min(max_pages, max_pages_per_split, max(min_pages, -(-max_pages // want)))
    return SplitPlan(pages, -(-max_pages // pages))


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (:func:`build.sm_count`)."""
    return build.sm_count(device)


def paged_route(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    q_rope: torch.Tensor | None = None,
    kr_pool: torch.Tensor | None = None,
) -> str:
    """The kernel's walk for these operands: ``latent`` (wgmma) for MLA's
    served shape, bf16 with one pool as keys and values (``v_pool is
    k_pool``: one kv head, Dk == Dv a multiple of 64 up to 512), its rope
    pool beside it (Dr a multiple of 8 up to 64), pages of a multiple of 8
    rows and 16-byte aligned operands (what TMA loads); ``split`` for the
    rest (f32, GQA, separate pools with rope, other head dims)."""
    if q_rope is None or kr_pool is None or v_pool is not k_pool:
        return "split"
    _, kh, ps, dk = k_pool.shape
    dr = q_rope.shape[-1]
    latent = (q.dtype == torch.bfloat16 and kh == 1 and dk % 64 == 0
              and dk <= LATENT_MAX_DIM
              and dr % 8 == 0 and 0 < dr <= LATENT_MAX_ROPE and ps % 8 == 0
              and all(build.aligned(t) for t in (q, k_pool, q_rope, kr_pool)))
    return "latent" if latent else "split"


def latent_plan(b: int, r: int, max_pages: int, page_size: int, dk: int, sms: int) -> SplitPlan:
    """The latent walk's split plan: :func:`split_plan` over the ``b *
    ceil(r / LATENT_ROWS)`` (slot, row tile) CTAs of a split, no split
    shorter than ``LATENT_MIN_POSITIONS``: one split where one CTA an SM
    covers the tiles in one, else aiming at ``LATENT_CTAS_PER_SM`` a SM."""
    tiles = -(-r // LATENT_ROWS)
    for ctas_per_sm in (1, LATENT_CTAS_PER_SM):
        plan = split_plan(b, tiles, max_pages, page_size, dk, dk, sms,
                          ctas_per_sm=ctas_per_sm, min_positions=LATENT_MIN_POSITIONS)
        if plan.n_splits == 1:
            break
    return plan


def paged_work(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    lengths: "list[int] | None" = None,
    *,
    q_rope: torch.Tensor | None = None,
) -> build.Work:
    """The kernel's work: q (and q_rope) read once and the (B, H, S, Dv)
    output written once; the K/V rows of the positions the slots reach read
    once (a pool that is both keys and values, MLA's latent, once; the
    rope pool's row beside it), the page table and ``index`` once; q.k,
    q_rope.k_rope and p.v for each (query row, position) seen, causal
    within the chunk.

    The work depends on the data: slot b at ``lengths[b]`` reaches
    ``lengths[b] + S`` positions.  Given concrete ``lengths`` (a host
    list, as ``chip_smoke.py`` phase 2 has them) it counts the positions
    seen; without them (a trace: the kernel's wrapper never reads
    ``index`` on the host) every slot is counted at the full context the
    page table's width admits, ``max_pages * page_size``."""
    b, hh, s, dk = q.shape
    kkh, ps = k_pool.shape[1], k_pool.shape[2]
    dv = v_pool.shape[-1]
    dr = 0 if q_rope is None else q_rope.shape[-1]
    cap = pages.shape[1] * ps
    if lengths is None:
        lengths = [cap] * b
    seen = sum(min(ln + si + 1, cap) for ln in lengths for si in range(s))
    n_pos = sum(min(ln + s, cap) for ln in lengths)
    e = q.element_size()
    per_pos = kkh * (dk if v_pool is k_pool else dk + dv) + dr
    nbytes = (e * (q.numel() + b * hh * s * dv + (0 if q_rope is None else q_rope.numel()))
              + e * n_pos * per_pos + 4 * (pages.numel() + b))
    flops = 2 * kkh * (hh // kkh) * seen * (dk + dv + dr)
    return build.Work(flops, nbytes, build.peak_of(q.dtype))


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    pages: torch.Tensor,
    index: torch.Tensor,
    *,
    q_rope: torch.Tensor | None = None,
    kr_pool: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused paged attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns (B, H, S, Dv) in q's dtype.  A call
    is two launches, the walk and the merge of its partials (one, the
    walk, for a latent plan of one split); the walk comes
    from :func:`paged_route` and its split plan from :func:`split_plan`
    (:func:`latent_plan` for the latent walk), and
    ``paged_attention.routes`` counts the launches of each walk."""
    if q.device.type == "cpu":
        return paged_attention_torch(
            q, k_pool, v_pool, pages, index, q_rope=q_rope, kr_pool=kr_pool,
            scale=scale,
        )
    b, h, s, dk = q.shape
    n_pool, kh, ps, _ = k_pool.shape
    dv = v_pool.shape[-1]
    mp = pages.shape[1]
    rope = q_rope is not None
    operands = [q, k_pool, v_pool, pages, index] + ([q_rope, kr_pool] if rope else [])
    build.refuse_grad("paged_attention", "paged_attention", *operands)
    build.check_cuda("paged_attention", *operands)
    if (q_rope is None) != (kr_pool is None):
        raise ValueError("paged_attention: q_rope and kr_pool come together")
    if k_pool.shape[-1] != dk or v_pool.shape[:3] != (n_pool, kh, ps) or h % kh:
        raise ValueError(
            f"paged_attention: q {tuple(q.shape)} does not fit pools "
            f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}"
        )
    if pages.shape != (b, mp) or index.shape != (b,):
        raise ValueError("paged_attention: pages must be (B, max_pages), index (B,)")
    if pages.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("paged_attention: pages and index must be int32")
    if any(t.dtype != q.dtype for t in (k_pool, v_pool)) or (
        rope and (q_rope.dtype != q.dtype or kr_pool.dtype != q.dtype)
    ):
        raise TypeError("paged_attention: q and the pools must share one dtype")
    dr = q_rope.shape[-1] if rope else 0
    if rope and (
        q_rope.shape[:3] != (b, h, s) or kr_pool.shape != (n_pool, 1, ps, dr)
    ):
        raise ValueError("paged_attention: q_rope (B,H,S,Dr) / kr_pool (P,1,ps,Dr) mismatch")
    for name, n in (("key", dk), ("value", dv), ("rope", dr)):
        if n > 512:
            raise ValueError(f"paged_attention: {name} head dim {n} exceeds 512")
    if scale is None:
        scale = 1.0 / (dk ** 0.5)
    route = paged_route(q, k_pool, v_pool, q_rope, kr_pool)
    if route == "latent":
        plan, groups = latent_plan(b, h * s, mp, ps, dk, sm_count(q.device)), LATENT_GROUPS
    else:
        plan, groups = split_plan(b, kh, mp, ps, dk, dv, sm_count(q.device)), WORKSPACE_GROUPS
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    # each (split, group)'s (B*H*S, Dv) f32 accumulator, then its max / sum
    work = torch.empty(plan.n_splits * groups * b * h * s * (dv + 2),
                       dtype=torch.float32, device=q.device)
    if build.skip_launch("paged_attention", q, work=lambda: paged_work(
            q, k_pool, v_pool, pages, q_rope=q_rope)):
        return out
    build.launch(
        "repro_paged_attention",
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        q_rope.data_ptr() if rope else None,
        kr_pool.data_ptr() if rope else None,
        pages.data_ptr(), index.data_ptr(), out.data_ptr(), work.data_ptr(), work.numel(),
        b, h, kh, s, dk, dv, dr, ps, mp, n_pool, *plan, scale,
        build.dtype_code(q), ROUTES.index(route), build.stream_of(q),
    )
    paged_attention.launches += 1
    paged_attention.routes[route] += 1
    return out


paged_attention.launches = 0
paged_attention.routes = dict.fromkeys(ROUTES, 0)
