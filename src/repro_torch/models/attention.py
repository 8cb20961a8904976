"""GQA attention (llama-style) with contiguous and paged KV caches — the GQA
half of ``repro/models/attention.py``.  MLA is not ported yet.

Modes: ``train``/``prefill`` run full-sequence causal attention through the
``attention`` block; ``decode`` (S = 1) and ``extend`` (S > 1, causal within
the chunk) append to the cache at each row's own position ``index`` (B,)
and attend over it — through the ``paged_attention`` block on the paged
cache.  Caches are updated in place (the reference returns new arrays).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blocks
from repro_torch.kernels.paged_attention import (  # noqa: F401  (re-exported)
    ChunkScatter,
    chunk_scatter_plan,
    insert_pages,
    scatter_chunk_pages,
    scatter_token_pages,
)
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamMeta, torch_dtype

_NEG = -1e30


def _require_gqa(cfg: ArchConfig) -> None:
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported yet")


# -- parameter metas -------------------------------------------------------------


def attn_metas(cfg: ArchConfig) -> dict:
    _require_gqa(cfg)
    d = cfg.d_model
    dt = cfg.param_dtype
    return {
        "wq": ParamMeta((d, cfg.n_heads * cfg.d_head), ("embed", "heads"), dt),
        "wk": ParamMeta((d, cfg.n_kv_heads * cfg.d_head), ("embed", "kv_heads"), dt),
        "wv": ParamMeta((d, cfg.n_kv_heads * cfg.d_head), ("embed", "kv_heads"), dt),
        "wo": ParamMeta((cfg.n_heads * cfg.d_head, d), ("heads", "embed"), dt),
    }


def cache_metas(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Per-layer KV cache metas (the LM adds the leading layer axis)."""
    _require_gqa(cfg)
    ct = cfg.compute_dtype
    axes = ("act_batch", "kv_heads_act", "cache_seq", None)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {
        "k": ParamMeta(shape, axes, ct, init="zeros"),
        "v": ParamMeta(shape, axes, ct, init="zeros"),
    }


def cache_metas_paged(cfg: ArchConfig, n_pages_total: int, page_size: int) -> dict:
    """Block-paged pool layout: the contiguous layout with the batch axis
    reinterpreted as a shared page pool (``n_pages_total`` includes the null
    page) and the sequence axis shrunk to one page."""
    out = {}
    for key, m in cache_metas(cfg, n_pages_total, page_size).items():
        axes = tuple(None if a in ("act_batch", "cache_seq") else a for a in m.axes)
        out[key] = ParamMeta(m.shape, axes, m.dtype, m.init, m.scale)
    return out


def cache_seq_axes(cfg: ArchConfig) -> dict:
    """Leaf name -> sequence-axis position in the per-layer cache leaf
    (batch leading); the same position holds the within-page axis in the
    paged pool layout."""
    return {key: m.axes.index("cache_seq") for key, m in cache_metas(cfg, 1, 1).items()}


# -- decode attention over a contiguous cache -------------------------------------


def _update_slot_rows(
    cache: torch.Tensor, update: torch.Tensor, index: torch.Tensor, axis: int,
    slots: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-batch-row write of ``update`` at each row's own position, in
    place.  ``axis`` is the sequence axis including the batch axis; each
    start clamps into the cache like ``dynamic_update_slice`` (a freed
    slot's index keeps counting past the end).  ``slots`` (B,) names the
    cache rows that ``update``'s rows go to (default: row ``b`` to row
    ``b``)."""
    s = update.shape[axis]
    start = torch.clamp(index.long(), 0, cache.shape[axis] - s)
    pos = start[:, None] + torch.arange(s, device=cache.device)  # (B, S)
    if slots is None:
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    else:
        rows = slots.long()[:, None]
    torch.movedim(cache, axis, 1)[rows, pos] = torch.movedim(update, axis, 1).to(cache.dtype)
    return cache


def decode_attention_gqa(
    q: torch.Tensor,  # (B, H, S, D) — S=1 decode, S>1 extend
    k_cache: torch.Tensor,  # (B, KH, Smax, D)
    v_cache: torch.Tensor,
    index: torch.Tensor,  # (B,): each row's first new-token position
) -> torch.Tensor:
    b, h, s, d = q.shape
    _, kh, smax, _ = k_cache.shape
    g = h // kh
    qg = q.reshape(b, kh, g, s, d).float() / (d ** 0.5)
    sc = torch.einsum("bkgqd,bktd->bkgqt", qg, k_cache.float())
    qpos = index.long()[:, None] + torch.arange(s, device=q.device)  # (B, S)
    valid = (
        torch.arange(smax, device=q.device)[None, None, None, None, :]
        <= qpos[:, None, None, :, None]
    )
    sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v_cache.float())
    return o.reshape(b, h, s, d).to(q.dtype)


# -- the GQA mixer --------------------------------------------------------------------


def gqa_forward(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ArchConfig,
    positions: torch.Tensor,  # (B, S)
    cache: dict | None = None,
    index: torch.Tensor | None = None,
    mode: str = "train",
    pages: torch.Tensor | None = None,
    slots: torch.Tensor | None = None,
    scatter: ChunkScatter | None = None,
):
    """Returns (out (B, S, D), cache) — the cache updated in place, or
    None when none was given.  ``slots`` (B,), contiguous ``extend`` only:
    the rows of a larger cache that the batch's rows are (the serve
    engine's chunked prefill extends one slot of its cache in place).
    ``scatter``, paged ``extend`` only: the chunk's pool rows, one plan for
    every layer (made here when not given)."""
    b, s, _ = x.shape
    cd = torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (xc @ p["wq"].to(cd)).reshape(b, s, h, dh)
    k = (xc @ p["wk"].to(cd)).reshape(b, s, kh, dh)
    v = (xc @ p["wv"].to(cd)).reshape(b, s, kh, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    qt = q.transpose(1, 2).contiguous()  # (B, H, S, dh)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)

    if mode in ("decode", "extend"):
        if cache is None or index is None:
            raise ValueError(f"{mode} mode needs a cache and its index")
        if pages is not None:
            for leaf, val in (("k", kt), ("v", vt)):
                if s == 1:
                    scatter_token_pages(cache[leaf], val[:, :, 0], pages, index, seq_axis=2)
                else:  # extend: S-token chunk, causal within the chunk
                    scatter_chunk_pages(cache[leaf], val, pages, index, seq_axis=2,
                                        plan=scatter)
            o = blocks.call("paged_attention", qt, cache["k"], cache["v"], pages, index)
        else:
            _update_slot_rows(cache["k"], kt, index, axis=2, slots=slots)
            _update_slot_rows(cache["v"], vt, index, axis=2, slots=slots)
            k_rows, v_rows = cache["k"], cache["v"]
            if slots is not None:
                k_rows, v_rows = k_rows.index_select(0, slots), v_rows.index_select(0, slots)
            o = decode_attention_gqa(qt, k_rows, v_rows, index)
    else:
        o = blocks.call(
            "attention", qt, kt.contiguous(), vt.contiguous(), causal=True
        )
        if cache is not None:  # prefill: persist kv
            cache["k"][:, :, :s] = kt
            cache["v"][:, :, :s] = vt
    o = o.transpose(1, 2).reshape(b, s, h * dh)
    return o.to(cd) @ p["wo"].to(cd), cache


def attention_forward(p, x, cfg, positions, cache=None, index=None, mode="train", pages=None,
                      slots=None, scatter=None):
    _require_gqa(cfg)
    return gqa_forward(p, x, cfg, positions, cache, index, mode, pages, slots, scatter)
