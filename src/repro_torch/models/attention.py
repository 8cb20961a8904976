"""Attention mixers: GQA (llama-style) and MLA (DeepSeek-V2), with
contiguous and paged KV caches — the port of ``repro/models/attention.py``.

Modes: ``train``/``prefill`` run full-sequence causal attention through the
``attention`` block; ``decode`` (S = 1) and ``extend`` (S > 1, causal within
the chunk) append to the cache at each row's own position ``index`` (B,)
and attend over it — through the ``paged_attention`` block on the paged
cache.  MLA caches the compressed latent ``c`` and the shared rope key
``kr`` and decodes in the *absorbed* form: scores and values computed
directly against the latent, which on the paged cache is the
``paged_attention`` block with one KV head whose keys and values are both
the latent pool.  Caches are updated in place (the reference returns new
arrays).
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
from repro_torch.models.layers import rmsnorm, rope, tp_out_einsum
from repro_torch.models.params import ParamMeta, torch_dtype
from repro_torch.sharding.utils import constrain, is_dtensor

_NEG = -1e30


# -- parameter metas -------------------------------------------------------------


def attn_metas(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    if cfg.mla:
        m = cfg.mla
        h = cfg.n_heads
        return {
            "wq": ParamMeta(
                (d, h * (m.qk_nope_head_dim + m.qk_rope_head_dim)), ("embed", "heads"), dt
            ),
            "w_dkv": ParamMeta((d, m.kv_lora_rank), ("embed", None), dt),
            "kv_norm": ParamMeta((m.kv_lora_rank,), (None,), dt, init="ones"),
            "w_uk": ParamMeta((m.kv_lora_rank, h * m.qk_nope_head_dim), (None, "heads"), dt),
            "w_uv": ParamMeta((m.kv_lora_rank, h * m.v_head_dim), (None, "heads"), dt),
            "w_kr": ParamMeta((d, m.qk_rope_head_dim), ("embed", None), dt),
            "wo": ParamMeta((h * m.v_head_dim, d), ("heads", "embed"), dt),
        }
    return {
        "wq": ParamMeta((d, cfg.n_heads * cfg.d_head), ("embed", "heads"), dt),
        "wk": ParamMeta((d, cfg.n_kv_heads * cfg.d_head), ("embed", "kv_heads"), dt),
        "wv": ParamMeta((d, cfg.n_kv_heads * cfg.d_head), ("embed", "kv_heads"), dt),
        "wo": ParamMeta((cfg.n_heads * cfg.d_head, d), ("heads", "embed"), dt),
    }


def cache_metas(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """Per-layer KV cache metas (the LM adds the leading layer axis); MLA
    caches the latent ``c`` (B, T, r) and the rope key ``kr`` (B, T, dr)."""
    ct = cfg.compute_dtype
    if cfg.mla:
        m = cfg.mla
        axes = ("act_batch", "cache_seq", None)
        return {
            "c": ParamMeta((batch, max_len, m.kv_lora_rank), axes, ct, init="zeros"),
            "kr": ParamMeta((batch, max_len, m.qk_rope_head_dim), axes, ct, init="zeros"),
        }
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
    if is_dtensor(cache):
        if slots is not None:
            raise ValueError("a sharded cache extends no slots of a larger cache")
        return _update_sharded_rows(cache, update, index, axis)
    s = update.shape[axis]
    start = torch.clamp(index.long(), 0, cache.shape[axis] - s)
    pos = start[:, None] + torch.arange(s, device=cache.device)  # (B, S)
    if slots is None:
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    else:
        rows = slots.long()[:, None]
    torch.movedim(cache, axis, 1)[rows, pos] = torch.movedim(update, axis, 1).to(cache.dtype)
    return cache


def _update_sharded_rows(cache, update, index, axis: int):
    """:func:`_update_slot_rows` on a ``DTensor`` cache, whose sequence
    axis may be sharded (``cache_seq``): each rank writes, in place in its
    own shard, the new positions that fall in it, token by token (one
    position per row a write: a position outside the shard rewrites the
    value it reads)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    total, s = cache.shape[axis], update.shape[axis]
    seq_dims = [i for i, p in enumerate(pl) if p == Shard(axis)]
    upd_pl = tuple(Replicate() if i in seq_dims else p for i, p in enumerate(pl))
    idx_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)

    def local(c, u, ix):
        n = c.shape[axis]
        shard = 0
        for i in seq_dims:  # the shard's number, the first mesh dim major
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
        start = torch.clamp(ix.long(), 0, total - s) - shard * n
        rows = torch.arange(c.shape[0], device=c.device)
        cm, um = torch.movedim(c, axis, 1), torch.movedim(u, axis, 1).to(c.dtype)
        for t in range(s):
            pos = start + t
            inside = ((pos >= 0) & (pos < n)).view(-1, *([1] * (cm.ndim - 2)))
            at = pos.clamp(0, n - 1)
            cm[rows, at] = torch.where(inside, um[:, t], cm[rows, at])
        return c

    return local_map(local, out_placements=list(pl), in_placements=(pl, upd_pl, idx_pl),
                     device_mesh=mesh, redistribute_inputs=True)(cache, update, index)


def decode_attention_gqa(
    q: torch.Tensor,  # (B, H, S, D) — S=1 decode, S>1 extend
    k_cache: torch.Tensor,  # (B, KH, Smax, D)
    v_cache: torch.Tensor,
    index: torch.Tensor,  # (B,): each row's first new-token position
) -> torch.Tensor:
    b, h, s, d = q.shape
    _, kh, smax, _ = k_cache.shape
    g = h // kh
    # under a mesh: every head of the rank's rows (the group split needs
    # whole heads); the cache may stay sharded on its sequence
    q = constrain(q, "act_batch", None, None, None)
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
    # under a mesh the projections keep whole heads before the split
    q = constrain(xc @ p["wq"].to(cd), "act_batch", None, "heads_act").reshape(b, s, h, dh)
    k = constrain(xc @ p["wk"].to(cd), "act_batch", None, "kv_heads_act").reshape(b, s, kh, dh)
    v = constrain(xc @ p["wv"].to(cd), "act_batch", None, "kv_heads_act").reshape(b, s, kh, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "act_batch", None, "heads_act", None)
    k = constrain(k, "act_batch", None, "kv_heads_act", None)

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
    o = constrain(o.transpose(1, 2).reshape(b, s, h * dh), "act_batch", None, "heads_act")
    return tp_out_einsum(o.to(cd), p["wo"].to(cd), cd), cache


# -- the MLA mixer -----------------------------------------------------------------


def mla_forward(
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
    """Returns (out (B, S, D), cache), as :func:`gqa_forward`.  Prefill
    expands the latent through ``w_uk`` / ``w_uv`` and attends at qk
    ``dn + dr`` / v ``dv`` through the ``attention`` block; decode and
    extend take the absorbed form: through the ``paged_attention`` block
    on the paged cache (the latent pool as one KV head, both keys and
    values, with the rope pool beside it), in f32 einsums on the
    contiguous one, as the reference (which has no kernel there)."""
    m = cfg.mla
    b, s, _ = x.shape
    cd = torch_dtype(cfg.compute_dtype)
    xc = x.to(cd)
    h, r = cfg.n_heads, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = (xc @ p["wq"].to(cd)).reshape(b, s, h, dn + dr)
    qn, qr = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
    c = rmsnorm(p["kv_norm"], xc @ p["w_dkv"].to(cd), cfg.norm_eps).to(cd)  # (B, S, r)
    kr = rope((xc @ p["w_kr"].to(cd))[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if mode in ("decode", "extend"):
        if cache is None or index is None:
            raise ValueError(f"{mode} mode needs a cache and its index")
        # absorbed: score = (qn w_uk) . c + qr . kr, the context a latent
        q_abs = torch.einsum("bshn,rhn->bshr", qn, p["w_uk"].to(cd).reshape(r, h, dn))
        scale = 1.0 / ((dn + dr) ** 0.5)
        if pages is not None:
            for leaf, val in (("c", c), ("kr", kr)):
                if s == 1:
                    scatter_token_pages(cache[leaf], val[:, 0], pages, index, seq_axis=1)
                else:  # extend chunk
                    scatter_chunk_pages(cache[leaf], val, pages, index, seq_axis=1,
                                        plan=scatter)
            latent = cache["c"][:, None]  # (P, 1, ps, r): keys and values
            ctx = blocks.call(
                "paged_attention", q_abs.transpose(1, 2).contiguous(), latent, latent,
                pages, index, q_rope=qr.transpose(1, 2).contiguous(),
                kr_pool=cache["kr"][:, None], scale=scale,
            ).transpose(1, 2)  # (B, S, H, r)
        else:
            _update_slot_rows(cache["c"], c, index, axis=1, slots=slots)
            _update_slot_rows(cache["kr"], kr, index, axis=1, slots=slots)
            c_view, kr_view = cache["c"], cache["kr"]
            if slots is not None:
                c_view, kr_view = c_view.index_select(0, slots), kr_view.index_select(0, slots)
            sc = (
                torch.einsum("bshr,btr->bhst", q_abs.float(), c_view.float())
                + torch.einsum("bshr,btr->bhst", qr.float(), kr_view.float())
            ) * scale  # (B, H, S, T)
            qpos = index.long()[:, None] + torch.arange(s, device=x.device)  # (B, S)
            valid = (
                torch.arange(c_view.shape[1], device=x.device)[None, None, None, :]
                <= qpos[:, None, :, None]
            )
            sc = torch.where(valid, sc, torch.full_like(sc, _NEG))
            ctx = torch.einsum("bhst,btr->bshr", torch.softmax(sc, dim=-1), c_view.float())
        o = torch.einsum("bshr,rhv->bshv", ctx.to(cd), p["w_uv"].to(cd).reshape(r, h, dv))
    else:
        kn = (c @ p["w_uk"].to(cd)).reshape(b, s, h, dn)
        v = (c @ p["w_uv"].to(cd)).reshape(b, s, h, dv)
        k = torch.cat([kn, kr[:, :, None, :].expand(b, s, h, dr)], dim=-1)
        qf = constrain(torch.cat([qn, qr], dim=-1), "act_batch", None, "heads_act", None)
        k = constrain(k, "act_batch", None, "heads_act", None)
        v = constrain(v, "act_batch", None, "heads_act", None)
        o = blocks.call(
            "attention", qf.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True,
        ).transpose(1, 2)  # (B, S, H, dv)
        if cache is not None:  # prefill: persist the latent and the rope key
            cache["c"][:, :s] = c
            cache["kr"][:, :s] = kr
    o = o.reshape(b, s, h * dv)
    return tp_out_einsum(o.to(cd), p["wo"].to(cd), cd), cache


def attention_forward(p, x, cfg, positions, cache=None, index=None, mode="train", pages=None,
                      slots=None, scatter=None):
    forward = mla_forward if cfg.mla is not None else gqa_forward
    return forward(p, x, cfg, positions, cache, index, mode, pages, slots, scatter)
