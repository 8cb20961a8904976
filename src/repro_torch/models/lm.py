"""Decoder LM over a block pattern — the port of ``repro/models/lm.py``.
One char per layer:

    'a'  attention + (MoE if configured, else SwiGLU MLP)
    'd'  attention + dense MLP (the leading dense layers of an MoE stack)
    'm'  Mamba-2 SSD block
    's'  shared-parameter attention + MLP block (Zamba2): one param set,
         applied at every 's' site; each site keeps its own KV cache

Consecutive identical pattern chars form a *group* whose parameters and
caches are stacked with a leading layer axis, keyed exactly as the
reference keys them (``blocks/g0_a/attn/wq``, ``g0_a/k``, ``g0_m/ssm``,
...); the shared block is one unstacked set (``shared_block``).  A Python
loop runs the layers.  Each branch's output stays pending until the next
norm, which adds it to the residual stream in the same launch
(``add_rmsnorm``); the values are the reference's ``x + branch`` then
``rmsnorm``.  An MoE layer's Switch aux loss is dropped here: it
matters to training only.  A batch carries ``tokens`` (B, S), or
``embeds`` (B, S, D) for a patch-embed frontend (pixtral).

Modes: ``prefill`` (fill the cache, logits), ``decode`` (one token per row
against the cache) and ``extend`` (an S-token chunk per row, causal within
the chunk).  ``cache["index"]`` is per-slot (B,): rows decode at their own
positions (continuous batching); a paged cache also carries
``cache["pages"]``, the (B, max_pages) page table; a contiguous ``extend``
may carry ``cache["slots"]``, the (B,) rows of a larger cache that the
batch extends (the serve engine's chunked prefill).  Caches are updated in
place and returned, ``cache["index"]`` too (the same tensor, advanced).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

import repro_torch.kernels  # noqa: F401  (registers the function blocks)
from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pm
from repro_torch.models.attention import (
    attention_forward,
    attn_metas,
    cache_metas,
    cache_metas_paged,
    cache_seq_axes,
    chunk_scatter_plan,
)
from repro_torch.models.layers import (
    add_rmsnorm,
    embed_lookup,
    embed_metas,
    lm_logits,
    mlp_forward,
    mlp_metas,
)
from repro_torch.models.moe import moe_forward, moe_metas
from repro_torch.models.params import ParamMeta, torch_dtype
from repro_torch.models.ssm import ssm_forward, ssm_metas, ssm_state_metas


# -- pattern grouping ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Group:
    index: int
    kind: str  # 'a' | 'd' | 'm' | 's'
    count: int

    @property
    def key(self) -> str:
        return f"g{self.index}_{self.kind}"


def groups_of(cfg: ArchConfig) -> list[Group]:
    pat = cfg.pattern()
    out: list[Group] = []
    i = 0
    while i < len(pat):
        j = i
        while j < len(pat) and pat[j] == pat[i]:
            j += 1
        out.append(Group(len(out), pat[i], j - i))
        i = j
    return out


# -- parameter metas ------------------------------------------------------------------


def _stack(metas: Any, n: int) -> Any:
    return pm.tree_map_metas(
        lambda m: ParamMeta((n,) + m.shape, ("layers",) + m.axes, m.dtype, m.init, m.scale),
        metas,
    )


def _block_metas(cfg: ArchConfig, kind: str) -> dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    if kind == "m":
        return {
            "ln": ParamMeta((d,), (None,), dt, init="ones"),
            "mixer": ssm_metas(cfg),
        }
    metas = {
        "ln1": ParamMeta((d,), (None,), dt, init="ones"),
        "attn": attn_metas(cfg),
        "ln2": ParamMeta((d,), (None,), dt, init="ones"),
    }
    if kind == "a" and cfg.moe is not None:
        metas["moe"] = moe_metas(cfg)
    else:
        metas["mlp"] = mlp_metas(d, cfg.d_ff, dt)
    return metas


def build_metas(cfg: ArchConfig) -> dict:
    groups = groups_of(cfg)
    metas: dict = {"embed": embed_metas(cfg)}
    if any(g.kind == "s" for g in groups):
        metas["shared_block"] = _block_metas(cfg, "s")
    metas["blocks"] = {
        g.key: _stack(_block_metas(cfg, g.kind), g.count) for g in groups if g.kind != "s"
    }
    metas["final_norm"] = ParamMeta((cfg.d_model,), (None,), cfg.param_dtype, init="ones")
    return metas


def cache_metas_tree(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    *,
    page_size: int | None = None,
    n_pages: int | None = None,
) -> dict:
    """Contiguous (default) or block-paged cache layout.  Paged: every
    attention leaf is a pool of ``n_pages`` pages plus the null page at
    index ``n_pages``; SSM state leaves stay per-slot (a recurrent state has
    no sequence axis to page)."""
    if page_size is not None and n_pages is None:
        raise ValueError("paged cache needs both page_size and n_pages")
    caches: dict = {}
    for g in groups_of(cfg):
        if g.kind == "m":
            caches[g.key] = _stack(ssm_state_metas(cfg, batch), g.count)
        elif page_size is not None:
            caches[g.key] = _stack(cache_metas_paged(cfg, n_pages + 1, page_size), g.count)
        else:
            caches[g.key] = _stack(cache_metas(cfg, batch, max_len), g.count)
    caches["index"] = ParamMeta((batch,), ("act_batch",), "int32", init="zeros")
    return caches


def init_params(cfg: ArchConfig, seed: int = 0, device="cpu") -> Any:
    return pm.init_params(build_metas(cfg), seed, device)


def init_cache(
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    *,
    page_size: int | None = None,
    n_pages: int | None = None,
    device="cpu",
) -> Any:
    metas = cache_metas_tree(cfg, batch, max_len, page_size=page_size, n_pages=n_pages)
    return pm.init_params(metas, 0, device)


def cast_for_compute(params: Any, cfg: ArchConfig) -> Any:
    """Cast every matrix (ndim >= 2 per layer: projections, embedding) to the
    compute dtype once; norm weights keep their parameter dtype.  The
    reference casts at every use inside its jitted programs; the values are
    the same, and the model's own ``.to(cd)`` calls become no-ops.  The
    SSM vectors (``a_log``, ``d_skip``, ``dt_bias``, ``norm``) are norm-like
    and keep theirs."""
    cd = torch_dtype(cfg.compute_dtype)

    def cast(tree: Any, stacked: bool) -> Any:
        if isinstance(tree, dict):
            return {k: cast(v, stacked or k == "blocks") for k, v in tree.items()}
        return tree.to(cd) if tree.ndim - stacked >= 2 else tree

    return cast(params, False)


# -- block application ----------------------------------------------------------------


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views: in-place cache writes land in
    the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_attn_block(lp, x, pending, cfg, positions, cache, index, mode, pages=None,
                      slots=None, scatter=None):
    """Returns (x, pending): the residual stream with the attention output
    added (fused into ln2) and the FFN's output (the MoE's on an MoE
    layer), which the next norm adds."""
    cd = torch_dtype(cfg.compute_dtype)
    x, h_in = add_rmsnorm(lp["ln1"], x, pending, cfg.norm_eps)
    attn_out, cache = attention_forward(
        lp["attn"], h_in.to(cd), cfg, positions, cache, index, mode, pages, slots, scatter
    )
    x, ff_in = add_rmsnorm(lp["ln2"], x, attn_out, cfg.norm_eps)
    if "moe" in lp:
        return x, moe_forward(lp["moe"], ff_in.to(cd), cfg, cd)[0]
    return x, mlp_forward(lp["mlp"], ff_in.to(cd), cd)


def _apply_mamba_block(lp, x, pending, cfg, cache, mode):
    if mode == "extend":
        raise ValueError(
            "chunked prefill (extend mode) is unsupported for SSM blocks: "
            "resuming the scan needs the conv window stitched across chunk "
            "boundaries"
        )
    cd = torch_dtype(cfg.compute_dtype)
    x, h_in = add_rmsnorm(lp["ln"], x, pending, cfg.norm_eps)
    out, _ = ssm_forward(lp["mixer"], h_in.to(cd), cfg, cache, mode)
    return x, out


# -- forward / serve ----------------------------------------------------------------------


def _pool_geometry(cfg: ArchConfig, cache: Any) -> tuple[int, int]:
    """(page_size, pool pages with the null page) of a paged cache's
    attention pools, read from the first leaf (GQA ``k``, MLA ``c``)."""
    leaf, seq_axis = next(iter(cache_seq_axes(cfg).items()))
    for g in groups_of(cfg):
        if g.kind != "m":
            pool = cache[g.key][leaf]
            return pool.shape[seq_axis + 1], pool.shape[1]  # the layer axis leads
    raise ValueError(f"{cfg.name}: no attention pool to extend")


def _blocks(params: Any, batch: dict, cfg: ArchConfig, mode: str, cache: Any):
    """All blocks.  Returns (x, pending, cache): every block's residual add
    lands in the next block's norm (``add_rmsnorm``), so the last block's
    output is still pending; None if there is no block."""
    cd = torch_dtype(cfg.compute_dtype)
    if "embeds" in batch:
        x = batch["embeds"].to(cd)
    else:
        x = embed_lookup(params["embed"], batch["tokens"], cd)
    b, s = x.shape[0], x.shape[1]
    steps = torch.arange(s, dtype=torch.int32, device=x.device)

    pages = slots = scatter = None
    if mode in ("decode", "extend"):
        index = cache["index"]
        if index.ndim != 1:
            raise ValueError("cache['index'] must be per-slot (B,) write positions")
        pages = cache.get("pages")  # (B, max_pages) page table, paged only
        slots = cache.get("slots")  # (B,) cache rows, contiguous extend only
        positions = index[:, None] + steps[None, :]
        if pages is not None and s > 1:
            # where the chunk's K/V land in the pool, shared by every layer
            scatter = chunk_scatter_plan(pages, index, s, *_pool_geometry(cfg, cache))
    else:
        index = None
        positions = steps[None, :].expand(b, s)

    pending = None
    for g in groups_of(cfg):
        gcache = cache[g.key] if cache is not None else None
        for i in range(g.count):
            lcache = _layer(gcache, i) if gcache is not None else None
            # each 's' site applies the one shared set to its own cache
            lp = params["shared_block"] if g.kind == "s" else _layer(params["blocks"][g.key], i)
            if g.kind == "m":
                x, pending = _apply_mamba_block(lp, x, pending, cfg, lcache, mode)
            else:
                x, pending = _apply_attn_block(
                    lp, x, pending, cfg, positions, lcache, index, mode, pages, slots, scatter
                )
    return x, pending, cache


def backbone(params: Any, batch: dict, cfg: ArchConfig, mode: str = "train", cache: Any = None):
    """All blocks, no head.  Returns (hidden (B, S, D), cache), the last
    block's residual add applied: the one add of a forward left unfused."""
    x, pending, cache = _blocks(params, batch, cfg, mode, cache)
    return (x if pending is None else x + pending.to(x.dtype)), cache


def head(params: Any, x: torch.Tensor, cfg: ArchConfig,
         pending: torch.Tensor | None = None) -> torch.Tensor:
    """The final norm (of ``x + pending``, fused, when the last block's
    output is pending) and the logits."""
    _, x = add_rmsnorm(params["final_norm"], x, pending, cfg.norm_eps)
    return lm_logits(params["embed"], x, cfg, torch_dtype(cfg.compute_dtype))


def forward(params: Any, batch: dict, cfg: ArchConfig, mode: str = "train", cache: Any = None):
    """Returns (logits, cache).  Every residual add lands in a norm."""
    x, pending, cache = _blocks(params, batch, cfg, mode, cache)
    s = x.shape[1]
    logits = head(params, x, cfg, pending)
    if cache is not None:  # in place: a CUDA graph replay writes the caller's tensor
        if mode in ("decode", "extend"):
            cache["index"].add_(s)
        else:  # prefill: every row's cache now holds s tokens
            cache["index"].fill_(s)
    return logits, cache


def prefill(params: Any, batch: dict, cfg: ArchConfig, cache: Any):
    return forward(params, batch, cfg, mode="prefill", cache=cache)


def decode_step(params: Any, tokens: torch.Tensor, cfg: ArchConfig, cache: Any):
    """tokens (B, 1) -> (logits (B, 1, V), cache); ``cache["index"]`` (B,)
    is each row's write position for this token."""
    return forward(params, {"tokens": tokens}, cfg, mode="decode", cache=cache)
