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
``rmsnorm``.  A batch carries ``tokens`` (B, S), or ``embeds`` (B, S, D)
for a patch-embed frontend (pixtral), and for training ``labels`` (B, S).

Modes: ``train`` (:func:`loss_fn`: the loss, with each MoE layer's Switch
aux loss summed and weighted by ``moe.aux_loss_coef``; with ``cfg.remat ==
"full"`` each layer and the head with its cross entropy are checkpointed
and recomputed in the backward, as the reference's ``jax.checkpoint``;
:data:`REMAT_POLICY` ``"save_moe"`` keeps each MoE block's output),
``prefill`` (fill the cache, logits), ``decode`` (one token per row
against the cache) and ``extend`` (an S-token chunk per row, causal within
the chunk).  ``cache["index"]`` is per-slot (B,): rows decode at their own
positions (continuous batching); a paged cache also carries
``cache["pages"]``, the (B, max_pages) page table; a contiguous ``extend``
may carry ``cache["slots"]``, the (B,) rows of a larger cache that the
batch extends (the serve engine's chunked prefill).  Caches are updated in
place and returned, ``cache["index"]`` too (the same tensor, advanced).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

import repro_torch.kernels  # noqa: F401  (registers the function blocks)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import blocks
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
    cross_entropy,
    embed_lookup,
    embed_metas,
    lm_logits,
    mlp_forward,
    mlp_metas,
)
from repro_torch.models.moe import moe_forward, moe_metas
from repro_torch.models.params import ParamMeta, torch_dtype
from repro_torch.models.ssm import ssm_forward, ssm_metas, ssm_state_metas
from repro_torch.sharding.utils import constrain, current_mesh, current_rules, use_sharding


# -- pattern grouping ------------------------------------------------------------


#: Remat policy for the per-layer checkpoint: "none" recomputes everything
#: (the paper-faithful baseline); "save_moe" keeps what each MoE block
#: computes so the backward never re-runs the expert forward, the
#: counterpart of the reference's ``save_only_these_names("moe_out")`` (a
#: dry-run knob).  The reference's XLA remat saves the block's output and
#: recomputes only the part of the block its VJP reads; an eager recompute
#: cannot drop part of a block, so the port saves every op run inside
#: :func:`_moe_block` and recomputes the rest of the layer: the MoE forward
#: runs once a layer a step.
REMAT_POLICY = "none"
#: depth of MoE blocks the current thread is inside (the policy's region)
_moe_region = threading.local()


@contextlib.contextmanager
def _moe_block():
    depth = getattr(_moe_region, "depth", 0)
    _moe_region.depth = depth + 1
    try:
        yield
    finally:
        _moe_region.depth = depth


def _save_moe_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save what an MoE block computes, recompute the rest."""
    if getattr(_moe_region, "depth", 0):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


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
        return tree.to(cd) if _cast_for_compute(tree.ndim, stacked) else tree

    return cast(params, False)


def _cast_for_compute(ndim: int, stacked: bool) -> bool:
    """Whether :func:`cast_for_compute` casts a leaf: a matrix per layer."""
    return ndim - stacked >= 2


def compute_metas(cfg: ArchConfig) -> dict:
    """:func:`build_metas` with each leaf in the dtype
    :func:`cast_for_compute` leaves it in: the parameters as the serve
    engine and the zoo's serving cells hold them on the device."""

    def cast(tree: Any, stacked: bool) -> Any:
        if isinstance(tree, pm.ParamMeta):
            if _cast_for_compute(len(tree.shape), stacked):
                return dataclasses.replace(tree, dtype=cfg.compute_dtype)
            return tree
        return {k: cast(v, stacked or k == "blocks") for k, v in tree.items()}

    return cast(build_metas(cfg), False)


# -- block application ----------------------------------------------------------------


def _unbind(tree: Any, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, as views.  Under
    autograd one ``unbind`` a leaf gives one backward that stacks the
    layers' gradients once; indexing each layer apart would give each of
    the ``n`` selects a backward that fills and adds a stack-sized zero
    tensor (``n`` times the stack's bytes, read and written, a step)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views: in-place cache writes land in
    the stacked tensors)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _region_input(h: torch.Tensor) -> torch.Tensor:
    """A mixer's or the head's input with the whole sequence (the
    sequence-parallel all-gather that opens a region; a no-op off a mesh).
    Gathered here, the projections' ``(B, S)`` flatten splits the batch
    only: a flatten of a batch and a sequence both sharded makes a strided
    shard, whose redistribution reads every offset on the host."""
    return constrain(h, "act_batch", None, None)


def _apply_attn_block(lp, x, pending, cfg, positions, cache, index, mode, pages=None,
                      slots=None, scatter=None):
    """Returns (x, pending, aux): the residual stream with the attention
    output added (fused into ln2), the FFN's output (the MoE's on an MoE
    layer), which the next norm adds, and the MoE's aux loss (None on a
    dense layer)."""
    cd = torch_dtype(cfg.compute_dtype)
    x, h_in = add_rmsnorm(lp["ln1"], x, pending, cfg.norm_eps)
    h_in = _region_input(h_in)
    attn_out, cache = attention_forward(
        lp["attn"], h_in.to(cd), cfg, positions, cache, index, mode, pages, slots, scatter
    )
    x, ff_in = add_rmsnorm(lp["ln2"], x, attn_out, cfg.norm_eps)
    if "moe" in lp:
        ff_in = ff_in.to(cd)
        with _moe_block():
            out, aux = moe_forward(lp["moe"], ff_in, cfg, cd)
        return x, out, aux
    return x, mlp_forward(lp["mlp"], ff_in.to(cd), cd), None


def _apply_mamba_block(lp, x, pending, cfg, cache, mode):
    if mode == "extend":
        raise ValueError(
            "chunked prefill (extend mode) is unsupported for SSM blocks: "
            "resuming the scan needs the conv window stitched across chunk "
            "boundaries"
        )
    cd = torch_dtype(cfg.compute_dtype)
    x, h_in = add_rmsnorm(lp["ln"], x, pending, cfg.norm_eps)
    h_in = _region_input(h_in)
    out, _ = ssm_forward(lp["mixer"], h_in.to(cd), cfg, cache, mode)
    return x, out, None


# -- forward / serve ----------------------------------------------------------------------


def _remat(fn, *args, policy=None):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    recomputed in the backward, but for what a selective ``policy`` saves.
    The recompute runs under the block bindings and the sharding context
    in force now: on the card
    autograd runs the backward on its own device thread, where this
    thread's bindings (thread-local) are not, and the recompute would
    otherwise take other targets than the forward did."""
    bound = blocks.registry.current_pattern()
    mesh, rules = current_mesh(), current_rules()

    def run(*a):
        with blocks.bind(bound), use_sharding(mesh, rules):
            return fn(*a)

    kw = {}
    if policy is not None:
        # the saved region writes some of its buffers in place (the MoE
        # router's scatters): the recompute takes each op's saved output,
        # written as the forward left it, and runs none of them again
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, policy,
                                             allow_cache_entry_mutation=True)
    return checkpoint(run, *args, use_reentrant=False, **kw)


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
    """All blocks.  Returns (x, pending, cache, aux): every block's residual
    add lands in the next block's norm (``add_rmsnorm``), so the last
    block's output is still pending (None if there is no block); aux is the
    MoE layers' aux losses summed in layer order (f32; train mode only,
    None otherwise or without an MoE layer).  In ``train`` mode with
    ``cfg.remat == "full"`` (and grad mode on) each layer runs under
    ``torch.utils.checkpoint``, carrying ``(x, pending)``: the backward
    recomputes the layer from its inputs."""
    cd = torch_dtype(cfg.compute_dtype)
    if "embeds" in batch:
        x = batch["embeds"].to(cd)
    else:
        x = embed_lookup(params["embed"], batch["tokens"], cd)
    x = constrain(x, "act_batch", "act_seq", None)
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

    remat = mode == "train" and cfg.remat == "full" and torch.is_grad_enabled()
    policy = _save_moe_policy if REMAT_POLICY == "save_moe" and cfg.moe else None
    pending = None
    aux = None
    for g in groups_of(cfg):
        gcache = cache[g.key] if cache is not None else None
        gparams = None if g.kind == "s" else _unbind(params["blocks"][g.key], g.count)
        for i in range(g.count):
            lcache = _layer(gcache, i) if gcache is not None else None
            # each 's' site applies the one shared set to its own cache
            lp = params["shared_block"] if g.kind == "s" else gparams[i]
            if g.kind == "m":
                def block(x, pending, lp=lp, lcache=lcache):
                    return _apply_mamba_block(lp, x, pending, cfg, lcache, mode)
            else:
                def block(x, pending, lp=lp, lcache=lcache):
                    return _apply_attn_block(lp, x, pending, cfg, positions, lcache, index,
                                             mode, pages, slots, scatter)
            if remat:
                x, pending, layer_aux = _remat(block, x, pending, policy=policy)
            else:
                x, pending, layer_aux = block(x, pending)
            # the residual stream (x + pending) between blocks
            x = constrain(x, "act_batch", "act_seq", None)
            pending = constrain(pending, "act_batch", "act_seq", None)
            if mode == "train" and layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
    return x, pending, cache, aux


def backbone(params: Any, batch: dict, cfg: ArchConfig, mode: str = "train", cache: Any = None):
    """All blocks, no head.  Returns (hidden (B, S, D), cache), the last
    block's residual add applied: the one add of a forward left unfused."""
    x, pending, cache, _ = _blocks(params, batch, cfg, mode, cache)
    return (x if pending is None else x + pending.to(x.dtype)), cache


def head(params: Any, x: torch.Tensor, cfg: ArchConfig,
         pending: torch.Tensor | None = None) -> torch.Tensor:
    """The final norm (of ``x + pending``, fused, when the last block's
    output is pending) and the logits."""
    _, x = add_rmsnorm(params["final_norm"], x, pending, cfg.norm_eps)
    x = _region_input(x)
    return lm_logits(params["embed"], x, cfg, torch_dtype(cfg.compute_dtype))


def forward(params: Any, batch: dict, cfg: ArchConfig, mode: str = "train", cache: Any = None):
    """Returns (logits, cache).  Every residual add lands in a norm."""
    x, pending, cache, _ = _blocks(params, batch, cfg, mode, cache)
    s = x.shape[1]
    logits = head(params, x, cfg, pending)
    if cache is not None:  # in place: a CUDA graph replay writes the caller's tensor
        if mode in ("decode", "extend"):
            cache["index"].add_(s)
        else:  # prefill: every row's cache now holds s tokens
            cache["index"].fill_(s)
    return logits, cache


def loss_fn(params: Any, batch: dict, cfg: ArchConfig):
    """``(total, {"loss", "ce", "aux"})`` of a batch with ``labels`` (B, S):
    the mean next-token cross entropy in f32 plus ``moe.aux_loss_coef``
    times the MoE layers' summed aux loss, as the reference's ``loss_fn``.
    ``params`` are the f32 master weights, cast to the compute dtype at
    each use (never :func:`cast_for_compute`).  With ``cfg.remat ==
    "full"`` the head and its cross entropy are checkpointed too: the (B,
    S, V) logits are recomputed in the backward, not held."""
    x, pending, _, aux = _blocks(params, batch, cfg, "train", None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = batch["labels"]

    def head_loss(x, pending):
        return cross_entropy(head(params, x, cfg, pending), labels)

    if cfg.remat == "full" and torch.is_grad_enabled():
        ce = _remat(head_loss, x, pending)
    else:
        ce = head_loss(x, pending)
    coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    total = ce + coef * aux
    return total, {"loss": total, "ce": ce, "aux": aux}


def prefill(params: Any, batch: dict, cfg: ArchConfig, cache: Any):
    return forward(params, batch, cfg, mode="prefill", cache=cache)


def decode_step(params: Any, tokens: torch.Tensor, cfg: ArchConfig, cache: Any):
    """tokens (B, 1) -> (logits (B, 1, V), cache); ``cache["index"]`` (B,)
    is each row's write position for this token."""
    return forward(params, {"tokens": tokens}, cfg, mode="decode", cache=cache)
