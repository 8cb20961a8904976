"""Step builders shared by the trainer and the dry-run (the port of
``repro/launch/steps.py``).

``input_specs``, ``abstract_state`` and ``abstract_cache`` build a cell's
inputs as fake tensors (the counterpart of the reference's
``ShapeDtypeStruct`` trees): every shape and dtype of the real ones, no
memory taken, so the dry-run (``launch/dryrun.py``) traces the exact
train, prefill and decode programs at any size.  ``make_prefill_step``
and ``make_decode_step`` are the dry-run's serving steps, the reference's
pure functions over a contiguous cache; the engine serves through its own
step programs (``serve/programs.py``).

The train step takes the loss's gradient with ``torch.autograd`` through
the model's function blocks: on the card the CUDA kernels of flash
attention and RMSNorm run forward and backward (their autograd Functions),
and a block with no backward kernel raises unless it is bound to
``torch``.  It updates the parameters and moments in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core import graph_analysis
from repro_torch.models import lm
from repro_torch.models import params as pm
from repro_torch.models.params import torch_dtype
from repro_torch.optim.adamw import AdamW, OptState, tree_leaves
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding.utils import is_dtensor


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    microbatch: int | None = None  # grad-accumulation chunks of the batch


# -- abstract inputs (the dry-run contract) ---------------------------------------------


def _empty_tree(metas: Any, mode: Any, device: Any) -> Any:
    with mode:
        return pm.tree_map_metas(
            lambda m: torch.empty(m.shape, dtype=torch_dtype(m.dtype), device=device), metas
        )


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, mode: Any = None,
                device: Any = "cpu") -> dict[str, Any]:
    """Fake stand-ins (in ``mode``, on ``device``) for every model input of
    this cell."""
    mode = mode or graph_analysis.fake_mode()
    b, s = shape.global_batch, shape.seq_len
    with mode:
        tok = lambda bb, ss: torch.empty((bb, ss), dtype=torch.int32, device=device)  # noqa: E731
        embeds = lambda: torch.empty((b, s, cfg.d_model),  # noqa: E731
                                     dtype=torch_dtype(cfg.compute_dtype), device=device)
        if shape.kind == "train":
            if cfg.frontend == "patch_embed":
                return {"embeds": embeds(), "labels": tok(b, s)}
            return {"tokens": tok(b, s), "labels": tok(b, s)}
        if shape.kind == "prefill":
            if cfg.frontend == "patch_embed":
                return {"embeds": embeds()}
            return {"tokens": tok(b, s)}
        # decode: one new token; the seq_len lives in the cache
        return {"tokens": tok(b, 1)}


def abstract_state(cfg: ArchConfig, opt: AdamW | None = None, *, mode: Any = None,
                   device: Any = "cpu"):
    """(params, opt_state) as fake tensors (opt_state None without ``opt``)."""
    mode = mode or graph_analysis.fake_mode()
    metas = lm.build_metas(cfg)
    params = _empty_tree(metas, mode, device)
    if opt is None:
        return params, None
    mdt = torch_dtype(opt.moment_dtype)
    with mode:
        mom = lambda: pm.tree_map_metas(  # noqa: E731
            lambda m: torch.empty(m.shape, dtype=mdt, device=device), metas)
        state = OptState(mu=mom(), nu=mom(),
                         step=torch.empty((), dtype=torch.int32, device=device))
    return params, state


def abstract_cache(cfg: ArchConfig, shape: ShapeConfig, page_size: int | None = None,
                   n_pages: int | None = None, *, mode: Any = None, device: Any = "cpu"):
    """The cell's KV cache as fake tensors — contiguous, or block-paged when
    ``page_size`` / ``n_pages`` are given, with the ``pages`` page table
    ((B, max_pages) int32) the paged decode reads through."""
    mode = mode or graph_analysis.fake_mode()
    metas = lm.cache_metas_tree(cfg, shape.global_batch, shape.seq_len,
                                page_size=page_size, n_pages=n_pages)
    tree = _empty_tree(metas, mode, device)
    if page_size is not None:
        max_pages = -(-shape.seq_len // page_size)
        with mode:
            tree["pages"] = torch.empty((shape.global_batch, max_pages), dtype=torch.int32,
                                        device=device)
    return tree


# -- steps --------------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, opt: AdamW, hyper: TrainHyper = TrainHyper(),
                    grad_shardings: Any = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient (with ``hyper.microbatch`` > 1,
    summed over that many slices of the batch in the moment dtype and
    averaged, the metrics too), the warm-up / cosine learning rate at the
    optimizer's step, and one AdamW update, in place.  ``batch`` holds
    tensors on the parameters' device; ``metrics`` are detached f32
    scalars on it (whole tensors under a mesh).

    Under a mesh (``DTensor`` parameters and batch, the step called inside
    ``use_sharding``) ``grad_shardings`` — a tree of placement tuples
    matching ``params`` (:func:`repro_torch.models.params.placement_tree`)
    — redistributes each gradient to its parameter's placements: partial
    sums reduce-scatter into the ZeRO shards instead of all-reducing the
    whole gradient tree."""

    def grads_of(params: Any, leaves: list, batch: dict):
        with torch.enable_grad():
            total, metrics = lm.loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf the loss does not reach (pixtral's token embedding under
        # patch embeddings) gets zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if grad_shardings is not None:
            grads = [g.redistribute(g.device_mesh, pl)
                     for g, pl in zip(grads, tree_leaves(grad_shardings))]
        return grads, {k: _whole(v.detach()) for k, v in metrics.items()}

    def train_step(params: Any, opt_state: OptState, batch: dict):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n = hyper.microbatch or 1
        if n > 1:
            acc_dt = torch_dtype(opt.moment_dtype)
            # a DTensor leaf's accumulator takes its placements
            acc = [torch.zeros_like(p, dtype=acc_dt) if is_dtensor(p)
                   else torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
            metrics = None
            for i in range(n):
                mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                      for k, v in batch.items()}
                grads, m = grads_of(params, leaves, mb)
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dt))
                metrics = m if metrics is None else {k: metrics[k] + m[k] for k in m}
            grads = [a / n for a in acc]
            metrics = {k: v / n for k, v in metrics.items()}
        else:
            grads, metrics = grads_of(params, leaves, batch)
        grads = _unflatten_like(params, grads)
        lr = warmup_cosine(opt_state.step, hyper.base_lr, hyper.warmup_steps, hyper.total_steps)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, metrics

    return train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a ``DTensor``'s full value)."""
    return t.full_tensor() if is_dtensor(t) else t


def _unflatten_like(tree: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) as a tree of ``tree``'s
    structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, init_cache: Any = None):
    """``prefill_step(params, batch) -> (logits (B, V) of the last
    position, cache)``: a zeroed contiguous cache for the cell, filled by
    the whole prompt.  Only the final hidden state is projected: the (B, S,
    V) logits are never made.  ``init_cache`` (device -> cache), if given,
    makes the zeroed cache (under a mesh: ``DTensor`` shards, the
    counterpart of the reference's ``out_shardings``)."""

    def prefill_step(params: Any, batch: dict):
        device = next(iter(batch.values())).device
        if init_cache is not None:
            cache = init_cache(device)
        else:
            cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
        x, pending, cache, _ = lm._blocks(params, batch, cfg, "prefill", cache)
        # the last position's rows, dense (the norm kernel takes contiguous rows)
        last = None if pending is None else pending[:, -1:].contiguous()
        logits = lm.head(params, x[:, -1:].contiguous(), cfg, last)
        cache["index"].fill_(shape.seq_len)
        return logits[:, 0, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, cache, batch) -> (logits (B, V), cache)``: one
    token per row against the cache, which advances in place."""

    def decode_step(params: Any, cache: Any, batch: dict):
        logits, cache = lm.decode_step(params, batch["tokens"], cfg, cache)
        return logits[:, 0, :], cache

    return decode_step
