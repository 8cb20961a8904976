"""Step builders of the trainer (the port of ``repro/launch/steps.py``'s
``TrainHyper`` and ``make_train_step``; the serving steps are the engine's
own programs, and ``input_specs`` / ``abstract_*`` wait for the dry-run,
ROADMAP A13).

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

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.params import torch_dtype
from repro_torch.optim.adamw import AdamW, OptState, tree_leaves
from repro_torch.optim.schedule import warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    base_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    microbatch: int | None = None  # grad-accumulation chunks of the batch


def make_train_step(cfg: ArchConfig, opt: AdamW, hyper: TrainHyper = TrainHyper()):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient (with ``hyper.microbatch`` > 1,
    summed over that many slices of the batch in the moment dtype and
    averaged, the metrics too), the warm-up / cosine learning rate at the
    optimizer's step, and one AdamW update, in place.  ``batch`` holds
    tensors on the parameters' device; ``metrics`` are detached f32
    scalars on it."""

    def grads_of(params: Any, leaves: list, batch: dict):
        with torch.enable_grad():
            total, metrics = lm.loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
        # a leaf the loss does not reach (pixtral's token embedding under
        # patch embeddings) gets zeros, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(params: Any, opt_state: OptState, batch: dict):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        n = hyper.microbatch or 1
        if n > 1:
            acc_dt = torch_dtype(opt.moment_dtype)
            acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
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


def _unflatten_like(tree: Any, leaves: list) -> Any:
    """``leaves`` (in :func:`tree_leaves` order) as a tree of ``tree``'s
    structure."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)
