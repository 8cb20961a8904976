"""AdamW with global-norm clipping and a configurable moment dtype (the
port of ``repro/optim/adamw.py``).

The update math runs in f32 whatever the moment dtype; the global gradient
norm is accumulated in f32 over the leaves in the reference's order
(sorted keys).  As the reference, every leaf with ``ndim >= 2`` is
decayed: matrices and embeddings, and also the stacked norm weights of a
layer group (``(L, d)``), while the unstacked ``final_norm`` (``(d,)``) is
not (mirrored, not fixed).  Unlike the reference's pure update, the port
updates the parameters and moments in place (no second copy of the model
and its moments during the step, and a pass over each f32 tensor an op:
the update is bound by its bytes); the step count is a device tensor, so
an update reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.params import torch_dtype


@dataclasses.dataclass
class OptState:
    mu: Any
    nu: Any
    step: torch.Tensor  # int32 scalar


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict in sorted-key order (``jax.tree.leaves``'
    order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"

    def init(self, params: Any) -> OptState:
        dt = torch_dtype(self.moment_dtype)
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"
        return OptState(
            mu=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
            nu=tree_map(lambda p: torch.zeros(p.shape, dtype=dt, device=p.device), params),
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any,
               lr: torch.Tensor | float) -> tuple[Any, OptState]:
        """One step, in place: returns ``(params, state)``, the same trees."""
        gs = tree_leaves(grads)
        # global-norm clip (f32 accumulation, leaf sums added in leaf order)
        total = None
        for g in gs:
            sq = torch.sum(torch.square(g.float()))
            total = sq if total is None else total + sq
        gnorm = torch.sqrt(total)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        state.step += 1
        t = state.step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32, device=t.device), t)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=t.device)
        for p, g, m, v in zip(tree_leaves(params), gs, tree_leaves(state.mu),
                              tree_leaves(state.nu)):
            # the reference's f32 formulas, evaluated in place (a pass of
            # each f32 tensor an op: the update is bound by those bytes)
            g32 = g.float() * scale
            m32, v32, p32 = m.float(), v.float(), p.float()  # the same tensors when f32
            m32.mul_(self.b1).add_(g32, alpha=1 - self.b1)
            v32.mul_(self.b2).addcmul_(g32, g32, value=1 - self.b2)
            delta = (m32 / c1).div_((v32 / c2).sqrt_().add_(self.eps))
            if p.ndim >= 2:  # no decay on norms / biases / scalars
                delta.add_(p32, alpha=self.weight_decay)
            p32.sub_(delta.mul_(lr))
            for t, t32 in ((p, p32), (m, m32), (v, v32)):
                if t32 is not t:
                    t.copy_(t32)
        return params, state
