"""Parameter metadata: one source of truth for the shape, dtype and
initialisation of every model parameter and cache leaf (the port of
``repro/models/params.py``; sharding specs are not ported).

``build_*_metas`` functions return nested dicts of :class:`ParamMeta`; the
same tree materialises parameters (:func:`init_params`) and caches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    dtype: str = "float32"
    init: str = "normal"  # "normal" | "zeros" | "ones" | "ssm_a" | "dt_bias"
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map_metas(fn: Callable[[ParamMeta], Any], tree: Any) -> Any:
    if isinstance(tree, ParamMeta):
        return fn(tree)
    return {k: tree_map_metas(fn, v) for k, v in tree.items()}


def init_params(
    metas: Any, seed: int = 0, device: "torch.device | str" = "cpu"
) -> Any:
    """Materialise a meta tree on ``device``; random leaves draw from one
    ``torch.Generator`` seeded with ``seed`` on that device, in sorted-key
    leaf order (the order ``jax.tree`` flattens dicts).  The draws differ
    from ``jax.random``'s: the tests carry the reference's weights across
    with ``repro_torch.bridge``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(m: ParamMeta) -> torch.Tensor:
        dt = torch_dtype(m.dtype)
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dt, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dt, device=device)
        if m.init == "ssm_a":  # A_log: log of uniform [1, 16)
            u = torch.rand(m.shape, generator=gen, dtype=torch.float32, device=device)
            return torch.log(1.0 + 15.0 * u).to(dt)
        if m.init == "dt_bias":  # softplus^-1 of a log-uniform dt in [1e-3, 1e-1]
            u = torch.rand(m.shape, generator=gen, dtype=torch.float32, device=device)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dtv = torch.exp(u * (hi - lo) + lo)
            return (dtv + torch.log(-torch.expm1(-dtv))).to(dt)
        if m.init != "normal":
            raise NotImplementedError(f"init '{m.init}' is not ported yet")
        x = torch.randn(m.shape, generator=gen, dtype=torch.float32, device=device)
        # scaled in place: one f32 copy of the leaf at a time (a stacked
        # expert leaf of arctic-480b is 17.8 GB in f32)
        return x.mul_(m.scale).to(dt)

    def build(tree: Any) -> Any:
        if isinstance(tree, ParamMeta):
            return make(tree)
        return {k: build(tree[k]) for k in sorted(tree)}

    return build(metas)

