"""Seeded weights, drawn on the device in the dtypes they are served in.

The tree's layout (names, shapes, dtypes, init kinds and scales) is the
port's parameter interface, ``lm.compute_metas``: the harness draws every
leaf itself from ``--seed``, with one ``torch.Generator`` on the device,
one call a stacked leaf, directly in the leaf's dtype.  The same tensors
go to the engine (``ServeEngine(params=...)``) and to the reference.
"""

from __future__ import annotations

from typing import Any

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int32": torch.int32}


def draw(metas: Any, seed: int, device: torch.device) -> Any:
    """A tensor for every leaf of a meta tree (objects with ``shape``,
    ``dtype``, ``init`` and ``scale``), in sorted-key order."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)

    def make(m) -> torch.Tensor:
        dt = DTYPES[m.dtype]
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dt, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dt, device=device)
        if m.init != "normal":
            raise ValueError(f"the harness draws no '{m.init}' leaf")
        return torch.randn(m.shape, generator=gen, dtype=dt, device=device).mul_(m.scale)

    def build(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return make(tree)

    return build(metas)
