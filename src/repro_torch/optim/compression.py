"""Gradient compression for cross-replica reduction (the port of
``repro/optim/compression.py``).

``compressed_psum_mean`` runs the data-parallel gradient mean over a mesh
axis with int8 quantization: each rank quantizes its own gradient (a
per-tensor scale, ``max|g| / 127``), all-reduces the int8 payload as
int32 partial sums, max-reduces the scales, and divides by the rank
count — 4x fewer all-reduce bytes than f32.  As the reference computes it,
the result is ``sum_r q_r * max_r s_r / n``: the mean of the dequantized
gradients only when every rank's scale is the same (mirrored, not
fixed).  ``quantize_tree`` exposes the same codec for checkpoint /
offload use; ``ef_update`` is the error-feedback step for loops that
keep a residual buffer."""

from __future__ import annotations

from typing import Any

import torch


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantize_tree(tree: Any) -> Any:
    """Every leaf of a nested dict -> its ``(q int8, scale f32)``."""
    if isinstance(tree, dict):
        return {k: quantize_tree(v) for k, v in tree.items()}
    return _quantize(tree)


def compressed_psum_mean(grads: Any, mesh: Any, axis: str = "data") -> Any:
    """Mean of per-rank gradient trees (plain tensors, each rank its own)
    over the mesh axis ``axis``, int8 on the wire."""
    from torch.distributed import _functional_collectives as funcol

    group = mesh[axis]
    n = group.size()

    def reduce(g: torch.Tensor) -> torch.Tensor:
        q, s = _quantize(g)
        tot = funcol.wait_tensor(funcol.all_reduce(q.to(torch.int32), "sum", group))
        smax = funcol.wait_tensor(funcol.all_reduce(s, "max", group))
        return (tot.to(torch.float32) * smax) / n

    if isinstance(grads, dict):
        return {k: compressed_psum_mean(v, mesh, axis) for k, v in grads.items()}
    return reduce(grads)


def ef_update(grad: torch.Tensor, residual: torch.Tensor):
    """Error-feedback quantization step: returns (q, scale, new_residual)."""
    comp = grad + residual
    q, s = _quantize(comp)
    return q, s, comp - _dequantize(q, s)
