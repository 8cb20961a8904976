"""Gradient compression codec (the port of ``repro/optim/compression.py``):
int8 block quantization with a per-tensor scale (``max|g| / 127``), the
tree form for checkpoint / offload use, and the error-feedback step.  The
cross-replica ``compressed_psum_mean`` waits for distribution (ROADMAP
A15)."""

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


def ef_update(grad: torch.Tensor, residual: torch.Tensor):
    """Error-feedback quantization step: returns (q, scale, new_residual)."""
    comp = grad + residual
    q, s = _quantize(comp)
    return q, s, comp - _dequantize(q, s)
