"""Shared layer primitives: norm, RoPE, SwiGLU MLP, embeddings (the port of
``repro/models/layers.py`` without its tensor-parallel ``shard_map``
branches).

Compute goes through the function-block registry (``blocks.call``) where
the shelf has a kernel.  Matmuls are ``x @ w`` in the compute dtype, as
the reference's ``einsum(x.astype(cd), w.astype(cd))``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blocks
from repro_torch.models.params import ParamMeta


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return blocks.call("rmsnorm", x, w, eps=eps)


def add_rmsnorm(
    w: torch.Tensor, x: torch.Tensor, delta: torch.Tensor | None, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, rmsnorm(x + delta)): a branch's residual add fused into
    the next norm (the sum in x's dtype, as the reference adds).  With no
    pending delta (a forward's first block) the plain norm of x."""
    if delta is None:
        return x, rmsnorm(w, x, eps)
    return blocks.call("rmsnorm", x, w, eps=eps, delta=delta.to(x.dtype))


def gated_rmsnorm(w, y, x, d_skip, z, eps: float) -> torch.Tensor:
    """Mamba-2's gated norm, ``norm((y + d_skip x) * silu(z)) * w`` in f32,
    in z's dtype: one call of the rmsnorm block."""
    return blocks.call("rmsnorm", y, w, eps=eps, gate=(x, d_skip, z))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama-style rotate-half.

    x: (B, S, H, d); positions: (B, S) integer.
    """
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)  # (half,)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -- SwiGLU MLP ------------------------------------------------------------------


def mlp_metas(d_model: int, d_ff: int, dtype: str) -> dict:
    return {
        "gate": ParamMeta((d_model, d_ff), ("embed", "ffn"), dtype),
        "up": ParamMeta((d_model, d_ff), ("embed", "ffn"), dtype),
        "down": ParamMeta((d_ff, d_model), ("ffn", "embed"), dtype),
    }


def mlp_forward(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    xc = x.to(compute_dtype)
    g = xc @ p["gate"].to(compute_dtype)
    u = xc @ p["up"].to(compute_dtype)
    return (F.silu(g) * u) @ p["down"].to(compute_dtype)


# -- embeddings -------------------------------------------------------------------


def embed_metas(cfg: ArchConfig) -> dict:
    d = {
        "embedding": ParamMeta(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), cfg.param_dtype,
            scale=0.02,
        )
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamMeta(
            (cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), cfg.param_dtype,
            scale=0.02,
        )
    return d


def embed_lookup(p: dict, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return p["embedding"].to(compute_dtype)[tokens.long()]


def lm_logits(
    p: dict, x: torch.Tensor, cfg: ArchConfig, compute_dtype: torch.dtype
) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["embedding"].to(compute_dtype).T
    else:
        w = p["lm_head"].to(compute_dtype)
    return x.to(compute_dtype) @ w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32; logits (B, S, V), labels (B, S).
    The same terms as the reference's one-hot contraction (the max shift
    held constant, ``log sum exp(shifted) - shifted[label]``), taking the
    label's logit by a gather: the port has no vocab-sharded logits."""
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
