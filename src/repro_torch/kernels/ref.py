"""Plain-torch oracles (the port of ``repro/kernels/ref.py``: only the
ones the serving path's blocks need)."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KH, Skv, D)
    v: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    group = h // kh
    kq = torch.repeat_interleave(k, group, dim=1)
    vq = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) / (d ** 0.5)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (skv - sq)  # align ends
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vq.float()).to(q.dtype)
