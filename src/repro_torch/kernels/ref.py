"""Plain-torch oracles (the port of ``repro/kernels/ref.py``: the serving
path's blocks and the offload pipeline's matmul, Schur update, 2-D FFT and
LU check)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A @ B accumulated in f32, returned in the promoted input type."""
    out = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out)


def schur_update_ref(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return c - a @ b


def fft2d_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(x).to(torch.complex64)


def lu_reconstruct(lu: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """Rebuild P^-1 L U from a packed factorisation + NR/LAPACK pivots —
    the pivot-invariant way to verify an LU."""
    n = lu.shape[0]
    l = torch.tril(lu, -1) + torch.eye(n, dtype=lu.dtype, device=lu.device)
    a = l @ torch.triu(lu)
    for j, i in reversed(list(enumerate(piv.tolist()))):  # undo swaps in reverse
        a[[j, i]] = a[[i, j]]
    return a


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
