"""Plain-torch oracles (the port of ``repro/kernels/ref.py``: the serving
path's blocks, the sequential SSD scan, and the offload pipeline's matmul,
Schur update, 2-D FFT and LU check)."""

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


def lu_ref(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """LAPACK-style getrf oracle: the packed LU and its 0-based pivots, as
    ``jax.scipy.linalg.lu_factor`` returns them."""
    lu, piv = torch.linalg.lu_factor(a)
    return lu, (piv - 1).to(torch.int32)


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


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    a: torch.Tensor,  # (H,) negative
    bmat: torch.Tensor,  # (B, S, N)
    cmat: torch.Tensor,  # (B, S, N)
    h0: torch.Tensor | None = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective-scan oracle:
    h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t.
    Returns (y (B, S, H, P) f32, final state (B, H, N, P) f32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf = bmat.float(), cmat.float()
    hprev = (
        torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
        if h0 is None else h0.float()
    )
    ys = []
    for t in range(s):
        decay = torch.exp(af[None, :] * dtf[:, t])  # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], bf[:, t], xf[:, t])
        hprev = hprev * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], hprev))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    return y, hprev
