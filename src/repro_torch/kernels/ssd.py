"""Mamba-2 SSD (state-space duality) chunk terms: the CUDA kernel's wrapper
(``csrc/ssd_chunks.cu``, the port of ``repro/kernels/ssd.py``'s
``ssd_chunks_pallas``) and its plain version.

For every (batch, chunk of L steps, head) the chunk terms of the
selective scan ``h_t = exp(a dt_t) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t``:

* ``y_intra``  (B, S, H, P): ``((C B^T) o Lambda o dt_j) x`` with
  ``Lambda[i, j] = exp(a_cum[i] - a_cum[j])`` on ``i >= j``;
* ``states``   (B, NC, H, N, P): ``(B o dt exp(a_tot - a_cum))^T x``;
* ``cumdecay`` (B, S, H): ``exp(a_cum)``;
* ``totals``   (B, NC, H): ``exp(a_tot)``;

all f32, with ``a_cum`` the within-chunk cumulative sum of ``a * dt``.
The O(S / L) scan across chunks runs on top (``ops.ssd_scan``).

The wrapper runs the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: the kernel's compile-time limits (``csrc/ssd_chunks.cu``); at all three limits
#: its f32 shared memory (C B^T and the decay-weighted W, L x L each; B^T
#: and C^T, N x (L + 1); the x tile, L x P; three (L,) vectors) is 231,936
#: bytes, within the H100's 232,448 opt-in limit
MAX_CHUNK = 128
MAX_STATE = 128
MAX_HEAD_DIM = 64


def check_chunks(s: int, chunk: int) -> None:
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")


def ssd_chunks_torch(x, dt, a, bmat, cmat, *, chunk: int):
    """Vectorised plain version (the reference's ``ops._ssd_chunks_jnp``)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    check_chunks(s, chunk)
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    af = a.reshape(h).float()
    bf = bmat.float().reshape(b, nc, chunk, n)
    cf = cmat.float().reshape(b, nc, chunk, n)

    a_cum = torch.cumsum(dtf * af, dim=2)  # (B, NC, L, H)
    a_tot = a_cum[:, :, -1, :]  # (B, NC, H)
    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B, NC, L, L, H)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    lam = torch.where(lower[None, None, :, :, None], torch.exp(diff), 0.0)
    g = torch.einsum("bcin,bcjn->bcij", cf, bf)  # (B, NC, L, L)
    w = g[..., None] * lam * dtf[:, :, None, :, :]  # (B, NC, L, L, H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xf)

    sw = dtf * torch.exp(a_tot[:, :, None, :] - a_cum)  # (B, NC, L, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bf, sw, xf)
    return (
        y_intra.reshape(b, s, h, p),
        states,
        torch.exp(a_cum).reshape(b, s, h),
        torch.exp(a_tot),
    )


def heads_per_cta(b: int, nc: int, h: int, n_sms: int) -> int:
    """Heads one CTA walks under one staged C B^T: as many as keep the grid
    to one wave of ``n_sms`` CTAs (one CTA fits on an SM)."""
    return max(1, min(h, -(-(b * nc * h) // n_sms)))


def _check_rows(name: str, t: torch.Tensor, inner: int) -> None:
    """The kernel takes any batch and sequence strides, but each row's
    trailing dims must be dense."""
    if t.stride(-1) != 1 or (inner > 1 and t.stride(-2) != t.shape[-1]):
        raise ValueError(f"ssd_chunks: {name}'s trailing dims must be contiguous")


def ssd_chunks(x, dt, a, bmat, cmat, *, chunk: int = 128):
    """x (B, S, H, P) f32/bf16, dt (B, S, H) f32, a (H,), B/C (B, S, N) in
    x's dtype -> (y_intra, states, cumdecay, totals), all f32."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    check_chunks(s, chunk)
    a = a.reshape(h).float()
    if x.device.type == "cpu":
        return ssd_chunks_torch(x, dt, a, bmat, cmat, chunk=chunk)
    build.check_cuda("ssd_chunks", a, dt)
    for t in (x, bmat, cmat):
        if t.device != a.device:
            raise ValueError(f"ssd_chunks: every operand must be on {a.device}")
    _check_rows("x", x, 2)
    _check_rows("bmat", bmat, 1)
    _check_rows("cmat", cmat, 1)
    if dt.dtype != torch.float32 or bmat.dtype != x.dtype or cmat.dtype != x.dtype:
        raise TypeError("ssd_chunks: dt must be float32 and B/C of x's dtype")
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n) or dt.shape != (b, s, h):
        raise ValueError("ssd_chunks: dt (B,S,H), B/C (B,S,N) must match x (B,S,H,P)")
    if chunk > MAX_CHUNK or n > MAX_STATE or p > MAX_HEAD_DIM:
        raise ValueError(
            f"ssd_chunks: the kernel takes chunk <= {MAX_CHUNK}, N <= "
            f"{MAX_STATE}, P <= {MAX_HEAD_DIM}; got {chunk}, {n}, {p}"
        )
    nc = s // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, s, h, p), **f32)
    states = torch.empty((b, nc, h, n, p), **f32)
    cumdecay = torch.empty((b, s, h), **f32)
    totals = torch.empty((b, nc, h), **f32)
    if y.numel():
        n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        build.launch(
            "repro_ssd_chunks", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(), states.data_ptr(),
            cumdecay.data_ptr(), totals.data_ptr(),
            x.stride(0), x.stride(1), bmat.stride(0), bmat.stride(1),
            cmat.stride(0), cmat.stride(1),
            b, s, h, p, n, chunk, heads_per_cta(b, nc, h, n_sms),
            build.dtype_code(x), build.stream_of(x),
        )
        ssd_chunks.launches += 1
    return y, states, cumdecay, totals


ssd_chunks.launches = 0
