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
launches the kernel or raises.  The C entry point picks the route by
dtype: bf16 (every config's path) on the tensor cores, with the f32
factors W and ``B o sw`` split into two bf16 terms each; f32 on the CUDA
cores.  Neither route limits chunk, N or P beyond the shared memory its
tiles take (chunks of several thousand steps).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build


def check_chunks(s: int, chunk: int) -> None:
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")


def ssd_chunks_torch(x, dt, a, bmat, cmat, *, chunk: int, dtype=torch.float32):
    """Vectorised plain version (the reference's ``ops._ssd_chunks_jnp``),
    computed in ``dtype`` (f32; f64 gives the checks their exact terms)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    check_chunks(s, chunk)
    nc = s // chunk
    xf = x.to(dtype).reshape(b, nc, chunk, h, p)
    dtf = dt.to(dtype).reshape(b, nc, chunk, h)
    af = a.reshape(h).to(dtype)
    bf = bmat.to(dtype).reshape(b, nc, chunk, n)
    cf = cmat.to(dtype).reshape(b, nc, chunk, n)

    a_cum = torch.cumsum(dtf * af, dim=2)  # (B, NC, L, H)
    a_tot = a_cum[:, :, -1, :]  # (B, NC, H)
    diff = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]  # (B, NC, L, L, H)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    # masked before the exp, not after (the reference's where(mask, exp, 0)):
    # above the diagonal diff is a sum of up to L - 1 positive -dt a terms
    # and overflows f32 at full width (chunk 128: ~200), and the where's
    # zero cotangent times that inf would make every gradient NaN; the
    # forward is the same bits either way (exp(-inf) = 0)
    lam = torch.exp(diff.masked_fill(~lower[None, None, :, :, None], float("-inf")))
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


def _seq_strides(t: torch.Tensor) -> tuple[int, int]:
    """The batch and sequence strides of ``t`` (B, S, ...); a dim of length
    1 gets the dense stride (it is never stepped, but a tensor map needs a
    valid one)."""
    b, s = t.shape[:2]
    ss = t.stride(1) if s > 1 else math.prod(t.shape[2:])
    return (t.stride(0) if b > 1 else s * ss), ss


def _check_rows(name: str, t: torch.Tensor, inner: int) -> None:
    """The kernel takes any batch and sequence strides, but each row's
    trailing dims must be dense."""
    if t.stride(-1) != 1 or (inner > 1 and t.stride(-2) != t.shape[-1]):
        raise ValueError(f"ssd_chunks: {name}'s trailing dims must be contiguous")


def ssd_work(x: torch.Tensor, n: int, chunk: int) -> build.Work:
    """The chunk kernel's work at x (B, S, H, P) and B/C of width ``n``:
    x, B and C read once in x's type, the f32 dt and a once, the four f32
    outputs (y, the chunks' states, cumdecay, totals) written once; FLOPs:
    the L(L+1)/2 entries of C B^T (N products each) once per (batch,
    chunk), and per head those of W x (P each) and the state product."""
    b, s, h, p = x.shape
    nc = s // chunk
    e = x.element_size()
    nbytes = (e * (x.numel() + 2 * b * s * n) + 4 * (b * s * h + h)
              + 4 * (x.numel() + b * nc * h * n * p + b * s * h + b * nc * h))
    tri = chunk * (chunk + 1)  # twice the triangle's entries: 2 flops a product
    flops = b * nc * (tri * n + h * (tri * p + 2 * chunk * n * p))
    return build.Work(flops, nbytes, build.peak_of(x.dtype))


def ssd_chunks(x, dt, a, bmat, cmat, *, chunk: int = 128):
    """x (B, S, H, P) f32/bf16, dt (B, S, H) f32, a (H,), B/C (B, S, N) in
    x's dtype -> (y_intra, states, cumdecay, totals), all f32.  bf16
    operands are padded or copied only where TMA cannot load them."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    check_chunks(s, chunk)
    a = a.reshape(h).float()
    if x.device.type == "cpu":
        return ssd_chunks_torch(x, dt, a, bmat, cmat, chunk=chunk)
    build.refuse_grad("ssd_chunks", "ssd_scan", x, dt, a, bmat, cmat)
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
    nc = s // chunk
    work = ssd_work(x, n, chunk) if build.is_abstract(x) else None  # before any padding
    f32 = dict(dtype=torch.float32, device=x.device)
    cumdecay = torch.empty((b, s, h), **f32)
    totals = torch.empty((b, nc, h), **f32)
    if x.dtype == torch.bfloat16:
        # TMA's 16-byte strides: N and P padded with zeros (zero columns of
        # B and C add nothing to C B^T; zero columns of x give zero columns
        # of y and the states, sliced away)
        x, bmat, cmat = (build.tma_operand(t) for t in (x, bmat, cmat))
    pp, nn = x.shape[-1], bmat.shape[-1]
    y = torch.empty((b, s, h, pp), **f32)
    states = torch.empty((b, nc, h, nn, pp), **f32)
    if y.numel() and not build.skip_launch("ssd_chunks", x, work=lambda: work):
        build.launch(
            "repro_ssd_chunks", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(), states.data_ptr(),
            cumdecay.data_ptr(), totals.data_ptr(),
            *_seq_strides(x), *_seq_strides(bmat), *_seq_strides(cmat),
            b, s, h, pp, nn, chunk, build.dtype_code(x), build.stream_of(x),
        )
        ssd_chunks.launches += 1
    if (pp, nn) != (p, n):
        y, states = y[..., :p].contiguous(), states[..., :n, :p].contiguous()
    return y, states, cumdecay, totals


ssd_chunks.launches = 0
