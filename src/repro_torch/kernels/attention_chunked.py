"""Chunked full-sequence attention with its backward: the port of
``repro/kernels/attention_xla.py`` (``_chunks``, ``_chunked_fwd_core``,
``_core_fwd``, ``_core_bwd``), as a ``torch.autograd.Function``.

The forward runs an online softmax over static (q chunk, kv chunk) blocks
and saves ``(q, k, v, out, lse)``; the backward recomputes each
probability block from ``lse`` instead of keeping the S^2 matrix.  Layouts
are the reference's: q (B, H, Sq, Dk), k (B, KH, Skv, Dk), v (B, KH, Skv,
Dv); ``out`` and ``lse`` are kept grouped, (B, KH, G, Sq, Dv) f32 and (B,
KH, G, Sq).  The causal mask aligns the sequence ends (``off = Skv -
Sq``), as the reference's; for Sq == Skv, the only case training runs,
that is the flash kernel's start-aligned mask.

:func:`flash_attention_bwd_torch` is the plain version of the flash
backward kernel (``csrc/flash_attention_bwd.cu``): ``_core_bwd`` on the
kernel's (B, H, Sq, *) operands, which the CPU tests and ``chip_smoke.py``
phase 2 hold the kernel against.  The shelf's ``attention`` block keeps
:func:`repro_torch.kernels.attention.flash_attention_torch` as its
``torch`` target, so no served trace or stored plan changes.
"""

from __future__ import annotations

import torch

_NEG = -1e30


def _chunks(s: int, target: int = 1024, max_chunks: int = 8) -> int:
    c = max(target, -(-s // max_chunks))
    c = min(c, s)
    while s % c:
        c += 1
    return c


def _p_block(qc_scaled, lsec, kcf, qpos, kpos, causal):
    s = torch.einsum("bkgqd,bksd->bkgqs", qc_scaled, kcf)
    if causal:
        mask = (qpos[:, None] >= kpos[None, :])[None, None, None]
        s = torch.where(mask, s, torch.full_like(s, _NEG))
    return s, torch.exp(s - lsec[..., None])


def _chunked_fwd_core(q, k, v, causal: bool, q_chunk: int, kv_chunk: int):
    """Returns (out (B, KH, G, Sq, Dv) f32, lse (B, KH, G, Sq))."""
    b, h, sq, dk = q.shape
    _, kh, skv, dv = v.shape
    g = h // kh
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = 1.0 / (dk ** 0.5)
    qg = q.reshape(b, kh, g, sq, dk)
    off = skv - sq  # align sequence ends (cached prefix)
    dev = q.device

    outs, lses = [], []
    for qi in range(nq):
        qc = qg[:, :, :, qi * q_chunk:(qi + 1) * q_chunk, :].float() * scale
        qpos = off + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m_acc = torch.full((b, kh, g, q_chunk), _NEG, dtype=torch.float32, device=dev)
        l_acc = torch.zeros((b, kh, g, q_chunk), dtype=torch.float32, device=dev)
        o_acc = torch.zeros((b, kh, g, q_chunk, dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if causal and ki * kv_chunk > off + (qi + 1) * q_chunk - 1:
                continue  # block fully above the diagonal
            kc = k[:, :, ki * kv_chunk:(ki + 1) * kv_chunk, :]
            vc = v[:, :, ki * kv_chunk:(ki + 1) * kv_chunk, :]
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s, _ = _p_block(qc, torch.zeros_like(m_acc), kc.float(), qpos, kpos, causal)
            m_new = torch.maximum(m_acc, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_acc - m_new)
            l_acc = l_acc * alpha + p.sum(dim=-1)
            o_acc = o_acc * alpha[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p, vc.float())
            m_acc = m_new
        l_safe = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
        outs.append(o_acc / l_safe[..., None])
        lses.append(m_acc + torch.log(l_safe))
    return torch.cat(outs, dim=3), torch.cat(lses, dim=3)


def _core_fwd(q, k, v, causal, q_chunk, kv_chunk):
    """(out in q's dtype (B, H, Sq, Dv), residuals (q, k, v, out, lse))."""
    out, lse = _chunked_fwd_core(q, k, v, causal, q_chunk, kv_chunk)
    b, h, sq, _ = q.shape
    return out.reshape(b, h, sq, -1).to(q.dtype), (q, k, v, out, lse)


def _core_bwd(causal, q_chunk, kv_chunk, res, do):
    """(dq, dk, dv) in their inputs' dtypes; ``out`` / ``lse`` grouped
    (B, KH, G, Sq, *).  dK and dV are summed over the group in f32."""
    q, k, v, out, lse = res
    b, h, sq, dk = q.shape
    _, kh, skv, dv = v.shape
    g = h // kh
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = 1.0 / (dk ** 0.5)
    qg = q.reshape(b, kh, g, sq, dk).float()
    dog = do.reshape(b, kh, g, sq, dv).float()
    off = skv - sq
    dev = q.device
    dsum = (dog * out.float()).sum(dim=-1)  # (B, KH, G, Sq)

    dq_parts = []
    dk_parts = [torch.zeros((b, kh, kv_chunk, dk), dtype=torch.float32, device=dev)
                for _ in range(nk)]
    dv_parts = [torch.zeros((b, kh, kv_chunk, dv), dtype=torch.float32, device=dev)
                for _ in range(nk)]
    for qi in range(nq):
        sl = slice(qi * q_chunk, (qi + 1) * q_chunk)
        qc = qg[:, :, :, sl, :] * scale
        doc = dog[:, :, :, sl, :]
        lsec = lse[:, :, :, sl].float()
        dsc = dsum[:, :, :, sl]
        qpos = off + qi * q_chunk + torch.arange(q_chunk, device=dev)
        dq_acc = torch.zeros((b, kh, g, q_chunk, dk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            if causal and ki * kv_chunk > off + (qi + 1) * q_chunk - 1:
                continue
            ksl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            kcf = k[:, :, ksl, :].float()
            vcf = v[:, :, ksl, :].float()
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            _, p = _p_block(qc, lsec, kcf, qpos, kpos, causal)
            dp = torch.einsum("bkgqd,bksd->bkgqs", doc, vcf)
            ds = p * (dp - dsc[..., None])
            dq_acc = dq_acc + torch.einsum("bkgqs,bksd->bkgqd", ds, kcf) * scale
            # qc already carries the 1/sqrt(d) factor
            dk_parts[ki] = dk_parts[ki] + torch.einsum("bkgqs,bkgqd->bksd", ds, qc)
            dv_parts[ki] = dv_parts[ki] + torch.einsum("bkgqs,bkgqd->bksd", p, doc)
        dq_parts.append(dq_acc)

    dq = torch.cat(dq_parts, dim=3)
    return (
        dq.reshape(b, h, sq, dk).to(q.dtype),
        torch.cat(dk_parts, dim=2).to(k.dtype),
        torch.cat(dv_parts, dim=2).to(v.dtype),
    )


class AttentionChunkedFn(torch.autograd.Function):
    """``attention_xla._attention_chunked_core`` with its custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk):
        out, res = _core_fwd(q, k, v, causal, q_chunk, kv_chunk)
        ctx.save_for_backward(*res)
        ctx.meta = (causal, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_core_bwd(*ctx.meta, ctx.saved_tensors, do), None, None, None)


def attention_chunked(
    q: torch.Tensor,  # (B, H, Sq, Dk)
    k: torch.Tensor,  # (B, KH, Skv, Dk)
    v: torch.Tensor,  # (B, KH, Skv, Dv)
    causal: bool = True,
    q_chunk: int | None = None,
    kv_chunk: int | None = None,
) -> torch.Tensor:
    sq, skv = q.shape[2], k.shape[2]
    q_chunk = min(q_chunk or _chunks(sq), sq)
    kv_chunk = min(kv_chunk or _chunks(skv), skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError("sequence lengths must tile by attention chunks")
    return AttentionChunkedFn.apply(q, k, v, causal, q_chunk, kv_chunk)


def flash_attention_bwd_torch(q, k, v, out, lse, do, causal: bool = True):
    """The plain version of the flash backward kernel: q (B, H, Sq, D), k
    (B, KH, Skv, D), v (B, KH, Skv, Dv), out and do (B, H, Sq, Dv), lse (B,
    H, Sq) f32 -> (dq, dk, dv) in their inputs' dtypes, through
    ``_core_bwd`` at the reference's chunk sizes."""
    b, h, sq, _ = q.shape
    kh, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // kh
    res = (q, k, v, out.reshape(b, kh, g, sq, dv), lse.reshape(b, kh, g, sq))
    return _core_bwd(causal, _chunks(sq), _chunks(skv), res, do)
