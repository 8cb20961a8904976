"""Causal flash-attention forward: the CUDA kernel's wrapper
(``csrc/flash_attention.cu``, the port of ``repro/kernels/attention.py``'s
``flash_attention_pallas``) and its plain version.

Both take q (B, H, Sq, D) and k/v (B, KH, Skv, D); query head ``h`` reads
kv head ``h // (H // KH)``.  The causal mask is aligned at the start
(key ``j`` visible to query ``i`` iff ``j <= i``), as in the TPU kernel;
for Sq == Skv, the only case prefill produces, that equals the reference
``attention_ref``'s end-aligned mask.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_NEG = -1e30


def flash_attention_torch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """Plain version: dense masked softmax in f32, q pre-scaled by
    ``1/sqrt(D)`` as the kernel (and the reference's chunked XLA target)."""
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    g = h // kh
    qg = q.reshape(b, kh, g, sq, d).float() * (1.0 / d ** 0.5)
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float())
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    build.check_cuda("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    if k.shape != (b, kh, skv, d) or v.shape != k.shape or h % kh:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if d > 128:
        raise ValueError(f"flash_attention: head dim {d} exceeds 128")
    if q.dtype == torch.bfloat16 and (d % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError(
            f"flash_attention: the bf16 kernel loads by TMA, which needs a head "
            f"dim that is a multiple of 8 (got {d}) and 16-byte aligned operands"
        )
    out = torch.empty_like(q)
    if out.numel() == 0 or skv == 0:
        return out
    build.launch(
        "repro_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kh, sq, skv, d, int(causal), 1.0 / d ** 0.5,
        build.dtype_code(q), build.stream_of(q),
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
