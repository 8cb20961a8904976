"""Causal flash-attention forward: the CUDA kernel's wrapper
(``csrc/flash_attention.cu``, the port of ``repro/kernels/attention.py``'s
``flash_attention_pallas``) and its plain version.

Both take q (B, H, Sq, D), k (B, KH, Skv, D) and v (B, KH, Skv, Dv) and
return (B, H, Sq, Dv); query head ``h`` reads kv head ``h // (H // KH)``,
and scores are scaled by ``1/sqrt(D)``.  The causal mask is aligned at the start
(key ``j`` visible to query ``i`` iff ``j <= i``), as in the TPU kernel;
for Sq == Skv, the only case prefill produces, that equals the reference
``attention_ref``'s end-aligned mask.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

_NEG = -1e30
#: the CUDA-core route's largest head dim, for q/k and for v (16 a lane)
MAX_HEAD_DIM = 512
#: the kernel's routes, by the code the C entry point takes
ROUTES = ("cuda_cores", "wgmma")


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


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel's route for these operands: bf16 with D == Dv <= 128,
    D % 8 == 0 and 16-byte aligned operands (what TMA loads) runs on
    wgmma; f32 and every other bf16 shape on the CUDA cores."""
    d, dv = q.shape[-1], v.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    tma = q.dtype == torch.bfloat16 and d == dv <= 128 and d % 8 == 0 and aligned
    return "wgmma" if tma else "cuda_cores"


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones.

    The route comes from :func:`flash_route` (D, Dv <= 512 on the CUDA
    cores); ``flash_attention.routes`` counts the launches of each."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    build.check_cuda("flash_attention", q, k, v)
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    dv = v.shape[-1]
    if k.shape != (b, kh, skv, d) or v.shape != (b, kh, skv, dv) or h % kh:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} do not fit"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share one dtype")
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {d}, {dv} exceed {MAX_HEAD_DIM}")
    out = q.new_empty((b, h, sq, dv))
    if out.numel() == 0 or skv == 0:
        return out
    route = flash_route(q, k, v)
    build.launch(
        "repro_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, kh, sq, skv, d, dv, int(causal), 1.0 / d ** 0.5,
        build.dtype_code(q), ROUTES.index(route), build.stream_of(q),
    )
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
