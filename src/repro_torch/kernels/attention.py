"""Causal flash attention: the forward kernel's wrapper
(``csrc/flash_attention.cu``, the port of ``repro/kernels/attention.py``'s
``flash_attention_pallas``), the backward kernel's
(``csrc/flash_attention_bwd.cu``, the port of ``attention_xla.py``'s
``_core_bwd``), the autograd Function that joins them, and their plain
versions.

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
from repro_torch.kernels.attention_chunked import flash_attention_bwd_torch

_NEG = -1e30
#: the CUDA-core route's largest head dim, for q/k and for v (16 a lane)
MAX_HEAD_DIM = 512
#: the backward kernel's largest head dim, for q/k and for v
MAX_BWD_HEAD_DIM = 256
#: the kernel's routes, by the code the C entry point takes
ROUTES = ("cuda_cores", "wgmma")
#: the largest head dims the forward's wgmma route takes: four column boxes
#: of 64 for q and k, two for v
MAX_WGMMA_HEAD_DIM = 256
MAX_WGMMA_V_HEAD_DIM = 128
#: the backward kernel's routes, by the code its C entry point takes
BWD_ROUTES = ("cuda_cores", "wgmma")
#: the largest head dims the backward's wgmma route takes: four column
#: boxes for q and k (the forward's range), two for v
MAX_WGMMA_BWD_HEAD_DIM = 256
MAX_WGMMA_BWD_V_HEAD_DIM = 128
#: the wgmma route's tile rows: its workspace pads Sq to a multiple
BWD_TILE = 64
_LOG2E = 1.4426950408889634


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


def causal_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """The (query, key) pairs a head attends: under the kernels'
    start-aligned causal mask, query i sees keys 0..i."""
    if not causal:
        return sq * skv
    if sq <= skv:
        return sq * (sq + 1) // 2
    return skv * (skv + 1) // 2 + (sq - skv) * skv


def flash_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True) -> build.Work:
    """The forward's work: q, k and v read once, the (B, H, Sq, Dv) output
    written once; q.k over Dqk and p.v over Dv for each attended pair (the
    causal half), at the operands' peak."""
    b, h, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + b * h * sq * dv)
    flops = 2 * (d + dv) * b * h * causal_pairs(sq, skv, causal)
    return build.Work(flops, nbytes, build.peak_of(q.dtype))


def flash_bwd_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> build.Work:
    """The backward's work: q, k, v, out, do (each of out's shape) and the
    f32 lse read once, dq, dk, dv written once; five products over the
    attended pairs: S and dK, dQ over Dqk, dP and dV over Dv."""
    b, h, sq, d = q.shape
    skv, dv = k.shape[2], v.shape[-1]
    e = q.element_size()
    out = b * h * sq * dv
    nbytes = e * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + 2 * out) + 4 * b * h * sq
    flops = 2 * b * h * causal_pairs(sq, skv, causal) * (3 * d + 2 * dv)
    return build.Work(flops, nbytes, build.peak_of(q.dtype))


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel's route for these operands: bf16 with D and Dv multiples
    of 8, D <= ``MAX_WGMMA_HEAD_DIM``, Dv <= ``MAX_WGMMA_V_HEAD_DIM`` and
    16-byte aligned operands (what TMA loads: deepseek-v2's qk 192 / v 128
    among them) runs on wgmma; f32 and every other bf16 shape on the CUDA
    cores."""
    d, dv = q.shape[-1], v.shape[-1]
    aligned = all(build.aligned(t) for t in (q, k, v))
    tma = (q.dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0
           and d <= MAX_WGMMA_HEAD_DIM and dv <= MAX_WGMMA_V_HEAD_DIM and aligned)
    return "wgmma" if tma else "cuda_cores"


def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One launch of the forward kernel: (out, lse), lse (B, H, Sq) f32 the
    rows' log-sum-exp of their scaled scores when ``with_lse`` (else None,
    and the kernel writes none)."""
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
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0 or skv == 0:
        return out, lse
    route = flash_route(q, k, v)
    if build.skip_launch("flash_attention", q, work=lambda: flash_work(q, k, v, causal)):
        return out, lse
    build.launch(
        "repro_flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, kh, sq, skv, d, dv, int(causal), 1.0 / d ** 0.5,
        build.dtype_code(q), ROUTES.index(route), build.stream_of(q),
    )
    flash_attention.launches += 1
    flash_attention.routes[route] += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """The ``cuda`` target under autograd: the forward kernel (writing
    ``lse``), then the backward kernel (``csrc/flash_attention_bwd.cu``)
    on the saved ``(q, k, v, out, lse)``, as ``attention_xla``'s custom
    VJP saves them."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_cuda(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_bwd_route(*operands: torch.Tensor) -> str:
    """The backward kernel's route for these operands (q, k, v first): bf16
    with D and Dv multiples of 8, D <= ``MAX_WGMMA_BWD_HEAD_DIM``, Dv <=
    ``MAX_WGMMA_BWD_V_HEAD_DIM`` and 16-byte aligned operands (what TMA
    loads: deepseek-v2's qk 192 / v 128 among them) runs on wgmma, f32 and
    every other shape on the CUDA cores."""
    d, dv = operands[0].shape[-1], operands[2].shape[-1]
    aligned = all(build.aligned(t) for t in operands)
    tma = (operands[0].dtype == torch.bfloat16 and d % 8 == 0 and dv % 8 == 0
           and d <= MAX_WGMMA_BWD_HEAD_DIM and dv <= MAX_WGMMA_BWD_V_HEAD_DIM and aligned)
    return "wgmma" if tma else "cuda_cores"


def bwd_delta_torch(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The delta pass's plain version: ``rowsum(do * out)`` in f32, (B, H,
    Sq), the reference ``_core_bwd``'s ``dsum``."""
    return (do.float() * out.float()).sum(-1)


def bwd_workspace_shape(b: int, h: int, sq: int) -> tuple[int, int, int]:
    """The wgmma route's workspace: (B * H, 2, Sq padded to ``BWD_TILE``)
    f32, row 0 the lse in log2 units, row 1 delta."""
    return b * h, 2, -(-sq // BWD_TILE) * BWD_TILE


def bwd_workspace_torch(out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """What the delta pass writes into the workspace: ``lse * log2 e`` and
    delta for each row, and past Sq ``+inf`` and 0, so that a padded row's
    probability ``exp2(s - inf)`` is exactly 0."""
    b, h, sq = lse.shape
    ws = torch.zeros(bwd_workspace_shape(b, h, sq), dtype=torch.float32, device=lse.device)
    ws[:, 0] = float("inf")
    ws[:, 0, :sq] = lse.reshape(b * h, sq) * _LOG2E
    ws[:, 1, :sq] = bwd_delta_torch(out, do).reshape(b * h, sq)
    return ws


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones.

    The route comes from :func:`flash_route` (D, Dv <= 512 on the CUDA
    cores; bf16 up to qk 256 / v 128 on wgmma); ``flash_attention.routes``
    counts the launches of each.  Under autograd (grad mode on, an input
    requiring grad) the call goes through
    :class:`FlashAttentionFn`, whose backward is the backward kernel (head
    dims up to ``MAX_BWD_HEAD_DIM``, a sequence attending to itself)."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal)
    if build.wants_grad(q, k, v):
        if max(q.shape[-1], v.shape[-1]) > MAX_BWD_HEAD_DIM:
            raise ValueError(
                f"flash_attention: the backward kernel takes head dims up to "
                f"{MAX_BWD_HEAD_DIM}, got {q.shape[-1]}, {v.shape[-1]}")
        if causal and q.shape[2] != k.shape[2]:
            raise ValueError("flash_attention: a causal gradient needs Sq == Skv")
        return FlashAttentionFn.apply(q, k, v, causal)
    return _flash_cuda(q, k, v, causal, with_lse=False)[0]


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of the forward from its saved ``out`` and ``lse`` and the
    output's gradient ``do``: the backward kernel for CUDA tensors, its
    plain version (``attention_chunked.flash_attention_bwd_torch``) for CPU
    ones.  dK and dV are summed over each kv head's query heads.  The route
    comes from :func:`flash_bwd_route`; ``flash_attention_bwd.routes``
    counts the launches of each.  The wgmma route's delta pass writes into
    a workspace allocated here (:func:`bwd_workspace_shape`)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_torch(q, k, v, out, lse, do, causal)
    return _flash_attention_bwd_cuda(q, k, v, out, lse, do, causal)


def _flash_attention_bwd_cuda(q, k, v, out, lse, do, causal):
    build.check_cuda("flash_attention_bwd", q, k, v, out, lse, do)
    b, h, sq, d = q.shape
    _, kh, skv, _ = k.shape
    dv = v.shape[-1]
    if (k.shape != (b, kh, skv, d) or v.shape != (b, kh, skv, dv) or h % kh
            or out.shape != (b, h, sq, dv) or do.shape != out.shape
            or lse.shape != (b, h, sq)):
        raise ValueError(
            f"flash_attention_bwd: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, out {tuple(out.shape)}, lse {tuple(lse.shape)}, "
            f"do {tuple(do.shape)} do not fit"
        )
    if any(t.dtype != q.dtype for t in (k, v, out, do)) or lse.dtype != torch.float32:
        raise TypeError("flash_attention_bwd: q, k, v, out and do share one dtype; lse is f32")
    if max(d, dv) > MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dims {d}, {dv} exceed {MAX_BWD_HEAD_DIM}")
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() and k.numel():
        route = flash_bwd_route(q, k, v, out, do, dq, dk, dvv)
        ws = None
        if route == "wgmma":  # the delta pass's rows: (lse, delta) of each query
            ws = torch.empty(bwd_workspace_shape(b, h, sq), dtype=torch.float32,
                             device=q.device)
        if build.skip_launch("flash_attention_bwd", q,
                             work=lambda: flash_bwd_work(q, k, v, causal)):
            return dq, dk, dvv
        build.launch(
            "repro_flash_attention_bwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
            None if ws is None else ws.data_ptr(), 0 if ws is None else ws.numel(),
            b, h, kh, sq, skv, d, dv, int(causal), 1.0 / d ** 0.5,
            build.dtype_code(q), BWD_ROUTES.index(route), build.stream_of(q),
        )
        flash_attention_bwd.launches += 1
        flash_attention_bwd.routes[route] += 1
    return dq, dk, dvv


flash_attention.launches = 0
flash_attention.routes = dict.fromkeys(ROUTES, 0)
flash_attention_bwd.launches = 0
flash_attention_bwd.routes = dict.fromkeys(BWD_ROUTES, 0)
