"""The plain reference: the served model's forward pass in float32, written
from the published layer equations as the configuration's file states
them (with the departures its ``port`` section lists), in plain PyTorch.

It imports nothing of the measured program and reads nothing the program
made: it takes the harness's own weight tree (the tensors the harness drew
from the seed and handed to both sides), the sizes and semantics of the
configuration's file, and a request's token ids.  Everything the program
derives (the compute-dtype cast, MLA's absorbed query, the latent cache,
the expert dispatch tables) is worked out again here from the equations.

One call runs one request, teacher-forced: the prompt followed by the
tokens the program served, every position through every layer, and the
head at the positions whose logits chose a served token.  It runs layer by
layer, each matrix cast to float32 when used and the attention in blocks
of query rows, so that it fits beside the program's weights.

``matmul`` is the product every projection takes: float32 (TF32 off), or
for the control, the same product with both operands rounded to fp8 e4m3
(each activation row and each weight column scaled to the format's range),
as an fp8 GEMM would compute it.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
QUERY_BLOCK = 512
FP8_MAX = 448.0


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w.float()


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def matmul_fp8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control: fp8 e4m3 operands (per row of ``a``, per column of
    ``w``), accumulated in float32."""
    return _fp8(a, -1) @ _fp8(w.float(), 0)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half rotary embedding of ``x`` (T, H, d) at positions (T,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v for q (T, H, dq), k (T, KH, dq),
    v (T, KH, dv), each group of H / KH query heads on one key head; in
    blocks of query rows."""
    t, h, _ = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    out = torch.empty(t, h, v.shape[-1], dtype=torch.float32, device=q.device)
    for q0 in range(0, t, QUERY_BLOCK):
        q1 = min(q0 + QUERY_BLOCK, t)
        scores = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        ki = torch.arange(q1, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v[:q1])
    return out


def swiglu(p: dict, x: torch.Tensor, mm: Matmul) -> torch.Tensor:
    return mm(F.silu(mm(x, p["gate"])) * mm(x, p["up"]), p["down"])


def gqa(p: dict, x: torch.Tensor, pos: torch.Tensor, dims, sem: dict, mm: Matmul):
    t = x.shape[0]
    h, kh, dh = dims.n_heads, dims.n_kv_heads, dims.d_head
    q = rope(mm(x, p["wq"]).view(t, h, dh), pos, sem["rope_theta"])
    k = rope(mm(x, p["wk"]).view(t, kh, dh), pos, sem["rope_theta"])
    v = mm(x, p["wv"]).view(t, kh, dh)
    o = causal_attention(q, k, v, 1.0 / math.sqrt(dh))
    return mm(o.reshape(t, h * dh), p["wo"])


def mla(p: dict, x: torch.Tensor, pos: torch.Tensor, dims, sem: dict, mm: Matmul):
    """Multi-head latent attention: the query projected directly (the
    port's departure: no low-rank query factor), the key-value latent
    normalised, keys and values expanded from it, one shared rope key."""
    t = x.shape[0]
    h, dn, dr, dv = dims.n_heads, dims.qk_nope, dims.qk_rope, dims.v_head
    q = mm(x, p["wq"]).view(t, h, dn + dr)
    qn, qr = q[..., :dn], rope(q[..., dn:], pos, sem["rope_theta"])
    c = rmsnorm(mm(x, p["w_dkv"]), p["kv_norm"], sem["norm_eps"])
    kr = rope(mm(x, p["w_kr"])[:, None, :], pos, sem["rope_theta"])
    kn = mm(c, p["w_uk"]).view(t, h, dn)
    v = mm(c, p["w_uv"]).view(t, h, dv)
    k = torch.cat([kn, kr.expand(t, h, dr)], dim=-1)
    o = causal_attention(torch.cat([qn, qr], dim=-1), k, v, 1.0 / math.sqrt(dn + dr))
    return mm(o.reshape(t, h * dv), p["wo"])


def capacity(s: int, dims, sem: dict) -> int:
    """Expert slots a routing group of ``s`` tokens gets: the capacity
    factor's share, rounded up to ``capacity_multiple``, at least
    ``capacity_min`` (GShard-style capacity routing, as the port states)."""
    c = math.ceil(s * dims.top_k / dims.n_experts * sem["capacity_factor"])
    m = sem["capacity_multiple"]
    return max(sem["capacity_min"], -(-c // m) * m)


def kept_choices(topi: torch.Tensor, groups: list[tuple[int, int]], dims, sem: dict):
    """(T, k) bool: which of each token's top-k choices its group's capacity
    keeps.  Within a group the choices claim slots choice rank by choice
    rank, tokens in order; a choice past its expert's capacity is dropped.
    Tokens outside every group (decode) keep all."""
    keep = torch.ones_like(topi, dtype=torch.bool)
    e = dims.n_experts
    for g0, g1 in groups:
        cap = capacity(g1 - g0, dims, sem)
        counts = torch.zeros(e, dtype=torch.long, device=topi.device)
        for rank in range(topi.shape[1]):
            onehot = F.one_hot(topi[g0:g1, rank], e)
            pos = (onehot.cumsum(0) - 1 + counts).gather(1, topi[g0:g1, rank, None])[:, 0]
            keep[g0:g1, rank] = pos < cap
            counts += onehot.sum(0)
    return keep


def moe(p: dict, x: torch.Tensor, groups, dims, sem: dict, mm: Matmul):
    """Softmax router in float32, top-k renormalised, capacity-limited per
    routing group; each expert a SwiGLU; the shared experts always on."""
    gates = torch.softmax(x @ p["router"].float(), dim=-1)
    topv, topi = torch.topk(gates, dims.top_k, dim=-1)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    keep = kept_choices(topi, groups, dims, sem)
    out = torch.zeros_like(x)
    for e in range(dims.n_experts):
        rows, ranks = torch.nonzero((topi == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = mm(F.silu(mm(xe, p["w_gate"][e])) * mm(xe, p["w_up"][e]), p["w_down"][e])
        out.index_add_(0, rows, y * topv[rows, ranks, None])
    return out + swiglu(p["shared"], x, mm)


def _layers(params: dict) -> list[tuple[str, dict]]:
    """(kind, layer params) of every layer, groups in order (``g<i>_<kind>``
    keys, each leaf stacked on a leading layer axis)."""
    out = []
    for key in sorted(params["blocks"], key=lambda k: int(k[1:].split("_")[0])):
        kind = key.split("_")[1]
        group = params["blocks"][key]
        n = next(iter(_leaves(group))).shape[0]
        out.extend((kind, _index(group, i)) for i in range(n))
    return out


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def routing_groups(prompt_len: int, chunk: int | None) -> list[tuple[int, int]]:
    """The prompt's routing groups: the whole prompt, or under chunked
    prefill each chunk (the last at its exact width)."""
    if chunk is None or prompt_len <= chunk:
        return [(0, prompt_len)]
    return [(s, min(s + chunk, prompt_len)) for s in range(0, prompt_len, chunk)]


@torch.no_grad()
def served_logits(params: dict, dims, sem: dict, prompt: list[int], served: list[int],
                  device: torch.device, mm: Matmul = matmul_f32,
                  chunk: int | None = None) -> torch.Tensor:
    """(len(served), vocab) float32 logits: row i is the distribution the
    model puts on served token i, after the prompt and served tokens before
    it."""
    tokens = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long, device=device)
    t, p_len = tokens.shape[0], len(prompt)
    pos = torch.arange(t, device=device)
    groups = routing_groups(p_len, chunk)
    x = params["embed"]["embedding"][tokens].float()
    mixer = mla if dims.mla else gqa
    for kind, lp in _layers(params):
        x = x + mixer(lp["attn"], rmsnorm(x, lp["ln1"], sem["norm_eps"]), pos, dims, sem, mm)
        h = rmsnorm(x, lp["ln2"], sem["norm_eps"])
        if kind == "a" and dims.moe:
            x = x + moe(lp["moe"], h, groups, dims, sem, mm)
        else:
            x = x + swiglu(lp["mlp"], h, mm)
    last = rmsnorm(x[p_len - 1:], params["final_norm"], sem["norm_eps"])
    embed = params["embed"]
    w = embed["lm_head"] if "lm_head" in embed else embed["embedding"].T
    return mm(last, w)[:, : dims.vocab]
