"""The yardstick's frozen arithmetic: the card's peaks, and the operations
and bytes of the kernels and of a model's tokens.

These are copies, frozen here, of the formulas the port's kernel modules
declare (``paged_work``, ``flash_work``): the program may change its own
copies, and a roofline share measured against a formula the change
rewrote would say nothing.  Each input byte is counted read once and each
output byte written once; where the work depends on the data (a decode
row's context), the positions these inputs need are counted.

``dims`` is a configuration's sizes as :func:`dims_of` reads them from
its file.
"""

from __future__ import annotations

import dataclasses
import math

#: Published peaks of one NVIDIA H100 SXM (data sheet, dense): bf16 tensor
#: cores and HBM3 bandwidth, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes a formula needs, as the configuration's file states them."""

    d_model: int
    n_layers: int
    pattern: str  # one char a layer: 'd' dense FFN, 'a' the model's mixer + FFN
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    page_size: int = 16
    # MLA (0 when absent)
    kv_lora_rank: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # MoE (0 when absent)
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared: int = 0

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    nbytes: float

    def bound_s(self) -> float:
        """The least time the card could take: the larger of operations
        over the bf16 peak and bytes over the bandwidth."""
        return max(self.flops / PEAK_BF16_FLOPS, self.nbytes / PEAK_HBM_BYTES)


def paged_decode_work(dims: Dims, lengths: list[int], s: int = 1) -> Work:
    """One paged-attention call (one layer) over the rows at resident
    lengths ``lengths`` (each row's write position), ``s`` new tokens a
    row, causal within them.  GQA: q (B, H, S, D) and the output read and
    written once, K and V of each position a row reaches read once.  MLA's
    latent walk: the absorbed query (B, H, S, r) and its rope part (B, H, S,
    dr), the latent output (B, H, S, r); the latent row is both key and
    value and is read once, with the rope key beside it.  The page table's
    entries for the positions reached and each row's index, 4 bytes each."""
    b = len(lengths)
    seen = sum(ln + si + 1 for ln in lengths for si in range(s))
    n_pos = sum(ln + s for ln in lengths)
    table = sum(math.ceil((ln + s) / dims.page_size) for ln in lengths) + b
    h = dims.n_heads
    if dims.mla:
        r, dr = dims.kv_lora_rank, dims.qk_rope
        q_bytes = BF16 * b * h * s * (r + dr + r)
        per_pos = r + dr
        flops = 2 * h * seen * (r + r + dr)
    else:
        d, kh = dims.d_head, dims.n_kv_heads
        q_bytes = BF16 * b * h * s * (d + d)
        per_pos = kh * (d + d)
        flops = 2 * h * seen * (d + d)
    return Work(float(flops), float(q_bytes + BF16 * n_pos * per_pos + 4 * table))


def flash_forward_work(dims: Dims, s: int) -> Work:
    """One causal flash forward (one layer) over a batch-1 prompt of ``s``
    tokens: q, k, v read and the output written once; q.k over the
    query-key width and p.v over the value width for each of the
    ``s (s + 1) / 2`` attended pairs."""
    h = dims.n_heads
    if dims.mla:
        dqk, dv, kh = dims.qk_nope + dims.qk_rope, dims.v_head, h
    else:
        dqk, dv, kh = dims.d_head, dims.d_head, dims.n_kv_heads
    pairs = s * (s + 1) // 2
    nbytes = BF16 * s * (h * dqk + kh * dqk + kh * dv + h * dv)
    return Work(float(2 * (dqk + dv) * h * pairs), float(nbytes))


def _mixer_flops_per_token(dims: Dims) -> int:
    """The attention projections' multiply-adds of one token, times two."""
    d, h = dims.d_model, dims.n_heads
    if dims.mla:
        r, dn, dr, dv = dims.kv_lora_rank, dims.qk_nope, dims.qk_rope, dims.v_head
        return 2 * (d * h * (dn + dr) + d * r + d * dr + r * h * dn + r * h * dv + h * dv * d)
    kh, dh = dims.n_kv_heads, dims.d_head
    return 2 * (d * h * dh + 2 * d * kh * dh + h * dh * d)


def _ffn_flops_per_token(dims: Dims, kind: str) -> int:
    """A SwiGLU FFN's (or the experts a token needs: top-k routed and the
    shared ones, with the router) multiply-adds, times two."""
    d = dims.d_model
    if kind == "a" and dims.moe:
        return 2 * (d * dims.n_experts + 3 * d * dims.d_expert * (dims.top_k + dims.n_shared))
    return 2 * 3 * d * dims.d_ff


def _pair_flops(dims: Dims) -> int:
    """Attention's flops for one (query, key) pair across the heads."""
    if dims.mla:
        return 2 * dims.n_heads * (dims.qk_nope + dims.qk_rope + dims.v_head)
    return 2 * dims.n_heads * (dims.d_head + dims.d_head)


def layer_flops_per_token(dims: Dims) -> int:
    """Every layer's projections and FFN for one token (no attention pairs)."""
    return sum(_mixer_flops_per_token(dims) + _ffn_flops_per_token(dims, k) for k in dims.pattern)


def head_flops(dims: Dims) -> int:
    return 2 * dims.d_model * dims.vocab


def prefill_flops(dims: Dims, s: int) -> int:
    """Model FLOPs a prompt of ``s`` tokens needs: every token through every
    layer, the causal pairs, and the head at the last position only (the
    one whose logits are sampled)."""
    pairs = s * (s + 1) // 2
    return s * layer_flops_per_token(dims) + dims.n_layers * pairs * _pair_flops(dims) + head_flops(
        dims)


def decode_flops(dims: Dims, length: int) -> int:
    """Model FLOPs of one decode token at resident length ``length``: every
    layer, ``length + 1`` attended positions, the head."""
    return (layer_flops_per_token(dims) + dims.n_layers * (length + 1) * _pair_flops(dims)
            + head_flops(dims))


def dims_of(config: dict, page_size: int) -> Dims:
    """The sizes of a configuration's file: its published keys (at the top
    level, as the source's config names them), as cut."""
    c = config
    h = c["num_attention_heads"]
    moe = "n_routed_experts" in c
    mla = "kv_lora_rank" in c
    n_layers = c["num_hidden_layers"]
    dense = c.get("first_k_dense_replace", 0) if moe else 0
    return Dims(
        d_model=c["hidden_size"], n_layers=n_layers,
        pattern="d" * dense + "a" * (n_layers - dense),
        n_heads=h, n_kv_heads=c["num_key_value_heads"],
        d_head=c.get("head_dim") or c["hidden_size"] // h,
        d_ff=c["intermediate_size"], vocab=c["vocab_size"], page_size=page_size,
        kv_lora_rank=c.get("kv_lora_rank", 0) if mla else 0,
        qk_nope=c.get("qk_nope_head_dim", 0), qk_rope=c.get("qk_rope_head_dim", 0),
        v_head=c.get("v_head_dim", 0),
        n_experts=c["n_routed_experts"] if moe else 0,
        top_k=c["num_experts_per_tok"] if moe else 0,
        d_expert=c["moe_intermediate_size"] if moe else 0,
        n_shared=c["n_shared_experts"] if moe else 0,
    )
