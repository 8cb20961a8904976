"""Mixture-of-Experts FFN: top-k routing with per-row capacity, index-based
dispatch (the port of ``repro/models/moe.py``).

Routing is computed per batch row: every row routes its S tokens into an
(E, C) index table (C from :func:`capacity_of`), slot by slot of the top-k
with counts carried across slots; a token past its expert's capacity is
dropped through the sentinel index ``S``.  Dispatch is a gather from the
row with one zero row appended (the sentinel reads zeros); the expert
products are batched matmuls over the expert axis, library products as the
reference's einsums are.  Combine sums each token's kept slots: the
terms of the reference's scatter-add, gathered as the token's top-k slot
rows and summed in top-k order (the reference adds them in flat (expert,
slot) order, so the last bits may differ).  ``index_add_`` on CUDA adds
with atomics in an order that changes from run to run; the gather keeps a
step's result the same bits at every call, so a CUDA-graph replay equals
its eager call.

Shared experts (DeepSeek: always on) and a dense residual FFN in parallel
(Arctic) are added; the Switch load-balancing loss comes back with the
output.  Nothing here reads the host or takes a shape from the data, so a
step program captures it as it stands.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.layers import mlp_forward, mlp_metas
from repro_torch.models.params import ParamMeta
from repro_torch.sharding.utils import constrain, is_dtensor


def moe_metas(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    dt = cfg.param_dtype
    metas = {
        "router": ParamMeta((d, m.n_experts), ("embed", None), dt, scale=0.02),
        "w_gate": ParamMeta(
            (m.n_experts, d, m.d_expert), ("experts", "expert_in", "expert_ffn"), dt
        ),
        "w_up": ParamMeta(
            (m.n_experts, d, m.d_expert), ("experts", "expert_in", "expert_ffn"), dt
        ),
        "w_down": ParamMeta(
            (m.n_experts, m.d_expert, d), ("experts", "expert_ffn", "expert_in"), dt
        ),
    }
    if m.n_shared:
        metas["shared"] = mlp_metas(d, m.d_expert * m.n_shared, dt)
    if m.dense_residual:
        metas["dense"] = mlp_metas(d, cfg.d_ff, dt)
    return metas


def capacity_of(seq: int, m: MoEConfig) -> int:
    c = int(math.ceil(seq * m.top_k / m.n_experts * m.capacity_factor))
    return max(4, ((c + 3) // 4) * 4)


def route(gates: torch.Tensor, top_k: int, capacity: int):
    """Route every row of ``gates`` (B, S, E) f32.

    Returns (idx (B, E, C) int64 — token id per expert slot, S = empty;
             w (B, E, C) f32 — combine weight per slot;
             frac (B, E) — fraction of the row's tokens dispatched per expert;
             where (B, S, top_k) int64 — the flat slot ``e * C + c`` each
             token's choice took, ``E * C`` where it was dropped).
    """
    b, s, e = gates.shape
    dev = gates.device
    topv, topi = torch.topk(gates, top_k, dim=-1)  # (B, S, k)
    total = topv[..., 0]
    for slot in range(1, top_k):  # in slot order, as XLA reduces the k values
        total = total + topv[..., slot]
    topv = topv / (total[..., None] + 1e-9)

    sentinel = e * capacity
    idx_flat = torch.full((b, sentinel + 1), s, dtype=torch.long, device=dev)
    w_flat = torch.zeros((b, sentinel + 1), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, e), dtype=torch.long, device=dev)
    token_ids = torch.arange(s, device=dev).expand(b, s)
    experts = torch.arange(e, device=dev)
    where = []
    for slot in range(top_k):
        eidx = topi[..., slot]  # (B, S)
        # one_hot by comparison: no bounds check that could read the host
        onehot = (eidx[..., None] == experts).long()  # (B, S, E)
        pos = onehot.cumsum(1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(1)
        pos_tok = (pos * onehot).sum(-1)  # (B, S)
        flat = torch.where(pos_tok < capacity, eidx * capacity + pos_tok,
                           torch.full_like(pos_tok, sentinel))
        # kept slots are distinct; every dropped token writes the sentinel
        idx_flat.scatter_(1, flat, token_ids)
        w_flat.scatter_(1, flat, topv[..., slot])
        where.append(flat)

    idx = idx_flat[:, :sentinel].reshape(b, e, capacity)
    w = w_flat[:, :sentinel].reshape(b, e, capacity)
    frac = torch.clamp(counts, max=capacity).float() / max(s, 1)
    return idx, w, frac, torch.stack(where, -1)


def _route_sharded(gates: torch.Tensor, top_k: int, capacity: int):
    """:func:`route` of a ``DTensor`` ``gates`` on each rank's own rows (the
    routing is row-local): the rows keep their batch shards, the tokens and
    experts of a row are whole."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rows = [Shard(0) if p == Shard(0) else Replicate() for p in gates.placements]
    return local_map(functools.partial(route, top_k=top_k, capacity=capacity),
                     out_placements=(rows, rows, rows, rows), in_placements=(rows,),
                     redistribute_inputs=True)(gates)


def route_row(gates: torch.Tensor, top_k: int, capacity: int):
    """Route one row of S tokens, ``gates`` (S, E) f32: (idx (E, C), w (E, C),
    frac (E,)) as the reference's ``route_row``."""
    idx, w, frac, _ = route(gates[None], top_k, capacity)
    return idx[0], w[0], frac[0]


def moe_forward(
    p: dict, x: torch.Tensor, cfg: ArchConfig, compute_dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in the compute dtype, aux_loss scalar f32)."""
    m = cfg.moe
    b, s, d = x.shape
    e = m.n_experts
    xc = constrain(x, "act_batch", None, None).to(compute_dtype)  # the region's all-gather
    gates = torch.softmax(xc.float() @ p["router"].float(), dim=-1)  # (B, S, E)
    cap = capacity_of(s, m)
    if is_dtensor(gates):
        idx, w, frac, where = _route_sharded(gates, m.top_k, cap)
    else:
        idx, w, frac, where = route(gates, m.top_k, cap)

    # dispatch: row-local gather, the sentinel S reading the appended zero row
    rows = torch.arange(b, device=x.device)
    xpad = torch.cat([xc, xc.new_zeros(b, 1, d)], dim=1)  # (B, S + 1, D)
    xin = xpad[rows[:, None, None], idx]  # (B, E, C, D)
    xin = constrain(xin, "act_batch", "experts_act", None, None)

    # the expert products, batched over the expert axis (B*C rows, B major)
    xe = xin.transpose(0, 1).reshape(e, b * cap, d)
    g = torch.matmul(xe, p["w_gate"].to(compute_dtype))
    u = torch.matmul(xe, p["w_up"].to(compute_dtype))
    # the reference's manual TP skips this batched product (tp_out_einsum
    # takes (B, S, Q) x (Q, D) only): a plain matmul in both
    eo = torch.matmul(constrain(F.silu(g) * u, "experts_act", "act_batch", None),
                      p["w_down"].to(compute_dtype))  # (E, B*C, D)
    eo = eo.reshape(e, b, cap, d).transpose(0, 1)  # (B, E, C, D)
    eo = eo * w[..., None].to(compute_dtype)

    # combine: each token's kept slots summed in slot order (empty slots
    # are read by no token; a dropped choice reads the appended zero row)
    eo = torch.cat([eo.reshape(b, e * cap, d), eo.new_zeros(b, 1, d)], dim=1)
    picked = eo[rows[:, None, None], where]  # (B, S, k, D)
    out = picked[:, :, 0]
    for slot in range(1, m.top_k):
        out = out + picked[:, :, slot]
    out = constrain(out, "act_batch", None, None)

    # Switch aux loss: E * sum_e f_e * mean_gate_e
    mean_gate = gates.mean(dim=(0, 1))
    aux = e * torch.sum(frac.mean(0) * mean_gate)

    if m.n_shared:
        out = out + mlp_forward(p["shared"], xc, compute_dtype)
    if m.dense_residual:
        out = out + mlp_forward(p["dense"], xc, compute_dtype)
    return out, aux.float()
