"""Shared layer primitives: norm, RoPE, SwiGLU MLP, embeddings, and the
manual tensor-parallel paths (the port of ``repro/models/layers.py``).

Compute goes through the function-block registry (``blocks.call``) where
the shelf has a kernel.  Matmuls are ``x @ w`` in the compute dtype, as
the reference's ``einsum(x.astype(cd), w.astype(cd))``.  Under a mesh
(``repro_torch.sharding``) the same code runs on ``DTensor``s; the two
flags below take manual control of the tensor-parallel collectives with
``local_map`` and ``torch.distributed._functional_collectives`` (the
reference's ``shard_map``), so a ``make_fx`` trace holds them as
``_c10d_functional`` ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import blocks
from repro_torch.models.params import ParamMeta
from repro_torch.sharding.utils import (
    constrain,
    current_mesh,
    current_rules,
    is_dtensor,
    placements,
    resolve_spec,
)


# Tensor-parallel output projections (attention wo, MLP down, SSM out):
# False = leave the contraction to DTensor's propagation, which reduces the
# partial sums in the product's dtype.  True = take manual control: a
# per-shard product (accumulated in f32 by the GEMM) rounded to the compute
# dtype, then reduce-scattered over "model" straight into the sequence
# shards when act_seq == "model" (all-reduced otherwise) — one RS of bf16
# in place of one AR.
BF16_TP_REDUCE = False


class _AllReduce(torch.autograd.Function):
    """Sum over a mesh axis whose result every rank holds whole: the
    gradient of each rank's partial sum is the (replicated) output
    gradient itself."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        return funcol.all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _tp_reduce(part: torch.Tensor, mesh, scatter_seq: bool) -> torch.Tensor:
    """A per-shard partial product summed over the "model" axis: scattered
    on the sequence (dim 1), or all-reduced."""
    group = mesh["model"]
    if scatter_seq:
        return _waited(_collective("reduce_scatter")(part.contiguous(), "sum", 1, group))
    return _waited(_AllReduce.apply(part, group))


def _waited(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result as a plain tensor, waited for by a
    differentiable op: ``local_map`` unwraps an ``AsyncCollectiveTensor``
    input by ``.wait()``, which drops its autograd history."""
    from torch.distributed import _functional_collectives as funcol

    if isinstance(t, funcol.AsyncCollectiveTensor):
        return funcol.wait_tensor(t)
    return t


def _collective(kind: str):
    """The differentiable functional collective ``kind`` (``all_gather`` /
    ``reduce_scatter``): ``*_single_autograd`` where torch has it, its
    older name ``*_tensor_autograd`` otherwise."""
    from torch.distributed import _functional_collectives as funcol

    return getattr(funcol, f"{kind}_single_autograd", None) or getattr(
        funcol, f"{kind}_tensor_autograd")


def _batch_spec():
    return resolve_spec(("act_batch",), current_rules())[0]


def _grad_over_batch(spec: tuple, mesh) -> tuple:
    """Gradient placements of a weight with ``spec``: partial sums on the
    mesh axes that shard the batch (each holds its rows' share)."""
    from torch.distributed.tensor import Partial

    batch = placements((_batch_spec(),), mesh)
    return tuple(Partial() if b.is_shard() and r.is_replicate() else r
                 for b, r in zip(batch, placements(spec, mesh)))


def tp_out_einsum(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``a @ b``, ``a`` (B, S, Q) and ``b`` (Q, D), the contraction crossing
    the tensor-parallel shards."""
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    if (not BF16_TP_REDUCE or mesh is None or "model" not in mesh.mesh_dim_names
            or a.ndim != 3 or b.ndim != 2 or not is_dtensor(a)):
        return a @ b
    tp = mesh_size(mesh, "model")
    scatter_seq = current_rules().get("act_seq") == "model" and a.shape[1] % tp == 0
    batch = _batch_spec()
    in_a, in_b = (batch, None, "model"), ("model", None)
    out = (batch, "model" if scatter_seq else None, None)

    def local(a_l, b_l):
        return _tp_reduce((a_l @ b_l).to(cd), mesh, scatter_seq)

    return local_map(
        local, out_placements=list(placements(out, mesh)),
        in_placements=(placements(in_a, mesh), placements(in_b, mesh)),
        in_grad_placements=(placements(in_a, mesh), _grad_over_batch(in_b, mesh)),
        device_mesh=mesh, redistribute_inputs=True,
    )(a, b)


def mesh_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    return blocks.call("rmsnorm", x, w, eps=eps)


def add_rmsnorm(
    w: torch.Tensor, x: torch.Tensor, delta: torch.Tensor | None, eps: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + delta, rmsnorm(x + delta)): a branch's residual add fused into
    the next norm (the sum in x's dtype, as the reference adds).  With no
    pending delta (a forward's first block) the plain norm of x."""
    if delta is None:
        return x, rmsnorm(w, x, eps)
    return blocks.call("rmsnorm", x, w, eps=eps, delta=delta.to(x.dtype))


def gated_rmsnorm(w, y, x, d_skip, z, eps: float) -> torch.Tensor:
    """Mamba-2's gated norm, ``norm((y + d_skip x) * silu(z)) * w`` in f32,
    in z's dtype: one call of the rmsnorm block."""
    return blocks.call("rmsnorm", y, w, eps=eps, gate=(x, d_skip, z))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, llama-style rotate-half.

    x: (B, S, H, d); positions: (B, S) integer.
    """
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)  # (half,)
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]  # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# -- SwiGLU MLP ------------------------------------------------------------------


def mlp_metas(d_model: int, d_ff: int, dtype: str) -> dict:
    return {
        "gate": ParamMeta((d_model, d_ff), ("embed", "ffn"), dtype),
        "up": ParamMeta((d_model, d_ff), ("embed", "ffn"), dtype),
        "down": ParamMeta((d_ff, d_model), ("ffn", "embed"), dtype),
    }


# True = the whole SwiGLU MLP runs as one local_map: all-gather the
# sequence shards once, gate / up / silu / down on the local FFN shard,
# reduce-scatter the output back to sequence shards.  Exactly Megatron
# TP+SP: 1 AG + 1 RS per MLP, and the FSDP weight gathers at the boundary
# move the compute dtype.
MEGATRON_MLP = False


def _megatron_mlp(p: dict, x: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    rules = current_rules()
    batch = _batch_spec()
    tp = mesh_size(mesh, "model")
    seq_sharded = rules.get("act_seq") == "model" and x.shape[1] % tp == 0
    xs = (batch, "model" if seq_sharded else None, None)
    w_in, w_out = (None, "model"), ("model", None)

    def local(x_l, g_l, u_l, d_l):
        x_full = x_l
        if seq_sharded:
            x_full = _waited(_collective("all_gather")(x_l.contiguous(), 1, mesh["model"]))
        h = F.silu(x_full @ g_l) * (x_full @ u_l)
        return _tp_reduce((h @ d_l).to(cd), mesh, seq_sharded)

    return local_map(
        local, out_placements=list(placements(xs, mesh)),
        in_placements=tuple(placements(s, mesh) for s in (xs, w_in, w_in, w_out)),
        in_grad_placements=(placements(xs, mesh),) + tuple(
            _grad_over_batch(s, mesh) for s in (w_in, w_in, w_out)),
        device_mesh=mesh, redistribute_inputs=True,
    )(x.to(cd), p["gate"].to(cd), p["up"].to(cd), p["down"].to(cd))


def mlp_forward(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    mesh = current_mesh()
    if MEGATRON_MLP and mesh is not None and "model" in mesh.mesh_dim_names and is_dtensor(x):
        return _megatron_mlp(p, x, compute_dtype)
    xc = constrain(x, "act_batch", None, None).to(compute_dtype)  # the region's all-gather
    g = xc @ p["gate"].to(compute_dtype)
    u = xc @ p["up"].to(compute_dtype)
    h = constrain(F.silu(g) * u, "act_batch", None, "ffn_act")
    return tp_out_einsum(h, p["down"].to(compute_dtype), compute_dtype)


# -- embeddings -------------------------------------------------------------------


def embed_metas(cfg: ArchConfig) -> dict:
    d = {
        "embedding": ParamMeta(
            (cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), cfg.param_dtype,
            scale=0.02,
        )
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamMeta(
            (cfg.d_model, cfg.padded_vocab), ("embed", "vocab"), cfg.param_dtype,
            scale=0.02,
        )
    return d


def embed_lookup(p: dict, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    emb = p["embedding"].to(compute_dtype)
    if is_dtensor(emb):
        return _embed_sharded(emb, tokens)
    return emb[tokens.long()]


def _embed_sharded(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup of a ``DTensor`` table: each rank takes the
    rows of its own vocab shard (zeros for tokens outside it) for its own
    batch rows, summed over the vocab-sharding mesh axes; the embedding
    dim is gathered (FSDP)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, vocab = emb.device_mesh, emb.shape[0]
    vocab_dims = [i for i, p in enumerate(emb.placements) if p == Shard(0)]
    rows = [Shard(0) if p == Shard(0) and i not in vocab_dims else Replicate()
            for i, p in enumerate(tokens.placements)] if is_dtensor(tokens) else (
        [Replicate()] * mesh.ndim)
    table = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    table_grad = [Shard(0) if i in vocab_dims else Partial() if r == Shard(0) else Replicate()
                  for i, r in enumerate(rows)]

    def local(e_l, t_l):
        shard, width = 0, vocab
        for i in vocab_dims:  # this shard's number and the chunk width, major first
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
            width = -(-width // mesh.size(i))
        t = t_l.long() - shard * width
        inside = ((t >= 0) & (t < e_l.shape[0]))[..., None]
        out = torch.where(inside, e_l[t.clamp(0, e_l.shape[0] - 1)], 0)
        for i in vocab_dims:
            out = _waited(_AllReduce.apply(out, mesh.get_group(i)))
        return out

    return local_map(local, out_placements=rows, in_placements=(table, rows),
                     in_grad_placements=(table_grad, rows), device_mesh=mesh,
                     redistribute_inputs=True)(emb, tokens)


def lm_logits(
    p: dict, x: torch.Tensor, cfg: ArchConfig, compute_dtype: torch.dtype
) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p["embedding"].to(compute_dtype).T
    else:
        w = p["lm_head"].to(compute_dtype)
    # under a mesh the head's weight is gathered on its embed dim (FSDP)
    # and stays vocab-sharded, as are the logits
    w = constrain(w, None, "vocab")
    return constrain(x.to(compute_dtype) @ w, "act_batch", None, "vocab")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32; logits (B, S, V), labels (B, S).
    The same terms as the reference's one-hot contraction (the max shift
    held constant, ``log sum exp(shifted) - shifted[label]``), taking the
    label's logit by a gather; vocab-sharded logits (a ``DTensor``) take the
    same terms shard by shard (:func:`_cross_entropy_sharded`)."""
    if is_dtensor(logits):
        return _cross_entropy_sharded(logits, labels)
    logits = logits.float()
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(shifted).sum(dim=-1))
    gold = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def _cross_entropy_sharded(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:func:`cross_entropy` of ``DTensor`` logits on each rank's shard (the
    reference's one-hot contraction, a sharded partial reduction, as a
    vocab-parallel loss): the max, the sum of exponentials and the label's
    logit reduced over the vocab-sharding mesh axes, the rows' sum over
    the row-sharding ones; no rank holds more than its shard of the
    logits."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.shelf import follow, lead_placements

    mesh, vocab = logits.device_mesh, logits.shape[-1]
    n_rows = logits.numel() // vocab
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    lead = lead_placements(logits, {0, 1, 2})
    rows = follow(lead, {0: 0, 1: 1})
    vocab_dims = [i for i, p in enumerate(lead) if p == Shard(2)]
    row_dims = [i for i, p in enumerate(lead) if p in (Shard(0), Shard(1))]

    def local(lg, y):
        shard, width = 0, vocab
        for i in vocab_dims:  # this shard's number and the chunk width, major first
            shard = shard * mesh.size(i) + mesh.get_local_rank(i)
            width = -(-width // mesh.size(i))
        lg = lg.float()
        m = lg.amax(dim=-1, keepdim=True).detach()
        for i in vocab_dims:
            m = _waited(funcol.all_reduce(m, "max", mesh.get_group(i)))
        shifted = lg - m
        sumexp = torch.exp(shifted).sum(dim=-1)
        t = y.long() - shard * width
        inside = (t >= 0) & (t < lg.shape[-1])
        gold = torch.where(inside, shifted.gather(-1, t.clamp(0, lg.shape[-1] - 1)[..., None])
                           [..., 0], 0)
        for i in vocab_dims:
            sumexp = _waited(_AllReduce.apply(sumexp, mesh.get_group(i)))
            gold = _waited(_AllReduce.apply(gold, mesh.get_group(i)))
        total = (torch.log(sumexp) - gold).sum()
        for i in row_dims:
            total = _waited(_AllReduce.apply(total, mesh.get_group(i)))
        return total / n_rows

    return local_map(local, out_placements=[Replicate()] * mesh.ndim,
                     in_placements=(lead, rows), in_grad_placements=(lead, rows),
                     device_mesh=mesh, redistribute_inputs=True)(logits, labels)
