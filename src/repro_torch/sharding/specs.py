"""Sharding rules: logical axis name -> mesh axes, per (arch, shape, mesh)
(the port of ``repro/sharding/specs.py``, rule by rule).

Parallelism map (baseline; §Perf hillclimbs adjust per cell):
  * batch          -> ("pod", "data")   DP across pods and the data axis
  * weight dim0    -> "data"            ZeRO-3/FSDP (all-gather on use)
  * heads/ffn/...  -> "model"           tensor parallelism
  * experts        -> "model"           expert parallelism (MoE)
  * act_seq        -> "data" only for batch=1 long-context (sequence
                      parallelism over the KV cache)

Rules drop a mesh axis automatically when the corresponding dimension is
not divisible (e.g. kv_heads=8 on a 16-way model axis stays replicated).
"""

from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ArchConfig, ShapeConfig

DEFAULT_RULES: dict[str, Any] = {
    # parameters
    "vocab": "model",
    "embed": "data",  # FSDP
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "expert_in": "data",   # FSDP-style: gathered on use (baseline)
    "expert_ffn": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "layers": None,
    # activations
    "act_batch": ("data",),
    "act_seq": None,
    "cache_seq": None,
    "heads_act": "model",
    "kv_heads_act": "model",
    "ffn_act": "model",
    "experts_act": "model",
    "ssm_inner_act": "model",
    "ssm_heads_act": "model",
}


def _axis_size(mesh_shape: dict[str, int], rule) -> int:
    if rule is None:
        return 1
    parts = (rule,) if isinstance(rule, str) else tuple(rule)
    n = 1
    for p in parts:
        n *= mesh_shape.get(p, 1)
    return n


def rules_for(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh_shape: dict[str, int],
    fsdp: bool | None = None,
    ep_mode: str = "gather",
) -> dict[str, Any]:
    """Build the logical->mesh rules for one evaluation cell."""
    rules = dict(DEFAULT_RULES)
    multi_pod = "pod" in mesh_shape

    # batch: pod axis joins data-parallel batch sharding
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if shape.global_batch % _axis_size(mesh_shape, batch_axes):
        batch_axes = ("data",) if shape.global_batch % mesh_shape.get(
            "data", 1
        ) == 0 else ()
    rules["act_batch"] = batch_axes or None

    # sequence parallelism for batch-1 long context
    if shape.global_batch == 1:
        rules["act_seq"] = ("pod", "data") if multi_pod else ("data",)

    # Megatron-style sequence parallelism for training: the residual stream
    # (and therefore the per-layer saved activation stacks, the dominant
    # memory term under remat) is sharded over "model" between blocks;
    # attention/FFN regions re-gather, GSPMD inserts the transitions.
    if shape.kind == "train" and shape.seq_len % mesh_shape.get("model", 1) == 0:
        rules["act_seq"] = "model"

    # KV caches shard their sequence axis (long decode contexts dwarf HBM
    # otherwise); conflicts with per-tensor axis reuse resolve gracefully
    if shape.kind in ("decode", "prefill"):
        rules["cache_seq"] = ("pod", "model") if multi_pod else ("model",)

    # FSDP: shard weight dim0 over data (and pod when multi-pod).  Default
    # on for training; for inference only when TP alone cannot fit params.
    if fsdp is None:
        tp = mesh_shape.get("model", 1)
        per_chip = cfg.param_count() * (2 if "16" in cfg.param_dtype else 4) / tp
        fsdp = shape.kind == "train" or per_chip > 8e9
    rules["embed"] = (("pod", "data") if multi_pod else "data") if fsdp else None

    # divisibility guards for model-axis sharding
    tp = mesh_shape.get("model", 1)
    if cfg.n_kv_heads and cfg.n_kv_heads % tp:
        rules["kv_heads_act"] = None
    if cfg.n_heads and cfg.n_heads % tp:
        rules["heads_act"] = None
    if cfg.ssm is not None:
        if cfg.ssm.n_heads(cfg.d_model) % tp:
            rules["ssm_heads_act"] = None
            rules["ssm_heads"] = None
    if cfg.moe is not None and cfg.moe.n_experts % tp:
        rules["experts_act"] = None
        rules["experts"] = None

    # expert-parallel mode: "gather" = expert weights FSDP'd over data and
    # all-gathered on use (baseline); "psum" = weights statically sharded
    # (E over model, expert-ffn over data), contractions produce partial
    # sums — activation psums replace weight gathers entirely.
    if ep_mode == "psum" and cfg.moe is not None:
        rules["expert_in"] = None
        rules["expert_ffn"] = "data"
    if not fsdp:
        rules["expert_in"] = None
    return rules
