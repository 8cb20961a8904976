"""Architecture configuration schema (the port's own copy of
``repro/configs/base.py``: the port imports nothing of ``repro``)."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # expert FFN hidden size
    n_shared: int = 0  # always-on shared experts (deepseek)
    dense_residual: bool = False  # dense FFN in parallel with MoE (arctic)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim

    def conv_dim(self, d_model: int) -> int:
        return self.d_inner(d_model) + 2 * self.d_state


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid: one char per layer — 'a' attention+mlp, 'm' mamba,
    # 's' shared attention block (parameters shared across all 's' sites)
    block_pattern: str | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    frontend: Literal["patch_embed", "audio_tokens"] | None = None
    first_k_dense: int = 0  # leading dense layers in an MoE stack
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    remat: Literal["full", "none"] = "full"
    subquadratic: bool = False

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        return ((self.vocab_size + 255) // 256) * 256

    def pattern(self) -> str:
        if self.block_pattern is not None:
            assert len(self.block_pattern) == self.n_layers
            return self.block_pattern
        if self.family == "ssm":
            return "m" * self.n_layers
        if self.moe is not None and self.first_k_dense:
            return "d" * self.first_k_dense + "a" * (
                self.n_layers - self.first_k_dense
            )
        return "a" * self.n_layers

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (same rule as the
        reference's ``ArchConfig.reduced``)."""
        pat = None
        if self.block_pattern is not None:
            pat = self.pattern()[: min(4, self.n_layers)]
            if "s" in self.pattern() and "s" not in pat:
                pat = pat[:-1] + "s"
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k), d_expert=64,
                n_shared=min(1, self.moe.n_shared),
            )
        mla = None
        if self.mla:
            mla = MLAConfig(
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16,
            )
        ssm = None
        if self.ssm:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=8, chunk=16)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(4, self.n_layers),
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=(
                min(4, max(1, self.n_kv_heads * 4 // self.n_heads))
                if self.n_heads
                else 0
            ),
            d_head=16 if self.n_heads else 0,
            d_ff=128,
            vocab_size=512,
            moe=moe,
            mla=mla,
            ssm=ssm,
            block_pattern=pat,
            param_dtype="float32",
            opt_dtype="float32",
        )
