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

    def cut(self, n_layers: int) -> "ArchConfig":
        """The first ``n_layers`` layers of the pattern at full width, a
        depth cut (an MoE stack keeps its ``first_k_dense`` lead)."""
        return dataclasses.replace(
            self, n_layers=n_layers,
            block_pattern=None if self.block_pattern is None else self.pattern()[:n_layers],
        )

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d = self.d_model
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for ch in self.pattern():
            total += self._block_params(ch)
        total += d  # final norm
        return total

    def _attn_params(self) -> int:
        d = self.d_model
        if self.mla:
            m = self.mla
            qd = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            return (
                d * qd
                + d * m.kv_lora_rank
                + m.kv_lora_rank * self.n_heads * m.qk_nope_head_dim
                + m.kv_lora_rank * self.n_heads * m.v_head_dim
                + d * m.qk_rope_head_dim
                + self.n_heads * m.v_head_dim * d
            )
        return (
            d * self.n_heads * self.d_head
            + 2 * d * self.n_kv_heads * self.d_head
            + self.n_heads * self.d_head * d
        )

    def _mlp_params(self, hidden: int) -> int:
        return 3 * self.d_model * hidden  # SwiGLU: gate, up, down

    def _block_params(self, ch: str) -> int:
        d = self.d_model
        if ch == "m":
            s = self.ssm
            di = s.d_inner(d)
            h = s.n_heads(d)
            cd = s.conv_dim(d)
            in_proj = d * (2 * di + 2 * s.d_state + h)
            return in_proj + s.d_conv * cd + cd + 3 * h + di + di * d + 2 * d
        # attention blocks
        total = self._attn_params() + 2 * d
        if ch == "s":
            return total + self._mlp_params(self.d_ff)
        if self.moe is not None and ch == "a":
            m = self.moe
            total += d * m.n_experts  # router
            total += m.n_experts * self._mlp_params(m.d_expert)
            total += m.n_shared * self._mlp_params(m.d_expert)
            if m.dense_residual:
                total += self._mlp_params(self.d_ff)
        else:
            total += self._mlp_params(self.d_ff)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for ch in self.pattern():
            if ch == "a":
                t = self._attn_params() + 2 * d + d * m.n_experts
                t += (m.top_k + m.n_shared) * self._mlp_params(m.d_expert)
                if m.dense_residual:
                    t += self._mlp_params(self.d_ff)
                total += t
            else:
                total += self._block_params(ch)
        return total

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
