"""arctic-480b [moe] — 128 experts top-2 + dense residual FFN.
hf:Snowflake/snowflake-arctic-base."""

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=4864,  # dense-residual FFN hidden
    vocab_size=32000,
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        d_expert=4864,
        dense_residual=True,
    ),
    rope_theta=10000.0,
    param_dtype="bfloat16",  # 480B: bf16 params + bf16 moments to fit HBM
    opt_dtype="bfloat16",
)
