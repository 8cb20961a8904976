"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.
arXiv:2405.04434."""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: all heads share the compressed kv latent
    d_head=128,
    d_ff=12288,  # the leading dense layer's FFN
    vocab_size=102400,
    moe=MoEConfig(
        n_experts=160,
        top_k=6,
        d_expert=1536,
        n_shared=2,
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    first_k_dense=1,
    rope_theta=10000.0,
    param_dtype="bfloat16",
    opt_dtype="bfloat16",
)
