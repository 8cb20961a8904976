"""pixtral-12b [vlm] — pixtral-ViT frontend (stubbed: precomputed patch
embeddings) + mistral-nemo decoder backbone. hf:mistralai/Pixtral-12B-2409."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    frontend="patch_embed",
)
