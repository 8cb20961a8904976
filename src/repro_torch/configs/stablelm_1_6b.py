"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b (unverified)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
)
