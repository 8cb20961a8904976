"""command-r-35b [dense] — GQA kv=8, no-bias. hf:CohereForAI/c4ai-command-r-v01."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab_size=256000,
    rope_theta=10000.0,
    tie_embeddings=True,  # command-r ties input/output embeddings
)
