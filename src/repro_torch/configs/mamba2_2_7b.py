"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
arXiv:2405.21060."""

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_head=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, head_dim=64, expand=2, chunk=128),
    subquadratic=True,
)
