"""zamba2-7b [hybrid] — Mamba-2 backbone with a shared-parameter attention
block applied every 6th layer (the Zamba2 shared-block design; per-site LoRA
deltas omitted, as in the reference).  arXiv:2411.15242."""

from repro_torch.configs.base import ArchConfig, SSMConfig


def _pattern(n_layers: int, period: int = 6) -> str:
    return "".join("s" if i % period == period - 1 else "m" for i in range(n_layers))


CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=112,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, head_dim=64, expand=2, chunk=128),
    block_pattern=_pattern(81),
    rope_theta=10000.0,
    subquadratic=True,
)
