"""musicgen-large [audio] — decoder-only over EnCodec tokens.
arXiv:2306.05284.  The EnCodec tokenizer frontend is stubbed (input_specs
provides the token stream); a single codebook stream is modelled — the
4-codebook delay-pattern interleave is a data-layout detail orthogonal to
this paper (as in the reference)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0,
    frontend="audio_tokens",
)
