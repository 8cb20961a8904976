from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compressed_psum_mean,
    ef_update,
    quantize_tree,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
