from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
from repro_torch.optim.compression import ef_update, quantize_tree  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
