from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.checkpoint.elastic import reshard_restore  # noqa: F401
