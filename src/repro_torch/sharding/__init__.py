"""Sharding of the port: logical-axis rules and the ``DTensor`` context
(the port of ``repro/sharding``)."""

from repro_torch.sharding.utils import (  # noqa: F401
    constrain,
    current_mesh,
    current_rules,
    placements,
    resolve_spec,
    use_sharding,
)
from repro_torch.sharding.specs import (  # noqa: F401
    DEFAULT_RULES,
    rules_for,
)
