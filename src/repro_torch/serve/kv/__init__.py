"""The block-paged KV cache's host-side accounting (the port of
``repro.serve.kv``): :class:`PagePool` owns which page is free or held
(plus the null page that absorbs writes from freed or prefilling slots),
:class:`PageTable` the per-slot page lists the decode step reads through.
"""

from repro_torch.serve.kv.pool import (  # noqa: F401
    PagePool,
    PageTable,
    PoolExhausted,
    pages_for,
)
