"""Elastic restore: bring a checkpoint up on a *different* mesh (the port of
``repro/checkpoint/elastic.py``).

Checkpoints store full host arrays, so elasticity is a placement problem:
given the new mesh and the spec tree for the new topology,
:func:`reshard_restore` places every leaf as a ``DTensor`` with its spec's
placements, on the mesh's device.  Scaling from 256 GPUs to 512 (or down
to what survived a failure) is then ``reshard_restore(mgr, like,
new_mesh, new_specs)`` — the sharding layer recomputes specs from the same
logical rules (``spec_tree(metas, rules_for(...))``), so no per-topology
code.
"""

from __future__ import annotations

from typing import Any

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.params import shard_tree


def reshard_restore(
    mgr: CheckpointManager,
    like: Any,
    mesh: Any,
    specs: Any,
    step: int | None = None,
) -> tuple[int, Any]:
    """``(step, tree)``: the checkpoint restored into ``like``'s structure
    (plain tensors on the host), then every leaf placed on ``mesh`` with
    its spec (a tree of the same structure)."""
    step, host_tree = mgr.restore(like, step)
    return step, shard_tree(host_tree, specs, mesh)
