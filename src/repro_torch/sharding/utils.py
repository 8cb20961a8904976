"""Logical-axis sharding context (the port of ``repro/sharding/utils.py``).

Models annotate parameters and activations with *logical* axis names
("vocab", "embed", "heads", "experts", "act_batch", ...).  A sharding
context maps logical names to the axes of a ``DeviceMesh``;
:func:`constrain` redistributes a ``DTensor`` to the placements the
active rules give it (the counterpart of ``with_sharding_constraint``)
and returns any other tensor untouched, as it does when no context is
active — so the same model code runs on one card with plain tensors and
under a mesh with ``DTensor`` parameters and activations, where
``DTensor``'s sharding propagation stands in for GSPMD.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), one mesh-axis name, or a tuple of names (the dimension
split over each, the first named axis major, as JAX lays out
``PartitionSpec(("pod", "data"))``).  :func:`placements` turns it into a
``DTensor`` placement per mesh dimension.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Mapping, Sequence

import torch

_state = threading.local()


def current_mesh() -> Any:
    """The active ``DeviceMesh`` (None outside :func:`use_sharding`)."""
    return getattr(_state, "mesh", None)


def current_rules() -> dict[str, Any]:
    return getattr(_state, "rules", {})


@contextlib.contextmanager
def use_sharding(mesh: Any, rules: Mapping[str, Any]) -> Iterator[None]:
    """Scope a mesh and its logical rules (thread-local, as the reference).
    Under a mesh a plain tensor that meets a ``DTensor`` (positions, masks,
    a scalar) counts as replicated, as a traced constant does under GSPMD."""
    prev = (current_mesh(), current_rules())
    _state.mesh = mesh
    _state.rules = dict(rules)
    try:
        # the flag is global and its context resets it on exit: enter it at
        # the outermost mesh only (the remat recompute re-enters a context)
        if mesh is None or prev[0] is not None:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _state.mesh, _state.rules = prev


def resolve_spec(
    axes: Sequence[str | None], rules: Mapping[str, Any] | None = None
) -> tuple:
    """Map logical axis names to a spec via the active rules; a mesh axis
    already used by an earlier dimension is dropped."""
    rules = current_rules() if rules is None else rules
    mesh_axes: list = []
    used: set[str] = set()
    for ax in axes:
        r = rules.get(ax) if ax is not None else None
        if r is None:
            mesh_axes.append(None)
            continue
        parts = (r,) if isinstance(r, str) else tuple(r)
        parts = tuple(p for p in parts if p not in used)
        used.update(parts)
        if not parts:
            mesh_axes.append(None)
        elif len(parts) == 1:
            mesh_axes.append(parts[0])
        else:
            mesh_axes.append(parts)
    return tuple(mesh_axes)


def placements(spec: Sequence, mesh: Any) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(i)`` on every mesh axis tensor dimension ``i`` names,
    ``Replicate()`` on the others.  A mesh axis the mesh lacks is skipped.
    A dimension split over several axes is split in mesh-dimension order,
    so its axes must be named in that order (major first)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        parts = [p for p in ((entry,) if isinstance(entry, str) else entry) if p in names]
        idx = [names.index(p) for p in parts]
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: dimension {dim} names mesh axes "
                             f"{parts} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``target``; the gradient is constrained too (as
    ``with_sharding_constraint`` constrains the cotangent): whatever
    placements it arrives in, it leaves in the input's, a partial sum
    there replicated (the transpose of the forward's reduction)."""

    @staticmethod
    def forward(ctx, x, mesh, target):
        from torch.distributed.tensor import Replicate

        ctx.mesh = mesh
        ctx.source = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        if tuple(x.placements) == target:
            return x.view_as(x)
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.source:
            g = g.redistribute(ctx.mesh, ctx.source)
        return g, None, None


def constrain(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Activation sharding constraint by logical axes: ``x`` (and its
    gradient) redistributed to the active rules' placements when a mesh is
    active and ``x`` is a ``DTensor``; ``x`` itself otherwise."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return _Constrain.apply(x, mesh, placements(resolve_spec(axes), mesh))
