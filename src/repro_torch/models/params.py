"""Parameter metadata: one source of truth for the shape, dtype and
initialisation of every model parameter and cache leaf (the port of
``repro/models/params.py``).

``build_*_metas`` functions return nested dicts of :class:`ParamMeta`; the
same tree materialises parameters (:func:`init_params`) and caches, and
gives the spec tree of any mesh's rules (:func:`spec_tree`), which
:func:`shard_params` places as ``DTensor`` leaves (the counterpart of
``jax.device_put`` with a ``NamedSharding``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.sharding.utils import placements, resolve_spec

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis names, len == len(shape)
    dtype: str = "float32"
    init: str = "normal"  # "normal" | "zeros" | "ones" | "ssm_a" | "dt_bias"
    scale: float = 0.02

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_meta(x: Any) -> bool:
    return isinstance(x, ParamMeta)


def tree_map_metas(fn: Callable[[ParamMeta], Any], tree: Any) -> Any:
    if is_meta(tree):
        return fn(tree)
    return {k: tree_map_metas(fn, v) for k, v in tree.items()}


def abstract_params(metas: Any) -> Any:
    """The meta tree as tensors on the ``meta`` device (shape and dtype,
    no storage): the counterpart of ``jax.ShapeDtypeStruct`` leaves."""
    return tree_map_metas(
        lambda m: torch.empty(m.shape, dtype=torch_dtype(m.dtype), device="meta"), metas
    )


def init_params(
    metas: Any, seed: int = 0, device: "torch.device | str" = "cpu"
) -> Any:
    """Materialise a meta tree on ``device``; random leaves draw from one
    ``torch.Generator`` seeded with ``seed`` on that device, in sorted-key
    leaf order (the order ``jax.tree`` flattens dicts).  The draws differ
    from ``jax.random``'s: the tests carry the reference's weights across
    with ``repro_torch.bridge``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(m: ParamMeta) -> torch.Tensor:
        dt = torch_dtype(m.dtype)
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dt, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dt, device=device)
        if m.init == "ssm_a":  # A_log: log of uniform [1, 16)
            u = torch.rand(m.shape, generator=gen, dtype=torch.float32, device=device)
            return torch.log(1.0 + 15.0 * u).to(dt)
        if m.init == "dt_bias":  # softplus^-1 of a log-uniform dt in [1e-3, 1e-1]
            u = torch.rand(m.shape, generator=gen, dtype=torch.float32, device=device)
            lo, hi = math.log(1e-3), math.log(1e-1)
            dtv = torch.exp(u * (hi - lo) + lo)
            return (dtv + torch.log(-torch.expm1(-dtv))).to(dt)
        if m.init != "normal":
            raise NotImplementedError(f"init '{m.init}' is not ported yet")
        x = torch.randn(m.shape, generator=gen, dtype=torch.float32, device=device)
        # scaled in place: one f32 copy of the leaf at a time (a stacked
        # expert leaf of arctic-480b is 17.8 GB in f32)
        return x.mul_(m.scale).to(dt)

    def build(tree: Any) -> Any:
        if isinstance(tree, ParamMeta):
            return make(tree)
        return {k: build(tree[k]) for k in sorted(tree)}

    return build(metas)


def spec_tree(metas: Any, rules: dict[str, Any]) -> Any:
    return tree_map_metas(lambda m: resolve_spec(m.axes, rules), metas)


def local_shape(shape: tuple, pl: tuple, mesh: Any) -> tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor with placements ``pl``
    (``torch.chunk``'s split, mesh dimensions in order), in plain ints."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            n, k = out[p.dim], mesh.size(i)
            full = -(-n // k)
            out[p.dim] = max(0, min(n, full * (coord[i] + 1)) - full * coord[i])
    return tuple(out)


def _from_local(local: torch.Tensor, mesh: Any, pl: tuple, shape: tuple) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def place(x: torch.Tensor, spec: tuple, mesh: Any) -> torch.Tensor:
    """``x`` as a ``DTensor`` on ``mesh`` with ``spec``'s placements.  A real
    tensor is split from rank 0's copy (``distribute_tensor``); a fake one
    (the dry-run's) becomes a fake local shard of the right shape, with no
    collective."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import distribute_tensor

    pl = placements(spec, mesh)
    if not isinstance(x, FakeTensor):
        return distribute_tensor(x.detach(), mesh, pl)
    return _from_local(x.new_empty(local_shape(x.shape, pl, mesh)), mesh, pl, tuple(x.shape))


def zeros_sharded(metas: Any, mesh: Any, rules: dict[str, Any], device: Any) -> Any:
    """A zeroed meta tree (a cache) made shard by shard: each rank
    allocates its own shard only."""

    def make(m: ParamMeta) -> torch.Tensor:
        pl = placements(resolve_spec(m.axes, rules), mesh)
        local = torch.zeros(local_shape(m.shape, pl, mesh), dtype=torch_dtype(m.dtype),
                            device=device)
        return _from_local(local, mesh, pl, m.shape)

    return tree_map_metas(make, metas)


def placement_tree(metas: Any, mesh: Any, rules: dict[str, Any]) -> Any:
    """Each leaf's ``DTensor`` placements on ``mesh`` (a train step's
    ``grad_shardings``)."""
    return tree_map_metas(lambda m: placements(resolve_spec(m.axes, rules), mesh), metas)


def shard_tree(tree: Any, specs: Any, mesh: Any) -> Any:
    """Every leaf of a nested dict placed with its spec (same structure)."""
    if isinstance(tree, dict):
        return {k: shard_tree(tree[k], specs[k], mesh) for k in tree}
    return place(tree, specs, mesh)


def shard_params(tree: Any, metas: Any, mesh: Any, rules: dict[str, Any]) -> Any:
    """A parameter (or cache) tree as ``DTensor`` leaves, each with its
    meta's logical axes resolved by ``rules``."""
    return shard_tree(tree, spec_tree(metas, rules), mesh)


def shard_opt_state(state: Any, metas: Any, mesh: Any, rules: dict[str, Any]) -> Any:
    """An optimizer state placed as the reference's dry-run places it: the
    moments with their parameters' specs, the step count replicated."""
    specs = spec_tree(metas, rules)
    return dataclasses.replace(state, mu=shard_tree(state.mu, specs, mesh),
                               nu=shard_tree(state.nu, specs, mesh),
                               step=place(state.step, (), mesh))


def shard_batch(batch: dict, mesh: Any, rules: dict[str, Any]) -> dict:
    """A batch's leaves sharded on their leading (``act_batch``) axis."""
    batch_axes = rules.get("act_batch")
    return {k: place(v, (batch_axes,) + (None,) * (v.ndim - 1), mesh)
            for k, v in batch.items()}


def count_params(metas: Any) -> int:
    """Number of parameters a meta tree materialises."""
    if isinstance(metas, ParamMeta):
        return math.prod(metas.shape)
    return sum(count_params(v) for v in metas.values())


def param_bytes(metas: Any) -> int:
    """Bytes a meta tree materialises, each leaf in its dtype."""
    if isinstance(metas, ParamMeta):
        return math.prod(metas.shape) * torch_dtype(metas.dtype).itemsize
    return sum(param_bytes(v) for v in metas.values())
