"""Carry weights and caches between the reference package and the port.

The bridge speaks numpy only: a caller holding the reference's trees maps
them to numpy on its side (``jax.tree.map(np.asarray, tree)``) and hands
the nested dicts over.  Keys are exactly the reference's
(``embed/embedding``, ``blocks/g0_a/attn/wq``, ... with the stacked layer
axis; caches ``g0_a/k``, ``index``), which the port's trees share.

bfloat16 arrays (``ml_dtypes.bfloat16`` from the reference) arrive as their
16-bit patterns and keep their bits; the inverses return float32 for a
bfloat16 tensor, which holds every bfloat16 value exactly.  An optimizer
state crosses as its three parts (``mu`` and ``nu`` shaped as the
parameters, in the moment dtype, and the step count), so both AdamWs can
start from the same moments.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.params import ParamMeta, torch_dtype
from repro_torch.optim.adamw import OptState


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the reference's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _convert(tree: Any, metas: Any, device, path: str = "", dtype=None) -> Any:
    """``tree`` checked key by key and shape by shape against ``metas``, in
    each meta's dtype (or ``dtype``)."""
    if isinstance(metas, ParamMeta):
        if isinstance(tree, dict):
            raise ValueError(f"{path}: expected an array, got a subtree")
        t = _to_torch(tree, device)
        if tuple(t.shape) != metas.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {metas.shape}")
        return t.to(dtype or torch_dtype(metas.dtype))
    if not isinstance(tree, dict) or set(tree) != set(metas):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or '/'}: keys {got} != {sorted(metas)}")
    return {k: _convert(tree[k], metas[k], device, f"{path}/{k}", dtype) for k in metas}


def params_from_numpy(tree: Any, cfg: ArchConfig, device="cpu") -> Any:
    """The reference's parameter tree (nested dicts of numpy arrays) ->
    the port's, checked key by key and shape by shape against the port's
    ``build_metas``."""
    return _convert(tree, lm.build_metas(cfg), device)


def cache_from_numpy(
    tree: Any,
    cfg: ArchConfig,
    batch: int,
    max_len: int,
    *,
    page_size: int | None = None,
    n_pages: int | None = None,
    device="cpu",
) -> Any:
    """The reference's cache tree (``lm.init_cache`` layout, contiguous or
    paged) -> the port's, checked against the port's ``cache_metas_tree``."""
    metas = lm.cache_metas_tree(cfg, batch, max_len, page_size=page_size, n_pages=n_pages)
    return _convert(tree, metas, device)


def params_to_numpy(params: Any) -> Any:
    """Inverse of :func:`params_from_numpy`."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return _to_numpy(params)


cache_to_numpy = params_to_numpy  # caches are the same kind of tree


def opt_state_from_numpy(mu: Any, nu: Any, step: Any, cfg: ArchConfig,
                         moment_dtype: str = "float32", device="cpu") -> OptState:
    """The reference's ``OptState`` parts (``mu`` / ``nu`` as nested dicts
    of numpy arrays, ``step`` a scalar) -> the port's, the moments checked
    against the parameters' metas and held in ``moment_dtype``."""
    metas, dt = lm.build_metas(cfg), torch_dtype(moment_dtype)
    return OptState(
        mu=_convert(mu, metas, device, dtype=dt),
        nu=_convert(nu, metas, device, dtype=dt),
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
    )


def opt_state_to_numpy(state: OptState) -> tuple[Any, Any, int]:
    """Inverse of :func:`opt_state_from_numpy`: ``(mu, nu, step)``."""
    return params_to_numpy(state.mu), params_to_numpy(state.nu), int(state.step)
