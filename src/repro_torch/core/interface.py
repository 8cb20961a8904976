"""Host-interface matching (paper §3.4 C-1 / C-2) — the port of
``repro/core/interface.py``.

When a function block is replaced by an accelerated implementation (a
hand-written CUDA kernel here; cuFFT / an IP core in the paper), the host-side
program and the replacement must agree on the calling interface.  The paper's
rules, implemented here:

* C-1 — interfaces agree: generate the glue and proceed (no user interaction).
* C-2 — interfaces differ:
    - pure dtype differences that a cast fixes (float vs double in the paper;
      f32/f64/bf16 here) are adapted **without** user confirmation;
    - replacement omits *optional* caller arguments: dropped automatically;
    - anything else (argument count/meaning, return arity) requires explicit
      user confirmation before a verification trial is attempted.

Shape extension (the analogue of matching an IP core's port widths): tiled
accelerator blocks require aligned shapes (multiples of 128).  ``pad_to`` / ``unpad_from`` provide shape adaptation, and
``InterfaceSpec`` entries may declare an ``align`` requirement which the
adapter satisfies transparently — alignment padding is value-preserving, so,
like casts, it needs no confirmation.

Arguments and results may be numpy arrays or torch tensors.  A cast of a
tensor follows the reference's canonicalisation with x64 off (float64 ->
float32, complex128 -> complex64, int64 -> int32), so adapted results
carry the same dtypes as the JAX engine's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

# Cast lattice: which automatic dtype adaptations are considered "benign".
# (paper: "float と double 等キャストすればよいだけであれば、特にユーザ確認
#  せずに試行に入ってもよい")
_CASTABLE = {
    ("float64", "float32"),
    ("float32", "float64"),
    ("float32", "bfloat16"),
    ("bfloat16", "float32"),
    ("float64", "bfloat16"),
    ("bfloat16", "float64"),
    ("int32", "int64"),
    ("int64", "int32"),
    ("complex128", "complex64"),
    ("complex64", "complex128"),
}


@dataclasses.dataclass(frozen=True)
class Param:
    """One parameter of a block interface."""

    name: str
    dtype: str  # numpy dtype name, e.g. "float32", "complex64"
    rank: int | None = None  # None = any rank
    optional: bool = False
    align: int | None = None  # required divisor of trailing dims (kernel tiles)


@dataclasses.dataclass(frozen=True)
class InterfaceSpec:
    """Callable interface: ordered params and return dtypes."""

    params: tuple[Param, ...]
    returns: tuple[str, ...]  # dtype names of outputs

    @property
    def required(self) -> tuple[Param, ...]:
        return tuple(p for p in self.params if not p.optional)


class InterfaceMismatch(Exception):
    """Raised when adaptation needs user confirmation and policy denies it."""


@dataclasses.dataclass
class Policy:
    """What may be adapted silently (paper C-2 defaults)."""

    auto_cast: bool = True
    auto_drop_optional: bool = True
    auto_pad: bool = True
    # callback invoked for semantic interface changes; returns True to allow.
    confirm: Callable[[str], bool] = lambda msg: False


@dataclasses.dataclass
class Adaptation:
    """A concrete plan for wrapping a replacement behind the source interface."""

    arg_casts: tuple[tuple[int, str] | None, ...]  # per-src-arg: (dst idx, dtype)
    ret_casts: tuple[str | None, ...]
    pads: tuple[int | None, ...]  # per-dst-arg alignment
    dropped: tuple[str, ...]  # names of source args dropped (optionals)
    confirmed: tuple[str, ...]  # messages the user confirmed
    exact: bool  # True => C-1 (no adaptation needed)

    def wrap(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        """Wrap ``fn`` (replacement) so it accepts source-interface calls."""

        arg_casts = self.arg_casts
        ret_casts = self.ret_casts
        pads = self.pads

        def adapted(*args: Any) -> Any:
            fwd: list[Any] = []
            orig_shapes: list[tuple[int, ...] | None] = []
            for i, plan in enumerate(arg_casts):
                if plan is None:  # dropped source argument
                    continue
                _, dt = plan
                a = args[i]
                if dt is not None:
                    a = cast(a, dt)
                j = len(fwd)
                pad = pads[j] if j < len(pads) else None
                if pad is not None and hasattr(a, "shape") and a.ndim >= 1:
                    orig_shapes.append(tuple(a.shape))
                    a = pad_to(a, pad)
                else:
                    orig_shapes.append(None)
                fwd.append(a)
            out = fn(*fwd)
            outs = out if isinstance(out, tuple) else (out,)
            adapted_outs = []
            for k, o in enumerate(outs):
                # un-pad outputs whose shape was inflated together with arg 0
                if (
                    orig_shapes
                    and orig_shapes[0] is not None
                    and hasattr(o, "shape")
                    and o.ndim == len(orig_shapes[0])
                    and all(
                        so >= sg for so, sg in zip(o.shape, orig_shapes[0])
                    )
                    and tuple(o.shape) != orig_shapes[0]
                ):
                    o = unpad_from(o, orig_shapes[0])
                dt = ret_casts[k] if k < len(ret_casts) else None
                if dt is not None:
                    o = cast(o, dt)
                adapted_outs.append(o)
            return adapted_outs[0] if len(adapted_outs) == 1 else tuple(adapted_outs)

        adapted.__name__ = getattr(fn, "__name__", "adapted")
        adapted.__wrapped__ = fn  # type: ignore[attr-defined]
        adapted.warmup_calls = getattr(fn, "warmup_calls", 1)  # type: ignore[attr-defined]
        return adapted


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float32,
    "bfloat16": torch.bfloat16, "complex64": torch.complex64,
    "complex128": torch.complex64, "int32": torch.int32, "int64": torch.int32,
}


def cast(x: Any, dtype: str) -> Any:
    """Cast a numpy array (``astype``) or a tensor (canonical dtype);
    anything else passes through."""
    if isinstance(x, torch.Tensor):
        return x.to(_TORCH_DTYPES[dtype])
    return x.astype(dtype) if hasattr(x, "astype") else x


def pad_to(x: Any, align: int) -> Any:
    """Zero-pad the trailing two dims (or last dim for rank-1) to ``align``."""
    if align is None or x.ndim == 0:
        return x
    shape = list(x.shape)
    ndims = min(2, x.ndim)
    pad_width = [(0, 0)] * x.ndim
    changed = False
    for d in range(x.ndim - ndims, x.ndim):
        rem = (-shape[d]) % align
        if rem:
            pad_width[d] = (0, rem)
            changed = True
    if not changed:
        return x
    return np.pad(x, pad_width) if isinstance(x, np.ndarray) else _torch_pad(x, pad_width)


def _torch_pad(x: torch.Tensor, pad_width: Sequence[tuple[int, int]]) -> torch.Tensor:
    # F.pad takes (before, after) pairs from the last dim backwards
    flat = [p for pair in reversed(pad_width) for p in pair]
    return torch.nn.functional.pad(x, flat)


def unpad_from(x: Any, shape: tuple[int, ...]) -> Any:
    slices = tuple(slice(0, s) for s in shape)
    return x[slices]


def match_interfaces(
    src: InterfaceSpec, dst: InterfaceSpec, policy: Policy | None = None
) -> Adaptation:
    """Compute the adaptation plan from a source call interface to a
    replacement interface, following the paper's C-1/C-2 rules.

    Raises InterfaceMismatch when a semantic change is needed and the policy's
    ``confirm`` callback declines it.
    """

    policy = policy or Policy()
    confirmed: list[str] = []

    def ask(msg: str) -> None:
        if not policy.confirm(msg):
            raise InterfaceMismatch(msg)
        confirmed.append(msg)

    n_src, n_dst = len(src.params), len(dst.params)
    arg_casts: list[tuple[int, str] | None] = []
    dropped: list[str] = []
    exact = True

    if n_src < len(dst.required):
        ask(
            f"replacement requires {len(dst.required)} args but source "
            f"provides {n_src}; call with replacement defaults?"
        )
        exact = False

    for i, sp in enumerate(src.params):
        if i < n_dst:
            dp = dst.params[i]
            if sp.dtype == dp.dtype:
                arg_casts.append((i, None))
            elif (sp.dtype, dp.dtype) in _CASTABLE:
                if not policy.auto_cast:
                    ask(f"cast arg '{sp.name}' {sp.dtype}->{dp.dtype}?")
                arg_casts.append((i, dp.dtype))
                exact = False
            else:
                ask(
                    f"arg '{sp.name}' type {sp.dtype} incompatible with "
                    f"replacement '{dp.name}' type {dp.dtype}; reinterpret?"
                )
                arg_casts.append((i, dp.dtype))
                exact = False
            if sp.rank is not None and dp.rank is not None and sp.rank != dp.rank:
                ask(
                    f"arg '{sp.name}' rank {sp.rank} != replacement rank "
                    f"{dp.rank}; reshape semantics change?"
                )
                exact = False
        else:
            # Source passes more arguments than the replacement takes.
            if sp.optional and policy.auto_drop_optional:
                arg_casts.append(None)
                dropped.append(sp.name)
                exact = False
            else:
                ask(
                    f"source arg '{sp.name}' has no replacement counterpart; "
                    "drop it?"
                )
                arg_casts.append(None)
                dropped.append(sp.name)
                exact = False

    # Returns.
    if len(src.returns) != len(dst.returns):
        ask(
            f"return arity differs: source {len(src.returns)} vs "
            f"replacement {len(dst.returns)}; accept replacement outputs?"
        )
        exact = False
    ret_casts: list[str | None] = []
    for k, rs in enumerate(src.returns):
        if k >= len(dst.returns):
            break
        rd = dst.returns[k]
        if rs == rd:
            ret_casts.append(None)
        elif (rd, rs) in _CASTABLE:
            if not policy.auto_cast:
                ask(f"cast return {rd}->{rs}?")
            ret_casts.append(rs)
            exact = False
        else:
            ask(f"return type {rd} incompatible with expected {rs}; cast anyway?")
            ret_casts.append(rs)
            exact = False

    pads = tuple(p.align for p in dst.params)
    if any(p is not None for p in pads):
        if not policy.auto_pad:
            ask("replacement requires lane-aligned shapes; zero-pad inputs?")
        exact = exact and all(p is None for p in pads)

    return Adaptation(
        arg_casts=tuple(arg_casts),
        ret_casts=tuple(ret_casts),
        pads=pads,
        dropped=tuple(dropped),
        confirmed=tuple(confirmed),
        exact=exact,
    )


def spec_from_arrays(
    args: Sequence[Any], returns: Sequence[Any], optional_from: int | None = None
) -> InterfaceSpec:
    """Build an InterfaceSpec by inspecting example arrays."""

    params = []
    for i, a in enumerate(args):
        a = _host(a)
        params.append(
            Param(
                name=f"arg{i}",
                dtype=a.dtype.name,
                rank=a.ndim,
                optional=optional_from is not None and i >= optional_from,
            )
        )
    rets = tuple(_host(r).dtype.name for r in returns)
    return InterfaceSpec(params=tuple(params), returns=rets)


def _host(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
