"""FunctionBlock registry — the port of ``repro/core/blocks.py``.

Models call *named function blocks* (``call("rmsnorm", ...)``); every name
has implementations tagged by execution target:

    "ref"    plain-torch oracle (the reference package's ``ref`` target)
    "torch"  plain-torch formulation (the kernels' plain versions)
    "cuda"   the hand-written Hopper kernel's wrapper

When no binding names a block, :meth:`FunctionBlockRegistry.call` picks the
target from the device of its first tensor argument: ``cuda`` for a CUDA
tensor, ``torch`` for a CPU tensor — the counterpart of the reference's
``ops._auto_backend``, which picks the Pallas kernel on the accelerator.
``bind({"rmsnorm": "torch"})`` pins a target for a scope (``chip_smoke.py``
uses it to compare a kernel against its plain version on the card); an
offload plan's mapping is bound the same way (the serve engine binds one
per phase).  The reference's targets map one to one: ``ref`` -> ``ref``,
``xla`` -> ``torch``, ``pallas`` -> ``cuda``.

A target may declare the calls it cannot differentiate (``no_backward``:
a kernel with no backward kernel).  An unbound call that picks such a
target while autograd will differentiate it (grad mode on, a tensor
argument requiring grad, those inside a tuple argument too) resolves to
``torch`` instead, as the reference's default resolves an unbound block
to ``xla``, which XLA differentiates.  Each such resolution is counted in
:attr:`FunctionBlockRegistry.grad_defaults`, by block and form.  A bound
target is never replaced: ``bind({"ssd_scan": "cuda"})`` under autograd
reaches the kernel's wrapper, which raises.

A call whose arguments are ``DTensor``s (under a mesh) runs the resolved
implementation on the local shards (:mod:`repro_torch.sharding.shelf`):
the target is chosen as for plain tensors, never changed because the
input is sharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Iterable, Iterator, Mapping

import torch

from repro_torch.sharding.shelf import call_local, has_dtensor

TARGETS = ("ref", "torch", "cuda")


#: ``(args, kwargs) ->`` the form of a call that a target cannot
#: differentiate ("" where the block has one form), or None where it can
NoBackward = Callable[[tuple, dict], "str | None"]


@dataclasses.dataclass(frozen=True)
class Impl:
    block: str
    target: str  # "ref" | "torch" | "cuda"
    fn: Callable[..., Any]
    note: str = ""
    no_backward: NoBackward | None = None  # None: every call differentiates


class GradRefused(RuntimeError):
    """A target asked to differentiate a call it has no backward for (a
    CUDA wrapper whose kernel has no backward kernel, under autograd)."""


def _device_target(args: tuple) -> str:
    for a in args:
        if isinstance(a, torch.Tensor):
            return "cuda" if a.is_cuda else "torch"
    raise TypeError("function block called without a tensor argument")


def wants_grad(*values: Any) -> bool:
    """Whether autograd will differentiate a call on ``values``: grad mode is
    on and a tensor among them, or inside a tuple or list among them,
    requires grad."""
    if not torch.is_grad_enabled():
        return False
    for a in values:
        for t in a if isinstance(a, (tuple, list)) else (a,):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return True
    return False


class FunctionBlockRegistry:
    def __init__(self) -> None:
        self._impls: dict[str, dict[str, Impl]] = {}
        self._local = threading.local()
        #: unbound calls resolved to ``torch`` for a gradient their device
        #: target cannot take, by ``block`` or ``block.form``
        self.grad_defaults: dict[str, int] = {}

    def register(
        self, block: str, target: str, fn: Callable[..., Any], note: str = "",
        no_backward: NoBackward | None = None,
    ) -> None:
        if target not in TARGETS:
            raise ValueError(f"unknown target '{target}'; known: {TARGETS}")
        self._impls.setdefault(block, {})[target] = Impl(block, target, fn, note, no_backward)

    def implementation(self, block: str, target: str) -> Impl:
        return self._impls[block][target]

    def blocks(self) -> list[str]:
        return sorted(self._impls)

    def targets(self, block: str) -> list[str]:
        return sorted(self._impls.get(block, {}))

    def shelf_fingerprint(self, blocks: Iterable[str] | None = None) -> str:
        """Hash of the registered implementations of the named blocks (all
        by default): (block, target, fn source) plus bound partial
        arguments.  Registration is import-order dependent, so persisted
        plans use a registration-time snapshot instead
        (``repro_torch.kernels.SHELF_FINGERPRINT``)."""
        names = sorted(blocks) if blocks is not None else self.blocks()
        return implementations_fingerprint(
            (block, target, self._impls[block][target].fn)
            for block in names
            for target in self.targets(block)
        )

    @property
    def _bindings(self) -> dict[str, str]:
        b = getattr(self._local, "bindings", None)
        if b is None:
            b = {}
            self._local.bindings = b
        return b

    @contextlib.contextmanager
    def bind(self, mapping: Mapping[str, str]) -> Iterator[None]:
        """Scope a block->target binding."""
        for block, target in mapping.items():
            if target not in self._impls.get(block, {}):
                raise KeyError(f"block '{block}' has no target '{target}'")
        saved = dict(self._bindings)
        self._bindings.update(mapping)
        try:
            yield
        finally:
            self._local.bindings = saved

    def current_pattern(self) -> dict[str, str]:
        return dict(self._bindings)

    def bindings(self) -> tuple[tuple[str, str], ...]:
        """The bindings in force in this thread, sorted (hashable: a CUDA
        graph freezes the targets it captured)."""
        return tuple(sorted(self._bindings.items()))

    def resolve(self, block: str, *args: Any, **kwargs: Any) -> Callable[..., Any]:
        """The implementation a call of ``block`` with ``args`` and
        ``kwargs`` runs: the bound target, else the target of the first
        tensor argument's device, unless that target cannot differentiate
        a call that autograd will differentiate: then ``torch``."""
        impls = self._impls.get(block)
        if not impls:
            raise KeyError(f"unknown function block '{block}'")
        target = self._bindings.get(block)
        if target is None:
            target = _device_target(args)
            no_backward = impls[target].no_backward
            form = None if no_backward is None else no_backward(args, kwargs)
            if form is not None and wants_grad(*args, *kwargs.values()):
                key = f"{block}.{form}" if form else block
                self.grad_defaults[key] = self.grad_defaults.get(key, 0) + 1
                target = "torch"
        return impls[target].fn

    def call(self, block: str, *args: Any, **kwargs: Any) -> Any:
        fn = self.resolve(block, *args, **kwargs)
        if has_dtensor(args, kwargs):  # under a mesh: on the local shards
            return call_local(block, fn, args, kwargs)
        return fn(*args, **kwargs)


def implementations_fingerprint(
    impls: "Iterable[tuple[str, str, Callable[..., Any]]]",
) -> str:
    """Hash (block, target, fn) triples by fn *source* (plus bound partial
    arguments), order-insensitively.  A rewritten wrapper changes the hash,
    which invalidates stored plans measured against the old code (a
    ``PlanStore`` fingerprint component)."""
    import functools
    import hashlib
    import inspect

    parts = []
    for block, target, fn in impls:
        bound = ""
        while isinstance(fn, functools.partial):
            bound += repr((fn.args, sorted((fn.keywords or {}).items())))
            fn = fn.func
        try:
            src = inspect.getsource(fn)
        except (OSError, TypeError):  # builtins / C extensions
            src = repr(fn)
        parts.append(f"{block}|{target}|{bound}|{src}")
    h = hashlib.sha256()
    for p in sorted(parts):
        h.update(p.encode())
    return h.hexdigest()[:16]


# Global registry used by the models.
registry = FunctionBlockRegistry()


def call(block: str, *args: Any, **kwargs: Any) -> Any:
    return registry.call(block, *args, **kwargs)


def bind(mapping: Mapping[str, str]):
    return registry.bind(mapping)


def register(block: str, target: str, note: str = ""):
    """Decorator: ``@register("rmsnorm", "cuda")``."""

    def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
        registry.register(block, target, fn, note)
        return fn

    return deco
