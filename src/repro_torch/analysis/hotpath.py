"""Hot-path lints for the serve engine's step programs (the port of
``repro/analysis/hotpath.py``).

``ServeEngine`` registers each program (prefill / decode / insert /
extend / extend_sample) with a :class:`ProgramSet` at construction; the
returned wrapper records every *signature* the program is called under
(the positional inputs' shapes and dtypes; a step program's keyword
arguments, such as the sampling policy, are not part of it: each policy
is a graph key of the same program), and the set lints the programs it
has observed:

* ``host-sync``     — a loop program returns a non-carry output larger than
                      ``sync_bytes``: the driver loop will pull it to host
                      every step (the contract is that decode's per-step
                      transfer is the sampled token ids only).
* ``callback``      — a host read inside the traced program (``.item()``,
                      ``.tolist()``): it waits for the device on every call
                      and cannot be captured in a CUDA graph.
* ``retrace-risk``  — more distinct signatures than the program declares
                      (``expected_signatures``): something in the
                      argument stream drifts, and every drift is a new
                      eager call and capture.
* ``weak-type``     — Python-scalar operands in a loop program's
                      signature; their dtype follows the call site.
* ``const-capture`` — a large tensor baked into the trace as a constant
                      instead of passed as an operand (a closed-over
                      weight: a captured graph pins it, and the program's
                      memory estimate cannot see it as state).

A "compile" is a signature's first call (its eager run) and, for a
graphed program, the call that captures its graph: each feeds a
``compile`` span and the ``serve_program_retraces_total`` /
``serve_program_compile_seconds_total`` counters.  The traced lints run
the program under fake tensors (``make_fx``), with the engine state it
reads passed as arguments (a record's ``trace``), so nothing runs on the
device.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.analysis import features as features_mod
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core import graph_analysis

#: Host-transfer budget per loop-program call (non-carry outputs).  The
#: decode contract is "token ids only": (B,) int32 stays far below this.
DEFAULT_SYNC_BYTES = 32 * 1024

#: A constant this large baked into a trace is a capture bug, not a table.
DEFAULT_CONST_BYTES = 1 << 20


@dataclasses.dataclass(frozen=True)
class Struct:
    """The shape and dtype of an observed operand (``device`` None for a
    host array, which a step program uploads to its own device)."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    device: torch.device | None = None


def _leaf_signature(leaf: Any) -> tuple:
    if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
        return (tuple(leaf.shape), str(leaf.dtype), False)
    # a Python scalar: its dtype follows the call site, not the program
    return ("pyscalar", type(leaf).__name__)


def _leaf_struct(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return Struct(tuple(leaf.shape), leaf.dtype, leaf.device)
    if isinstance(leaf, np.ndarray):
        return Struct(leaf.shape, torch.from_numpy(np.empty(0, leaf.dtype)).dtype)
    return leaf


def _tree_bytes(tree: Any) -> int:
    return sum(features_mod.tensor_bytes(leaf) for leaf in tree_leaves(tree))


@dataclasses.dataclass
class ProgramRecord:
    """One registered hot-path program and its observed call signatures."""

    name: str
    fn: Callable[..., Any]
    loop: bool = False  # called once per engine step (the decode loop)
    carry_outputs: tuple[int, ...] = ()  # top-level outputs that stay on device
    expected_signatures: int | None = None  # None = unbounded (e.g. prefill)
    #: trace-span kind covering this program's calls (None = the engine
    #: never span-instruments it — the obs info lint flags that)
    span_kind: str | None = None
    #: ``(args, kwargs) -> (function, arguments)`` to trace for a call's
    #: (fake) arguments: the engine's step function with the state it
    #: reads as arguments.  None: ``fn`` itself on the call's arguments
    trace: Callable[[tuple, dict], tuple[Callable[..., Any], tuple]] | None = None
    #: signature -> (the call's operand structs, its keyword arguments)
    signatures: dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    calls: int = 0
    #: wall seconds spent compiling: each signature's first call, and each
    #: call that captured a graph
    compile_seconds: float = 0.0

    @property
    def retraces(self) -> int:
        """Signatures beyond the first — each one a new eager call and
        capture."""
        return max(len(self.signatures) - 1, 0)

    def observe(self, args: tuple, kwargs: dict | None = None) -> bool:
        """Record one call; True when its signature is new."""
        self.calls += 1
        sig = tuple(_leaf_signature(leaf) for leaf in tree_leaves(args))
        if sig not in self.signatures:
            # structs for on-demand tracing; built only for new signatures
            # so the steady-state decode step pays one tuple()
            self.signatures[sig] = (tree_map(_leaf_struct, args), dict(kwargs or {}))
            return True
        return False


def _captured_graphs(fn: Any) -> int:
    """Graphs a program has captured (a step program's ``captures``)."""
    captures = getattr(fn, "captures", None)
    return len(captures.keys()) if captures is not None else 0


class ProgramSet:
    """Registry of one engine's hot-path programs, lintable on demand.
    ``programs[name]`` is the registered program itself.  ``device`` is
    where a host-array operand goes (a step program's device)."""

    def __init__(
        self,
        sync_bytes: int = DEFAULT_SYNC_BYTES,
        const_bytes: int = DEFAULT_CONST_BYTES,
        device: "torch.device | str" = "cpu",
    ) -> None:
        self.records: dict[str, ProgramRecord] = {}
        self.sync_bytes = sync_bytes
        self.const_bytes = const_bytes
        self.device = torch.device(device)
        #: optional ``repro_torch.obs`` attachments (set by the engine): a
        #: Tracer that receives a "compile" span per compile, and a
        #: MetricsRegistry that carries per-program retrace/compile-time
        #: counters.  Both default off — a bare ProgramSet stays
        #: analysis-only with zero obs coupling.
        self.tracer: Any = None
        self.metrics: Any = None

    def __getitem__(self, name: str) -> Any:
        return self.records[name].fn

    def register(
        self,
        name: str,
        fn: Callable[..., Any],
        loop: bool = False,
        carry_outputs: Sequence[int] = (),
        expected_signatures: int | None = None,
        span_kind: str | None = None,
        trace: Callable[[tuple, dict], tuple[Callable[..., Any], tuple]] | None = None,
    ) -> Callable[..., Any]:
        """Wrap ``fn`` so calls record their signature (and the wall time
        of each compile).  Returns the wrapper the caller should invoke
        instead of ``fn``."""
        rec = ProgramRecord(
            name=name, fn=fn, loop=loop, carry_outputs=tuple(carry_outputs),
            expected_signatures=expected_signatures, span_kind=span_kind, trace=trace,
        )
        self.records[name] = rec

        @functools.wraps(fn)
        def observed(*args: Any, **kwargs: Any) -> Any:
            new_sig = rec.observe(args, kwargs)
            graphs = _captured_graphs(rec.fn)
            t0 = time.perf_counter()
            out = rec.fn(*args, **kwargs)
            if new_sig or _captured_graphs(rec.fn) != graphs:
                dt = time.perf_counter() - t0
                rec.compile_seconds += dt
                self._on_compile(rec, t0, dt, retrace=new_sig and len(rec.signatures) > 1)
            return out

        observed.record = rec  # type: ignore[attr-defined]
        return observed

    def _on_compile(self, rec: ProgramRecord, t0: float, dt: float, retrace: bool) -> None:
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.add_span(
                "compile", t0, t0 + dt,
                program=rec.name, signature=len(rec.signatures),
            )
        if self.metrics is not None:
            self.metrics.counter(
                "serve_program_retraces_total",
                "distinct signatures per program beyond the first",
                labelnames=("program",),
            ).labels(program=rec.name).inc(1 if retrace else 0)
            self.metrics.counter(
                "serve_program_compile_seconds_total",
                "wall seconds spent in each signature's first call and in "
                "graph captures",
                labelnames=("program",),
            ).labels(program=rec.name).inc(dt)

    def stats(self) -> dict[str, dict[str, Any]]:
        """Per-program compile/retrace counters for reports and the
        metrics endpoint."""
        return {
            name: {
                "calls": rec.calls,
                "signatures": len(rec.signatures),
                "retraces": rec.retraces,
                "compile_seconds": rec.compile_seconds,
                "span_kind": rec.span_kind,
            }
            for name, rec in self.records.items()
        }

    def observe(self, name: str, *args: Any, **kwargs: Any) -> None:
        """Record a signature without wrapping (tests, ad-hoc programs)."""
        self.records[name].observe(args, kwargs)

    # -- lints ---------------------------------------------------------------

    def lint(self, names: Sequence[str] | None = None) -> list[Diagnostic]:
        diags: list[Diagnostic] = []
        for name, rec in self.records.items():
            if names is not None and name not in names:
                continue
            diags.extend(self._lint_record(rec))
        return diags

    def _fake(self, structs: Any, mode: FakeTensorMode) -> Any:
        def make(leaf: Any) -> Any:
            if isinstance(leaf, Struct):
                with mode:
                    return torch.empty(leaf.shape, dtype=leaf.dtype,
                                       device=leaf.device or self.device)
            if isinstance(leaf, torch.Tensor) and not isinstance(leaf, FakeTensor):
                return mode.from_tensor(leaf)  # a program's own state
            return leaf

        return tree_map(make, structs)

    def _lint_record(self, rec: ProgramRecord) -> list[Diagnostic]:
        diags: list[Diagnostic] = []
        if not rec.signatures:
            return diags  # never called — nothing observed to lint

        if self.tracer is not None and rec.span_kind is None:
            # the engine attached a tracer but this program's calls carry
            # no span kind: its time is invisible in the exported timeline
            diags.append(Diagnostic(
                pass_name="hotpath", code="no-span", severity="info",
                program=rec.name, subject="span-instrumentation",
                message=(
                    "program is registered with a traced engine but has no "
                    "span_kind — its calls won't appear in obs timelines"
                ),
            ))

        if rec.expected_signatures is not None and len(rec.signatures) > rec.expected_signatures:
            sigs = len(rec.signatures)
            diags.append(Diagnostic(
                pass_name="hotpath", code="retrace-risk", severity="warning",
                program=rec.name, subject=f"{sigs}-signatures",
                message=(
                    f"{sigs} distinct signatures observed over {rec.calls} calls "
                    f"(declared {rec.expected_signatures}) — each drift is a new "
                    "eager call and capture"
                ),
            ))

        first_sig = next(iter(rec.signatures))
        structs, kwargs = rec.signatures[first_sig]
        if rec.loop:
            for leaf_sig in first_sig:
                if leaf_sig and leaf_sig[0] == "pyscalar":
                    diags.append(Diagnostic(
                        pass_name="hotpath", code="weak-type",
                        severity="warning", program=rec.name,
                        subject=f"pyscalar-{leaf_sig[1]}",
                        message=(
                            f"python {leaf_sig[1]} operand in a loop program; "
                            "pass an array to pin its dtype"
                        ),
                    ))
        mode = graph_analysis.fake_mode()
        try:
            args = self._fake(structs, mode)
            fn, fn_args = (rec.trace(args, kwargs) if rec.trace is not None
                           else (functools.partial(rec.fn, **kwargs), args))
            fn_args = self._fake(fn_args, mode)
        except Exception:  # noqa: BLE001 — unlintable under this signature
            return diags
        if rec.loop:
            diags.extend(self._lint_host_sync(rec, fn, fn_args, mode))
        diags.extend(self._lint_traced(rec, fn, fn_args))
        return diags

    def _lint_host_sync(self, rec: ProgramRecord, fn: Callable[..., Any], args: tuple,
                        mode: FakeTensorMode) -> list[Diagnostic]:
        """The program run under fake tensors (the counterpart of
        ``jax.eval_shape``) sizes its non-carry outputs."""
        try:
            with mode:
                out = fn(*args)
        except Exception:  # noqa: BLE001 — unlintable under this signature
            return []
        parts = list(out) if isinstance(out, (tuple, list)) else [out]
        diags = []
        for i, part in enumerate(parts):
            if i in rec.carry_outputs:
                continue
            nbytes = _tree_bytes(part)
            if nbytes > self.sync_bytes:
                diags.append(Diagnostic(
                    pass_name="hotpath", code="host-sync", severity="warning",
                    program=rec.name, subject=f"output[{i}]",
                    message=(
                        f"non-carry output {i} is {nbytes} bytes "
                        f"(> {self.sync_bytes}); the driver loop pulls it "
                        "to host every step — fuse the reduction (e.g. "
                        "sampling) into the program"
                    ),
                ))
        return diags

    def _lint_traced(self, rec: ProgramRecord, fn: Callable[..., Any],
                     args: tuple) -> list[Diagnostic]:
        try:
            feats = features_mod.extract_features(*graph_analysis.trace(fn, *args))
        except Exception:  # noqa: BLE001 — unlintable under this signature
            return []
        diags = []
        for cb in feats.callbacks:
            diags.append(Diagnostic(
                pass_name="hotpath", code="callback", severity="warning",
                program=rec.name, subject=cb,
                message=(
                    f"'{cb}' in the traced program reads a device value on "
                    "the host on every call"
                ),
            ))
        if feats.largest_const_bytes > self.const_bytes:
            diags.append(Diagnostic(
                pass_name="hotpath", code="const-capture", severity="warning",
                program=rec.name,
                subject=f"const-{feats.largest_const_bytes}B",
                message=(
                    f"a {feats.largest_const_bytes}-byte tensor is baked "
                    "into the trace as a constant; pass it as an operand"
                ),
            ))
        return diags

    def features(self, name: str) -> features_mod.ProgramFeatures:
        """The traced features of a program under its first signature (its
        aten ops and the kernels its trace stood in for)."""
        rec = self.records[name]
        structs, kwargs = next(iter(rec.signatures.values()))
        mode = graph_analysis.fake_mode()
        args = self._fake(structs, mode)
        fn, fn_args = (rec.trace(args, kwargs) if rec.trace is not None
                       else (functools.partial(rec.fn, **kwargs), args))
        return features_mod.extract_features(*graph_analysis.trace(fn, *self._fake(fn_args, mode)))


def lint_traced_program(
    name: str,
    fn: Callable[..., Any],
    example_args: Sequence[Any],
    sync_bytes: int = DEFAULT_SYNC_BYTES,
    const_bytes: int = DEFAULT_CONST_BYTES,
    loop: bool = False,
    carry_outputs: Sequence[int] = (),
) -> list[Diagnostic]:
    """One-shot lint of a standalone program (zoo cells, CLI sweeps)."""
    ps = ProgramSet(sync_bytes=sync_bytes, const_bytes=const_bytes)
    ps.register(name, fn, loop=loop, carry_outputs=carry_outputs)
    ps.records[name].observe(tuple(example_args))
    return ps.lint()
