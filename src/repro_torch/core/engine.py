"""OffloadEngine — the paper's Steps 1-3, end to end (the port of
``repro/core/engine.py``: the application path).

Given a CPU application (a Python callable), the engine:

  Step 1  analyses the defining module's source (``ast_analysis``) — library
          calls (A-1), local definitions (A-2), loop statements;
  Step 2  discovers offloadable blocks: DB name matching (B-1) and
          Deckard-style similarity (B-2);
          interfaces are reconciled per C-1/C-2 (casts silently, semantic
          changes only with user confirmation);
  Step 3  hands the discovered blocks to ``planner``: candidate
          offload patterns are a ``SubsetSpace`` (built by AST call-site
          substitution) searched by a pluggable ``SearchStrategy`` —
          ``SingleThenCombine`` (the paper's procedure) by default, or the
          prior-work ``GeneticSearch`` — through a shared
          ``MeasurementCache``.  The fastest pattern is numerics-checked
          and returned.

A replacement block receives the host program's numpy arrays; it moves
them to the engine's ``device`` — the CUDA card unless the caller passes
``device="cpu"`` — runs there, and its results cross back to the host
program as numpy arrays.

For the model zoo the engine selects block bindings: by declaration
(``select_block_pattern``, the dry-run case) or by measurement over listed
patterns (``measure_block_pattern``, a shim over the session's binding
mode).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Mapping, Sequence

import numpy as np

import torch

from repro_torch.core import ast_analysis, planner, similarity, substitute, verify
from repro_torch.core.blocks import registry as block_registry
from repro_torch.core.interface import (
    Adaptation,
    InterfaceMismatch,
    InterfaceSpec,
    Policy,
    match_interfaces,
    spec_from_arrays,
)
from repro_torch.core.pattern_db import CodePatternDB, ReplacementEntry, default_db


@dataclasses.dataclass
class Discovery:
    kind: str  # "libcall" (A-1/B-1) | "similar" (A-2/B-2)
    source_name: str  # the call name (as written) or local def name
    entry: ReplacementEntry
    score: float = 1.0
    needs_confirmation: bool = False
    confirm_messages: tuple[str, ...] = ()


@dataclasses.dataclass
class AdaptedApp:
    fn: Callable[..., Any]
    discoveries: list[Discovery]
    skipped: list[Discovery]
    verification: verify.VerificationReport
    numerics_ok: bool
    offload_pattern: tuple[str, ...]


@dataclasses.dataclass
class PreparedApp:
    """Steps 1-2 output: the searchable space for an existing application.

    Produced by ``OffloadEngine.prepare``; consumed by
    ``repro_torch.offload.OffloadSession`` (whose ``plan`` stage searches
    ``space`` and whose ``commit`` stage builds the winning variant).
    """

    space: "planner.SubsetSpace"
    discoveries: list[Discovery]
    skipped: list[Discovery]
    source_report: ast_analysis.SourceReport


def _resolve_dotted(ns: Mapping[str, Any], dotted: str) -> Any | None:
    obj: Any = ns.get(dotted.split(".")[0])
    for part in dotted.split(".")[1:]:
        if obj is None:
            return None
        obj = getattr(obj, part, None)
    return obj


def _host(x: Any) -> Any:
    if isinstance(x, tuple):
        return tuple(_host(e) for e in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_wrap(fn: Callable[..., Any], device: torch.device) -> Callable[..., Any]:
    """Array arguments move to ``device`` (canonicalised, as the reference's
    ``jnp.asarray`` with x64 off) before the accelerated block runs."""
    from repro_torch.kernels.ops import as_tensor

    def on_device(*args: Any) -> Any:
        return fn(*(
            as_tensor(a, device) if isinstance(a, (np.ndarray, torch.Tensor)) else a
            for a in args
        ))

    on_device.__name__ = getattr(fn, "__name__", "offloaded")
    return on_device


def _host_wrap(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Results cross back to the host program after the offloaded block."""

    def wrapped(*args: Any) -> Any:
        return _host(fn(*args))

    wrapped.__name__ = getattr(fn, "__name__", "offloaded")
    return wrapped


class OffloadEngine:
    def __init__(
        self,
        db: CodePatternDB | None = None,
        policy: Policy | None = None,
        similarity_threshold: float = similarity.DEFAULT_THRESHOLD,
        device: "torch.device | str | None" = None,
    ) -> None:
        from repro_torch.kernels.ops import resolve_device

        self.device = resolve_device(device)
        self.db = db or default_db()
        self.policy = policy or Policy()
        self.similarity_threshold = similarity_threshold

    # -- Step 1 ---------------------------------------------------------------
    def analyze(self, app_fn: Callable[..., Any]) -> ast_analysis.SourceReport:
        return ast_analysis.analyze_module_of(app_fn, self.db.known_library_names)

    # -- Step 2 ---------------------------------------------------------------
    def discover(
        self, report: ast_analysis.SourceReport, entry_fn: str | None = None
    ) -> list[Discovery]:
        found: dict[str, Discovery] = {}

        # A-1/B-1: library calls matched by name against the DB list.
        for call in report.library_calls:
            if entry_fn is not None and call.enclosing != entry_fn:
                continue
            entry = self.db.lookup_by_call(call.call_name)
            if entry and entry.name not in found:
                found[entry.name] = Discovery(
                    kind="libcall", source_name=call.call_name, entry=entry
                )

        # A-2/B-2: local defs similar to DB reference code.  Skip defs whose
        # *name* is already a DB library name (those are the library itself,
        # handled by A-1).  A function block is compared together with the
        # local helpers it calls (one level), matching how the DB registers
        # reference code for whole blocks.  When the entry function is known,
        # only blocks it calls directly are candidates — the paper replaces
        # blocks *used by the application*.
        lib_names = {
            n.rsplit(".", 1)[-1] for n in self.db.known_library_names
        }
        by_name = {fd.name: fd for fd in report.func_defs}
        allowed: set[str] | None = None
        if entry_fn is not None and entry_fn in by_name:
            allowed = set(by_name[entry_fn].calls)
        candidates = []
        for fd in report.func_defs:
            if fd.name in lib_names or fd.name == entry_fn:
                continue
            if allowed is not None and fd.name not in allowed:
                continue
            aug_source = fd.source
            for callee in dict.fromkeys(fd.calls):
                sub = by_name.get(callee)
                if sub is not None and sub.name != fd.name:
                    aug_source = aug_source + "\n\n" + sub.source
            candidates.append(
                ast_analysis.FuncDef(
                    name=fd.name,
                    lineno=fd.lineno,
                    source=aug_source,
                    kind=fd.kind,
                    calls=fd.calls,
                )
            )
        hits = similarity.find_similar(
            candidates,
            self.db.entries_with_reference(),
            threshold=self.similarity_threshold,
        )
        for hit in hits:
            if hit.db_name not in found:
                found[hit.db_name] = Discovery(
                    kind="similar",
                    source_name=hit.local_name,
                    entry=self.db.get(hit.db_name),
                    score=hit.score,
                )
        return list(found.values())

    # -- C-1 / C-2 -------------------------------------------------------------
    def build_replacement(
        self,
        discovery: Discovery,
        module_ns: Mapping[str, Any],
        recorded: tuple[tuple[Any, ...], tuple[Any, ...]] | None,
    ) -> Callable[..., Any] | None:
        """Resolve, interface-match and wrap the accelerated implementation.

        Returns None when adaptation needs a confirmation the policy denies
        (the discovery is then reported in ``skipped``).
        """
        impl = _device_wrap(discovery.entry.resolve(), self.device)
        dst_spec = discovery.entry.interface
        if recorded is None or dst_spec is None:
            # No observed source interface or no declared replacement
            # interface: C-1 with no adaptation (trust the recipe).
            return _host_wrap(impl)
        args, rets = recorded
        src_spec = spec_from_arrays(args, rets)
        try:
            adaptation = match_interfaces(src_spec, dst_spec, self.policy)
        except InterfaceMismatch as e:
            discovery.needs_confirmation = True
            discovery.confirm_messages = (str(e),)
            return None
        return _host_wrap(adaptation.wrap(impl))

    # -- Steps 1-2, packaged for the session ------------------------------------
    def prepare(
        self,
        app_fn: Callable[..., Any],
        example_args: Sequence[Any],
        report: ast_analysis.SourceReport | None = None,
    ) -> PreparedApp:
        """Analyze + discover + reconcile interfaces, and wrap the result as
        a ``planner.SubsetSpace`` whose candidates are source-substituted
        variants of the application.  ``report`` short-cuts Step 1 when the
        caller (the session's ``analyze`` stage) already parsed the module."""
        module = inspect.getmodule(app_fn)
        if module is None:  # pragma: no cover
            raise ValueError("cannot locate the application's module source")
        module_src = inspect.getsource(module)
        module_ns = vars(module)

        if report is None:
            report = ast_analysis.analyze_source(
                module_src, self.db.known_library_names
            )
        discoveries = self.discover(report, entry_fn=app_fn.__name__)

        # Record each discovered block's observed interface by instrumenting
        # one baseline run (the paper's Step-1 "grasp the program structure").
        recordings: dict[str, tuple[tuple[Any, ...], tuple[Any, ...]]] = {}
        recorders: dict[str, Callable[..., Any]] = {}
        for d in discoveries:
            orig = _resolve_dotted(module_ns, d.source_name)
            if orig is None:
                continue

            def make_rec(name: str, fn: Callable[..., Any]):
                def rec(*args: Any):
                    out = fn(*args)
                    outs = out if isinstance(out, tuple) else (out,)
                    recordings[name] = (args, outs)
                    return out

                return rec

            recorders[d.source_name] = make_rec(d.source_name, orig)
        if recorders:
            ns = substitute.rewrite_calls(module_src, recorders)
            ns[app_fn.__name__](*example_args)

        # Build adapted replacements (C-1/C-2).
        replacements: dict[str, Callable[..., Any]] = {}
        active: list[Discovery] = []
        skipped: list[Discovery] = []
        for d in discoveries:
            adapted = self.build_replacement(
                d, module_ns, recordings.get(d.source_name)
            )
            if adapted is None:
                skipped.append(d)
            else:
                replacements[d.source_name] = adapted
                active.append(d)

        by_entry = {d.entry.name: d for d in active}

        def build_variant(subset: frozenset[str]) -> Callable[..., Any]:
            mapping = {
                by_entry[name].source_name: replacements[by_entry[name].source_name]
                for name in subset
            }
            if not mapping:
                return app_fn
            ns = substitute.rewrite_calls(module_src, mapping)
            return substitute.extract_function(ns, app_fn.__name__)

        space = planner.SubsetSpace(
            build_variant,
            [d.entry.name for d in active],
            tag=f"{app_fn.__module__}.{app_fn.__qualname__}",
        )
        return PreparedApp(
            space=space,
            discoveries=active,
            skipped=skipped,
            source_report=report,
        )

    # -- Step 3 -----------------------------------------------------------------
    def adapt(
        self,
        app_fn: Callable[..., Any],
        example_args: Sequence[Any],
        repeats: int = 3,
        verify_rtol: float = 1e-3,
        strategy: "planner.SearchStrategy | None" = None,
        cache: "planner.MeasurementCache | None" = None,
    ) -> AdaptedApp:
        """Deprecated shim: the full lifecycle in one call, now delegated to
        ``repro_torch.offload.OffloadSession``.  New code should drive the
        session directly (it adds objectives, plan persistence and staged
        control)."""
        from repro_torch.offload import OffloadSession

        session = OffloadSession(
            app_fn,
            args=example_args,
            engine=self,
            strategy=strategy,
            cache=cache,
            repeats=repeats,
            rtol=verify_rtol,
        )
        result = session.run()
        return AdaptedApp(
            fn=result.fn,
            discoveries=result.discoveries,
            skipped=result.skipped,
            verification=result.verification,
            numerics_ok=bool(result.numerics_ok),
            offload_pattern=result.pattern,
        )

    # -- framework-native path: block bindings for the model zoo ---------------
    def select_block_pattern(
        self, environment: str, blocks: Sequence[str] | None = None
    ) -> dict[str, str]:
        """Declared-environment binding selection (the dry-run case) — thin
        wrapper over ``planner.declared_pattern``."""
        return planner.declared_pattern(
            environment, blocks=blocks, registry=block_registry
        )

    def measure_block_pattern(
        self,
        step_builder: Callable[[], Callable[..., Any]],
        patterns: Sequence[Mapping[str, str]],
        args: Sequence[Any],
        repeats: int = 3,
        cache: "planner.MeasurementCache | None" = None,
        min_seconds: float = 0.0,
    ) -> tuple[dict[str, str], list[tuple[dict[str, str], float]]]:
        """Deprecated shim: measured binding selection over the listed
        patterns, delegated to ``repro_torch.offload.OffloadSession``
        (binding mode, exhaustive strategy, numerics stage skipped — the
        historical contract measured only)."""
        from repro_torch.offload import OffloadSession

        space = planner.BindingSpace.from_patterns(
            step_builder, patterns, registry=block_registry
        )
        # closures from one factory share a __qualname__ (the default tag):
        # disambiguate by object identity so two models measured through
        # the same factory never answer each other's cache lookups
        space.tag = (
            f"{getattr(step_builder, '__qualname__', 'step')}"
            f"@{id(step_builder):x}"
        )
        cands = [space.candidate_from_mapping(dict(p)) for p in patterns]
        session = OffloadSession(
            space,
            args=args,
            strategy=planner.ExhaustiveSearch(
                candidates=cands, include_baseline=False
            ),
            cache=cache,
            repeats=repeats,
            min_seconds=min_seconds,
        )
        result = session.run(verify=False, build=False)
        by_key = {t.candidate: t.seconds for t in result.report.trials}
        results = [
            (dict(pat), by_key[cand]) for pat, cand in zip(patterns, cands)
        ]
        best = min(results, key=lambda r: r[1])[0]
        return best, results
