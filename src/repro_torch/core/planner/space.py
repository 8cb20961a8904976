"""SearchSpace — what an offload-pattern search ranges over (the port of
``repro/core/planner/space.py``).

A *candidate* is a tuple of per-axis choice indices.  Index 0 is always the
axis's baseline (the un-offloaded / default formulation), so the all-zeros
candidate is the unmodified application.  Spaces know how to turn a
candidate into a runnable callable (``build``) and into human/store-facing
descriptions (``pattern`` / ``mapping_of``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Callable, Iterator, Mapping, Sequence

Candidate = tuple[int, ...]

#: Sentinel choice label meaning "leave this block on its default binding".
DEFAULT_TARGET = "default"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One independently searchable position: a block and its choices.

    ``choices[0]`` is the baseline choice for the axis.
    """

    name: str
    choices: tuple[str, ...]

    def __post_init__(self) -> None:
        if not self.choices:
            raise ValueError(f"axis '{self.name}' has no choices")


class SearchSpace:
    """Abstract base: a product of axes plus a candidate -> callable builder."""

    axes: tuple[Axis, ...] = ()
    #: Distinguishes spaces with identical axes but different workloads
    #: (different application/builder) in cache and store keys.
    tag: str = ""

    # -- structure -----------------------------------------------------------
    def baseline(self) -> Candidate:
        return (0,) * len(self.axes)

    def size(self) -> int:
        n = 1
        for a in self.axes:
            n *= len(a.choices)
        return n

    def enumerate(self) -> Iterator[Candidate]:
        for cand in itertools.product(*(range(len(a.choices)) for a in self.axes)):
            yield cand

    def validate(self, cand: Candidate) -> None:
        if len(cand) != len(self.axes):
            raise ValueError(
                f"candidate has {len(cand)} genes, space has {len(self.axes)} axes"
            )
        for axis, c in zip(self.axes, cand):
            if not 0 <= c < len(axis.choices):
                raise ValueError(
                    f"axis '{axis.name}' choice index {c} out of range"
                )

    # -- legality ------------------------------------------------------------
    def pruned(self, cand: Candidate) -> str | None:
        """Reason this candidate must not be measured, or None if legal.

        The static pre-filter hook (paper Step 1): strategies consult this
        before handing a candidate to the MeasurementCache, so statically
        illegal bindings are skipped instead of timed (or crashed on).
        The base space prunes nothing.
        """
        return None

    # -- descriptions --------------------------------------------------------
    def signature(self) -> str:
        """Stable identity of the space (cache/store key component)."""
        parts = [f"{a.name}:{'|'.join(a.choices)}" for a in self.axes]
        label = f"[{self.tag}]" if self.tag else ""
        return f"{type(self).__name__}{label}({','.join(parts)})"

    def canonical(self, cand: Candidate) -> tuple:
        """Order-independent hashable key for a candidate."""
        return tuple(
            sorted((a.name, a.choices[c]) for a, c in zip(self.axes, cand))
        )

    def mapping_of(self, cand: Candidate) -> dict[str, str]:
        """Non-baseline choices as an ``{axis_name: choice_label}`` mapping."""
        return {
            a.name: a.choices[c]
            for a, c in zip(self.axes, cand)
            if c != 0
        }

    def pattern(self, cand: Candidate) -> tuple[str, ...]:
        """Sorted names of the axes moved off their baseline choice."""
        return tuple(sorted(a.name for a, c in zip(self.axes, cand) if c != 0))

    def deploy_mapping(self, cand: Candidate) -> dict[str, str]:
        """The mapping a persisted Plan must carry so deployment reproduces
        exactly this candidate.  Defaults to the non-baseline choices;
        spaces whose baseline choice is itself an explicit binding override
        this to pin every axis."""
        return self.mapping_of(cand)

    def candidate_from_mapping(self, mapping: Mapping[str, str]) -> Candidate:
        by_name = {a.name: a for a in self.axes}
        unknown = set(mapping) - set(by_name)
        if unknown:
            raise KeyError(f"mapping names unknown axes: {sorted(unknown)}")
        genes = []
        for a in self.axes:
            label = mapping.get(a.name, a.choices[0])
            if label not in a.choices:
                raise KeyError(
                    f"axis '{a.name}' has no choice '{label}' "
                    f"(choices: {a.choices})"
                )
            genes.append(a.choices.index(label))
        return tuple(genes)

    # -- execution -----------------------------------------------------------
    def build(self, cand: Candidate) -> Callable[..., Any]:
        raise NotImplementedError


class SubsetSpace(SearchSpace):
    """Binary offload-or-not per discovered block (the paper's space).

    Wraps the historical ``build_variant(subset: frozenset[str])`` builder
    used by the engine's Step 3 and by the loop-GA baseline: gene 1 on axis
    *i* puts ``names[i]`` into the offloaded subset.
    """

    def __init__(
        self,
        build_variant: Callable[[frozenset[str]], Callable[..., Any]],
        names: Sequence[str],
        on_label: str = "offload",
        off_label: str = "cpu",
        tag: str = "",
    ) -> None:
        self._build_variant = build_variant
        self.names = tuple(names)
        self.axes = tuple(Axis(n, (off_label, on_label)) for n in self.names)
        self.tag = tag

    @classmethod
    def from_genome_builder(
        cls,
        build_variant: Callable[[tuple[int, ...]], Callable[..., Any]],
        n_genes: int,
        names: Sequence[str] | None = None,
        tag: str = "",
    ) -> "SubsetSpace":
        """Adapt a bit-genome builder (the historical loop-GA interface:
        ``build_variant((0, 1, ...))``) into a SubsetSpace."""
        gene_names = (
            list(names) if names is not None
            else [f"gene{i}" for i in range(n_genes)]
        )

        def build_subset(subset: frozenset[str]) -> Callable[..., Any]:
            return build_variant(tuple(int(n in subset) for n in gene_names))

        return cls(
            build_subset,
            gene_names,
            tag=tag or getattr(build_variant, "__qualname__", ""),
        )

    def subset_of(self, cand: Candidate) -> frozenset[str]:
        return frozenset(n for n, c in zip(self.names, cand) if c)

    def candidate_from_subset(self, subset: frozenset[str]) -> Candidate:
        return tuple(1 if n in subset else 0 for n in self.names)

    def build(self, cand: Candidate) -> Callable[..., Any]:
        self.validate(cand)
        return self._build_variant(self.subset_of(cand))


class BindingSpace(SearchSpace):
    """Per-block choice among registered execution targets.

    This generalises the paper's GPU-vs-FPGA *destination* choice: each
    function block independently picks one of its registered targets
    (``{ref, torch, cuda}``), so a GA genome over this space is n-ary
    rather than binary.  ``step_builder`` is re-invoked under the candidate
    binding and its calls run under the binding too, so a captured step
    program keys (and freezes) the candidate's targets.
    """

    def __init__(
        self,
        step_builder: Callable[[], Callable[..., Any]],
        blocks: Mapping[str, Sequence[str]] | None = None,
        registry: Any = None,
        baseline_target: str = "ref",
        tag: str = "",
    ) -> None:
        self.tag = tag or getattr(step_builder, "__qualname__", "")
        if registry is None:
            from repro_torch.core.blocks import registry as registry_mod

            registry = registry_mod
        self.registry = registry
        self.step_builder = step_builder
        if blocks is None:
            blocks = {b: registry.targets(b) for b in registry.blocks()}
        axes = []
        for name, targets in blocks.items():
            targets = list(dict.fromkeys(targets))
            # baseline first: the un-offloaded formulation when present
            if baseline_target in targets:
                targets.remove(baseline_target)
                targets.insert(0, baseline_target)
            axes.append(Axis(name, tuple(targets)))
        self.axes = tuple(axes)
        # (block, target) -> reason, filled by mark_illegal(); consulted by
        # pruned()
        self._illegal: dict[tuple[str, str], str] = {}

    @classmethod
    def from_patterns(
        cls,
        step_builder: Callable[[], Callable[..., Any]],
        patterns: Sequence[Mapping[str, str]],
        registry: Any = None,
    ) -> "BindingSpace":
        """Space covering an explicit list of binding patterns.

        Blocks absent from some pattern get the ``DEFAULT_TARGET`` sentinel
        choice (leave the registry's default binding in place).
        """
        blocks: dict[str, list[str]] = {}
        for pat in patterns:
            for name, target in pat.items():
                blocks.setdefault(name, [])
                if target not in blocks[name]:
                    blocks[name].append(target)
        for name in blocks:
            if any(name not in pat for pat in patterns):
                blocks[name].insert(0, DEFAULT_TARGET)
        return cls(
            step_builder,
            blocks,
            registry=registry,
            baseline_target=DEFAULT_TARGET,
        )

    def mark_illegal(
        self, verdicts: Mapping[tuple[str, str], str]
    ) -> None:
        """Record statically-illegal ``(block, target)`` bindings with their
        reasons.  Candidates selecting any of them are reported by
        ``pruned()`` and skipped by every search strategy.  The
        ``DEFAULT_TARGET`` sentinel is never illegal (it is whatever the
        registry would do anyway), and marking it is rejected."""
        for (block, target), reason in verdicts.items():
            if target == DEFAULT_TARGET:
                raise ValueError(
                    f"cannot mark default binding of '{block}' illegal"
                )
            self._illegal[(block, target)] = str(reason)

    def pruned(self, cand: Candidate) -> str | None:
        for a, c in zip(self.axes, cand):
            label = a.choices[c]
            if label == DEFAULT_TARGET:
                continue
            reason = self._illegal.get((a.name, label))
            if reason is not None:
                return f"{a.name}->{label}: {reason}"
        return None

    def binding_of(self, cand: Candidate) -> dict[str, str]:
        """The registry binding for a candidate (all axes, sans defaults)."""
        return {
            a.name: a.choices[c]
            for a, c in zip(self.axes, cand)
            if a.choices[c] != DEFAULT_TARGET
        }

    def deploy_mapping(self, cand: Candidate) -> dict[str, str]:
        """Persisted plans must pin *every* measured axis, baseline choices
        included: a plan that omitted a block left on ``ref`` would deploy
        under the registry's default (the device's target) — a binding
        that was never the measured winner."""
        return self.binding_of(cand)

    def build(self, cand: Candidate) -> Callable[..., Any]:
        self.validate(cand)
        binding = self.binding_of(cand)
        with self.registry.bind(binding):
            fn = self.step_builder()

        def run(*args: Any, **kwargs: Any) -> Any:
            with self.registry.bind(binding):
                return fn(*args, **kwargs)

        return run

    @contextlib.contextmanager
    def bind(self, cand: Candidate):
        with self.registry.bind(self.binding_of(cand)):
            yield
