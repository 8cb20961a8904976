"""Static memory/resource-envelope verifier and capacity planner (the port
of ``repro/analysis/resources.py``).

The paper's FPGA flow rejects an offload pattern whose HLS resource
estimate exceeds the board *before* spending any measurement (Step 5).
This module is the GPU analogue over traced torch programs:

* :func:`estimate_memory` — peak-live-bytes of a program from its fake
  ``make_fx`` trace: operands + captured constants + the peak of the
  intermediate live set (:func:`graph_peak_bytes`).  Nothing runs.
* :func:`check_binding_space_resources` — per-``BindingSpace``-candidate
  verdicts against a :class:`~repro_torch.analysis.devices.DeviceEnvelope`;
  the OOM subset feeds ``BindingSpace.mark_illegal`` so all search
  strategies prune statically-OOM candidates exactly like legality
  prunes illegal ones.
* :func:`plan_serve_capacity` — static serve-engine sizing from
  ``ParamMeta`` trees (nothing materialised, so full-size configs plan in
  milliseconds): params + KV bytes, max slots / pages that fit, a
  prefill-chunk width bound, cross-checked against ``PagePool`` math.
* :func:`lint_shelf_coverage` — every shelf implementation must declare
  both a ``BLOCK_LEGALITY`` envelope and a ``BLOCK_RESOURCES`` hint.

The estimates are meant as *upper* bounds: a program this pass admits may
use less memory at run time, but one it rejects cannot plausibly fit.
PyTorch runs the program eagerly, op by op, so there is no fusion to make
the run leaner than its graph: the live set of the walk is what the
caching allocator holds, each block rounded up to its 512-byte granule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.devices import DeviceEnvelope, GiB, KiB, MiB, resolve_envelope
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.features import (
    graph_constants,
    node_values,
    output_values,
    tensor_bytes,
)
from repro_torch.core import graph_analysis
from repro_torch.core.planner.space import DEFAULT_TARGET, BindingSpace

#: the CUDA caching allocator's block granule: an allocation takes a
#: multiple of 512 bytes
ALLOC_GRANULE = 512


def _allocated(nbytes: int) -> int:
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def _first_tensor_arg(node: Any) -> Any:
    for a in node.args:
        if isinstance(a, torch.fx.Node):
            return a
    return None


def graph_peak_bytes(gm: Any) -> int:
    """Peak bytes of *node-produced* values live at any program point.

    A liveness walk in program order: each node's outputs go live when
    produced (rounded up to the allocator's granule); a value dies after
    the last node that reads it or any view of it, and not before the
    Python frame that made it returns (``meta["frames"]``, noted by the
    trace: an eager run frees a tensor when its last reference goes, and a
    frame's locals hold theirs until it returns); the program's outputs
    stay live to the end.  A view or an in-place op (``view``, ``t``,
    ``expand``, ``slice``, ``copy_``, ``index_put_``) adds no bytes: it
    aliases its first argument's storage, whose life it extends.  A
    higher-order op's subgraphs add their own peak on top of the live set
    at their call site.  Placeholders and constants are *not* counted
    here; :func:`estimate_memory` adds them once for the whole program.
    """
    nodes = list(gm.graph.nodes)
    owner: dict[Any, Any] = {}
    size: dict[Any, int] = {}
    for node in nodes:
        if node.op != "call_function":
            owner[node] = node
            continue
        name = graph_analysis.op_name(node.target)
        base = _first_tensor_arg(node)
        if base is not None and (name in graph_analysis.VIEW_OPS or graph_analysis.is_inplace(name)):
            owner[node] = owner[base]
        else:
            owner[node] = node
            size[node] = sum(_allocated(tensor_bytes(v)) for v in node_values(node))

    last_use: dict[Any, int] = {}
    frame_end: dict[int, int] = {}  # frame -> the last node it was on the stack for
    for i, node in enumerate(nodes):
        end = len(nodes) if node.op == "output" else i
        for a in node.all_input_nodes:
            last_use[owner[a]] = max(last_use.get(owner[a], -1), end)
        for frame in node.meta.get("frames", ()):
            frame_end[frame] = i
    for node in size:
        frames = node.meta.get("frames")
        if frames:
            last_use[node] = max(last_use.get(node, -1), frame_end[frames[-1]])

    subs = {name: m for name, m in gm.named_children() if isinstance(m, torch.fx.GraphModule)}
    live: dict[Any, int] = {}
    live_bytes = peak = 0
    for i, node in enumerate(nodes):
        inner = max((graph_peak_bytes(subs[a.target]) for a in node.all_input_nodes
                     if a.op == "get_attr" and a.target in subs), default=0)
        if node in size:
            live[node] = size[node]
            live_bytes += size[node]
        peak = max(peak, live_bytes + inner)
        for v in [v for v in live if last_use.get(v, -1) <= i]:
            live_bytes -= live.pop(v)
    return peak


@dataclasses.dataclass(frozen=True)
class MemoryEstimate:
    """Static memory footprint of one traced program (upper bound)."""

    operand_bytes: int  # program inputs (params, batch, cache, ...)
    const_bytes: int  # captured constants (get_attr tensors)
    output_bytes: int  # program outputs
    peak_intermediate_bytes: int  # liveness-walk peak (includes outputs)
    donated_bytes: int = 0  # inputs whose buffers may be reused

    @property
    def peak_live_bytes(self) -> int:
        """Operands + consts + peak intermediates, minus donation credit
        (a donated input buffer can back an output of the same size)."""
        credit = min(self.donated_bytes, self.output_bytes)
        return max(
            0,
            self.operand_bytes + self.const_bytes + self.peak_intermediate_bytes - credit,
        )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["peak_live_bytes"] = self.peak_live_bytes
        return d

    def __str__(self) -> str:
        return (
            f"peak ~{self.peak_live_bytes / MiB:.1f} MiB "
            f"(operands {self.operand_bytes / MiB:.1f}, "
            f"consts {self.const_bytes / MiB:.1f}, "
            f"intermediates {self.peak_intermediate_bytes / MiB:.1f}, "
            f"donated {self.donated_bytes / MiB:.1f} MiB)"
        )


def _tree_bytes(tree: Any) -> int:
    return sum(tensor_bytes(leaf) for leaf in tree_leaves(tree))


def estimate_memory(
    fn: Callable[..., Any],
    *example_args: Any,
    donate_argnums: tuple[int, ...] = (),
) -> MemoryEstimate:
    """Trace ``fn`` under fake tensors and size its working set.

    ``example_args`` are the step's inputs *and* the state it reads
    (parameters, cache, static buffers), passed as arguments: a tensor
    the function closes over is a constant of the trace.  ``donate_argnums``
    mirrors ``jax.jit``'s: those arguments' buffers are credited against
    the peak up to ``output_bytes``.  (A cache written in place, as the
    port's engine writes it, needs no credit: in-place ops add no bytes.)
    """
    gm, _ = graph_analysis.trace(fn, *example_args)
    return graph_memory(gm, example_args, donate_argnums)


def graph_memory(gm: Any, example_args: tuple = (),
                 donate_argnums: tuple[int, ...] = ()) -> MemoryEstimate:
    """:func:`estimate_memory` of a program already traced into ``gm`` (from
    ``example_args``).  A constant counts the elements its strides reach:
    an expanded view (a mesh trace's weight broadcast over the batch) holds
    its base's storage, not its shape's."""
    from repro_torch.launch.graph_cost import reached_bytes

    operand_bytes = sum(tensor_bytes(n.meta.get("val")) for n in gm.graph.nodes
                        if n.op == "placeholder")
    output_bytes = sum(tensor_bytes(v) for v in output_values(gm))
    donated = sum(_tree_bytes(example_args[i]) for i in donate_argnums
                  if 0 <= i < len(example_args))
    return MemoryEstimate(
        operand_bytes=operand_bytes,
        const_bytes=sum(reached_bytes(c) for c in graph_constants(gm)),
        output_bytes=output_bytes,
        peak_intermediate_bytes=graph_peak_bytes(gm),
        donated_bytes=donated,
    )


@dataclasses.dataclass(frozen=True)
class ResourceHint:
    """Per-(block, target) adjustment over the baseline program estimate.

    Candidate bindings share the baseline's shapes, so their working sets
    differ only by implementation overheads: an explicit scratch
    workspace, a multiplicative factor (a formulation that keeps an extra
    copy of its operands), and the shared memory a CTA of the target's
    kernels takes at most (checked against the envelope's ``smem_bytes``;
    the counterpart of the reference's ``vmem_tile_bytes``).
    """

    workspace_bytes: int = 0
    memory_multiplier: float = 1.0
    smem_tile_bytes: int | None = None
    notes: str = ""

    def need_bytes(self, base_peak: int) -> int:
        return int(base_peak * self.memory_multiplier) + self.workspace_bytes


@dataclasses.dataclass(frozen=True)
class ResourceVerdict:
    """Fit verdict for one (block, target) binding against one envelope."""

    block: str
    target: str
    status: str  # "fits" | "oom" | "smem-oom" (the reference's "vmem-oom")
    need_bytes: int
    headroom_bytes: int
    reason: str = ""

    @property
    def fits(self) -> bool:
        return self.status == "fits"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ResourceReport:
    """Resource verdicts for every candidate binding of one program."""

    program: str
    envelope: DeviceEnvelope
    base: MemoryEstimate
    verdicts: dict[tuple[str, str], ResourceVerdict] = dataclasses.field(default_factory=dict)

    @property
    def oom(self) -> dict[tuple[str, str], str]:
        """(block, target) -> reason, for bindings that do not fit.
        Reasons carry the ``memory:`` tag so a prune surfaced through
        ``PlanReport.pruned_reasons`` is attributable to this pass."""
        return {
            pair: f"memory: {v.reason}"
            for pair, v in self.verdicts.items()
            if not v.fits
        }

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for v in self.verdicts.values():
            out[v.status] = out.get(v.status, 0) + 1
        return out

    def min_headroom_bytes(self) -> int:
        fitting = [v.headroom_bytes for v in self.verdicts.values() if v.fits]
        if fitting:
            return min(fitting)
        return self.envelope.headroom_bytes(self.base.peak_live_bytes)

    def diagnostics(self) -> list[Diagnostic]:
        """Info-severity diagnostics (fit depends on the chosen envelope,
        not on the code), stamped with the envelope name as platform."""
        out = []
        for (block, target), v in sorted(self.verdicts.items()):
            code = "resource-fit" if v.fits else f"resource-{v.status}"
            msg = v.reason or (
                f"needs ~{v.need_bytes / MiB:.1f} MiB, "
                f"headroom {v.headroom_bytes / MiB:.1f} MiB"
            )
            out.append(
                Diagnostic(
                    pass_name="resources",
                    code=code,
                    severity="info",
                    program=self.program,
                    subject=f"{block}->{target}",
                    message=msg,
                    platform=self.envelope.name,
                )
            )
        return out

    def to_dict(self) -> dict:
        return {
            "program": self.program,
            "envelope": self.envelope.to_dict(),
            "base": self.base.to_dict(),
            "verdicts": [v.to_dict() for _, v in sorted(self.verdicts.items())],
            "counts": self.counts(),
            "min_headroom_bytes": self.min_headroom_bytes(),
        }


def shelf_resources() -> dict[tuple[str, str], ResourceHint]:
    """The kernel shelf's declared hints (imported here: the kernels
    package imports this module for the :class:`ResourceHint` type)."""
    from repro_torch import kernels

    return dict(kernels.BLOCK_RESOURCES)


def check_binding_space_resources(
    space: BindingSpace,
    example_args: tuple,
    *,
    envelope: Any = None,
    hints: Mapping[tuple[str, str], ResourceHint] | None = None,
    program: str = "",
    safety: float = 1.0,
    device: "torch.device | str" = "cuda",
) -> ResourceReport:
    """Fit every candidate binding of ``space`` against an envelope
    (``"host"`` probes ``device``).

    Traces the *baseline* (all-default) binding once — candidate bindings
    share its shapes, so per-candidate needs are the baseline peak
    adjusted by each target's :class:`ResourceHint` (shelf defaults,
    overridable via ``hints``).  The baseline itself is never marked: the
    planner guarantees a measurable fallback, mirroring legality.
    """
    env = resolve_envelope(envelope, device)
    merged = shelf_resources()
    if hints:
        merged.update(hints)
    base = estimate_memory(space.build(space.baseline()), *example_args)
    report = ResourceReport(program=program or space.tag, envelope=env, base=base)
    budget = int(env.memory_bytes * safety)
    for axis in space.axes:
        for target in axis.choices:
            if target == DEFAULT_TARGET:
                continue
            hint = merged.get((axis.name, target), ResourceHint())
            need = hint.need_bytes(base.peak_live_bytes)
            headroom = env.memory_bytes - need
            if need > budget:
                status = "oom"
                reason = (
                    f"needs ~{need / MiB:.1f} MiB "
                    f"(base {base.peak_live_bytes / MiB:.1f} MiB, "
                    f"x{hint.memory_multiplier:g} "
                    f"+ {hint.workspace_bytes / MiB:.1f} MiB workspace) "
                    f"> {env.name} budget {budget / MiB:.1f} MiB"
                )
            elif env.smem_bytes and hint.smem_tile_bytes and hint.smem_tile_bytes > env.smem_bytes:
                status = "smem-oom"
                reason = (
                    f"a CTA's tiles take ~{hint.smem_tile_bytes / KiB:.1f} KiB "
                    f"> {env.name} shared memory {env.smem_bytes / KiB:.1f} KiB a block"
                )
            else:
                status = "fits"
                reason = ""
            report.verdicts[(axis.name, target)] = ResourceVerdict(
                block=axis.name, target=target, status=status, need_bytes=need,
                headroom_bytes=headroom, reason=reason,
            )
    return report


# ---------------------------------------------------------------------------
# Serve-engine capacity planning


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Static sizing of one serve configuration against one envelope.

    All byte counts come from ``ParamMeta`` trees — nothing is
    materialised, so planning a 480B config takes the same milliseconds
    as a reduced one.  ``params_bytes`` counts the parameters as the
    port's engine holds them (matrices in the compute dtype,
    ``lm.compute_metas``).  ``max_slots``/``max_pages`` answer "how far
    could this config scale on this device"; ``max_prefill_tokens`` bounds
    the ``--prefill-chunk`` width by per-token activation cost.
    """

    arch: str
    envelope: DeviceEnvelope
    n_slots: int
    max_len: int
    page_size: int | None
    n_pages: int | None
    params_bytes: int
    cache_bytes: int
    per_slot_bytes: int
    per_page_bytes: int
    total_bytes: int
    budget_bytes: int
    headroom_bytes: int
    fits: bool
    max_slots: int
    max_pages: int | None
    pool_tokens: int
    max_prefill_tokens: int | None = None
    safety: float = 1.0

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["envelope"] = self.envelope.to_dict()
        return d

    def summary(self) -> str:
        lines = [
            f"capacity plan: {self.arch} on {self.envelope}",
            f"  params     {self.params_bytes / GiB:9.3f} GiB",
            f"  kv cache   {self.cache_bytes / GiB:9.3f} GiB "
            f"({self.n_slots} slots x {self.max_len} tokens"
            + (f", {self.n_pages} pages x {self.page_size})" if self.paged else ")"),
            f"  total      {self.total_bytes / GiB:9.3f} GiB "
            f"vs budget {self.budget_bytes / GiB:.3f} GiB "
            f"(safety x{self.safety:g})",
            f"  headroom   {self.headroom_bytes / GiB:9.3f} GiB "
            f"-> {'FITS' if self.fits else 'DOES NOT FIT'}",
            f"  max slots  {self.max_slots} (at {self.max_len} tokens each)",
        ]
        if self.paged:
            lines.append(f"  max pages  {self.max_pages}")
        lines.append(f"  pool       {self.pool_tokens} tokens")
        if self.max_prefill_tokens is not None:
            lines.append(
                f"  prefill    <= {self.max_prefill_tokens} tokens/chunk "
                f"by activation headroom"
            )
        return "\n".join(lines)

    def diagnostics(self, program: str = "") -> list[Diagnostic]:
        """A single ratchetable diagnostic: warning when the configured
        deployment cannot fit, info otherwise."""
        if self.fits:
            sev, code = "info", "capacity-fit"
            msg = (
                f"fits {self.envelope.name} with "
                f"{self.headroom_bytes / MiB:.0f} MiB headroom "
                f"(max {self.max_slots} slots)"
            )
        else:
            sev, code = "warning", "capacity-oom"
            msg = (
                f"params+cache ~{self.total_bytes / MiB:.0f} MiB exceed "
                f"{self.envelope.name} budget {self.budget_bytes / MiB:.0f} "
                f"MiB by {-self.headroom_bytes / MiB:.0f} MiB"
            )
        return [
            Diagnostic(
                pass_name="resources",
                code=code,
                severity=sev,
                program=program or f"{self.arch}:capacity",
                subject=f"slots={self.n_slots},max_len={self.max_len}"
                + (f",page_size={self.page_size}" if self.paged else ""),
                message=msg,
                platform=self.envelope.name,
            )
        ]


def _cache_bytes_fn(cfg, max_len: int, page_size, n_pages):
    from repro_torch.models import lm
    from repro_torch.models import params as pm

    def f(batch: int, pages: int | None) -> int:
        kw = {}
        if page_size is not None:
            kw = {"page_size": page_size, "n_pages": pages}
        return pm.param_bytes(lm.cache_metas_tree(cfg, batch, max_len, **kw))

    return f


def _fake_tree(metas: Any, mode: Any) -> Any:
    """Fake CPU tensors of a meta tree (shapes and dtypes; no memory)."""
    from repro_torch.models import params as pm

    with mode:
        return pm.tree_map_metas(
            lambda m: torch.empty(m.shape, dtype=pm.torch_dtype(m.dtype)), metas)


def _prefill_token_bytes(cfg) -> int | None:
    """Peak intermediate bytes per prefill token (batch=1), from the fake
    trace of ``lm.prefill`` over fake parameters — best effort, None when
    the trace fails.  The trace is of the CPU program (the blocks' plain
    versions): the planner needs no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import lm

    seq = 8
    try:
        mode = FakeTensorMode()
        params = _fake_tree(lm.compute_metas(cfg), mode)
        cache = _fake_tree(lm.cache_metas_tree(cfg, 1, seq), mode)
        with mode:
            batch = {"tokens": torch.zeros((1, seq), dtype=torch.int32)}
        gm, _ = graph_analysis.trace(lambda p, b, c: lm.prefill(p, b, cfg, c), params, batch, cache)
        return max(1, graph_peak_bytes(gm) // seq)
    except Exception:  # noqa: BLE001 — sizing hint only, never fatal
        return None


def plan_serve_capacity(
    cfg: Any,
    *,
    n_slots: int,
    max_len: int,
    page_size: int | None = None,
    n_pages: int | None = None,
    envelope: Any = None,
    safety: float = 0.9,
    prefill_bound: bool = True,
    device: "torch.device | str" = "cuda",
) -> CapacityPlan:
    """Size a serve deployment statically against a device envelope
    (``"host"`` probes ``device``).

    Cache bytes are linear in slots and (when paged) pages; two-sample
    deltas over the meta tree recover the per-slot / per-page
    coefficients, from which the max slots / pages that fit the budget
    follow directly.  ``pool_tokens`` restates the configured pool in
    tokens so :meth:`ServeEngine.plan_capacity` can cross-check it
    against the live ``PagePool``.
    """
    from repro_torch.models import lm
    from repro_torch.models import params as pm
    from repro_torch.serve.kv.pool import pages_for

    env = resolve_envelope(envelope, device)
    budget = int(env.memory_bytes * safety)
    params_bytes = pm.param_bytes(lm.compute_metas(cfg))

    paged = page_size is not None
    pages_per_slot = pages_for(max_len, page_size) if paged else 0
    if paged and n_pages is None:
        n_pages = n_slots * pages_per_slot  # the engine's default pool

    f = _cache_bytes_fn(cfg, max_len, page_size, n_pages)
    if paged:
        cache_bytes = f(n_slots, n_pages)
        per_slot = f(2, n_pages) - f(1, n_pages)  # SSM state + index rows
        per_page = f(1, n_pages + 1) - f(1, n_pages)
        fixed = f(1, n_pages) - per_slot - n_pages * per_page
        slot_cost = per_slot + pages_per_slot * per_page
    else:
        cache_bytes = f(n_slots, None)
        per_slot = f(2, None) - f(1, None)
        per_page = 0
        fixed = f(1, None) - per_slot
        slot_cost = per_slot

    total = params_bytes + cache_bytes
    headroom = budget - total
    spare = budget - params_bytes - fixed
    max_slots = max(0, spare // slot_cost) if slot_cost > 0 else n_slots
    max_pages = None
    if paged:
        page_spare = spare - n_slots * per_slot
        max_pages = max(0, page_spare // per_page) if per_page > 0 else n_pages
    pool_tokens = n_pages * page_size if paged else n_slots * max_len

    max_prefill = None
    if prefill_bound and headroom > 0:
        per_tok = _prefill_token_bytes(cfg)
        if per_tok:
            max_prefill = max(1, headroom // per_tok)

    return CapacityPlan(
        arch=getattr(cfg, "name", str(cfg)),
        envelope=env,
        n_slots=n_slots,
        max_len=max_len,
        page_size=page_size,
        n_pages=n_pages if paged else None,
        params_bytes=params_bytes,
        cache_bytes=cache_bytes,
        per_slot_bytes=per_slot,
        per_page_bytes=per_page,
        total_bytes=total,
        budget_bytes=budget,
        headroom_bytes=headroom,
        fits=headroom >= 0,
        max_slots=int(max_slots),
        max_pages=int(max_pages) if max_pages is not None else None,
        pool_tokens=int(pool_tokens),
        max_prefill_tokens=max_prefill,
        safety=safety,
    )


# ---------------------------------------------------------------------------
# Shelf coverage


def lint_shelf_coverage(
    *,
    impls: tuple[tuple[str, str], ...] | None = None,
    legality: Mapping[tuple[str, str], Any] | None = None,
    hints: Mapping[tuple[str, str], ResourceHint] | None = None,
) -> list[Diagnostic]:
    """Every shelf implementation must declare a ``BLOCK_LEGALITY``
    envelope AND a ``BLOCK_RESOURCES`` hint — missing entries are
    ratcheted warnings, so a new kernel cannot land unchecked."""
    from repro_torch import kernels

    impls = impls if impls is not None else kernels.SHELF_IMPL_PAIRS
    legality = legality if legality is not None else kernels.BLOCK_LEGALITY
    hints = hints if hints is not None else kernels.BLOCK_RESOURCES
    out = []
    for block, target in impls:
        missing = []
        if (block, target) not in legality:
            missing.append("BLOCK_LEGALITY")
        if (block, target) not in hints:
            missing.append("BLOCK_RESOURCES")
        if missing:
            out.append(
                Diagnostic(
                    pass_name="resources",
                    code="shelf-coverage",
                    severity="warning",
                    program="kernels.shelf",
                    subject=f"{block}->{target}",
                    message=(
                        f"shelf implementation declares no "
                        f"{' or '.join(missing)} entry; every kernel must "
                        f"ship its static envelope"
                    ),
                )
            )
    return out
