"""Deep structural features of a traced program (the port of
``repro/analysis/features.py``).

``repro_torch.core.graph_analysis`` stays the histogram/FLOPs walker; this
module layers the facts the analysis passes decide on, over the fake
``make_fx`` trace of a program: the full op set (aten names, plus the
hand-written kernels the trace stood in for, as ``kernel:<name>``), the
dtype universe, control-flow and host-read presence, captured constant
sizes and dynamic-shape detection.  Everything here is trace inspection —
nothing runs on the device.

Where the reference's programs use ``lax.scan`` over layers, the port's
layer loops are Python, unrolled by the trace: ``has_scan`` / ``has_while``
/ ``has_cond`` read torch's ``scan`` / ``while_loop`` / ``cond`` higher-order
ops, which the port's programs do not use, so they are false where the
reference's are true.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import graph_analysis

#: The counterpart of the reference's callback primitives: a host read
#: inside the program (``.item()``, ``.tolist()``, a branch on a value)
#: waits for the device on every call and cannot be captured in a CUDA
#: graph.
CALLBACK_OPS = frozenset({"aten._local_scalar_dense", "aten.item"})


@dataclasses.dataclass
class ProgramFeatures:
    """Facts about one traced program, for legality and hot-path passes."""

    primitives: frozenset[str]  # aten / higher-order names and kernel:<name>
    dtypes: frozenset[str]  # every value dtype seen ("float32", "bfloat16")
    n_eqns: int  # call_function nodes
    has_scan: bool
    has_while: bool
    has_cond: bool
    callbacks: tuple[str, ...]  # host reads present, sorted
    const_bytes: int  # total bytes of captured constants (get_attr)
    largest_const_bytes: int
    n_consts: int
    dynamic_shapes: bool  # any dimension a SymInt (a data-dependent shape)
    flops: float  # matmul + conv + fft estimate
    dot_flops: float
    out_avals: tuple[Any, ...]  # the outputs' fake values (host-sync sizing)
    report: graph_analysis.GraphReport  # the underlying histogram report


def dtype_name(dtype: torch.dtype) -> str:
    """``float32`` for ``torch.float32`` (the reference's spelling)."""
    return str(dtype).removeprefix("torch.")


def tensor_bytes(t: Any) -> int:
    """Bytes of a tensor (or fake value); 0 for non-tensors and symbolic
    shapes.  A ``DTensor`` counts this device's shard."""
    if not isinstance(t, torch.Tensor):
        return 0
    t = getattr(t, "_local_tensor", t)
    try:
        return int(t.numel()) * t.element_size()
    except (TypeError, RuntimeError):  # unbacked SymInt: not sizeable
        return 0


def node_values(node: Any) -> list[Any]:
    """The fake values a node produces (tuples and lists flattened)."""
    val = node.meta.get("val")
    vals = list(val) if isinstance(val, (tuple, list)) else [val]
    return [v for v in vals if v is not None]


def _is_dynamic(val: Any) -> bool:
    shape = getattr(val, "shape", None)
    return shape is not None and any(isinstance(d, torch.SymInt) for d in shape)


def graph_constants(gm: Any) -> list[torch.Tensor]:
    """The tensors the program captured as constants (its ``get_attr``
    nodes' tensors, subgraphs included)."""
    out = []

    def walk(module: Any) -> None:
        for node in module.graph.nodes:
            if node.op == "get_attr":
                value = getattr(module, node.target)
                if isinstance(value, torch.Tensor):
                    out.append(value)
        for sub in graph_analysis.subgraphs(module):
            walk(sub)

    walk(gm)
    return out


def output_values(gm: Any) -> tuple[Any, ...]:
    """The program's outputs as fake values, in order (None for an output
    that is no tensor)."""
    (node,) = [n for n in gm.graph.nodes if n.op == "output"]
    args = node.args[0]
    args = args if isinstance(args, (tuple, list)) else (args,)
    return tuple(a.meta.get("val") if isinstance(a, torch.fx.Node) else None for a in args)


def extract_features(gm: Any, kernels: tuple[str, ...] = ()) -> ProgramFeatures:
    """Features of a traced FX graph module; ``kernels`` are the
    hand-written kernels its trace stood in for."""
    report = graph_analysis.analyze_graph(gm, kernels)
    dtypes: set[str] = set()
    dynamic = False
    n_eqns = 0

    def walk(module: Any) -> None:
        nonlocal dynamic, n_eqns
        for node in module.graph.nodes:
            n_eqns += node.op == "call_function"
            for val in node_values(node):
                if isinstance(val, torch.Tensor):
                    dtypes.add(dtype_name(val.dtype))
                    dynamic = dynamic or _is_dynamic(val)
        for sub in graph_analysis.subgraphs(module):
            walk(sub)

    walk(gm)
    consts = graph_constants(gm)
    const_sizes = [tensor_bytes(c) for c in consts]
    ops = frozenset(report.histogram)
    return ProgramFeatures(
        primitives=ops | {f"kernel:{k}" for k in kernels},
        dtypes=frozenset(dtypes),
        n_eqns=n_eqns,
        has_scan=report.has_scan,
        has_while=report.has_while,
        has_cond="higher_order.cond" in ops,
        callbacks=tuple(sorted(ops & CALLBACK_OPS)),
        const_bytes=sum(const_sizes),
        largest_const_bytes=max(const_sizes, default=0),
        n_consts=len(consts),
        dynamic_shapes=dynamic,
        flops=report.flops,
        dot_flops=report.dot_flops,
        out_avals=output_values(gm),
        report=report,
    )


def trace_features(fn: Callable[..., Any], *example_args: Any) -> ProgramFeatures:
    """Trace ``fn`` under fake tensors (no execution) and extract its
    features.  ``example_args`` are tensors (real ones are read for their
    shapes and dtypes only), or pytrees of them."""
    return extract_features(*graph_analysis.trace(fn, *example_args))
