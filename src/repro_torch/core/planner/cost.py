"""Roofline cost model as a search pre-filter (the port of
``repro/core/planner/cost.py``).

``launch/graph_cost.py`` derives FLOPs and HBM bytes from a fake
``make_fx`` trace (each hand-written kernel counted by the work its
wrapper declares); here those feed a roofline estimate, seconds bounded
below by compute and by memory traffic, that ``CostGuidedSearch`` and
``GeneticSearch(seed_from_cost=True)`` rank candidates by before any
measurement: the paper's FPGA narrowing step, where estimating is cheap
(one trace, nothing launched) and measuring is expensive.

The peaks are the H100's (``launch/mesh.HW``): the FLOPs of each compute
class (bf16, tf32 for the 3xTF32 kernels, f32) at that class's peak.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

from repro_torch.core.planner.space import Candidate, SearchSpace


def roofline_seconds(fn: Callable[..., Any], args: Sequence[Any], hw: Any = None) -> float:
    """Lower-bound runtime of ``fn(*args)`` from its fake trace on the
    device ``args`` live on: ``max(flops / peak, hbm_bytes / bw, 1e-12)``.
    Nothing is launched.  Raises whatever the trace raises;
    ``CostGuidedSearch`` treats that as an unrankable candidate."""
    from repro_torch.launch import graph_cost
    from repro_torch.launch.mesh import HW

    cost = graph_cost.analyze(graph_cost.trace_table(fn, *args))
    return graph_cost.roofline(cost, hw or HW)[0]


def make_roofline_cost_fn(
    hw: Any = None,
) -> Callable[[SearchSpace, Candidate, Sequence[Any]], float]:
    """Cost function for CostGuidedSearch: build the candidate variant and
    score it with the roofline model."""

    def cost_fn(space: SearchSpace, cand: Candidate, args: Sequence[Any]) -> float:
        return roofline_seconds(space.build(cand), args, hw=hw)

    return cost_fn
