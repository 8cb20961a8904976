"""Prior-work loop-offload GA (paper §3.2, refs [32][33]) — deprecated shim
(the port of ``repro/core/ga.py``).

The GA itself now lives in ``repro_torch.core.planner.GeneticSearch``, which runs
the same elitist generational algorithm (tournament selection, single-point
crossover, per-gene mutation) over *any* ``SearchSpace`` — binary genomes on
a ``SubsetSpace`` (this module's historical behaviour: one bit per
parallelisable loop, 1 = offload) and n-ary genomes on a binding space
(per-block choice among {ref, torch, cuda} targets, the paper's
GPU-vs-FPGA destination choice generalised).  Measurement memoisation moved
from the private fitness dict into the shared ``planner.MeasurementCache``,
so a GA and a single-then-combine search over the same space never
re-measure each other's visited patterns.

``run_ga`` is kept as a thin wrapper producing the historical ``GAReport``
(per-generation best speedup = the paper's Fig. 4 curve); new code should
drive the planner directly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

Genome = tuple[int, ...]


@dataclasses.dataclass
class GAReport:
    best_genome: Genome
    best_seconds: float
    baseline_seconds: float
    generations: list[float]  # best speedup per generation (paper Fig. 4)
    evaluations: int  # number of *measured* trials
    search_seconds: float

    @property
    def best_speedup(self) -> float:
        return self.baseline_seconds / self.best_seconds


def run_ga(
    build_variant: Callable[[Genome], Callable[..., Any]],
    n_genes: int,
    args: Sequence[Any],
    population: int = 8,
    generations: int = 8,
    mutation_rate: float = 0.1,
    elite: int = 2,
    tournament: int = 3,
    repeats: int = 2,
    seed: int = 0,
) -> GAReport:
    """Deprecated shim over ``planner.GeneticSearch`` on a binary space."""
    from repro_torch.core import planner

    space = planner.SubsetSpace.from_genome_builder(build_variant, n_genes)
    strategy = planner.GeneticSearch(
        population=population,
        generations=generations,
        mutation_rate=mutation_rate,
        elite=elite,
        tournament=tournament,
        seed=seed,
    )
    t0 = time.perf_counter()
    report = strategy.search(
        space, args, cache=planner.MeasurementCache(), repeats=repeats
    )
    return GAReport(
        best_genome=tuple(report.best.candidate),
        best_seconds=report.best.seconds,
        baseline_seconds=report.baseline_seconds,
        generations=list(report.generations or []),
        evaluations=report.evaluations,
        search_seconds=time.perf_counter() - t0,
    )
