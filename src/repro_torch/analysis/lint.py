"""Project-wide static-analysis sweep: ``python -m repro_torch.analysis.lint``
(the port of ``repro/analysis/lint.py``).

Runs every ``repro_torch.analysis`` pass over the two program populations the
repo actually ships:

* **configs-zoo cells** — each (arch, phase) step the offload planner
  searches gets the *legality* pass (every (block, target) binding of its
  :class:`~repro_torch.core.planner.space.BindingSpace` classified against
  the kernel shelf's metadata and probe-traced) plus the static hot-path
  lints (host reads, constant-capture bloat).  Zoo cells return full
  logits by design, so the loop-program host-sync contract is *not*
  applied to them — that contract belongs to the engine programs below.
* **serve engines** — a tiny :class:`~repro_torch.serve.ServeEngine` per
  representative arch (attention-family paged + SSM contiguous) serves a
  short mixed-length trace, then ``engine.lint()`` checks the hot-path
  contracts over the programs as actually called (decode host transfer is
  token ids only, recomposition never adds a signature) and the
  page-aliasing sanitizer over the final page table.

Cells and engines run on ``--device`` (the CUDA card by default; ``cpu``
runs the blocks' plain versions, and judges every ``cuda`` binding
illegal for the platform, an ``info`` verdict).

With ``--resources``, the memory-envelope pass also runs: every zoo
cell's candidate bindings are fitted against ``--envelope`` (default
``cpu-host-16g``, a *static* envelope so verdicts are host-independent)
and every serve engine gets a static capacity plan, whose cannot-fit
verdicts are ratcheted warnings.  The kernel-shelf coverage lint
(every implementation must declare ``BLOCK_LEGALITY`` *and*
``BLOCK_RESOURCES``) always runs.

Diagnostics diff against a checked-in baseline
(``analysis_baseline_torch.json``; the reference's ``analysis_baseline.json``
is its own)
so ``--fail-on-new`` fails CI only on *new* warning/error findings — the
ratchet discipline of a type-checker baseline.  ``info`` diagnostics
(host-platform-dependent legality verdicts, per-binding resource fits)
never enter the ratchet, and diagnostic fingerprints exclude the platform
they were found on.

  PYTHONPATH=src python -m repro_torch.analysis.lint --fail-on-new
  PYTHONPATH=src python -m repro_torch.analysis.lint --update-baseline --device cpu
  PYTHONPATH=src python -m repro_torch.analysis.lint --arch llama3.2-1b --json
  PYTHONPATH=src python -m repro_torch.analysis.lint --resources --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import warnings
from typing import Sequence

from repro_torch.analysis.diagnostics import AnalysisReport, Baseline, Diagnostic

DEFAULT_BASELINE = "analysis_baseline_torch.json"

#: Zoo phases linted by default — the serving phases whose plans the
#: engine binds.  ``train`` cells work too (``--kinds train,...``) but
#: triple the sweep for programs the serve path never runs.
DEFAULT_ZOO_KINDS = ("prefill", "decode")

#: One attention-family arch (paged KV) + one SSM arch (contiguous
#: state) cover both engine code paths.
DEFAULT_SERVE_ARCHS = ("llama3.2-1b", "mamba2-2.7b")


def lint_zoo_cell(
    arch: str,
    kind: str,
    *,
    reduced: bool = True,
    layers: int = 1,
    batch: int = 1,
    seq: int = 8,
    seed: int = 0,
    targets: Sequence[str] | None = None,
    probe_trace: bool = True,
    envelope: object = None,
    resources_out: dict | None = None,
    device: str = "cuda",
) -> list[Diagnostic]:
    """Legality + static hot-path lints for one configs-zoo cell.

    With ``envelope`` the memory-envelope pass runs too; its per-binding
    fit report lands in ``resources_out`` (keyed by program) when given.
    """
    from repro_torch.analysis.hotpath import lint_traced_program
    from repro_torch.analysis.legality import check_binding_space
    from repro_torch.core import blocks as blocks_mod
    from repro_torch.core.planner.space import BindingSpace
    from repro_torch.offload.zoo import _cell_blocks, _cell_target

    program = f"zoo:{arch}:{kind}"
    builder, args, cfg = _cell_target(
        arch, kind, reduced=reduced, layers=layers, batch=batch, seq=seq,
        seed=seed, device=device,
    )
    registry = blocks_mod.registry
    diags: list[Diagnostic] = []
    block_map = _cell_blocks(cfg, registry, targets, kind)
    if block_map:
        space = BindingSpace(
            builder, blocks=block_map, registry=registry, tag=program
        )
        rep = check_binding_space(
            space, args, probe_trace=probe_trace, program=program,
            envelope=envelope, device=device,
        )
        diags.extend(rep.diagnostics())
        if rep.resources is not None and resources_out is not None:
            resources_out[program] = rep.resources.to_dict()
    diags.extend(lint_traced_program(program, builder(), args))
    return diags


def lint_serve_engine(
    arch: str,
    *,
    page_size: int | None = None,
    n_slots: int = 2,
    max_len: int = 32,
    requests: int = 3,
    prompt_len: int = 6,
    gen: int = 4,
    max_steps: int = 256,
    seed: int = 0,
    envelope: object = None,
    resources_out: dict | None = None,
    device: str = "cuda",
) -> list[Diagnostic]:
    """Serve a short trace on a tiny reduced engine, then run its hot-path
    and page-table lints.  Program names are rewritten to
    ``serve:<arch>:<program>`` so fingerprints stay unique across archs.

    With ``envelope`` the engine's static capacity plan joins the
    diagnostics (``capacity-oom`` is a ratcheted warning) and its full
    figures land in ``resources_out`` when given.
    """
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch).reduced()
    engine = ServeEngine(
        cfg, n_slots=n_slots, max_len=max_len, page_size=page_size,
        seed=seed, device=device, quiet=True,
    )
    rng = np.random.default_rng(seed)
    for i in range(requests):
        prompt = rng.integers(0, cfg.vocab_size, prompt_len + i).tolist()
        engine.submit(Request(prompt, max_new_tokens=gen))
    engine.run_until_idle(max_steps=max_steps)

    raw = list(engine.lint())
    if envelope is not None:
        plan = engine.plan_capacity(envelope)
        raw.extend(plan.diagnostics(program=f"{cfg.name}:capacity"))
        if resources_out is not None:
            resources_out[f"serve:{arch}:capacity"] = plan.to_dict()

    diags = []
    for d in raw:
        prog = d.program
        if prog.startswith(cfg.name + ":"):
            prog = prog[len(cfg.name) + 1:]
        diags.append(dataclasses.replace(d, program=f"serve:{arch}:{prog}"))
    return diags


def run_lint(
    archs: Sequence[str] | None = None,
    kinds: Sequence[str] = DEFAULT_ZOO_KINDS,
    serve_archs: Sequence[str] | None = DEFAULT_SERVE_ARCHS,
    *,
    probe_trace: bool = True,
    seed: int = 0,
    verbose: bool = False,
    envelope: object = None,
    resources_out: dict | None = None,
    device: str = "cuda",
) -> AnalysisReport:
    """The full sweep the CLI and the fast-tier test share.

    Cells that cannot be built on this host are skipped with a
    ``UserWarning`` (matching ``plan_zoo``'s sweep discipline) rather than
    aborting the whole lint.  ``envelope`` turns the memory-envelope pass
    on for zoo cells and serve engines; the shelf-coverage lint always
    runs (missing metadata must ratchet regardless of envelope choice).
    """
    from repro_torch.analysis.resources import lint_shelf_coverage
    from repro_torch.configs import ARCH_NAMES

    report = AnalysisReport()
    try:
        report.extend(lint_shelf_coverage())
    except Exception as e:  # noqa: BLE001 — keep sweeping
        warnings.warn(
            f"lint: shelf coverage failed: {type(e).__name__}: {e}",
            stacklevel=2,
        )
    for arch in archs if archs is not None else ARCH_NAMES:
        for kind in kinds:
            try:
                diags = lint_zoo_cell(
                    arch, kind, seed=seed, probe_trace=probe_trace,
                    envelope=envelope, resources_out=resources_out,
                    device=device,
                )
            except Exception as e:  # noqa: BLE001 — keep sweeping
                warnings.warn(
                    f"lint: zoo cell {arch}:{kind} failed: "
                    f"{type(e).__name__}: {e}",
                    stacklevel=2,
                )
                continue
            if verbose:
                print(f"zoo:{arch}:{kind}: {len(diags)} diagnostics")
            report.extend(diags)
    for arch in serve_archs or ():
        try:
            # paged KV only exists for attention-family caches; SSM archs
            # exercise the contiguous path
            paged = "m" not in _pattern_of(arch)
            diags = lint_serve_engine(
                arch, page_size=8 if paged else None, seed=seed,
                envelope=envelope, resources_out=resources_out,
                device=device,
            )
        except Exception as e:  # noqa: BLE001 — keep sweeping
            warnings.warn(
                f"lint: serve engine {arch} failed: {type(e).__name__}: {e}",
                stacklevel=2,
            )
            continue
        if verbose:
            print(f"serve:{arch}: {len(diags)} diagnostics")
        report.extend(diags)
    return report


def _pattern_of(arch: str) -> str:
    from repro_torch.configs import get_config

    return get_config(arch).pattern()


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description=__doc__.split("\n")[0],
    )
    ap.add_argument("--arch", default="all",
                    help="comma-separated zoo archs to lint (default: all)")
    ap.add_argument("--kinds", default=",".join(DEFAULT_ZOO_KINDS),
                    help="comma-separated zoo phases (prefill,decode[,train])")
    ap.add_argument("--serve-arch", default=",".join(DEFAULT_SERVE_ARCHS),
                    help="comma-separated archs to serve-lint with a tiny "
                         "engine ('' disables the engine sweep)")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the per-binding probe trace (metadata-only "
                         "legality verdicts)")
    ap.add_argument("--resources", action="store_true",
                    help="run the memory-envelope pass: per-binding fit "
                         "verdicts for zoo cells and a static capacity "
                         "plan per serve engine")
    ap.add_argument("--envelope", default="cpu-host-16g",
                    help="device envelope --resources checks against: a "
                         "static name (default cpu-host-16g so verdicts "
                         "ratchet identically on every host) or 'host'")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="accepted-diagnostics file for the ratchet")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit 1 if any warning/error diagnostic is not in "
                         "the baseline (the CI mode)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's diagnostics")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where zoo cells and engines run (the card by default)")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_NAMES

    archs = list(ARCH_NAMES) if args.arch == "all" else args.arch.split(",")
    kinds = tuple(k for k in args.kinds.split(",") if k)
    serve_archs = tuple(a for a in args.serve_arch.split(",") if a)

    resources_out: dict | None = {} if args.resources else None
    report = run_lint(
        archs, kinds, serve_archs,
        probe_trace=not args.no_probe, seed=args.seed,
        verbose=not args.json,
        envelope=args.envelope if args.resources else None,
        resources_out=resources_out,
        device=args.device,
    )
    baseline = Baseline.load(args.baseline)
    new = report.new_versus(baseline)

    if args.update_baseline:
        baseline.save(args.baseline, report)

    if args.json:
        payload = report.to_dict()
        payload["new"] = [d.to_dict() for d in new]
        payload["baseline"] = args.baseline
        if resources_out is not None:
            payload["resources"] = {
                "envelope": args.envelope,
                "reports": resources_out,
            }
        print(json.dumps(payload, indent=2))
    else:
        counts = report.counts()
        print(
            f"repro_torch.analysis: {len(report.diagnostics)} diagnostics "
            f"({counts['error']} error, {counts['warning']} warning, "
            f"{counts['info']} info); {len(new)} new vs baseline "
            f"'{args.baseline}'"
        )
        if resources_out is not None:
            plans = [r for r in resources_out.values() if "fits" in r]
            fits = sum(1 for r in plans if r["fits"])
            print(
                f"resources: {len(resources_out)} envelope reports against "
                f"'{args.envelope}' ({fits}/{len(plans)} capacity plans fit)"
            )
        for d in sorted(report.diagnostics, key=lambda d: d.fingerprint):
            marker = " [NEW]" if d in new else ""
            print(f"  {d}{marker}")
        if args.update_baseline:
            print(f"baseline updated: {args.baseline}")

    if args.fail_on_new and new:
        if not args.json:
            print(
                f"FAIL: {len(new)} new diagnostic(s) above baseline — fix "
                "them or re-accept with --update-baseline", file=sys.stderr,
            )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
