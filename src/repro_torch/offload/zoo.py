"""Zoo-wide offload planning: one verified plan per (arch, shape) cell (the
port of ``repro/offload/zoo.py``).

The serve engine and CLI only *load* plans; this module is the
verification-environment side that produces them for the model zoo.  For
every requested (arch, kind) cell it builds the *real* step — prefill or
decode, the functions the engine's programs run, as a captured step
program (:class:`repro_torch.runtime.programs.Program`, the port's
counterpart of the reference's ``jax.jit``); or the trainer's
``make_train_step`` — wraps it in a ``BindingSpace`` over the function
blocks that step exercises, runs a full ``OffloadSession`` lifecycle, and
commits the winning plan to the store under ``zoo:<arch>:<kind>``.  A
prefill or decode trial therefore times replays of the captured step, as
the engine runs it: the first two calls of a candidate's program run
eagerly and capture (the measurement's warm-up), every timed call is a
replay.  A train step is not captured: its trials time eager steps after
one warm-up call, each on a copy of the cell's weights and moments (the
step updates in place; the reference's jitted step is pure).

  PYTHONPATH=src python -m repro_torch.offload.zoo --plan-dir results/plans \\
      --arch llama3.2-1b --kind decode --reduced --device cpu

On the card the CLI searches ``--targets torch,cuda`` by default; with
``--device cpu`` it searches ``ref,torch`` (a kernel wrapper given a CPU
tensor runs its plain version).
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings
from typing import Any, Mapping, Sequence

from repro_torch.core.planner import (
    BindingSpace,
    Objective,
    PlanStore,
    SearchStrategy,
)
from repro_torch.metering import EXECUTOR_NAMES, METER_NAMES
from repro_torch.offload.session import OffloadResult, OffloadSession

#: Shelf blocks each layer kind routes compute through (see repro_torch.models).
_BLOCKS_BY_LAYER_KIND = {
    "a": ("rmsnorm", "attention"),
    "d": ("rmsnorm", "attention"),
    "s": ("rmsnorm", "attention"),
    "m": ("rmsnorm", "ssd_scan"),
}

#: Extra blocks the *decode* cell exercises per layer kind: decode cells
#: run through the paged KV pool (the serving layout), so the hot-loop
#: attention read is the planner-searchable paged_attention block.
_DECODE_BLOCKS_BY_LAYER_KIND = {
    "a": ("paged_attention",),
    "d": ("paged_attention",),
    "s": ("paged_attention",),
}

ZOO_KINDS = ("train", "prefill", "decode")

#: the CLI's default targets per device
DEFAULT_TARGETS = {"cuda": ("torch", "cuda"), "cpu": ("ref", "torch")}


def canonical_arch(arch: str) -> str:
    """Registry spelling of an arch name (``llama3.2_1b`` ->
    ``llama3.2-1b``); unknown names pass through unchanged so non-zoo
    callers can use arbitrary labels."""
    try:
        from repro_torch.configs import get_config

        return get_config(arch).name
    except Exception:  # noqa: BLE001 — unknown arch: keep caller's label
        return arch


def zoo_key(arch: str, kind: str) -> str:
    # canonicalised so every spelling a driver accepts (get_config is
    # permissive) addresses the same stored plan
    return f"zoo:{canonical_arch(arch)}:{kind}"


def default_plan_key(
    plan_dir: str | None,
    arch: str,
    kind: str,
    match_fingerprint: bool = False,
) -> str | None:
    """``zoo:<arch>:<kind>`` when the store actually holds that plan, else
    None — lets launch drivers default ``--plan-key`` without "plan not
    found" noise on hosts that never ran the zoo sweep.

    By default presence only (fingerprint/registry compatibility is still
    enforced at bind time).  Pass ``match_fingerprint=True`` when deciding
    whether a *search* is needed: a plan verified under a different
    environment would be rejected at bind time, so for search purposes it
    counts as missing.
    """
    if not plan_dir:
        return None
    key = zoo_key(arch, kind)
    plan = PlanStore(plan_dir).load(key, match_fingerprint=match_fingerprint)
    return None if plan is None else key


def launch_plan_keys(
    plan_dir: str | None,
    arch: str,
    kinds: Sequence[str],
    *,
    search: bool = False,
    targets: Sequence[str] | None = None,
    executor: Any = None,
    meter: Any = None,
    device: Any = "cuda",
) -> dict[str, str | None]:
    """The launch drivers' zoo-default flow, in one place: optionally
    search+commit any cell whose stored plan is absent **or verified under
    a different environment**, then return each kind's bindable default
    key (presence-checked; binding still enforces compatibility)."""
    if not plan_dir:
        return {kind: None for kind in kinds}
    if search:
        missing = [
            kind
            for kind in kinds
            if default_plan_key(plan_dir, arch, kind, match_fingerprint=True)
            is None
        ]
        if missing:
            print(f"searching offload plans for {arch}: {missing}")
            plan_zoo(
                plan_dir,
                [(arch, kind) for kind in missing],
                targets=targets,
                executor=executor,
                meter=meter,
                device=device,
                quiet=False,
            )
    return {
        kind: default_plan_key(plan_dir, arch, kind) for kind in kinds
    }


def _cell_blocks(
    cfg: Any,
    registry: Any,
    targets: Sequence[str] | None,
    kind: str = "train",
) -> dict[str, list[str]]:
    """Axes for one cell: the blocks this arch's step actually exercises,
    restricted to the requested (and registered) targets."""
    wanted: list[str] = []
    per_kind = dict(_BLOCKS_BY_LAYER_KIND)
    if kind == "decode":
        per_kind = {
            k: v + _DECODE_BLOCKS_BY_LAYER_KIND.get(k, ())
            for k, v in per_kind.items()
        }
    for kind_char in dict.fromkeys(cfg.pattern()):
        for b in per_kind.get(kind_char, ()):
            if b not in wanted:
                wanted.append(b)
    out: dict[str, list[str]] = {}
    for b in wanted:
        avail = registry.targets(b)
        chosen = [t for t in (targets or avail) if t in avail]
        if len(chosen) > 1:
            out[b] = chosen
    return out


def _materialize(shapes: Mapping[str, tuple], cfg: Any, rng: Any, device: Any):
    """Token-id tensors of the given shapes, drawn from ``rng``."""
    import numpy as np
    import torch

    return {
        k: torch.from_numpy(rng.integers(0, cfg.vocab_size, s).astype(np.int32)).to(device)
        for k, s in shapes.items()
    }


def _captured(name: str, step: Any, device: Any):
    """``step`` as a captured program whose arguments are read in place
    (a cell's weights and cache keep their addresses): its first call
    eager, its second captured, every later call a replay of the step, as
    the engine runs it.  A trial's warm-up takes the first two
    (:func:`repro_torch.core.verify.measure`)."""
    from repro_torch.runtime.programs import Program

    return Program(name, step, device, static=False)


def _cell_target(
    arch: str,
    kind: str,
    *,
    reduced: bool,
    layers: int,
    batch: int,
    seq: int,
    seed: int,
    device: Any = "cuda",
):
    """(step_builder, args, cfg) for one zoo cell: the engine's own
    prefill / decode functions over seeded weights cast for compute, and
    a builder that returns them as a captured program; or the train step
    (``TrainHyper(warmup_steps=2, total_steps=16)``, as the reference's
    cell) over f32 master weights and fresh moments, eager."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import lm

    if kind not in ZOO_KINDS:
        raise ValueError(f"unknown cell kind '{kind}'; known: {ZOO_KINDS}")
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(
            cfg,
            n_layers=layers,
            block_pattern=None if cfg.block_pattern is None
            else cfg.pattern()[:layers],
        )
    rng = np.random.default_rng(seed)
    name = f"zoo:{cfg.name}:{kind}"
    if kind == "train":
        return _train_cell(cfg, rng, batch, seq, seed, device)
    params = lm.cast_for_compute(lm.init_params(cfg, seed=seed, device=device), cfg)

    if kind == "prefill":
        batch_tree = _materialize({"tokens": (batch, seq)}, cfg, rng, device)

        def builder():
            return _captured(name, lambda p, b, c: lm.prefill(p, b, cfg, c), device)

        args = (params, batch_tree, lm.init_cache(cfg, batch, seq, device=device))
    else:  # decode
        tokens = _materialize({"tokens": (batch, 1)}, cfg, rng, device)["tokens"]
        # attention-family decode runs through the block-paged KV pool (the
        # serving layout), so the cell's binding space includes the
        # paged_attention hot-loop block; pure-SSM archs have no sequence
        # axis to page and keep the contiguous state
        if any(ch in "ads" for ch in cfg.pattern()):
            page_size = max(1, min(8, seq))
            max_pages = -(-seq // page_size)
            cache = lm.init_cache(
                cfg, batch, seq, page_size=page_size, n_pages=batch * max_pages,
                device=device,
            )
            # identity table: slot b owns pages [b*mp, (b+1)*mp); ragged
            # per-slot positions so the cell measures the staggered
            # continuous-batching case, not the aligned one
            cache["pages"] = torch.arange(
                batch * max_pages, dtype=torch.int32, device=device
            ).reshape(batch, max_pages)
            cache["index"] = torch.arange(batch, dtype=torch.int32, device=device) % seq
        else:
            cache = lm.init_cache(cfg, batch, seq, device=device)
        # the step advances the index in place; every call starts from the
        # cell's positions, as every call of the reference's pure step does
        start = cache["index"].clone()

        def decode(p, t, c):
            c["index"].copy_(start)
            return lm.decode_step(p, t, cfg, c)

        def builder():
            return _captured(name, decode, device)

        args = (params, tokens, cache)
    return builder, args, cfg


def _train_cell(cfg: Any, rng: Any, batch: int, seq: int, seed: int, device: Any):
    """The train cell: ``make_train_step`` over the f32 master weights, its
    batch (``embeds`` for a patch-embed frontend, as the reference's
    ``input_specs``) and labels.  Each call steps a copy of the weights and
    moments, so every trial (and the numerics stage) starts from the cell's
    state, as the reference's pure step does."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW, OptState, tree_map

    params = lm.init_params(cfg, seed=seed, device=device)
    opt = AdamW(moment_dtype=cfg.opt_dtype)
    step = make_train_step(cfg, opt, TrainHyper(warmup_steps=2, total_steps=16))
    tree = _materialize({"labels": (batch, seq)}, cfg, rng, device)
    if cfg.frontend == "patch_embed":
        embeds = rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32)
        tree["embeds"] = torch.from_numpy(embeds).to(device)
    else:
        tree.update(_materialize({"tokens": (batch, seq)}, cfg, rng, device))

    def train(p, o, b):
        copy = lambda t: t.detach().clone()  # noqa: E731
        return step(tree_map(copy, p),
                    OptState(tree_map(copy, o.mu), tree_map(copy, o.nu), o.step.clone()), b)

    def builder():
        return train

    train.warmup_calls = 1  # eager: one warm-up call, no capture
    return builder, (params, opt.init(params), tree), cfg


def plan_zoo(
    store: PlanStore | str,
    cells: Sequence[tuple[str, str]] | None = None,
    *,
    reduced: bool = True,
    layers: int = 2,
    batch: int = 2,
    seq: int = 16,
    targets: Sequence[str] | None = None,
    objective: Objective | str | None = None,
    strategy: SearchStrategy | None = None,
    executor: Any = None,
    meter: Any = None,
    repeats: int = 1,
    min_seconds: float = 0.0,
    registry: Any = None,
    seed: int = 0,
    verify: bool = False,
    force_search: bool = False,
    legality: bool = False,
    resources: Any = False,
    device: Any = "cuda",
    quiet: bool = True,
) -> dict[tuple[str, str], OffloadResult]:
    """Search and persist an offload plan for every (arch, kind) cell.

    ``cells`` defaults to every registered architecture x every step kind
    (train, prefill, decode).  Already-stored compatible plans short-cut to
    zero measurements (pass ``force_search=True`` to re-measure).
    ``device`` is where the cells run (the CUDA card unless ``"cpu"``).
    ``executor`` / ``meter`` select the ``repro_torch.metering``
    measurement executor (e.g. ``batched`` for short trials) and power
    meter (``"auto"`` autodetects, ``"nvml"`` reads the card's board draw,
    with provenance recorded on every trial).  ``legality=True`` runs the
    ``repro_torch.analysis`` static legality pass per cell so strategies
    prune statically-illegal bindings instead of measuring them (a ``cuda``
    target on a CPU device, a wrapper's refusal in the probe trace);
    ``resources`` (True / "host" / an envelope name / a ``DeviceEnvelope``)
    also runs the memory-envelope pass, so statically-OOM bindings are
    pruned before measurement — the paper's FPGA resource-fit check.  Returns
    ``{(arch, kind): OffloadResult}``; cells whose step cannot be built or
    measured are skipped with a ``UserWarning`` (regardless of ``quiet``,
    which only silences progress lines) rather than aborting the sweep.
    """
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.core import blocks as blocks_mod
    from repro_torch.metering import resolve_executor, resolve_meter

    if cells is None:
        cells = [(a, k) for a in ARCH_NAMES for k in ZOO_KINDS]
    for _, kind in cells:
        if kind not in ZOO_KINDS:
            raise ValueError(f"unknown cell kind '{kind}'; known: {ZOO_KINDS}")
    executor = resolve_executor(executor)
    meter = resolve_meter(meter)
    registry = registry or blocks_mod.registry
    store = PlanStore(store) if isinstance(store, str) else store

    results: dict[tuple[str, str], OffloadResult] = {}
    for arch, kind in cells:
        try:
            builder, args, cfg = _cell_target(
                arch, kind, reduced=reduced, layers=layers, batch=batch,
                seq=seq, seed=seed, device=device,
            )
            block_map = _cell_blocks(cfg, registry, targets, kind)
            if not block_map:
                if not quiet:
                    print(f"zoo cell {arch}:{kind}: no searchable blocks "
                          f"for targets={targets}; skipped")
                continue
            space = BindingSpace(
                builder,
                blocks=block_map,
                registry=registry,
                tag=f"zoo:{arch}:{kind}:b{batch}xs{seq}",
            )
            session = OffloadSession(
                space,
                args=args,
                objective=objective,
                strategy=strategy,
                store=store,
                key=zoo_key(arch, kind),
                meter=meter,
                executor=executor,
                repeats=repeats,
                min_seconds=min_seconds,
                registry=registry,
                force_search=force_search,
                legality=legality,
                resources=resources,
                device=device,
            )
            result = session.run(verify=verify)
        except Exception as e:  # noqa: BLE001 — keep sweeping other cells
            warnings.warn(
                f"zoo cell {arch}:{kind} failed: {type(e).__name__}: {e}",
                stacklevel=2,
            )
            continue
        results[(arch, kind)] = result
        if not quiet:
            src = "store" if result.from_store else result.plan.strategy
            pruned = getattr(result.report, "pruned", 0) if result.report else 0
            pruned_note = f" pruned={pruned}" if pruned else ""
            print(
                f"zoo cell {arch}:{kind}: {result.mapping or '(baseline)'} "
                f"speedup={result.speedup:.2f}x via {src} "
                f"[{result.objective}]{pruned_note}"
            )
    return results


def main(argv: Sequence[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plan-dir", required=True,
                    help="PlanStore directory to commit plans into")
    ap.add_argument("--arch", default="all",
                    help="comma-separated arch names, or 'all'")
    ap.add_argument("--kind", default="all",
                    help="comma-separated step kinds (train,prefill,decode)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="search reduced configs (--no-reduced for the full "
                         "configs on the card)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--targets", default=None,
                    help="comma-separated targets to search over (default: "
                         "torch,cuda on the card, ref,torch with --device cpu)")
    ap.add_argument("--legality", action="store_true",
                    help="run the repro_torch.analysis static legality pass per "
                         "cell; statically-illegal bindings are pruned from the "
                         "search instead of measured")
    ap.add_argument("--resources", action="store_true",
                    help="run the repro_torch.analysis memory-envelope pass per "
                         "cell; statically-OOM bindings are pruned from the "
                         "search instead of measured")
    ap.add_argument("--envelope", default=None,
                    help="device envelope for --resources: a static name (e.g. "
                         "h100-80g, cpu-host-16g, tiny-32m) or 'host' to probe "
                         "the device (default)")
    ap.add_argument("--objective", default="latency",
                    help="latency | perf_per_watt")
    ap.add_argument("--executor", default="serial",
                    choices=EXECUTOR_NAMES,
                    help="measurement executor (repro_torch.metering)")
    ap.add_argument("--meter", default="none",
                    choices=METER_NAMES,
                    help="power meter (provenance recorded per trial)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--force", action="store_true",
                    help="re-search even when a stored plan exists")
    ap.add_argument("--verify", action="store_true",
                    help="run the numerics stage per cell")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_NAMES

    archs = ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    kinds = ZOO_KINDS if args.kind == "all" else tuple(args.kind.split(","))
    targets = (tuple(args.targets.split(",")) if args.targets
               else DEFAULT_TARGETS[args.device])
    cells = [(a, k) for a in archs for k in kinds]
    results = plan_zoo(
        args.plan_dir,
        cells,
        reduced=args.reduced,
        layers=args.layers,
        batch=args.batch,
        seq=args.seq,
        targets=targets,
        objective=args.objective,
        executor=args.executor,
        meter=args.meter,
        repeats=args.repeats,
        verify=args.verify,
        force_search=args.force,
        legality=args.legality,
        resources=(args.envelope or True) if args.resources else False,
        device=args.device,
        quiet=False,
    )
    print(f"planned {len(results)}/{len(cells)} cells -> {args.plan_dir}")


if __name__ == "__main__":
    main()
