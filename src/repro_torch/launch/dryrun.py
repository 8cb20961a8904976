"""One-card dry-run: trace every (arch x shape) cell for the H100 (the port
of ``repro/launch/dryrun.py``).

For each cell the production step function (train / prefill / decode) is
traced with fake inputs (``launch/steps.py``: every shape and dtype, no
memory taken, nothing launched; each hand-written kernel stands in with
the work its wrapper declares) and we record:

  * the memory estimate (``analysis/resources.py``): argument, temporary
    and output bytes and the peak, against the card's memory
    (``fits_device``, where the reference checks 16 GB of a TPU chip);
  * the cost model (``launch/graph_cost.py``): FLOPs, HBM bytes and
    collective bytes of the trace's node table, and the roofline time on
    the H100 (``roofline_s``, ``bound_by``);
  * the model FLOPs (6 N T to train, 2 N T to serve) and the trace's wall
    time (``trace_s``, where the reference has ``lower_s`` / ``compile_s``).

Records keep the reference's keys where they have a counterpart (``mesh``
is ``"1"``, ``chips`` 1); ``--save-hlo DIR`` saves each cell's node table
(gzip JSON, the counterpart of the reference's HLO text) and ``--reparse``
recomputes the cost fields from them.  The reference's multi-pod meshes
and its sharding overrides wait for the port's distribution (ROADMAP A6).

Usage (on the card):
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from collections import Counter
from typing import Any

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import graph_analysis
from repro_torch.launch import graph_cost, steps
from repro_torch.launch.mesh import HW

MESH = "1"
#: overrides with no meaning on one device
_DISTRIBUTED = ("ep_mode", "bf16_tp_reduce", "megatron_mlp")


def _shape(shape: "str | ShapeConfig") -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else get_shape(shape)


def build_cell(arch: str, shape: "str | ShapeConfig", overrides: dict | None = None,
               *, device: Any = "cuda", mode: Any = None):
    """``(cfg, shape, fn, args)`` for one cell: the step function and its
    fake arguments (in ``mode``, on ``device``).

    ``overrides`` (the reference's perf-iteration knobs):
      param_dtype / opt_dtype / compute_dtype: str
      n_heads: int; remat: "full" | "none"
      microbatch: int            grad-accumulation chunks (train; default 2)
      remat_policy: "none" | "save_moe"
    ``ep_mode``, ``bf16_tp_reduce`` and ``megatron_mlp`` shard across
    devices and raise here (ROADMAP A6).  The reference's ``scores_dtype``
    and ``norm_precision`` set the precision of XLA's plain attention and
    norm, which the card's kernels replace: they are not ported and raise
    as unknown overrides.  ``remat_policy`` is a module setting, set (to
    its default when not given) at every call, as the reference sets it.
    """
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    ov = dict(overrides or {})
    distributed = sorted(k for k in _DISTRIBUTED if k in ov)
    if distributed:
        raise ValueError(f"overrides {distributed} shard across devices: they wait for the "
                         "port's distribution (ROADMAP A6)")
    cfg = get_config(arch)
    cfg_fields = {k: ov.pop(k) for k in ("param_dtype", "opt_dtype", "compute_dtype", "remat",
                                         "n_heads") if k in ov}
    if cfg_fields:
        cfg = dataclasses.replace(cfg, **cfg_fields)
    lm.REMAT_POLICY = ov.pop("remat_policy", "none")
    microbatch = ov.pop("microbatch", 2)
    if ov:
        raise ValueError(f"unknown overrides: {sorted(ov)}")
    shape = _shape(shape)
    mode = mode or graph_analysis.fake_mode()
    kw = dict(mode=mode, device=device)

    batch = steps.input_specs(cfg, shape, **kw)
    if shape.kind == "train":
        opt = AdamW(moment_dtype=cfg.opt_dtype)
        params, opt_state = steps.abstract_state(cfg, opt, **kw)
        fn = steps.make_train_step(cfg, opt, steps.TrainHyper(microbatch=microbatch))
        args = (params, opt_state, batch)
    elif shape.kind == "prefill":
        params, _ = steps.abstract_state(cfg, **kw)
        fn = steps.make_prefill_step(cfg, shape)
        args = (params, batch)
    else:  # decode
        params, _ = steps.abstract_state(cfg, **kw)
        fn = steps.make_decode_step(cfg)
        args = (params, steps.abstract_cache(cfg, shape, **kw), batch)
    return cfg, shape, fn, args


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n_active * tokens)


def _table_path(arch: str, shape_name: str, mesh: str, table_dir: str) -> pathlib.Path:
    return pathlib.Path(table_dir) / f"{arch}_{shape_name}_{mesh}.nodes.json.gz"


def _cost_fields(rec: dict, table: list[dict]) -> None:
    cost = graph_cost.analyze(table)
    seconds, bound_by = graph_cost.roofline(cost, HW)
    rec["graph_flops_per_device"] = cost["flops"]
    rec["graph_bytes_per_device"] = cost["hbm_bytes"]
    rec["collectives_per_device"] = {k: float(v) for k, v in cost["collectives"].items()}
    rec["collective_bytes_per_device"] = cost["collective_bytes"]
    rec["flops_by_peak"] = cost["flops_by_peak"]
    rec["roofline_s"] = seconds
    rec["bound_by"] = bound_by


def reparse(out_path: str, table_dir: str = "results/graphs") -> None:
    """Recompute the cost-model fields of an existing results JSON from the
    saved node tables (no tracing)."""
    path = pathlib.Path(out_path)
    results = json.loads(path.read_text())
    for rec in results:
        if rec.get("status") != "ok":
            continue
        p = _table_path(rec["arch"], rec["shape"], rec["mesh"], table_dir)
        if not p.exists():
            continue
        _cost_fields(rec, graph_cost.load_table(p))
        print(f"reparsed {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
              f"flops/dev={rec['graph_flops_per_device']:.3g}", flush=True)
    path.write_text(json.dumps(results, indent=1))


def run_cell(arch: str, shape: "str | ShapeConfig", table_dir: str | None = None,
             overrides: dict | None = None, *, device: Any = "cuda") -> dict:
    """One cell's record (``status`` ``ok``, ``skipped`` or ``error``)."""
    from repro_torch.analysis.resources import graph_memory

    shape = _shape(shape)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": MESH, "status": "ok"}
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch at 500k context (the reference's skip rule)"
        return rec
    if overrides:
        rec["overrides"] = dict(overrides)
    try:
        cfg, shape, fn, args = build_cell(arch, shape, overrides, device=device)
        t0 = time.perf_counter()
        gm, kernels = graph_analysis.trace_with_work(fn, *args)
        rec["trace_s"] = round(time.perf_counter() - t0, 2)
        mem = graph_memory(gm, args)
        rec["argument_size_in_bytes"] = mem.operand_bytes + mem.const_bytes
        rec["temp_size_in_bytes"] = mem.peak_intermediate_bytes
        rec["output_size_in_bytes"] = mem.output_bytes
        table = graph_cost.node_table(gm, kernels)
        if table_dir:
            graph_cost.save_table(table, _table_path(arch, shape.name, MESH, table_dir))
        _cost_fields(rec, table)
        rec["kernels"] = dict(Counter(name for name, _ in kernels))
        rec["chips"] = 1
        rec["model_flops"] = model_flops(cfg, shape)
        rec["peak_bytes_per_device"] = mem.peak_live_bytes
        rec["device_memory_bytes"] = HW.memory_bytes()
        rec["fits_device"] = rec["peak_bytes_per_device"] < rec["device_memory_bytes"]
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv: list[str] | None = None, *, device: Any = "cuda") -> None:
    """The reference's CLI less ``--multi-pod``; ``--save-hlo`` saves node
    tables.  ``device`` is where the cells are traced for (the card; a
    caller may ask for ``"cpu"``, where the plain versions stand in for the
    kernels)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--save-hlo", default=None,
                    help="directory to save each cell's node table (gzip JSON)")
    ap.add_argument("--reparse", action="store_true",
                    help="recompute costs from saved node tables, no tracing")
    args = ap.parse_args(argv)

    if args.reparse:
        reparse(args.out, args.save_hlo or "results/graphs")
        return

    archs = ARCH_NAMES if (args.all or args.arch is None) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or args.shape is None) else (args.shape,)
    out_path = pathlib.Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results: list[dict] = []
    if args.append and out_path.exists():
        results = json.loads(out_path.read_text())
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    for a in archs:
        for s in shapes:
            if (a, s, MESH) in done:
                continue
            t0 = time.perf_counter()
            rec = run_cell(a, s, table_dir=args.save_hlo, device=device)
            dt = time.perf_counter() - t0
            status = rec["status"]
            extra = ""
            if status == "ok":
                extra = (
                    f" peak={rec['peak_bytes_per_device'] / 1e9:.2f}GB"
                    f" flops/dev={rec['graph_flops_per_device']:.3g}"
                    f" roofline={rec['roofline_s'] * 1e3:.3f}ms ({rec['bound_by']})"
                )
            elif status == "error":
                extra = " " + rec["error"][:120]
            print(f"[{dt:7.1f}s] {a} x {s} x {rec['mesh']}: {status}{extra}", flush=True)
            results.append(rec)
            out_path.write_text(json.dumps(results, indent=1))
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {out_path}")


if __name__ == "__main__":
    main()
