"""Dry-run: trace every (arch x shape x mesh) cell for the H100 (the port
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

Meshes: ``"1"`` (one card, the default) and the reference's ``"16x16"``
(``("data", "model")``, 256 GPUs) and ``"2x16x16"`` (``("pod", "data",
"model")``, 512 GPUs); tests use smaller ones (``"2x4"``).  A mesh cell
traces rank 0's program in one process on the ``fake`` process-group
backend: the parameters, optimizer state, batch and cache are placed as
``DTensor``s by the spec tree of ``rules_for`` (``shard_params``), the
step runs inside ``use_sharding``, and every count (FLOPs, bytes, memory,
collectives) is per device.

Records keep the reference's keys where they have a counterpart (``mesh``,
``chips``, ``*_per_device``); ``--save-hlo DIR`` saves each cell's node
table (gzip JSON, the counterpart of the reference's HLO text) and
``--reparse`` recomputes the cost fields from them.

Usage (on the card):
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.json
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --multi-pod both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import math
import time
import traceback
from collections import Counter
from typing import Any

import torch

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import graph_analysis
from repro_torch.launch import graph_cost, steps
from repro_torch.launch.mesh import HW, make_mesh, mesh_shape_dict

MESH = "1"
#: overrides that shard across devices: a mesh cell's only
_DISTRIBUTED = ("ep_mode", "bf16_tp_reduce", "megatron_mlp")
#: ``--multi-pod`` -> the meshes traced
POD_MESHES = {"single": ("16x16",), "multi": ("2x16x16",), "both": ("16x16", "2x16x16")}


def mesh_dims(mesh: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"16x16"`` -> ((16, 16), ("data", "model")); three dims lead with
    ``"pod"``."""
    shape = tuple(int(d) for d in mesh.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"mesh '{mesh}': give 2 or 3 dims (data x model, pod x data x model)")
    return shape, axes


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of ``size`` ranks on the ``fake`` backend
    (this process is rank 0; collectives move nothing), torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: a mesh cell traces on a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _shape(shape: "str | ShapeConfig") -> ShapeConfig:
    return shape if isinstance(shape, ShapeConfig) else get_shape(shape)


def build_cell(arch: str, shape: "str | ShapeConfig", overrides: dict | None = None,
               *, device: Any = "cuda", mode: Any = None, mesh: Any = None):
    """``(cfg, shape, fn, args)`` for one cell: the step function and its
    fake arguments (in ``mode``, on ``device``); with a ``DeviceMesh``,
    the arguments are ``DTensor``s placed by the cell's rules and ``fn``
    runs inside ``use_sharding``.

    ``overrides`` (the reference's perf-iteration knobs):
      param_dtype / opt_dtype / compute_dtype: str
      n_heads: int; remat: "full" | "none"
      microbatch: int            grad-accumulation chunks (train; default 2)
      remat_policy: "none" | "save_moe"
      ep_mode: "gather" | "psum" MoE expert-weight strategy (mesh cells)
      bf16_tp_reduce / megatron_mlp: bool  manual TP paths (mesh cells)
    The three sharding overrides raise on one card.  The reference's
    ``scores_dtype`` and ``norm_precision`` set the precision of XLA's
    plain attention and norm, which the card's kernels replace: they are
    not ported and raise as unknown overrides.  ``remat_policy``,
    ``bf16_tp_reduce`` and ``megatron_mlp`` are module settings, set (to
    their defaults when not given) at every call, as the reference sets
    them.
    """
    from repro_torch.models import layers, lm
    from repro_torch.models import params as pm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import rules_for, use_sharding

    ov = dict(overrides or {})
    distributed = sorted(k for k in _DISTRIBUTED if k in ov)
    if distributed and mesh is None:
        raise ValueError(f"overrides {distributed} shard across devices: give a mesh cell")
    cfg = get_config(arch)
    cfg_fields = {k: ov.pop(k) for k in ("param_dtype", "opt_dtype", "compute_dtype", "remat",
                                         "n_heads") if k in ov}
    if cfg_fields:
        cfg = dataclasses.replace(cfg, **cfg_fields)
    lm.REMAT_POLICY = ov.pop("remat_policy", "none")
    layers.BF16_TP_REDUCE = ov.pop("bf16_tp_reduce", False)
    layers.MEGATRON_MLP = ov.pop("megatron_mlp", False)
    microbatch = ov.pop("microbatch", 2)
    ep_mode = ov.pop("ep_mode", "gather")
    if ov:
        raise ValueError(f"unknown overrides: {sorted(ov)}")
    shape = _shape(shape)
    mode = mode or graph_analysis.fake_mode()
    kw = dict(mode=mode, device=device)
    metas = lm.build_metas(cfg)
    rules = None
    if mesh is not None:
        rules = rules_for(cfg, shape, mesh_shape_dict(mesh), ep_mode=ep_mode)

    def placed(tree, tree_metas):
        return tree if mesh is None else pm.shard_params(tree, tree_metas, mesh, rules)

    batch = steps.input_specs(cfg, shape, **kw)
    if mesh is not None:
        batch = pm.shard_batch(batch, mesh, rules)
    if shape.kind == "train":
        opt = AdamW(moment_dtype=cfg.opt_dtype)
        params, opt_state = steps.abstract_state(cfg, opt, **kw)
        grad_shardings = None
        if mesh is not None:
            opt_state = pm.shard_opt_state(opt_state, metas, mesh, rules)
            grad_shardings = pm.placement_tree(metas, mesh, rules)
        fn = steps.make_train_step(cfg, opt, steps.TrainHyper(microbatch=microbatch),
                                   grad_shardings=grad_shardings)
        args = (placed(params, metas), opt_state, batch)
    elif shape.kind == "prefill":
        params, _ = steps.abstract_state(cfg, **kw)
        cache_metas = lm.cache_metas_tree(cfg, shape.global_batch, shape.seq_len)
        fn = steps.make_prefill_step(
            cfg, shape, init_cache=None if mesh is None else
            (lambda dev: pm.zeros_sharded(cache_metas, mesh, rules, dev)))
        args = (placed(params, metas), batch)
    else:  # decode
        params, _ = steps.abstract_state(cfg, **kw)
        cache_metas = lm.cache_metas_tree(cfg, shape.global_batch, shape.seq_len)
        fn = steps.make_decode_step(cfg)
        args = (placed(params, metas), placed(steps.abstract_cache(cfg, shape, **kw),
                                               cache_metas), batch)
    if mesh is not None:
        step = fn

        def fn(*a):
            with use_sharding(mesh, rules):
                return step(*a)

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
             overrides: dict | None = None, *, device: Any = "cuda", mesh: str = MESH) -> dict:
    """One cell's record (``status`` ``ok``, ``skipped`` or ``error``) on
    ``mesh`` (``"1"``: one card; ``"16x16"``, ``"2x16x16"``, ...: traced on
    a fake process group of the mesh's size)."""
    shape = _shape(shape)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh, "status": "ok"}
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.subquadratic:
        rec["status"] = "skipped"
        rec["reason"] = "full-attention arch at 500k context (the reference's skip rule)"
        return rec
    if overrides:
        rec["overrides"] = dict(overrides)
    try:
        if mesh == MESH:
            _trace_cell(rec, arch, shape, table_dir, overrides, device, None)
        else:
            dims, axes = mesh_dims(mesh)
            with fake_world(math.prod(dims)):
                device_type = torch.device(device).type
                _trace_cell(rec, arch, shape, table_dir, overrides, device,
                            make_mesh(dims, axes, device_type))
    except Exception as e:  # noqa: BLE001
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def _trace_cell(rec: dict, arch: str, shape: ShapeConfig, table_dir: str | None,
                overrides: dict | None, device: Any, mesh: Any) -> None:
    from repro_torch.analysis.resources import graph_memory

    cfg, shape, fn, args = build_cell(arch, shape, overrides, device=device, mesh=mesh)
    t0 = time.perf_counter()
    gm, kernels = graph_analysis.trace_with_work(fn, *args)
    if mesh is not None:
        # DTensor's sharding propagation infers some ops' output metadata by
        # running them on empty whole tensors (seen in the backward on torch
        # 2.11); the trace records those as chains nothing reads, which the
        # program never runs
        gm.graph.eliminate_dead_code()
        gm.recompile()
    rec["trace_s"] = round(time.perf_counter() - t0, 2)
    mem = graph_memory(gm, args)
    rec["argument_size_in_bytes"] = mem.operand_bytes + mem.const_bytes
    rec["temp_size_in_bytes"] = mem.peak_intermediate_bytes
    rec["output_size_in_bytes"] = mem.output_bytes
    table = graph_cost.node_table(gm, kernels)
    if table_dir:
        graph_cost.save_table(table, _table_path(arch, shape.name, rec["mesh"], table_dir))
    _cost_fields(rec, table)
    rec["kernels"] = dict(Counter(name for name, _ in kernels))
    rec["chips"] = 1 if mesh is None else mesh.size()
    rec["model_flops"] = model_flops(cfg, shape)
    rec["peak_bytes_per_device"] = mem.peak_live_bytes
    rec["device_memory_bytes"] = HW.memory_bytes()
    rec["fits_device"] = rec["peak_bytes_per_device"] < rec["device_memory_bytes"]


def main(argv: list[str] | None = None, *, device: Any = "cuda") -> None:
    """The reference's CLI; ``--save-hlo`` saves node tables.  Without
    ``--multi-pod`` the cells are traced on one card (``mesh`` ``"1"``);
    ``--multi-pod single|multi|both`` traces them on the reference's
    ``16x16`` and / or ``2x16x16`` meshes.  ``device`` is where the cells
    are traced for (the card; a caller may ask for ``"cpu"``, where the
    plain versions stand in for the kernels)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=tuple(POD_MESHES), default=None,
                    help="trace on the 16x16 and / or 2x16x16 meshes (default: one card)")
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
    meshes = POD_MESHES[args.multi_pod] if args.multi_pod else (MESH,)

    for a, s, m in ((a, s, m) for a in archs for s in shapes for m in meshes):
        if (a, s, m) in done:
            continue
        t0 = time.perf_counter()
        rec = run_cell(a, s, table_dir=args.save_hlo, device=device, mesh=m)
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
