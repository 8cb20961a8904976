"""Training CLI (the port of ``repro/launch/train.py``).

Wires together: config -> synthetic data pipeline -> train step ->
fault-tolerant loop (async checkpoints, restart/replay, straggler monitor).
Runs on the CUDA card, where flash attention and RMSNorm run as CUDA
kernels forward and backward:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --batch 8 --seq 512

``--device cpu`` runs on the CPU explicitly (the tests do, with
``--reduced``).  ``--layers N`` keeps the first N layers of the pattern at
full width.  A previously verified offload plan (committed by an
``OffloadSession``, e.g. the ``repro_torch.offload.zoo`` sweep) can be
bound at startup with ``--plan-dir`` / ``--plan-key``; with ``--plan-dir``
alone the stored ``zoo:<arch>:train`` plan (when present) binds, and
``--plan-search`` searches and commits a missing plan first (over
``--plan-targets``; ``--executor`` picks how its trials are timed), and
``--meter`` reports the run's power telemetry with measured/estimated
provenance (``power: train loop ...``).  With default bindings, a call
whose CUDA kernel has no
backward (the SSD chunk kernel, the gated norm: an SSM arch) runs its plain
version, as the reference's default runs ``xla``; the run ends with a
``grad_default:`` line naming those blocks and their calls.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core import blocks
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.steps import TrainHyper, make_train_step
from repro_torch.metering import EXECUTOR_NAMES, METER_NAMES, meter_window, resolve_meter
from repro_torch.models import lm
from repro_torch.models.params import count_params
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.fault import FaultTolerantLoop
from repro_torch.runtime.monitor import StepMonitor


@dataclasses.dataclass
class TrainState:
    """The state a train step carries: the parameters and the optimizer's."""

    params: object
    opt_state: object


def build(args: argparse.Namespace):
    """(cfg, data, step_fn, params, opt_state, device) for the CLI's
    arguments: the f32 master weights made from ``--seed`` on the device."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.cut(args.layers)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed,
    )
    opt = AdamW(moment_dtype=cfg.opt_dtype)
    hyper = TrainHyper(
        base_lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
        total_steps=args.steps, microbatch=args.microbatch,
    )
    step_fn = make_train_step(cfg, opt, hyper)
    params = lm.init_params(cfg, seed=args.seed, device=device)
    return cfg, data, step_fn, params, opt.init(params), device


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (a depth cut; widths stay)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--plan-dir", default=None,
                    help="PlanStore directory with verified offload plans")
    ap.add_argument("--plan-key", default=None,
                    help="plan to load and bind at startup (zero search); defaults to "
                         "the stored zoo:<arch>:train plan when present")
    ap.add_argument("--plan-search", action="store_true",
                    help="search+commit a missing zoo:<arch>:train plan before binding "
                         "(the verification-environment step)")
    ap.add_argument("--plan-targets", default=None,
                    help="targets --plan-search searches over (default: torch,cuda on "
                         "the card, ref,torch with --device cpu)")
    ap.add_argument("--executor", default="serial", choices=EXECUTOR_NAMES,
                    help="measurement executor for --plan-search")
    ap.add_argument("--meter", default="none", choices=METER_NAMES,
                    help="power telemetry for the run (and --plan-search)")
    return ap


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    if args.plan_dir and not args.plan_key:
        from repro_torch.offload.zoo import DEFAULT_TARGETS, launch_plan_keys

        targets = (tuple(args.plan_targets.split(",")) if args.plan_targets
                   else DEFAULT_TARGETS[args.device])
        args.plan_key = launch_plan_keys(
            args.plan_dir, args.arch, ("train",), search=args.plan_search,
            targets=targets, executor=args.executor, meter=args.meter, device=args.device,
        )["train"]
        if args.plan_key is None:
            args.plan_dir = None  # no stored plan: default bindings, quietly
    meter = resolve_meter(args.meter)

    cfg, data, step_fn, params, opt_state, device = build(args)
    print(f"arch={cfg.name} params={count_params(lm.build_metas(cfg)) / 1e6:.1f}M")

    monitor = StepMonitor()
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    state = {"params": params, "opt": opt_state}
    last_metrics: dict = {}

    def one_step(state, batch, step):
        nonlocal last_metrics
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(state["params"], state["opt"], b)
        last_metrics = {k: float(v) for k, v in metrics.items()}
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {last_metrics['loss']:.4f} "
                  f"({monitor.median_step() * 1e3:.0f} ms/step)", flush=True)
        return {"params": params, "opt": opt_state}

    loop = FaultTolerantLoop(
        step_fn=one_step, batch_fn=data.batch_at, ckpt=ckpt, ckpt_every=args.ckpt_every,
        monitor=monitor,
    )
    from repro_torch.offload import OffloadSession

    t0 = time.time()
    defaults0 = dict(blocks.registry.grad_defaults)
    with OffloadSession.attach(args.plan_dir, args.plan_key):
        # each step's float(loss) waits for the card, so the window closes
        # after the last step's device work
        with meter_window(meter) as tele:
            result = loop.run(state, args.steps)
    dt = time.time() - t0
    defaults = {k: n - defaults0.get(k, 0) for k, n in blocks.registry.grad_defaults.items()}
    named = ", ".join(f"{k} ({n} calls)" for k, n in sorted(defaults.items()) if n)
    print(f"grad_default: {named} resolved to torch: their cuda kernels have no backward"
          if named else "grad_default: none")
    tokens = args.steps * args.batch * args.seq
    print(f"done: {result.completed_steps} steps, {result.restarts} restarts, "
          f"final loss {last_metrics.get('loss', float('nan')):.4f}, {tokens / dt:.0f} tok/s")
    if meter is not None:
        print(f"power: train loop {tele.summary()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
