"""End-to-end training example on the card, with the PyTorch / CUDA
port (``repro_torch``): the counterpart of ``examples/train_lm.py``.  Trains
a reduced llama-family model for a few hundred steps on the synthetic
pipeline, with checkpointing and fault tolerance active (flash attention
and RMSNorm run as CUDA kernels, forward and backward).

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_lm_<config> under the temp dir "
                         "(scoped so runs with different shapes never cross-restore)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import lm
    from repro_torch.models import params as pm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.fault import FaultTolerantLoop
    from repro_torch.runtime.monitor import StepMonitor

    device = resolve_device(args.device)
    cfg = dataclasses.replace(
        get_config("llama3.2-1b"),
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8,
        n_kv_heads=4,
        d_head=args.d_model // 8,
        d_ff=args.d_model * 4,
        vocab_size=2048,
    )
    if args.ckpt_dir is None:
        args.ckpt_dir = os.path.join(
            tempfile.gettempdir(),
            f"repro_torch_train_lm_d{args.d_model}_l{args.layers}_s{args.seq}")
    n_params = pm.count_params(lm.build_metas(cfg))
    print(f"model: {cfg.name} reduced, {n_params/1e6:.1f}M params")

    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, structure=1.0,
    )
    opt = AdamW(weight_decay=0.01)
    step_fn = make_train_step(
        cfg, opt,
        TrainHyper(base_lr=2e-3, warmup_steps=15, total_steps=args.steps),
    )
    params = lm.init_params(cfg, seed=0, device=device)
    state = {"params": params, "opt": opt.init(params)}
    monitor = StepMonitor()
    losses = []

    def one_step(state, batch, step):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        p, o, m = step_fn(state["params"], state["opt"], b)
        losses.append(float(m["loss"]))
        if step % 20 == 0:
            print(f"  step {step:4d}  loss {losses[-1]:.4f}", flush=True)
        return {"params": p, "opt": o}

    loop = FaultTolerantLoop(
        step_fn=one_step, batch_fn=data.batch_at,
        ckpt=CheckpointManager(args.ckpt_dir, keep=2),
        ckpt_every=100, monitor=monitor,
    )
    t0 = time.time()
    res = loop.run(state, args.steps)
    dt = time.time() - t0
    print(
        f"trained {res.completed_steps} steps in {dt:.0f}s "
        f"({args.steps*args.batch*args.seq/dt:.0f} tok/s); "
        f"loss {np.mean(losses[:10]):.3f} -> {np.mean(losses[-10:]):.3f}"
    )
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    print("loss decreased: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
