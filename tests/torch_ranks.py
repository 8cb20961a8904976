"""Multi-rank helpers of the port's distribution tests: run a function on N
local ``gloo`` ranks (spawned processes, a ``FileStore`` in the test's
``tmp_path``: no TCP port, so parallel test workers cannot collide), under
a timeout of its own; and the rank programs the tests run.  This module
imports ``torch`` and ``repro_torch`` only, so each spawned rank starts
without JAX."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

#: the reference test's config (``tests/test_manual_tp.py``), kv heads apart
TP_CFG = dict(n_layers=2, d_model=64, n_heads=4, d_head=16, d_ff=128, vocab_size=512,
              compute_dtype="float32", remat="none")
TP_BATCH, TP_SEQ = 4, 16


def _entry(rank: int, fn, world: int, store: str, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0) -> None:
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks; raises if a rank
    fails or the ranks outlast ``timeout`` seconds (they are killed)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_entry, args=(fn, world, str(tmp_path / "store"), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks of {fn.__name__} outlasted {timeout} s")


def tp_config(n_kv_heads: int):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("llama3.2-1b").reduced(), n_kv_heads=n_kv_heads,
                               **TP_CFG)


def tp_batch() -> dict:
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, TP_CFG["vocab_size"], (TP_BATCH, TP_SEQ))
                                .astype(np.int32)) for k in ("tokens", "labels")}


def manual_tp_rank(rank: int, out_dir: str, n_kv_heads: int) -> None:
    """On a (data=2, model=2) mesh with ``act_seq`` forced to ``"model"``,
    under both settings (propagation; ``BF16_TP_REDUCE`` and
    ``MEGATRON_MLP``): the loss and every gradient of ``lm.loss_fn``, then
    one ``make_train_step`` with ``grad_shardings``.  Rank 0 saves the
    whole values to ``out_dir/sharded.pt``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers, lm
    from repro_torch.models import params as pm
    from repro_torch.optim.adamw import AdamW, tree_leaves
    from repro_torch.sharding import rules_for, use_sharding

    cfg = tp_config(n_kv_heads)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rules = rules_for(cfg, ShapeConfig("t", TP_SEQ, TP_BATCH, "train"), {"data": 2, "model": 2})
    rules["act_seq"] = "model"  # force SP so the reduce-scatter paths engage
    metas = lm.build_metas(cfg)
    params = torch.load(os.path.join(out_dir, "params.pt"))
    batch = tp_batch()
    opt = AdamW()
    out = {}
    try:
        for name, flags in (("propagation", (False, False)), ("manual", (True, True))):
            layers.BF16_TP_REDUCE, layers.MEGATRON_MLP = flags
            sp = pm.shard_params(params, metas, mesh, rules)
            sb = pm.shard_batch(batch, mesh, rules)
            leaves = tree_leaves(sp)
            for p in leaves:
                p.requires_grad_(True)
            with use_sharding(mesh, rules):
                loss, _ = lm.loss_fn(sp, sb, cfg)
                grads = torch.autograd.grad(loss, leaves)
            placed = [tuple(p.placements) for p in leaves]
            loss, grads = loss.detach().full_tensor(), [g.full_tensor() for g in grads]
            step = steps.make_train_step(cfg, opt, steps.TrainHyper(),
                                         grad_shardings=pm.placement_tree(metas, mesh, rules))
            sp = pm.shard_params(params, metas, mesh, rules)
            so = pm.shard_opt_state(opt.init(params), metas, mesh, rules)
            with use_sharding(mesh, rules):
                sp, so, metrics = step(sp, so, sb)
            kept = placed == [tuple(p.placements) for p in tree_leaves(sp)]
            out[name] = {"loss": loss, "grads": grads, "step_loss": metrics["loss"],
                         "stepped": [p.full_tensor() for p in tree_leaves(sp)],
                         "placements_kept": kept}
    finally:
        layers.BF16_TP_REDUCE = layers.MEGATRON_MLP = False
    if rank == 0:
        torch.save(out, os.path.join(out_dir, "sharded.pt"))


def distributed_state_rank(rank: int, out_dir: str) -> None:
    """``compressed_psum_mean`` over "data" of a (data=4,) mesh on each
    rank's own gradients (``grads_<rank>.pt``), and ``reshard_restore`` of
    the world-1 checkpoint under ``out_dir/ckpt`` onto a (2, 2) mesh.
    Each rank saves what it got."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager, reshard_restore
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import compressed_psum_mean

    mesh = make_mesh((4,), ("data",), "cpu")
    grads = torch.load(os.path.join(out_dir, f"grads_{rank}.pt"))
    mean = compressed_psum_mean(grads, mesh, "data")
    dist.barrier()
    mesh2 = make_mesh((2, 2), ("data", "model"), "cpu")
    like = torch.load(os.path.join(out_dir, "like.pt"))
    specs = {"w": ("data", "model"), "b": (("data", "model"),), "s": ()}
    step, tree = reshard_restore(CheckpointManager(os.path.join(out_dir, "ckpt")), like,
                                 mesh2, specs)
    plain = type(mean["equal"]) is torch.Tensor
    torch.save({"mean": mean, "mean_is_plain": plain, "step": step,
                "coord": mesh2.get_coordinate(),
                "local": {k: v.to_local().clone() for k, v in tree.items()},
                "placements": {k: str(v.placements) for k, v in tree.items()},
                "full": {k: v.full_tensor() for k, v in tree.items()}},
               os.path.join(out_dir, f"state_{rank}.pt"))
