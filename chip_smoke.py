#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc/`` and
drives ``repro_torch`` on the card, phase by phase; each phase prints one
JSON line, and any failure raises (exit code != 0):

1. device: the card's name and power limit, and the kernel build's time;
2. kernels: every kernel against its plain PyTorch version on the same
   inputs, at the serving path's full-width shapes (llama3.2-1b: d=2048,
   H=32, KH=8, D=64, bf16), with its time, the plain version's, the card's
   bound for the same work and one PyTorch library call's where there is
   one;
3. served f32 trace: a short greedy trace of the full-width config cut to
   2 layers, once through the kernels and once with the plain versions
   bound; the tokens must be identical.  It runs twice: at exact prompt
   lengths (prefill eager: ``graphs`` shows no prefill capture), with
   ``prefill_bucket=16``, where padded lengths repeat and the prefill
   program replays its CUDA graphs (prefill replays > 0), and with
   ``prefill_chunk=16`` on the paged cache, where prompts longer than 16
   run as chunks through the ``extend`` / ``extend_sample`` programs
   (replays of both > 0) under an enabled tracer whose ``prefill-chunk``
   spans must number ``stats.prefill_chunks``;
4. the main path: full-width llama3.2-1b (16 layers, seeded random
   weights made on the card) served by ``repro_torch.serve.ServeEngine``
   from the paged KV cache (page_size=16, 8 slots, 16 requests), with
   every kernel's launch count over that run, each of which must be > 0,
   and the launches of each rmsnorm form (``rmsnorm_forms``: plain and
   add must be > 0).  The engine runs its decode step as CUDA graphs
   (``repro_torch.serve.programs``; prefill too where lengths are
   bucketed, not here); ``graphs`` gives each program's calls, eager
   calls, captures, replays, capture seconds and graph keys.  Decode must
   capture at most three times (once per sampling policy) and replay every
   step after its key's first; the launch counts include the replays'
   launches;
5. decode profile: a full-width decode step at 8 busy slots, wall time
   and device time by kernel (``torch.profiler``), the host and device ms
   of one sampled ``sample_tokens`` call (temperature and top-k) at the
   same batch and the full vocabulary, and ``replay_ms_per_step``, the
   CUDA-event time of back-to-back decode steps (``_top_k``: of a top-k
   batch, the sampler inside the graph).  Then ``replay_vs_eager``:
   from one engine state (the cache cloned), one replay of the decode
   graph and one eager call of the decode step function on the same
   inputs, logits and the whole cache held to ``TOL`` (greedy, and a top-k
   batch).  The profiler's events of rmsnorm's and paged attention's
   kernels over the profiled replays must equal the launches the replays
   added to their counts;
6. offload: the paper's function-block offload pipeline
   (``repro_torch.offload.OffloadSession``) on the card for the four
   application entry points (FFT n=256, LU n=192), with the
   ``complex_matmul`` and ``schur_update`` launch counts over that run,
   each of which must be > 0; the ``matmul`` DB entry resolved and called
   through its C-2 interface adapter; then the prior-work loop-offload GA
   on both apps and the paper's Fig. 5 comparison (cpu / loop / block,
   each re-timed as the median of ``FIG5_REPEATS`` calls);
7. offload_full: the committed libcall applications at the paper's
   2048 x 2048, checked against ``np.fft.fft2`` and |det| = 1, timed beside
   cuFFT (``torch.fft.fft2``) and cuSOLVER (``torch.linalg.lu_factor``);
8. served f32 trace, SSM: full-width mamba2-2.7b cut to 2 layers, kernels
   against plain versions, as phase 3's exact lengths (an SSM refuses
   buckets; every prefill after the first starts from the shared batch-1
   state, zeroed inside the prefill program);
9. the SSM main path: full-width, full-depth mamba2-2.7b (64 layers)
   served from contiguous slots (8 slots, the same 16 requests), with the
   ``rmsnorm`` and ``ssd_chunks`` launch counts (each > 0) and rmsnorm's
   plain, add and gated forms (each > 0), then a decode profile at 8 busy
   slots as phase 5 (its ``replay_vs_eager`` greedy);
10. hybrid: zamba2-7b at full width cut to 12 layers (``mmmmmsmmmmms``)
   served from the paged cache (page_size 16, 8 slots, the same trace),
   with the ``rmsnorm``, ``ssd_chunks``, ``paged_attention`` and
   ``flash_attention`` launch counts (each > 0) and rmsnorm's three forms
   (each > 0), then its decode profile as phase 5 (``replay_vs_eager``
   greedy).  Phases 9 and 10 report ``graphs`` and hold decode's captures
   and replays as phase 4;
11. main_path_chunked: phase 4's configuration and trace with
   ``prefill_chunk=128``: prompts longer than 128 tokens prefill as
   128-wide chunks extended in place into their pages (paged attention's
   extend route at B=1, S=128), the final chunk over the context's last
   128 positions.  ``paged_attention`` must launch more often than in
   phase 4; ``extend`` captures once and ``extend_sample`` at most three
   times (once per policy), every later call a replay.  It reports prefill
   seconds, TTFT and tok/s beside phase 4's, the extra device tokens of
   the overlapped final chunks, and ``replay_vs_eager`` of both chunk
   programs from a cloned cache (logits and the pool held to ``TOL``);
12. offload_programs: the offload pipeline's compiled units.  The blocked
   LU as one captured program per (n, nb, trailing update) at 2048 / nb
   128 and 192 / nb 32: a replay bit-identical to an eager ``lu_blocked``
   call on the same input, one capture a key, its capture seconds, replay
   seconds beside the eager call's and ``torch.linalg.lu_factor``'s, the
   Schur updates one replay launches and the phase's peak memory; then
   phase 6's Fig. 5 again with every staged and block program captured
   (``numerics_ok``: loop and block outputs agree with the CPU program's);
13. binding: the paper's per-environment selection on the serving path.
   ``plan_zoo`` searches llama3.2-1b's prefill and decode cells at full
   width and depth (batch 8, seq 512) over the torch and cuda targets,
   each trial timing replays of the cell's captured step, and commits a
   plan a cell with every axis pinned; phase 4's trace is served under
   the plans and again with ``decode_impl="torch"``, with each kernel's
   launches per phase (a block bound to torch in a phase launches no
   kernel there; the torch-bound paged attention none at all); a 2-layer
   f32 greedy trace under the plans equals the default bindings' tokens;
14. served f32 trace, MoE and MLA: deepseek-v2-236b at full width cut to
   2 layers (``da``: its dense layer, then an MoE layer), kernels against
   plain versions, paged, at exact lengths, with ``prefill_bucket=16`` and
   with ``prefill_chunk=16`` (as phase 3);
15. main_path_mla_moe: deepseek-v2-236b at full width cut to 4 layers
   (``daaa``, ~27 GB of bf16 weights) served as phase 4 (the same engine
   settings and trace; decode as graph replays), with the rmsnorm, paged
   attention (the latent pool as keys and values, the rope pool beside
   it, G = 128 rows: every launch on the latent walk) and flash (qk 192 /
   v 128: every launch on wgmma) launch counts, each > 0, one decode
   replay bit-identical to its eager call (``replay_vs_eager``), and the
   bf16 path as a whole (``bf16_path_vs_plain``): with 8 requests
   decoding, one prefill's and one decode step's logits against the same
   calls with ``attention`` and ``paged_attention`` bound to ``torch`` and
   the MoE's expert choices pinned to the kernel run's, within
   ``PATH_TOL`` of the plain logits' largest |value| or, where larger,
   ``PATH_FLOOR_FACTOR`` times the rounding floor (the pinned plain run
   with each attention's P rounded to bf16 before P V), every
   attention call of the path within ``TOL`` of its kernel on the same
   inputs (the unpinned comparison and the flipped expert choices
   reported beside it);
16. extend_mla: phase 15 with ``prefill_chunk=128`` (every paged launch on
   the latent walk, every flash launch on wgmma): the chunk programs
   extend the latent and rope pools; ``extend`` captures once and replays
   every later call; an MoE's final chunk runs at its exact width (no
   overlapped tokens, a key per width); one replay of each chunk program
   equals its eager call from a cloned cache;
17. main_path_moe_residual: arctic-480b at full width cut to 1 layer
   (~28 GB: 128 experts of d_ff 4864 beside the dense residual FFN), as
   phase 15, flash on its wgmma route.  Phases 15-17 cut depth so the
   weights and the init's transient f32 leaf fit the card's 80 GB
   (``MOE_LAYERS``);
18. train_f32: llama3.2-1b at full width cut to 2 layers in f32 compute (B
   2, S 128): the loss and every gradient leaf of ``lm.loss_fn`` through
   the kernels (flash attention and RMSNorm, forward and backward) against
   ``attention`` / ``rmsnorm`` bound to ``torch`` (each leaf within 1e-4 of
   its largest |g|, the loss within 1e-5), every train-path kernel
   launched by the first and none by the second; then three
   ``make_train_step`` steps each way, the losses within 1e-5 relative;
19. main_path_train: full llama3.2-1b (16 layers, f32 master weights and
   moments, bf16 compute, full remat) for ``TRAIN_STEPS`` steps of
   ``make_train_step`` on ``SyntheticLMData`` at B 8, S 512: every loss
   finite, ms a step (median after the first), tok/s, peak memory, the
   launches of flash forward and backward and of rmsnorm's plain and add
   forms forward and backward (each > 0), one profiled step (busy share,
   device ms by kernel, top 10, RMSNorm backward's device ms by kernel);
   then from the trained state one step twice from one state and batch
   (``repeat_step``: whether every parameter leaf is bit-identical, and
   the leaves that differ), and the loss and the global grad norm through
   the kernels against the plain bindings, to ``TRAIN_BF16_TOL``;
20. train_loop: the training CLI's ``build`` at ``--reduced`` run by
   ``FaultTolerantLoop`` (a checkpoint every 4 steps, a failure injected
   at step 6) against an uninterrupted run: the restarts and the largest
   |difference| of every leaf, the leaves that differ named; then
   ``python -m repro_torch.launch.train --reduced`` as a process, exit 0,
   for llama3.2-1b and for mamba2-2.7b (two steps; its ``grad_default:``
   line names ``ssd_scan``);
21. train_ssm: mamba2-2.7b at full width cut to 2 layers in f32 (B 2, S
   256), as phase 18 on default bindings against every block bound to
   ``torch``: the norms' plain and add forms launch their kernels forward
   and backward; every SSD scan and gated norm resolves to ``torch`` for
   its gradient (``grad_default/ssd_scan``, ``grad_default/rmsnorm.gated``
   > 0) and ``ssd_chunks`` launches nothing;
21b. train_mla: deepseek-v2-236b at full width cut to its dense layer
   (``TRAIN_MLA``: pattern ``d``, MLA at qk 192 / v 128 and the 12288-wide
   FFN, bf16 params and moments) for four ``make_train_step`` steps at B
   2, S 512: every loss finite, ms a step, tok/s, peak memory beside the
   dry-run's estimate of the same step; flash's forward and backward and
   RMSNorm's backward launched, every flash launch forward and backward on
   wgmma; from the trained state (copied to the host once), one more step
   profiled, one step twice bit-identical, and the loss and grad norm
   against the plain bindings within ``TRAIN_BF16_TOL``;
22. metering: the port's power meters (``repro_torch.metering``).
   ``autodetect()`` must be the NVML meter (NVIDIA's NVML library
   through ctypes), on the card torch runs on (its name, and the NVML
   handle of torch's PCI address), its power limit beside ``nvidia-smi``'s;
   one ``meter_window`` around ``METER_WINDOW_S`` of replays of
   llama3.2-1b's graphed B=8 decode step within ``METER_TOL`` of the
   card's energy counter (``nvmlDeviceGetTotalEnergyConsumption``) over the
   same window; phase 4's trace served with no meter and with
   ``meter="nvml"``: identical tokens, each phase's joules measured, fed
   to ``serve_phase_joules_total`` and below 1.05x the power limit, J/token
   and the decode step's median with and without the meter; the offload
   pipeline on phase 6's libcall apps under ``perf_per_watt`` with the
   meter through the serial (``measured`` joules), batched (``estimated``)
   and device-parallel executors (the serial run's winner); then a
   ``latency`` and a ``perf_per_watt`` store of the FFT app (trials of at
   least a second) and their trade-off table (``metering.report``);
23. analysis: static analysis (``repro_torch.analysis``) on the card.  The
   probed envelope (torch's card: its total bytes beside the static
   ``h100-80g`` row, its shared memory per block); phase 4's engine after
   phase 4's trace: its capacity plan against the card (params and cache
   bytes equal to the engine's tensors', the pool the live pool's, the
   slots that would fit), ``engine.lint()`` (no warning or error, paged
   attention and rmsnorm among the decode trace's kernels, not one launch,
   its seconds), and ``estimate_memory`` of one eager decode step at B = 8
   against the step's measured peak (an upper bound within
   ``ESTIMATE_BRACKET``); phase 6's libcall apps with ``legality=True,
   resources="host"`` (the same winner as without), their blocks in
   binding mode (cuda legal by a probe that launches nothing, nothing
   pruned against the card; against ``tiny-32m`` the FFT's cuda binding at
   2048 pruned with a ``memory:`` reason, the LU's at 128 not, as it fits:
   ``ANALYSIS_BLOCKS``); the serve CLI's ``--preflight --envelope
   host``: full llama3.2-1b exits 0, full deepseek-v2-236b exits 2;
24. cost_model: the cost model and the one-card dry-run
   (``repro_torch.launch.dryrun`` over ``launch/graph_cost.py``) at full
   width: llama3.2-1b's ``train_4k``, ``prefill_32k`` and ``decode_32k``
   records (``long_500k`` skipped by the reference's rule; no kernel
   launched by a trace: each wrapper declares its kernel's work instead);
   the roofline as a lower bound, like for like: a B=8 decode step with
   every slot at full context (1024) against its CUDA-graph replay's device
   time, and phase 19's train step (B 8, S 512) against that phase's
   profiled device ms, each ``roofline_s`` at most the measured time, the
   train step's estimated peak beside phase 19's measured peak; then
   ``CostGuidedSearch(top_k=2)`` with the default roofline through
   ``plan_zoo`` on llama3.2-1b's decode bindings (torch, cuda): the
   baseline and two trials measured, nothing launched while ranking, its
   winner and seconds beside the zoo's default strategy's;
25. distributed: (a) a one-rank NCCL group and a (1, 1) ``("data",
   "model")`` mesh: the parameters, optimizer state and batch placed as
   ``DTensor``s (``shard_params``), the train step under ``use_sharding``
   with ``grad_shardings``, under both settings (``DTensor`` propagation;
   ``BF16_TP_REDUCE`` and ``MEGATRON_MLP``).  At 2 layers in f32 (phase
   18's cell) the loss and every gradient leaf equal the unsharded ones
   (loss 1e-5 relative, each leaf 1e-4 of its max |g|); at phase 19's
   full llama3.2-1b (B 8, S 512, bf16, full remat) the step's loss, its
   gradients' global norm and the stepped parameters equal the unsharded
   step's within ``MESH_BF16_TOL``, the hand kernels launch as often as in
   the unsharded step (flash and RMSNorm, forward and backward), and the
   sharded step's wall and device ms stand beside phase 19's.  (b) The
   mesh dry-run, traced with no launch on a fake process group:
   llama3.2-1b's ``train_4k``, ``prefill_32k`` and ``decode_32k`` on
   ``16x16`` and ``2x16x16``, deepseek-v2-236b's ``decode_32k`` cut to 4
   layers on ``16x16`` under ``ep_mode`` gather and psum: per-device
   peak, ``fits_device``, collective bytes by kind and trace seconds;
26. examples: ``examples/quickstart_torch.py --fast``,
   ``offload_existing_app_torch.py`` and ``train_lm_torch.py`` (40 steps
   at d 128, 2 layers: its loss must fall) each as a process on the card,
   each exiting 0;
27. the zoo's dense configs at full width (``ZOO_LAYERS``): stablelm-1.6b
   (24 layers, MHA at D 64), granite-3-8b (40, G = 4 at D 128, a vocab of
   49155), command-r-35b (14 of 40 layers, 64 heads over 8 at D 128, a
   tied vocab of 256000) and musicgen-large (48, MHA at D 64, its
   EnCodec token stream), each first as phase 3's 2-layer f32 trace
   (kernels against plain, token-identical), then as ``zoo_<arch>``:
   phase 4's engine and trace, every flash launch on wgmma and every
   paged launch on the split walk, one decode replay bit-identical to its
   eager call and the bf16 path against the plain attention's within
   ``PATH_TOL`` (as phase 15);
28. pixtral_forward: the serving engine refuses pixtral-12b (a patch-embed
   frontend has no token prompt, as in the reference); pixtral at full
   width cut to 2 layers in f32 runs ``lm.forward`` on seeded patch
   embeddings (B 2, S 512, d 5120), kernels against the plain bindings
   (``PIXTRAL_FORWARD``);
29. train_vlm: pixtral-12b at full width cut to 8 of 40 layers
   (``TRAIN_VLM``: f32 master weights and moments, bf16 compute) trained
   on seeded patch embeddings at B 2, S 512 as phase 21b: every flash
   launch forward and backward on wgmma (32 heads over 8 at D 128),
   RMSNorm's backward launched, one step twice from the trained state
   bit-identical (the state restored to the card from the host before
   each), the loss and grad norm on a batch the steps did not see within
   ``TRAIN_BF16_TOL`` of the plain bindings.  Each of phases 27-29 prints its seconds.

RMSNorm is held in its three forms (``kernels/rmsnorm.py``): plain at
llama's decode and prefill (f32 and bf16 weights), at ragged widths (f32 d
= 100, bf16 d = 2050: the scalar path) and at d = 20480 (the two-pass
loop); the add form (residual add fused, its sum bit-identical to the
plain version's) at llama's decode and prefill; the gated form (Mamba-2's
gate and skip fused) at mamba2's decode and prefill, zamba2's decode, an
f32 prefill and a ragged shape, x and z read in place from wider tensors;
and with a bf16 weight, plain at deepseek-v2's 512-wide ``kv_norm``, plain
and add at deepseek-v2's d = 5120 and arctic-480b's d = 7168 (8 and 512
rows each).

The backward kernels are held in phase 2 too: flash's backward (dq, dk,
dv from the forward kernel's ``out`` and ``lse``, the ``lse`` itself
against the plain forward's) at llama's train shape (B 8, H 32, KH 8, S
512, D 64, bf16: the wgmma route), bf16 at B 2, S 300 (its ragged edge),
zamba2's D 112 and arctic's D 128 (wgmma, two column boxes), deepseek-v2's
qk 192 / v 128 and qk 256 / v 128 at H 16 over KH 4, S 300 (wgmma, dK / dV
on two consumer warpgroups; their kernels' own device ms), f32 at B 2, S
300 and at qk 192 / v 128 (the CUDA cores; each row names its route);
RMSNorm's backward, plain and add forms, at 4096 x 2048 bf16 and f32 at d
= 100, and 4096 bf16 rows of deepseek-v2's 512-wide ``kv_norm`` (plain, a
bf16 weight) and of arctic-480b's d = 7168 (plain and add), the add form
at d = 2050 and 9000 (the scalar layout, the two-pass loop), each row with
its kernels' own device ms (``ms_by_kernel``). Each is called twice on the
same inputs, bit for bit; the library call is the backward alone of SDPA /
``F.rms_norm`` through autograd, timed eagerly.

The offload kernels (complex matmul, Schur update, matmul) are held
against their plain versions in phase 2 at the paper's scale (2048^2 f32),
matmul also at (96, 160, 96) at blocks of 32, and each at a ragged shape
whose N or K is not a multiple of 4 (matmul and complex matmul at 99^3,
the Schur update at (100, 100, 30)); the SSD chunk kernel
at mamba2's and zamba2's prefill shapes, at chunk 256 (bf16 and f32) and
at N = 256 with P = 128; paged and flash attention at zamba2's head dim
112 too (flash also at B=2 and a ragged S=300, at qk 48 / v 32 in f32 (the
CUDA-core route) and bf16, at deepseek-v2's MLA prefill, qk 192 / v 128 (the
wgmma route at dv != d), and at a bf16 D = 100 (the CUDA cores)).  Each
flash, paged and SSD row names the route it ran; each paged row names its
split plan's ``n_splits`` (paged attention also runs with all eight slots near
1024 positions, at B=1 with a one-page table, and on phase 11's extend
chunk: B=1, S=128 from position 384; and at deepseek-v2's MLA decode, B=8,
H=128 over one 512-wide latent that is both keys and values, rope 64,
and its S=16 (phase 14's) and S=128 (phase 16's) extend chunks from
position 384, each on the latent walk; at arctic-480b's decode, H=56, KH=8, D=128;
flash also at arctic's prefill, H=56 over KH=8, D=128).  Phase 5 sums the
device time of paged attention's split and merge kernels per step.  The
zoo's dense heads (``ZOO_HEADS``: 32 / 32 / 64, 32 / 8 / 128 and 64 / 8 /
128) add a paged decode row each (8 slots at ~512 positions, the split
walk) and a flash row each (B 1, S 512), flash's backward gains pixtral's
train shape (B 2, H 32, KH 8, S 512, D 128), RMSNorm plain and add rows at
``ZOO_NORM_SHAPES`` (f32 weights) and backward rows at 1024 x 5120 (plain
and add); each after its kernel's earlier rows.

The last lines are the card as ``nvidia-smi`` reports it, the kernels'
summary and ``{"ok": true, "device": {...}}``.  Needs CUDA and the rest of
the repository next to this file; exits non-zero without either.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# kernel vs plain version on the same inputs: f32 differs only by the order
# of f32 sums; bf16 outputs are rounded once from f32 by both, so they may
# sit one bf16 step apart (2^-8 relative; values here stay below ~4)
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)
# f32 GEMMs over K <= 2048 of unit-scale operands: kernel and cuBLAS sum
# the same products in another order, each off by ~K * 2^-24 * |a||b|
# (~1.2e-4 at K = 2048) per output, with outputs up to ~2e2 in size
GEMM_TOL = (1e-3, 1e-4)
# SSD chunk terms, each of the four f32 outputs held on its own (both
# versions upcast bf16 inputs exactly).  y sums L <= 128 terms G[i, j] *
# decay * dt * x, where each G is itself an f32 sum of N <= 128 products of
# unit-scale values (|G| up to ~50), dt <= 0.1; summed in another order,
# each output is off by ~L * N * 2^-24 * |terms| (~1e-4 here, with |y| up
# to ~20).  A state sums L products B * dt * exp(a_tot - a_cum) * x
# (|state| up to ~1): the two a_cum, cumulative sums of up to ~200 in size
# taken in another order, may differ by a few f32 ulps (~1e-5 each), which
# moves a decay by ~1e-4 relative.  cumdecay and totals are one f32 exp of
# those cumulative sums: mostly relative, the atol only covers values that
# underflow toward 0 (exp of -50 and below).
SSD_TOL = {"y": (1e-3, 1e-4), "states": (1e-4, 1e-3),
           "cumdecay": (1e-7, 1e-4), "totals": (1e-7, 1e-4)}

SOURCES = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:47"),
    "paged_attention": (
        "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:330",
    ),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/attention.py:107",
    ),
    "matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:60"),
    "schur_update": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:115"),
    "complex_matmul": (
        "src/repro_torch/kernels/csrc/complex_matmul.cu",
        "src/repro/kernels/fft.py:90",
    ),
    "ssd_chunks": ("src/repro_torch/kernels/csrc/ssd_chunks.cu", "src/repro/kernels/ssd.py:92"),
    # the backward kernels of the train path: no Pallas kernel of the
    # reference has a backward; these replace its jnp VJP of the chunked
    # attention and XLA's autodiff of the reference rmsnorm
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/attention_xla.py:119"),
    "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu", "src/repro/kernels/ref.py:33"),
}


#: the serving path's kernels (phase 4); the offload shelf's run in phase 6
SERVE_KERNELS = ("rmsnorm", "paged_attention", "flash_attention")
#: the SSM path's kernels (phase 9) and the hybrid's (phase 10)
SSM_KERNELS = ("rmsnorm", "ssd_chunks")
HYBRID_KERNELS = ("rmsnorm", "ssd_chunks", "paged_attention", "flash_attention")
#: the rmsnorm forms each path must launch: the first block's norm is plain
#: (and the prefill head's, after backbone's one unfused add), every other
#: block norm and the decode head's take the add form, Mamba-2's gate the
#: gated form
NORM_FORMS = {"llama3.2-1b": ("plain", "add"), "mamba2-2.7b": ("plain", "add", "gated"),
              "zamba2-7b": ("plain", "add", "gated"), "deepseek-v2-236b": ("plain", "add"),
              "arctic-480b": ("plain", "add"), "stablelm-1.6b": ("plain", "add"),
              "granite-3-8b": ("plain", "add"), "command-r-35b": ("plain", "add"),
              "musicgen-large": ("plain", "add")}
#: zamba2-7b at full width, cut to 12 layers (two shared-attention sites)
ZAMBA2_PATTERN = "mmmmmsmmmmms"
#: the MoE configs at full width, cut in depth to fit one card's 80 GB with
#: their init's transient f32 leaf: deepseek-v2 to its dense layer and three
#: MoE layers (``daaa``, ~27 GB of bf16 weights), arctic-480b to one layer
#: (~28 GB, 26.8 of them experts; two layers' init would pass 80 GB)
MOE_LAYERS = {"deepseek-v2-236b": 4, "arctic-480b": 1}
#: the zoo's dense configs served at full width (phase 27), cut in depth
#: only as far as 80 GB forces: the engine draws f32 weights and casts
#: them to bf16 beside them (~6 B a parameter at the cast).  stablelm-1.6b
#: (1.64 B parameters), musicgen-large (3.23 B) and granite-3-8b (8.37 B)
#: whole; command-r-35b (705 M a layer beside 2.10 B of tied embedding)
#: at 14 of its 40 layers, the deepest cut under ~75 GB at the cast
ZOO_LAYERS = {"stablelm-1.6b": 24, "granite-3-8b": 40, "command-r-35b": 14,
              "musicgen-large": 48}

#: the zoo's dense attention heads (H, KH, D) beside llama's: MHA at D 64
#: (stablelm-1.6b, musicgen-large: G = 1), G = 4 at D 128 (granite-3-8b,
#: pixtral-12b) and G = 8 at D 128 (command-r-35b: 64 query heads)
ZOO_HEADS = ((32, 32, 64), (32, 8, 128), (64, 8, 128))
#: the decode lengths of the zoo's paged attention rows (~512 positions)
ZOO_DECODE_LENGTHS = (512, 600, 480, 520, 530, 400, 511, 450)
#: the zoo's norm widths (granite-3-8b 4096, pixtral-12b 5120, command-r-35b 8192)
ZOO_NORM_SHAPES = ((8, 8192), (512, 4096), (512, 5120), (512, 8192))

#: calls per version when Fig. 5's cpu / loop / block are re-timed (median)
FIG5_REPEATS = 5

#: dw of the RMSNorm backward sums a column's terms over 4096 rows, in
#: another order than the plain version's: each sum off by ~rows * 2^-24 *
#: |term| (~3e-4 relative at worst), with |dw| up to ~1e2
NORM_DW_TOL = (1e-3, 1e-4)
#: the train phases' batch: llama3.2-1b at B = 8, S = 512 (phase 20)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 10
#: phase 20's kernels-vs-plain step in bf16: the loss (~11.8 at a random
#: init, a mean over 4096 tokens) within 1e-3 relative, the global grad norm
#: within 2e-2: the bindings round at other places (the wgmma forward
#: rounds P to bf16 before P V, the plain softmax multiplies in f32)
TRAIN_BF16_TOL = {"loss": 1e-3, "grad_norm": 2e-2}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# -- timing --------------------------------------------------------------------


class Timer:
    """Device time of one call.  ``reps`` calls are captured in a CUDA graph
    (so the host's launch cost is left out) and the graph is timed with
    CUDA events, median of 5 replays.  Before each call a 64 MB buffer is
    rewritten so the call finds the 50 MB L2 cold, as in the serving loop,
    where 16 layers of K/V and weights pass between two uses of one layer's
    data; the rewrite's own time, measured the same way, is subtracted."""

    def __init__(self, torch, reps: int = 20):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
        self._flush_ms = self._graph_ms(self.flush.zero_)

    def _graph_ms(self, body) -> float:
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(self.reps):
                body()
        graph.replay()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[2] / self.reps

    def ms(self, fn) -> float:
        def body():
            self.flush.zero_()
            fn()

        return self._graph_ms(body) - self._flush_ms

    def eager_ms(self, fn) -> float:
        """As :meth:`ms`, but the ``reps`` calls run eagerly between CUDA
        events (a library backward runs through autograd's engine, which
        does not capture here).  The card first sleeps ~20 ms
        (``torch.cuda._sleep``), so the host enqueues the whole window
        ahead of it and no launch gap is timed.  Median of 5."""
        torch = self.torch

        def window(body) -> float:
            for _ in range(2):
                body()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's ~1.98 GHz
                start.record()
                for _ in range(self.reps):
                    body()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return sorted(times)[2] / self.reps

        def body():
            self.flush.zero_()
            fn()

        return window(body) - window(self.flush.zero_)


def bound_ms(work) -> tuple[float, str]:
    """The least time the card could take for a kernel call's declared work
    (``repro_torch.kernels.build.Work``, from the formula in the kernel's
    module): its bytes over the HBM rate, or its FLOPs, counted once, over
    the peak of their type (the H100 SXM data sheet's,
    ``repro_torch.launch.mesh.HW``), whichever is larger."""
    from repro_torch.launch.mesh import HW

    t_bytes = work.bytes / HW.hbm_bw * 1e3
    t_ops = work.flops / HW.peak(work.peak) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, dtype: str, tol=None) -> float:
    atol, rtol = tol or TOL[dtype]
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    err = (got - want).abs()
    if bool((err > atol + rtol * want.abs()).any()):
        raise AssertionError(
            f"kernel disagrees with its plain version: max abs err "
            f"{float(err.max()):.3g} > {atol} + {rtol}*|want| ({dtype})"
        )
    return float(err.max())


# -- phases --------------------------------------------------------------------


def phase_device(torch) -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    seconds = time.perf_counter() - t0
    # per kernel: registers, shared memory and spills; and ptxas's warnings
    # that wgmma was serialized (C7515)
    ptxas, fn = [], "?"
    for line in build.build_info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1][:90]
        elif "ptxas info    : Used" in line or "spill stores" in line:
            ptxas.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
        elif "C7515" in line:
            ptxas.append(line.strip()[:200])
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_seconds": round(seconds, 3),
        "nvcc_seconds": round(build.build_info["seconds"], 3),
        "library": build.build_info["path"],
        "ptxas": ptxas,
    }
    emit(info)
    return info


def _case(torch, name, dtype, shape, got, want, timer, run, plain, library, work,
          tol=None, extra=None, library_eager=None):
    """``got`` and ``want`` are one tensor, or dicts of named outputs that
    are each held to ``tol[name]``.  ``work`` is the call's declared work,
    the bound's numerator; ``extra`` adds keys to the printed row.
    ``library_eager`` is a library call timed eagerly (a backward through
    autograd) in place of ``library``."""
    if isinstance(got, dict):
        errs = {k: compare(torch, got[k], want[k], dtype, tol[k]) for k in got}
        err = max(errs.values())
    else:
        errs, err = None, compare(torch, got, want, dtype, tol)
    bound, by = bound_ms(work)
    row = {
        "phase": "kernel", "name": name, "dtype": dtype, "shape": shape,
        "max_abs_err": err, "tol": tol or TOL[dtype],
        "ms": timer.ms(run), "plain_ms": timer.ms(plain),
        "bound_ms": bound, "bound_by": by,
        "library_ms": timer.ms(library) if library is not None else None,
    }
    if library_eager is not None:
        row["library_ms"] = timer.eager_ms(library_eager)
        row["library_timing"] = "eager"
    if errs:
        row["max_abs_err_by_output"] = errs
    row.update(extra or {})
    emit(row)
    return row


def flash_routed(fa, q, k, v) -> tuple:
    """``fa(q, k, v)`` and the route its launch took, read from the
    wrapper's per-route counts."""
    before = dict(fa.routes)
    out = fa(q, k, v)
    (route,) = [r for r, n in fa.routes.items() if n > before[r]]
    return out, {"route": route}


def phase_kernels(torch) -> dict:
    """Each kernel vs its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import flash_attention, flash_attention_torch, flash_work

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch)
    rows: dict[str, list] = {k: [] for k in SOURCES}
    d, h, kh, dh = 2048, 32, 8, 64

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    rows["rmsnorm"] = (_norm_plain_cases(torch, timer, randn)
                       + _norm_fused_cases(torch, timer, randn)
                       # bf16 weights (the MoE configs' parameter type): the
                       # plain form at deepseek-v2's latent kv_norm (512 wide),
                       # both forms at its d = 5120 and arctic-480b's d = 7168
                       + _norm_width_cases(
                           torch, timer, randn,
                           ((8, 512), (512, 512), (8, 5120), (512, 5120), (8, 7168), (512, 7168)),
                           ((8, 5120), (512, 5120), (8, 7168), (512, 7168)), torch.bfloat16)
                       # f32 weights at the dense zoo's widths (ZOO_NORM_SHAPES)
                       + _norm_width_cases(torch, timer, randn, ZOO_NORM_SHAPES,
                                           ZOO_NORM_SHAPES, torch.float32))

    rows["paged_attention"] = _paged_cases(torch, timer, randn, gen)

    # flash attention: prefill B=1 at S=512 and a ragged S=300
    for s, dtype in ((512, torch.bfloat16), (300, torch.bfloat16), (300, torch.float32)):
        q = randn(1, h, s, dh, dtype=dtype)
        k = randn(1, kh, s, dh, dtype=dtype)
        v = randn(1, kh, s, dh, dtype=dtype)
        got, route = flash_routed(flash_attention, q, k, v)
        rows["flash_attention"].append(_case(
            torch, "flash_attention", str(dtype).split(".")[1], [1, h, kh, s, dh],
            got, flash_attention_torch(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            work=flash_work(q, k, v), extra=route,
        ))

    # arctic-480b's prefill: H=56 over KH=8, D=128 (wgmma)
    q = randn(1, 56, 512, 128, dtype=torch.bfloat16)
    k, v = (randn(1, 8, 512, 128, dtype=torch.bfloat16) for _ in range(2))
    got, route = flash_routed(flash_attention, q, k, v)
    arctic_row = _case(
        torch, "flash_attention", "bfloat16", [1, 56, 8, 512, 128],
        got, flash_attention_torch(q, k, v), timer,
        lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        work=flash_work(q, k, v), extra=route,
    )

    # zamba2-7b's shared attention block: H = KH = 32, head dim 112
    zh, zd = 32, 112
    q, k, v = (randn(1, zh, 512, zd, dtype=torch.bfloat16) for _ in range(3))
    got, route = flash_routed(flash_attention, q, k, v)
    rows["flash_attention"].append(_case(
        torch, "flash_attention", "bfloat16", [1, zh, zh, 512, zd],
        got, flash_attention_torch(q, k, v), timer,
        lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        work=flash_work(q, k, v), extra=route,
    ))
    # B=2 at a ragged S: the sequence edge at a (b, h) boundary, D=112 in two
    # column boxes
    q, k, v = (randn(2, zh, 300, zd, dtype=torch.bfloat16) for _ in range(3))
    got, route = flash_routed(flash_attention, q, k, v)
    rows["flash_attention"].append(_case(
        torch, "flash_attention", "bfloat16", [2, zh, zh, 300, zd],
        got, flash_attention_torch(q, k, v), timer,
        lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        work=flash_work(q, k, v), extra=route,
    ))
    # v's head dim apart from q's: the reference test's qk 48 / v 32 in f32
    # (the CUDA cores) and bf16 (wgmma), deepseek-v2's MLA prefill, H = KH =
    # 128, qk 192 / v 128 (wgmma: three column boxes for q and k, two for
    # v); and a bf16 head dim that is not a multiple of 8 (the CUDA cores)
    for (hh, s, dqk, dv), dtype in (((4, 128, 48, 32), torch.float32),
                                    ((4, 128, 48, 32), torch.bfloat16),
                                    ((128, 512, 192, 128), torch.bfloat16),
                                    ((8, 300, 100, 100), torch.bfloat16)):
        q, k = randn(1, hh, s, dqk, dtype=dtype), randn(1, hh, s, dqk, dtype=dtype)
        v = randn(1, hh, s, dv, dtype=dtype)
        got, route = flash_routed(flash_attention, q, k, v)
        rows["flash_attention"].append(_case(
            torch, "flash_attention", str(dtype).split(".")[1],
            {"B": 1, "H": hh, "KH": hh, "S": s, "Dqk": dqk, "Dv": dv},
            got, flash_attention_torch(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            work=flash_work(q, k, v), extra=route,
        ))
    rows["flash_attention"].append(arctic_row)
    # the zoo's dense heads at a 512-token prefill (wgmma)
    for zh, zkh, zd in ZOO_HEADS:
        q = randn(1, zh, 512, zd, dtype=torch.bfloat16)
        k, v = (randn(1, zkh, 512, zd, dtype=torch.bfloat16) for _ in range(2))
        got, route = flash_routed(flash_attention, q, k, v)
        rows["flash_attention"].append(_case(
            torch, "flash_attention", "bfloat16", [1, zh, zkh, 512, zd],
            got, flash_attention_torch(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=zkh != zh),
            work=flash_work(q, k, v), extra=route,
        ))
    rows["flash_attention_bwd"] = _flash_bwd_cases(torch, timer, randn)
    rows["rmsnorm_bwd"] = _norm_bwd_cases(torch, timer, randn)
    rows["ssd_chunks"] = _ssd_cases(torch, timer, randn, gen)
    rows.update(_offload_kernel_cases(torch, timer, randn))
    return rows


def _repeat_identical(torch, name: str, run) -> None:
    """Two calls on the same inputs give the same bits (no atomics, fixed
    reduction orders: the train loop's restart is held to the bit)."""
    first, second = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def _flash_bwd_cases(torch, timer, randn) -> list:
    """The flash backward kernel against its plain version
    (``attention_chunked.flash_attention_bwd_torch``, the reference's
    ``_core_bwd``) on the forward kernel's own ``out`` and ``lse`` (the
    forward's ``lse`` itself held against the plain forward's): llama's
    train shape (B 8, H 32, KH 8, S 512, D 64, bf16; the headline; the
    wgmma route), bf16 and f32 at B 2 and a ragged S 300 (the wgmma
    route's padded edge; the CUDA cores), deepseek-v2's MLA prefill (qk
    192 / v 128, H = KH = 128, S 512, bf16: wgmma, dK / dV on two consumer
    warpgroups), qk 256 / v 128 at H 16 over KH 4 and a ragged S 300
    (four column boxes, a group), the same qk 192 / v 128 in f32 (the CUDA
    cores' 32-row tiles), and on the wgmma route zamba2's shared attention
    (H = KH = 32, D 112: two column boxes, zero-filled past 112) and
    arctic's (H 56, KH 8, D 128).  Each row names its route and is called
    twice, bit for bit; a row past D 128 on wgmma gives its kernels' own
    device ms (``ms_by_kernel``: the delta pass, dK / dV, dQ).  The
    library call is the backward alone of ``F.scaled_dot_product_attention``
    (causal, GQA), through ``torch.autograd.grad`` from a kept graph."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention as fa
    from repro_torch.kernels.attention_chunked import _chunked_fwd_core, flash_attention_bwd_torch

    rows = []
    for b, h, kh, s, d, dv, dtype in ((8, 32, 8, 512, 64, 64, torch.bfloat16),
                                      (2, 32, 8, 300, 64, 64, torch.bfloat16),
                                      (2, 32, 8, 300, 64, 64, torch.float32),
                                      (1, 128, 128, 512, 192, 128, torch.bfloat16),
                                      (1, 16, 4, 300, 256, 128, torch.bfloat16),
                                      (1, 8, 8, 300, 192, 128, torch.float32),
                                      (1, 32, 32, 512, 112, 112, torch.bfloat16),
                                      (1, 56, 8, 512, 128, 128, torch.bfloat16),
                                      # pixtral-12b's train shape (phase 29)
                                      (2, 32, 8, 512, 128, 128, torch.bfloat16)):
        q, k = randn(b, h, s, d, dtype=dtype), randn(b, kh, s, d, dtype=dtype)
        v, do = randn(b, kh, s, dv, dtype=dtype), randn(b, h, s, dv, dtype=dtype)
        out, lse = fa._flash_cuda(q, k, v, True, with_lse=True)
        args = (q, k, v, out, lse, do)
        before = dict(fa.flash_attention_bwd.routes)
        got = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd(*args)), lse=lse)
        (route,) = [r for r, n in fa.flash_attention_bwd.routes.items() if n > before[r]]
        want = dict(zip(("dq", "dk", "dv"), flash_attention_bwd_torch(*args)),
                    lse=_chunked_fwd_core(q, k, v, True, s, s)[1].reshape(b, h, s))
        _repeat_identical(torch, "flash_attention_bwd", lambda: fa.flash_attention_bwd(*args))
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=kh != h)

        def library():
            torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

        name = str(dtype).split(".")[1]
        extra = {"route": route, "repeat_bit_identical": True}
        if route == "wgmma" and d > 128:
            extra["ms_by_kernel"] = _kernel_split(
                torch, timer, lambda: fa.flash_attention_bwd(*args), ("flash_bwd_",))
        rows.append(_case(
            torch, "flash_attention_bwd", name,
            {"B": b, "H": h, "KH": kh, "S": s, "Dqk": d, "Dv": dv}, got, want, timer,
            lambda: fa.flash_attention_bwd(*args), lambda: flash_attention_bwd_torch(*args),
            None, tol={**{k_: TOL[name] for k_ in ("dq", "dk", "dv")}, "lse": TOL["float32"]},
            work=fa.flash_bwd_work(q, k, v), extra=extra, library_eager=library,
        ))
    return rows


#: the RMSNorm backward's kernels, by a substring of their names (this
#: design's and the one before it: the A/B runs this tree's cases on both)
NORM_BWD_KERNEL_NAMES = ("norm_bwd", "dw_kernel")


def _kernel_split(torch, timer, fn, names, reps: int = 20) -> dict:
    """Device ms a call of each kernel that ``fn`` launches whose name holds
    one of ``names``, from the profiler's kernel events over ``reps`` eager
    calls, each after the L2 flush (cold, as :meth:`Timer.ms`).  A
    programmatic dependent's duration includes its wait for its primary."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    device, _ = _device_events(prof)
    return {k[:60]: v / reps for k, v in device.items() if any(n in k for n in names)}


def _norm_bwd_cases(torch, timer, randn) -> list:
    """The RMSNorm backward kernel against its plain version
    (``rmsnorm_bwd_torch``), plain and add forms at llama's train shape
    (4096 rows of 2048, bf16 x, f32 w; plain is the headline), f32 at a
    ragged d = 100 (512 rows, the scalar path), and 4096 bf16 rows of
    deepseek-v2's 512-wide ``kv_norm`` (bf16 w: a warp a row) and of
    arctic-480b's d = 7168 (two chunks a thread), plain and add; and the
    add form at a ragged d = 2050 (bf16 elements tpr apart, a bf16 weight)
    and at d = 9000 (the two-pass loop).  dx is held to the type's
    ``TOL``, dw to ``NORM_DW_TOL`` (f32 w) or ``TOL`` (bf16 w).  Each row gives the device ms of each of the backward's kernels
    (``ms_by_kernel``, profiler events).  The library call is
    ``F.rms_norm``'s backward (weight in x's type) through
    ``torch.autograd.grad`` from a kept graph."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    rows, eps = [], 1e-5
    for n_rows, d, dtype, form, wdtype in (
            (4096, 2048, torch.bfloat16, "plain", torch.float32),
            (4096, 2048, torch.bfloat16, "add", torch.float32),
            (512, 100, torch.float32, "plain", torch.float32),
            (512, 100, torch.float32, "add", torch.float32),
            (4096, 512, torch.bfloat16, "plain", torch.bfloat16),
            (4096, 7168, torch.bfloat16, "plain", torch.float32),
            (4096, 7168, torch.bfloat16, "add", torch.float32),
            # the layouts off the main paths: bf16 elements tpr apart (d %
            # 8 != 0) and rows past the registers (the two-pass loop)
            (256, 2050, torch.bfloat16, "add", torch.bfloat16),
            (64, 9000, torch.bfloat16, "add", torch.float32),
            # pixtral-12b's train step (phase 29): B 2 x S 512 rows of 5120
            (1024, 5120, torch.bfloat16, "plain", torch.float32),
            (1024, 5120, torch.bfloat16, "add", torch.float32)):
        x, dy = randn(n_rows, d, dtype=dtype), randn(n_rows, d, dtype=dtype)
        ds = randn(n_rows, d, dtype=dtype) if form == "add" else None
        w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(wdtype)
        name, wname = (str(t).split(".")[1] for t in (dtype, wdtype))
        got = dict(zip(("dx", "dw"), rn.rmsnorm_bwd(x, dy, w, eps, ds=ds)))
        want = dict(zip(("dx", "dw"), rn.rmsnorm_bwd_torch(x, dy, w, eps, ds=ds)))
        _repeat_identical(torch, "rmsnorm_bwd", lambda: rn.rmsnorm_bwd(x, dy, w, eps, ds=ds))
        xl = x.detach().clone().requires_grad_(True)
        wl = w.to(dtype).requires_grad_(True)
        lib_out = F.rms_norm(xl, (d,), wl, eps)

        def library():
            torch.autograd.grad(lib_out, (xl, wl), dy, retain_graph=True)

        def run():
            return rn.rmsnorm_bwd(x, dy, w, eps, ds=ds)

        rows.append(_case(
            torch, "rmsnorm_bwd", name, [n_rows, d], got, want, timer, run,
            lambda: rn.rmsnorm_bwd_torch(x, dy, w, eps, ds=ds), None,
            tol={"dx": TOL[name], "dw": NORM_DW_TOL if wname == "float32" else TOL[wname]},
            work=rn.norm_bwd_work(x, w, form == "add"),
            extra={"form": form, "w": wname, "repeat_bit_identical": True,
                   "ms_by_kernel": _kernel_split(torch, timer, run, NORM_BWD_KERNEL_NAMES)},
            library_eager=library,
        ))
    return rows


def _norm_plain_cases(torch, timer, randn) -> list:
    """RMSNorm's plain form with an f32 weight (the cases the first kernel
    also takes): llama3.2-1b's decode (8 rows) and prefill (512 rows) of d
    = 2048 in bf16 (the headline first), f32 decode, then the scalar path at
    ragged widths (f32 d = 100, bf16 d = 2050) and a bf16 row past the
    registers (d = 20480, the two-pass loop).  ``F.rms_norm`` is the
    library call (weight in x's type)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import norm_work, rmsnorm, rmsnorm_torch

    rows, eps = [], 1e-5
    bf16, f32 = torch.bfloat16, torch.float32
    for n_rows, d, dtype in ((8, 2048, bf16), (512, 2048, bf16), (8, 2048, f32),
                             (8, 100, f32), (8, 2050, bf16), (8, 20480, bf16)):
        x = randn(n_rows, d, dtype=dtype)
        w = 1.0 + 0.1 * randn(d, dtype=f32)
        w_lib = w.to(dtype)
        rows.append(_case(
            torch, "rmsnorm", str(dtype).split(".")[1], [n_rows, d],
            rmsnorm(x, w, eps), rmsnorm_torch(x, w, eps), timer,
            lambda: rmsnorm(x, w, eps), lambda: rmsnorm_torch(x, w, eps),
            lambda: F.rms_norm(x, (d,), w_lib, eps), work=norm_work("plain", x, w),
            extra={"form": "plain", "w": "float32"},
        ))
    return rows


def _norm_width_cases(torch, timer, randn, plain_shapes, add_shapes, wdtype) -> list:
    """RMSNorm at the zoo's widths, bf16 x and a weight of ``wdtype`` (the
    config's parameter type): the plain form at ``plain_shapes``
    (``F.rms_norm`` the library call), then the add form (the fused
    residual chain; s bit for bit) at ``add_shapes``, each (rows, d)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    rows, eps = [], 1e-5
    bf16, wname = torch.bfloat16, str(wdtype).split(".")[1]
    for n_rows, d in plain_shapes:
        x = randn(n_rows, d, dtype=bf16)
        w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(wdtype)
        w_lib = w.to(bf16)
        rows.append(_case(
            torch, "rmsnorm", "bfloat16", [n_rows, d],
            rn.rmsnorm(x, w, eps), rn.rmsnorm_torch(x, w, eps), timer,
            lambda: rn.rmsnorm(x, w, eps), lambda: rn.rmsnorm_torch(x, w, eps),
            lambda: F.rms_norm(x, (d,), w_lib, eps), work=rn.norm_work("plain", x, w),
            extra={"form": "plain", "w": wname},
        ))
    for n_rows, d in add_shapes:
        x, delta = randn(n_rows, d, dtype=bf16), randn(n_rows, d, dtype=bf16)
        w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(wdtype)
        got = dict(zip("sy", rn.add_rmsnorm(x, delta, w, eps)))
        want = dict(zip("sy", rn.add_rmsnorm_torch(x, delta, w, eps)))
        rows.append(_case(
            torch, "rmsnorm", "bfloat16", [n_rows, d], got, want, timer,
            lambda: rn.add_rmsnorm(x, delta, w, eps),
            lambda: rn.add_rmsnorm_torch(x, delta, w, eps), None,
            work=rn.norm_work("add", x, w), tol={"s": (0.0, 0.0), "y": TOL["bfloat16"]},
            extra={"form": "add", "w": wname},
        ))
    return rows


def _norm_fused_cases(torch, timer, randn) -> list:
    """RMSNorm's plain form with a bf16 weight, the add form (x + delta
    then the norm; s must match its plain version bit for bit) at llama's
    decode and prefill, and the gated form (Mamba-2's (y + D x) silu(z)
    norm, y f32) at mamba2-2.7b's decode (8 x 80 heads x 64) and prefill
    (512 rows of 5120), zamba2-7b's decode (8 x 112 x 64), an f32 prefill
    (the f32 traces' path) and a ragged bf16 shape (head dim 20, odd
    strides: the scalar path).  As in the Mamba-2 block, x and z are
    column slices of wider tensors, read in place.  No single PyTorch call
    computes a fused form."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    rows, eps = [], 1e-5
    bf16, f32 = torch.bfloat16, torch.float32
    for n_rows, d in ((8, 2048), (512, 2048)):
        x = randn(n_rows, d, dtype=bf16)
        w = (1.0 + 0.1 * randn(d, dtype=f32)).to(bf16)
        rows.append(_case(
            torch, "rmsnorm", "bfloat16", [n_rows, d],
            rn.rmsnorm(x, w, eps), rn.rmsnorm_torch(x, w, eps), timer,
            lambda: rn.rmsnorm(x, w, eps), lambda: rn.rmsnorm_torch(x, w, eps),
            lambda: F.rms_norm(x, (d,), w, eps), work=rn.norm_work("plain", x, w),
            extra={"form": "plain", "w": "bfloat16"},
        ))
    for n_rows, d in ((8, 2048), (512, 2048)):
        x, delta = randn(n_rows, d, dtype=bf16), randn(n_rows, d, dtype=bf16)
        w = 1.0 + 0.1 * randn(d, dtype=f32)
        got = dict(zip("sy", rn.add_rmsnorm(x, delta, w, eps)))
        want = dict(zip("sy", rn.add_rmsnorm_torch(x, delta, w, eps)))
        rows.append(_case(
            torch, "rmsnorm", "bfloat16", [n_rows, d], got, want, timer,
            lambda: rn.add_rmsnorm(x, delta, w, eps),
            lambda: rn.add_rmsnorm_torch(x, delta, w, eps), None,
            work=rn.norm_work("add", x, w), tol={"s": (0.0, 0.0), "y": TOL["bfloat16"]},
            extra={"form": "add", "w": "float32"},
        ))
    for b, s, h, p, n, dtype in ((8, 1, 80, 64, 128, bf16), (1, 512, 80, 64, 128, bf16),
                                 (8, 1, 112, 64, 64, bf16), (1, 100, 80, 64, 128, f32),
                                 (2, 3, 6, 20, 3, bf16)):
        di = h * p
        zxbcdt = randn(b, s, 2 * di + 2 * n + h, dtype=dtype)
        xbc = randn(b, s, di + 2 * n, dtype=dtype)
        z, x = zxbcdt[..., :di], xbc[..., :di].reshape(b, s, h, p)
        y = randn(b, s, h, p, dtype=f32)
        d_skip = 1.0 + 0.1 * randn(h, dtype=f32)
        w = 1.0 + 0.1 * randn(di, dtype=f32)
        args = (y, x, d_skip, z, w, eps)
        name = str(dtype).split(".")[1]
        rows.append(_case(
            torch, "rmsnorm", name, {"B": b, "S": s, "H": h, "P": p, "N": n},
            rn.gated_rmsnorm(*args), rn.gated_rmsnorm_torch(*args), timer,
            lambda: rn.gated_rmsnorm(*args), lambda: rn.gated_rmsnorm_torch(*args), None,
            work=rn.norm_work("gated", z, w, d_skip),
            extra={"form": "gated", "w": "float32"},
        ))
    return rows


def _paged_cases(torch, timer, randn, gen) -> list:
    """Paged attention against its plain version: llama3.2-1b's decode at
    B=8 with ragged lengths up to 1024 (the headline), an extend chunk
    (S=4), the MLA operands (G=16, 512 + 64 dims), f32 decode, zamba2-7b's
    shared block (H = KH = 32, head dim 112), all eight slots near 1024
    positions, and B=1 with a one-page table (one split).  Then two shapes
    TMA does not take, whose pages come by cp.async: bf16 rows of 64 bytes
    (the reference tests' head dim 32, pages of 8, an S=4 chunk) on the
    tensor cores, and f32 head dim 20 with pages of 7 on the CUDA cores.
    Last, a long table: llama's heads at 16k positions in pages of one
    (16384 pages, more page ids a split than a CTA has threads, more than
    32 splits).  Last, chunked prefill's extend at llama's shape: one slot,
    a 128-token chunk from position 384 (tensor-core walk, 512 rows a kv
    head).  Then deepseek-v2's MLA (one latent pool as keys and values,
    rope 64) at decode and at 16- and 128-token chunks, and a reduced
    latent (256 wide, rope 32, pages of 8), each on the latent walk (the
    wgmma route, ``paged_route``), and arctic-480b's decode.  Null pages are
    poisoned.  Each row names its walk (``route``) and its split plan's
    ``n_splits``."""
    from repro_torch.kernels import paged_attention as pa

    h, kh, dh = 32, 8, 64
    dev = "cuda"

    def paged_case(b, hh, kkh, s, dk, dv, lengths, dtype, dr=0, ps=16, mp=None, latent=False,
                   expect=None):
        mp = mp or 1024 // ps
        n_pages = b * mp
        null = n_pages
        k_pool = randn(n_pages + 1, kkh, ps, dk, dtype=dtype)
        # latent: one pool is both keys and values, as MLA serves it
        v_pool = k_pool if latent else randn(n_pages + 1, kkh, ps, dv, dtype=dtype)
        k_pool[null] = 1e6  # poison: masked rows must never contribute
        v_pool[null] = 1e6
        q = randn(b, hh, s, dk, dtype=dtype)
        perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
        pages = perm.reshape(b, mp).clone()
        for i, ln in enumerate(lengths):
            pages[i, -(-(ln + s) // ps):] = null
        index = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = {}
        if dr:
            kr_pool = randn(n_pages + 1, 1, ps, dr, dtype=dtype)
            kr_pool[null] = 1e6
            kw = dict(q_rope=randn(b, hh, s, dr, dtype=dtype), kr_pool=kr_pool,
                      scale=1.0 / (dk + dr) ** 0.5)
        args = (q, k_pool, v_pool, pages, index)
        # the positions the lengths reach (the kernel's declared work counts
        # every position of the table's width: a trace has no lengths)
        work = pa.paged_work(q, k_pool, v_pool, pages, list(lengths), q_rope=kw.get("q_rope"))
        # the walk the launch took, from the wrapper's per-route counts (the
        # parent of a comparison, scripts/ab_parent_change.py, may have none)
        routes = dict(getattr(pa.paged_attention, "routes", {}))
        got = pa.paged_attention(*args, **kw)
        extra = {"route": next((r for r, n in getattr(pa.paged_attention, "routes", {}).items()
                                if n > routes[r]), None)}
        if hasattr(pa, "latent_plan") and extra["route"] == "latent":
            plan = pa.latent_plan(b, hh * s, mp, ps, dk, pa.sm_count(q.device))
        elif hasattr(pa, "sm_count"):  # the parent's may have no plan
            plan = pa.split_plan(b, kkh, mp, ps, dk, dv, pa.sm_count(q.device))
        else:
            plan = None
        if plan is not None:
            extra.update(n_splits=plan.n_splits, pages_per_split=plan.pages_per_split)
        if expect is not None and extra["route"] != expect:
            raise AssertionError(f"paged_attention: {extra['route']} route, {expect} expected")
        return _case(
            torch, "paged_attention", str(dtype).split(".")[1],
            {"B": b, "H": hh, "KH": kkh, "S": s, "Dk": dk, "Dv": dv, "Dr": dr,
             "page_size": ps, "max_pages": mp, "lengths": list(lengths),
             **({"latent": True} if latent else {})},
            got, pa.paged_attention_torch(*args, **kw), timer,
            lambda: pa.paged_attention(*args, **kw), lambda: pa.paged_attention_torch(*args, **kw),
            None, work=work, extra=extra,
        )

    bf16 = torch.bfloat16
    decode_lengths = [1022, 700, 511, 256, 95, 16, 15, 0]
    # the MLA rows' walk and the others' (a parent without routes names none)
    latent_walk = "latent" if hasattr(pa, "paged_route") else None
    split_walk = "split" if hasattr(pa, "paged_route") else None
    return [
        paged_case(8, h, kh, 1, dh, dh, decode_lengths, bf16),
        paged_case(8, h, kh, 4, dh, dh, [1000, 300, 17, 0, 64, 5, 900, 250], bf16),
        paged_case(4, 16, 1, 1, 512, 512, [1022, 333, 64, 0], bf16, dr=64),
        paged_case(8, h, kh, 1, dh, dh, decode_lengths, torch.float32),
        paged_case(8, 32, 32, 1, 112, 112, [512, 600, 480, 520, 530, 400, 511, 450], bf16),
        paged_case(8, h, kh, 1, dh, dh, [1023, 1022, 1020, 1018, 1016, 1010, 1005, 1000], bf16),
        paged_case(1, h, kh, 1, dh, dh, [9], bf16, mp=1),
        paged_case(2, 4, 2, 4, 32, 32, [70, 0], bf16, ps=8, mp=16),
        paged_case(2, 4, 2, 1, 20, 20, [40, 3], torch.float32, ps=7, mp=8),
        paged_case(2, h, kh, 1, dh, dh, [16380, 9000], bf16, ps=1, mp=16384),
        # phase 11's chunk: 128 tokens extended from position 384
        paged_case(1, h, kh, 128, dh, dh, [384], bf16),
        # deepseek-v2's MLA decode (G = 128 query rows over the 512-wide
        # latent, keys and values, with 64 rope dims), a 16-token extend
        # chunk from position 384 (phase 14's) and a 128-token one (phase
        # 16's), each on the latent walk; arctic-480b's GQA decode (H=56,
        # KH=8)
        paged_case(8, 128, 1, 1, 512, 512, decode_lengths, bf16, dr=64, latent=True,
                   expect=latent_walk),
        paged_case(1, 128, 1, 16, 512, 512, [384], bf16, dr=64, latent=True, expect=latent_walk),
        paged_case(1, 128, 1, CHUNK, 512, 512, [384], bf16, dr=64, latent=True,
                   expect=latent_walk),
        # the latent walk off deepseek's widths: a 256-wide latent (boxes
        # past it zeros), rope 32, pages of 8, a second 64-row tile half full
        paged_case(2, 24, 1, 4, 256, 256, [37, 150], bf16, dr=32, ps=8, mp=32, latent=True,
                   expect=latent_walk),
        paged_case(8, 56, 8, 1, 128, 128, decode_lengths, bf16),
        # the zoo's dense heads at decode, 8 slots at ~512-token contexts
        *(paged_case(8, zh, zkh, 1, zd, zd, ZOO_DECODE_LENGTHS, bf16, expect=split_walk)
          for zh, zkh, zd in ZOO_HEADS),
    ]


def _ssd_cases(torch, timer, randn, gen) -> list:
    """The SSD chunk kernel at mamba2-2.7b's prefill of a 512-token prompt
    (H=80, P=64, N=128, L=128), a ragged 97-token prompt (one chunk of
    L=97) and zamba2-7b's (H=112, N=64): x, B and C in bf16 as the main
    path gives them, dt in the models' initial range [1e-3, 0.1], a from
    -U[1, 16).  A fourth case takes mamba2's shape with slow decay (dt in
    [1e-3, 2e-3], a from -U[1, 1.1)), so that cumdecay and totals stay of
    order 1 across the chunk.  Then the shapes past the first kernel's
    limits: mamba2's at chunk 256 (Mamba-2's published default) and N =
    256 with P = 128 at 8 heads, each in bf16 and in f32 (the f32 route).
    Each of the four outputs is compared on its own.  The bound counts the
    function's work once, at the inputs' type: C B^T once per (batch,
    chunk), its causal lower triangle only, and per head W x (the same
    triangle) and the state product."""
    from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_torch, ssd_work

    names = ("y", "states", "cumdecay", "totals")
    rows = []
    b = 1
    fast = ((1e-3, 0.1), (1.0, 16.0))  # (dt range, -a range)
    slow = ((1e-3, 2e-3), (1.0, 1.1))
    bf16, f32 = torch.bfloat16, torch.float32
    for s, h, p, n, chunk, ((dt0, dt1), (a0, a1)), dtype in (
        (512, 80, 64, 128, 128, fast, bf16), (97, 80, 64, 128, 97, fast, bf16),
        (512, 112, 64, 64, 128, fast, bf16), (512, 80, 64, 128, 128, slow, bf16),
        (512, 80, 64, 128, 256, fast, bf16), (512, 8, 128, 256, 128, fast, bf16),
        (512, 80, 64, 128, 256, fast, f32), (512, 8, 128, 256, 128, fast, f32),
    ):
        x = randn(b, s, h, p, dtype=dtype)
        bm = randn(b, s, n, dtype=dtype)
        cm = randn(b, s, n, dtype=dtype)
        dt = dt0 + (dt1 - dt0) * torch.rand((b, s, h), generator=gen, device="cuda")
        a = -(a0 + (a1 - a0) * torch.rand((h,), generator=gen, device="cuda"))
        args = (x, dt, a, bm, cm)
        shape = {"B": b, "S": s, "H": h, "P": p, "N": n, "L": chunk,
                 "dt": [dt0, dt1], "minus_a": [a0, a1]}
        name = str(dtype).split(".")[1]
        rows.append(_case(
            torch, "ssd_chunks", name, shape,
            dict(zip(names, ssd_chunks(*args, chunk=chunk))),
            dict(zip(names, ssd_chunks_torch(*args, chunk=chunk))),
            timer, lambda: ssd_chunks(*args, chunk=chunk),
            lambda: ssd_chunks_torch(*args, chunk=chunk), None,
            work=ssd_work(x, n, chunk), tol=SSD_TOL,
            extra={"route": "wgmma" if dtype == bf16 else "cuda_cores"},
        ))
    return rows


def _offload_kernel_cases(torch, timer, randn) -> dict:
    """The offload shelf at the paper's scale (2048^2, f32): one DFT stage
    of fft2d, the LU's first trailing update at n=2048, nb=128 (and one of
    n=192, nb=32), and a 2048^3 matmul; then ragged shapes whose N or K is
    not a multiple of 4, which the wrappers pad for TMA.  The three kernels
    run 3xTF32 on the tensor cores: each bound counts the product once at
    the TF32 peak, and each row shows the three passes' floor too."""
    from repro_torch.kernels.fft import complex_matmul, complex_matmul_torch, complex_matmul_work
    from repro_torch.kernels.matmul import (
        matmul,
        matmul_torch,
        matmul_work,
        schur_update,
        schur_update_torch,
        schur_work,
    )
    from repro_torch.launch.mesh import HW

    f32 = torch.float32
    rows: dict[str, list] = {"complex_matmul": [], "schur_update": [], "matmul": []}

    def floor(work):
        return {"floor_3xtf32_ms": work.passes * work.flops / HW.peak(work.peak) * 1e3}

    for m, nn, k in ((2048, 2048, 2048), (99, 99, 99)):
        ar, ai = randn(m, k, dtype=f32), randn(m, k, dtype=f32)
        br, bi = randn(k, nn, dtype=f32), randn(k, nn, dtype=f32)
        ac, bc = torch.complex(ar, ai), torch.complex(br, bi)
        kw = dict(block_m=min(m, 128), block_n=min(nn, 128), block_k=min(k, 128))
        work = complex_matmul_work(m, nn, k)
        rows["complex_matmul"].append(_case(
            torch, "complex_matmul", "float32", [m, nn, k],
            torch.cat(complex_matmul(ar, ai, br, bi, **kw)), torch.cat(complex_matmul_torch(ar, ai, br, bi)),
            timer, lambda: complex_matmul(ar, ai, br, bi, **kw), lambda: complex_matmul_torch(ar, ai, br, bi),
            lambda: torch.matmul(ac, bc), work=work, tol=GEMM_TOL, extra=floor(work),
        ))
    # the trailing update A22 -= L21 @ U12 right after the first panel, and
    # a ragged one
    for (m, nn, k), (bm, bn) in (((1920, 1920, 128), (128, 128)), ((160, 160, 32), (32, 32)),
                                  ((100, 100, 30), (100, 100))):
        c, a, b = randn(m, nn, dtype=f32), randn(m, k, dtype=f32), randn(k, nn, dtype=f32)
        blk = dict(block_m=bm, block_n=bn, block_k=k)
        work = schur_work(m, nn, k)
        rows["schur_update"].append(_case(
            torch, "schur_update", "float32", [m, nn, k],
            schur_update(c, a, b, **blk), schur_update_torch(c, a, b), timer,
            lambda: schur_update(c, a, b, **blk), lambda: schur_update_torch(c, a, b),
            lambda: torch.addmm(c, a, b, alpha=-1), work=work, tol=GEMM_TOL, extra=floor(work),
        ))
    for (m, nn, k), blk in (((2048, 2048, 2048), 128), ((96, 160, 96), 32), ((99, 99, 99), 99)):
        a, b = randn(m, k, dtype=f32), randn(k, nn, dtype=f32)
        kw = dict(block_m=blk, block_n=blk, block_k=blk)
        work = matmul_work(m, nn, k)
        rows["matmul"].append(_case(
            torch, "matmul", "float32", [m, nn, k], matmul(a, b, **kw), matmul_torch(a, b), timer,
            lambda: matmul(a, b, **kw), lambda: matmul_torch(a, b), lambda: torch.matmul(a, b),
            work=work, tol=GEMM_TOL, extra=floor(work),
        ))
    return rows


def _engine_trace(ServeEngine, Request, cfg, params, prompts, gens, **kw):
    engine = ServeEngine(cfg, params=params, seed=0, device="cuda", **kw)
    ids = [engine.submit(Request(p, max_new_tokens=g)) for p, g in zip(prompts, gens)]
    engine.run_until_idle(max_steps=10_000)
    return [engine.completions[i].tokens for i in ids], engine


def phase_served_f32(torch, arch: str = "llama3.2-1b", lens=(37, 100, 16, 70, 37, 100),
                     gens=(12, 6, 10, 8, 5, 7), **kw) -> None:
    """Full-width ``arch`` cut to 2 layers in f32: kernels vs plain, on
    prompts of ``lens`` tokens that generate ``gens`` tokens each.  With
    ``prefill_bucket`` the repeated padded lengths replay their prefill
    graphs; without, prefill runs eagerly.  With ``prefill_chunk`` the
    longer prompts run as chunks, whose programs must replay, under a
    tracer with one ``prefill-chunk`` span a chunk."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import blocks
    from repro_torch.models import lm
    from repro_torch.obs import Tracer
    from repro_torch.serve import Request, ServeEngine

    _free_dead_engines(torch)
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32")
    cfg = cfg.cut(2)
    # cast once: both engines then share the f32 matrices (deepseek-v2's
    # two layers hold ~22 GB of them)
    params = lm.cast_for_compute(lm.init_params(cfg, seed=1, device="cuda"), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    kw = dict(dict(n_slots=2, max_len=128, page_size=16), **kw)
    plain = {"rmsnorm": "torch", "attention": "torch", "paged_attention": "torch",
             "ssd_scan": "torch"}
    chunked = kw.get("prefill_chunk") is not None
    t0 = time.perf_counter()
    kernels, engine = _engine_trace(ServeEngine, Request, cfg, params, prompts, gens,
                                    tracer=Tracer() if chunked else None, **kw)
    with blocks.bind(plain):
        plain_tokens, plain_engine = _engine_trace(
            ServeEngine, Request, cfg, params, prompts, gens, **kw)
    if kernels != plain_tokens:
        raise AssertionError(
            f"f32 served trace differs: kernels {kernels} vs plain {plain_tokens}")
    graphs, plain_graphs = engine.graph_stats(), plain_engine.graph_stats()
    bucketed = kw.get("prefill_bucket") is not None
    for g in (graphs, plain_graphs):
        _check_graphs("served_f32", g)
        if (g["prefill"]["replays"] > 0) != bucketed or (g["prefill"]["captures"] > 0) != bucketed:
            raise AssertionError(f"served_f32: prefill graphs {g['prefill']} with "
                                 f"prefill_bucket={kw.get('prefill_bucket')}")
        if chunked and not (g["extend"]["replays"] > 0 and g["extend_sample"]["replays"] > 0):
            raise AssertionError(f"served_f32: chunk programs never replayed: "
                                 f"{g['extend']} {g['extend_sample']}")
    out = {"phase": "served_f32", "arch": cfg.name, "layers": 2, "requests": len(prompts),
           "prefill_bucket": kw.get("prefill_bucket"), "prefill_chunk": kw.get("prefill_chunk"),
           "identical": True, "tokens": [list(t) for t in kernels],
           "graphs": graphs, "plain_graphs": plain_graphs}
    if chunked:
        spans = sum(1 for r in engine.tracer.records() if r.name == "prefill-chunk")
        chunks = engine.stats.prefill_chunks
        if spans != chunks or chunks != plain_engine.stats.prefill_chunks or chunks <= 0:
            raise AssertionError(f"served_f32: {spans} prefill-chunk spans, "
                                 f"{chunks} chunks ({plain_engine.stats.prefill_chunks} plain)")
        out.update(prefill_chunks=chunks, prefill_chunk_spans=spans,
                   overlap_tokens=engine.overlap_tokens)
    out["seconds"] = round(time.perf_counter() - t0, 3)
    emit(out)


def _check_graphs(phase: str, stats: dict, decode_steps: int | None = None) -> None:
    """Decode captures at most once per sampling policy and replays every
    step after its key's first call."""
    dec = stats["decode"]
    if dec["captures"] > 3 or dec["eager_calls"] > 3:
        raise AssertionError(f"{phase}: decode captured {dec['captures']} times, "
                             f"{dec['eager_calls']} eager calls (at most 3 each)")
    if decode_steps is not None and dec["replays"] + dec["eager_calls"] != decode_steps:
        raise AssertionError(f"{phase}: {decode_steps} decode steps, but {dec['replays']} "
                             f"replays and {dec['eager_calls']} eager calls")


def _free_dead_engines(torch) -> None:
    """Free the engines of earlier phases (an engine is a reference cycle:
    its step programs hold its methods), so a phase's ``peak_memory_gb``
    is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def _serve_config(arch: str):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "zamba2-7b":  # full width, depth cut to two shared sites
        cfg = dataclasses.replace(cfg, n_layers=len(ZAMBA2_PATTERN), block_pattern=ZAMBA2_PATTERN)
    layers = {**MOE_LAYERS, **ZOO_LAYERS}
    if arch in layers:  # full width, depth cut (first_k_dense keeps the dense layer)
        cfg = cfg.cut(layers[arch])
    return cfg


def phase_main_path(torch, arch: str = "llama3.2-1b", expect=SERVE_KERNELS,
                    phase: str = "main_path", report=None, prepare=None, **engine_kw) -> dict:
    """Full-width ``arch`` served by ``ServeEngine`` (default: llama3.2-1b
    from the paged KV cache); every kernel in ``expect`` must launch.
    ``prepare(engine)`` runs before the trace; ``report(engine, out)``
    checks the run further and adds to its line."""
    import numpy as np

    import repro_torch.kernels as kernels
    from repro_torch.serve import Request, ServeEngine

    cfg = _serve_config(arch)
    engine_kw = dict(dict(n_slots=8, max_len=1024, page_size=16), **engine_kw)
    _free_dead_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = t_phase = time.perf_counter()
    engine = ServeEngine(cfg, seed=0, device="cuda", **engine_kw)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    n_req, gen = 16, 32
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
               for _ in range(n_req)]
    if prepare is not None:
        prepare(engine)

    kernels.reset_launches()
    t0 = time.perf_counter()
    ids = [engine.submit(Request(p, max_new_tokens=gen)) for p in prompts]
    completions = engine.run_until_idle(max_steps=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.launch_counts().items() if k in expect}
    norm_forms = dict(kernels.KERNELS["rmsnorm"].forms)
    graphs = engine.graph_stats()

    if len(completions) != n_req:
        raise AssertionError(f"{len(completions)}/{n_req} requests completed")
    for i in ids:
        toks = engine.completions[i].tokens
        if len(toks) != gen or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {i}: bad tokens {toks}")
    missing = [k for k in expect if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{phase}: {arch} never launched {missing}: {launches}")
    missing = [f for f in NORM_FORMS[arch] if "rmsnorm" in expect and norm_forms[f] <= 0]
    if missing:
        raise AssertionError(f"{phase}: {arch} never took rmsnorm's {missing} form: {norm_forms}")

    stats = engine.stats
    _check_graphs(phase, graphs, stats.decode_steps)
    if graphs["decode"]["replays"] <= 0:
        raise AssertionError(f"{phase}: decode never replayed its graph: {graphs['decode']}")
    pct = lambda xs, q: float(np.percentile(xs, q))  # noqa: E731
    ttft = [c.ttft * 1e3 for c in completions]
    lat = [c.latency * 1e3 for c in completions]
    out = {
        "phase": phase, "arch": cfg.name, "layers": cfg.n_layers,
        "pattern": cfg.pattern() if cfg.block_pattern else None,
        "slots": engine.n_slots, "max_len": engine.max_len,
        "page_size": engine.kv.pool.page_size if engine.paged else None,
        "requests": n_req,
        "prompt_tokens": sum(len(p) for p in prompts), "generated_tokens": n_req * gen,
        "setup_seconds": setup, "wall_seconds": wall,
        "tok_per_s": n_req * gen / wall,
        "prefill_tok_per_s": engine.telemetry["prefill"].tokens_per_second,
        "prefill_seconds": engine.telemetry["prefill"].seconds,
        "decode_seconds": engine.telemetry["decode"].seconds,
        "decode_tok_per_s": engine.telemetry["decode"].tokens_per_second,
        "decode_median_ms": engine.median_decode_step() * 1e3,
        "ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
        "latency_p50_ms": pct(lat, 50), "latency_p99_ms": pct(lat, 99),
        "slot_reuses": stats.slot_reuses, "preemptions": stats.preemptions,
        "prefill_calls": stats.prefill_calls, "decode_steps": stats.decode_steps,
        "launches": launches, "rmsnorm_forms": norm_forms, "graphs": graphs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if "flash_attention" in expect:  # the routes the prefills' launches took
        out["flash_routes"] = dict(kernels.KERNELS["flash_attention"].routes)
    if "paged_attention" in expect:  # the walks paged attention's launches took
        out["paged_routes"] = dict(kernels.KERNELS["paged_attention"].routes)
    if report is not None:
        report(engine, out)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


#: phase 11's chunk width
CHUNK = 128


def phase_main_path_chunked(torch, main: dict) -> dict:
    """Phase 4's run with ``prefill_chunk=CHUNK``: paged attention launches
    more than in phase 4 (``main``), the chunk programs capture once a key
    and replay every later call, and each replays as its step function
    runs eagerly from the same cloned state."""

    def report(engine, out):
        graphs = out["graphs"]
        ext, fin = graphs["extend"], graphs["extend_sample"]
        if ext["captures"] != 1 or ext["eager_calls"] != 1 or ext["replays"] != ext["calls"] - 1:
            raise AssertionError(f"main_path_chunked: extend {ext}")
        if not (1 <= fin["captures"] <= 3 and fin["eager_calls"] == fin["captures"]
                and fin["replays"] == fin["calls"] - fin["eager_calls"]):
            raise AssertionError(f"main_path_chunked: extend_sample {fin}")
        if out["launches"]["paged_attention"] <= main["launches"]["paged_attention"]:
            raise AssertionError(f"main_path_chunked: paged_attention launched "
                                 f"{out['launches']['paged_attention']} times, phase 4 "
                                 f"{main['launches']['paged_attention']}")
        out["prefill_chunk"] = CHUNK
        out["prefill_chunks"] = engine.stats.prefill_chunks
        # positions the final chunks re-extended beyond their new tokens
        out["overlap_tokens"] = engine.overlap_tokens
        out["main_path"] = {k: main[k] for k in (
            "wall_seconds", "tok_per_s", "prefill_seconds", "decode_seconds",
            "decode_median_ms", "ttft_p50_ms", "ttft_p99_ms", "latency_p50_ms",
            "latency_p99_ms", "launches")}
        out["replay_vs_eager"] = [_chunk_replay_vs_eager(torch, engine, name)
                                  for name in ("extend", "extend_sample")]

    return phase_main_path(torch, phase="main_path_chunked", report=report, prefill_chunk=CHUNK)


def _chunk_replay_vs_eager(torch, engine, name: str) -> dict:
    """From one engine state (the cache cloned and restored in place), one
    replay of chunk program ``name`` and one eager call of its step
    function on the same inputs: a 128-token chunk from position 384 into
    slot 0, through the first pages of the pool (free once the run is
    done).  A key the run captured replays at once; one it did not (an MoE
    final chunk's width) takes its eager call and its capture first.  The
    pool, the index and (for ``extend_sample``) the logits are held to the
    compute type's ``TOL``; the errors are printed."""
    import numpy as np

    program = engine.programs[name]
    rng = np.random.default_rng(3)
    i32 = lambda v: np.asarray([v], np.int32)  # noqa: E731
    inputs = [i32(0), i32(384), np.arange(engine.kv.max_pages, dtype=np.int32)[None]]
    kw = {}
    if name == "extend_sample":
        inputs += [i32(11), i32(0), np.asarray([0.0], np.float32), i32(0)]
        kw = {"policy": "greedy"}
    inputs.append(rng.integers(0, engine.cfg.vocab_size, (1, CHUNK)).astype(np.int32))
    saved = _tree(torch.clone, engine.cache)

    def restore():
        _tree(lambda pair: pair[0].copy_(pair[1]), _zip_trees(engine.cache, saved))

    with torch.no_grad():
        for _ in range(2):  # a new key's eager call, then its capture and replay
            replays = program.summary()["replays"]
            out_g = program(inputs, **kw)
            if program.summary()["replays"] == replays + 1:
                break
            restore()
        else:
            raise AssertionError(f"replay_vs_eager: {name} did not replay")
        logits_g = out_g[1].clone() if out_g is not None else None
        graph_cache = _tree(torch.clone, engine.cache)
        restore()
        views = [torch.from_numpy(a.copy()).to(engine.device) for a in inputs]
        out_e = program.fn(*views, **kw)
        torch.cuda.synchronize()
        dtype = engine.cfg.compute_dtype
        errs = {}
        if logits_g is not None:
            errs["logits"] = compare(torch, logits_g, out_e[1], dtype)
        for key, group in graph_cache.items():
            if key == "index":
                if not torch.equal(group, engine.cache["index"]):
                    raise AssertionError(f"replay_vs_eager: {name} set the index differently")
                continue
            for leaf, value in group.items():
                errs[f"{key}/{leaf}"] = compare(torch, value, engine.cache[key][leaf], dtype)
        restore()
    return {"program": name, "tol": TOL[dtype], "max_abs_err": errs,
            "bit_identical": all(e == 0.0 for e in errs.values())}


def phase_decode_profile(torch, arch: str = "llama3.2-1b", sampled: bool = True,
                         phase: str = "decode_profile", **engine_kw) -> dict:
    """Where a full-width decode step's time goes, at 8 busy slots with
    ~512-token contexts: wall time per step unprofiled, then device time
    per step by kernel from ``torch.profiler`` over the same number of
    steps.  The busy share is device time over unprofiled wall time.  Then
    the decode graph's replay against an eager call (greedy; with
    ``sampled`` a top-k batch too) and the CUDA-event time of back-to-back
    decode steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule

    import repro_torch.kernels as kernels
    from repro_torch.serve import Request, ServeEngine

    cfg = _serve_config(arch)
    engine_kw = dict(dict(n_slots=8, max_len=1024, page_size=16), **engine_kw)
    _free_dead_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, seed=0, device="cuda", **engine_kw)
    rng = np.random.default_rng(2)
    for _ in range(8):
        engine.submit(Request(rng.integers(0, cfg.vocab_size, 512).tolist(), max_new_tokens=64))
    for _ in range(3):  # admits all 8, then warm decode steps
        engine.step()
    if len(engine.scheduler.active) != 8:
        raise AssertionError("profile: not all 8 slots are decoding")
    n = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n

    def profiled_window():
        # one decode step while the profiler warms up (its tracing starts,
        # nothing is kept), then the n steps it records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            engine.step()
            torch.cuda.synchronize()
            prof.step()
            counted, replays = kernels.counters(), engine.graph_stats()["decode"]["replays"]
            for _ in range(n):
                engine.step()
            torch.cuda.synchronize()
        if engine.graph_stats()["decode"]["replays"] - replays != n:
            raise AssertionError(f"{phase}: the {n} profiled decode steps were not all replays")
        added = {k: v - counted[k] for k, v in kernels.counters().items()}
        return (prof, *_replay_launches(prof, added, n))

    prof, replay_launches, first_window = profiled_window()
    if first_window:
        # a replay launches what its capture counted, so a miscount recurs in
        # every window, while a record the profiler lost (seen in rare
        # windows: one norm event short of 200) does not: the second window
        # must match exactly
        prof, replay_launches, missed = profiled_window()
        if missed:
            raise AssertionError(f"{phase}: " + "; ".join(first_window + missed))
    device, events = _device_events(prof)
    total = sum(device.values()) / n
    top = sorted(device.items(), key=lambda kv: -kv[1])[:10]
    out = {
        "phase": phase, "arch": cfg.name, "slots": 8, "context": 512, "steps": n,
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": total if device else None,
        "device_busy_share": total / wall_ms if device else None,
        "device_events_per_step": events / n,
        "replay_launches_per_step": replay_launches,
        # the first window's mismatches where a second window was taken
        "profiler_first_window_missed": first_window or None,
        # paged attention's split and merge kernels together
        "paged_device_ms_per_step": sum(v for k, v in device.items() if "paged" in k) / n,
        "top_device_ms_per_step": {k[:80]: v / n for k, v in top},
        "graphs": engine.graph_stats(),
    }
    if sampled:
        out["sampled"] = _sampler_cost(torch, cfg.vocab_size, wall_ms)
    out["replay_vs_eager"] = [_replay_vs_eager(torch, engine, policy)
                              for policy in (("greedy", "top_k") if sampled else ("greedy",))]
    out["replay_ms_per_step"] = _replay_ms(torch, engine)
    if sampled:  # the sampler inside the graph: a top-k batch's step
        out["replay_ms_per_step_top_k"] = _replay_ms(torch, engine, policy="top_k")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(out)
    return out


#: each counted kernel's device-side names (paged attention: a launch is a
#: split walk and its merge)
KERNEL_EVENTS = {"rmsnorm": ("norm_kernel",),
                 "paged_attention": ("paged_attention_split", "paged_attention_merge")}


def _replay_launches(prof, added: dict, n: int) -> tuple[dict, list[str]]:
    """Hold the launches that ``n`` profiled decode replays added to the
    wrappers' counts (the capture's counts, added at each replay) against
    the profiler's device events of those kernels: each counted launch
    must be one event of each of its kernel's names.  Returns the launches
    per step and the mismatches."""
    import re

    from torch.autograd import DeviceType

    names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    out, missed = {}, []
    for counter, kernel_names in KERNEL_EVENTS.items():
        for name in kernel_names:
            seen = sum(1 for ev in names if re.search(rf"(?<!\w){name}(?!\w)", ev))
            if seen != added[counter]:
                missed.append(f"{n} replays counted {added[counter]} {counter} launches, "
                              f"the profiler saw {seen} {name}")
        out[counter] = added[counter] / n
    return out, missed


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _decode_inputs(engine, policy: str) -> list:
    """The engine's decode inputs, the knobs set for ``policy`` (top-k: 40
    at temperature 0.8 in every slot)."""
    import numpy as np

    inputs = list(engine._decode_inputs())
    if policy != "greedy":
        n = engine.n_slots
        inputs[3] = np.full((n,), 0.8, np.float32)
        inputs[4] = np.full((n,), 40 if policy == "top_k" else 0, np.int32)
    return inputs


def _replay_vs_eager(torch, engine, policy: str) -> dict:
    """From one engine state (the cache cloned and restored in place), one
    replay of the decode graph of ``policy`` and one eager call of the
    program's underlying step function on the same inputs.  Logits and
    every cache leaf (the rows the step wrote; the rest is untouched by
    both) are held to the compute type's ``TOL``: cuBLAS may pick another
    algorithm on the capture stream, and the SSM state is computed from
    bf16 products.  The step's index advance must be the same."""
    program = engine.programs["decode"]
    inputs = _decode_inputs(engine, policy)
    saved = _tree(torch.clone, engine.cache)

    def restore():
        _tree(lambda pair: pair[0].copy_(pair[1]), _zip_trees(engine.cache, saved))

    with torch.no_grad():
        for _ in range(3):  # the key's eager call and capture, then a replay
            replays = program.summary()["replays"]
            tok_g, logits_g = (t.clone() for t in program(inputs, policy=policy))
            if program.summary()["replays"] > replays and program.summary()["captures"] > 0:
                break
            restore()
        else:
            raise AssertionError(f"replay_vs_eager: {policy} never replayed")
        graph_cache = _tree(torch.clone, engine.cache)
        restore()
        views = [torch.from_numpy(a.copy()).to(engine.device) for a in inputs]
        tok_e, logits_e = program.fn(*views, policy=policy)
        torch.cuda.synchronize()
        dtype = engine.cfg.compute_dtype
        errs = {"logits": compare(torch, logits_g, logits_e, dtype)}
        for key, group in graph_cache.items():
            if key == "index":
                if not torch.equal(group, engine.cache["index"]):
                    raise AssertionError("replay_vs_eager: the index advanced differently")
                continue
            for leaf, value in group.items():
                errs[f"{key}/{leaf}"] = compare(torch, value, engine.cache[key][leaf], dtype)
        restore()
    return {"policy": policy, "tol": TOL[dtype], "max_abs_err": errs,
            "tokens_equal": bool(torch.equal(tok_g, tok_e))}


def _zip_trees(a, b):
    if isinstance(a, dict):
        return {k: _zip_trees(a[k], b[k]) for k in a}
    return (a, b)


def _replay_ms(torch, engine, n: int = 10, policy: str = "greedy") -> float:
    """CUDA-event ms per decode step over ``n`` back-to-back calls of the
    decode program under ``policy`` (replays: ``replay_vs_eager`` captured
    the key), its inputs uploaded each call as in serving; the engine's
    cache advances."""
    program = engine.programs["decode"]
    inputs = _decode_inputs(engine, policy)
    with torch.no_grad():
        program(inputs, policy=policy)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            program(inputs, policy=policy)
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_events(prof) -> tuple[dict, int]:
    """Device time (ms) by kernel or copy name, and the number of such
    events, from the profiler's device events alone: the CPU ops that
    launched them are not counted again."""
    from torch.autograd import DeviceType

    device, count = {}, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            count += 1
            device[ev.name] = device.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
    return device, count


def _busy_ms(prof, names) -> float:
    """ms during which at least one device event whose name holds one of
    ``names`` ran: the union of their intervals (events that overlap, as a
    programmatic dependent and its primary do, count once)."""
    from torch.autograd import DeviceType

    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA and any(n in ev.name for n in names))
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3


def _sampler_cost(torch, vocab: int, step_ms: float, b: int = 8, n: int = 20) -> dict:
    """What a sampled request adds to a decode step: ``sample_tokens`` at
    (B, V) = (8, vocab) with temperature 0.8 and top-k 40 (the profiled
    steps above are greedy).  Host ms is the synchronised wall time per
    call, device ms the profiler's kernel time per call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.sampler import sample_tokens

    gen = torch.Generator(device="cuda").manual_seed(3)
    logits = torch.randn((b, vocab), generator=gen, device="cuda")
    seeds = torch.arange(b, device="cuda")
    steps = torch.full((b,), 7, device="cuda")
    temps = torch.full((b,), 0.8, device="cuda")
    top_ks = torch.full((b,), 40, device="cuda")

    def call():
        return sample_tokens(logits, seeds, steps, temps, top_ks, policy="top_k")

    toks = call()
    top40 = torch.topk(logits, 40, dim=-1).indices
    if not bool((top40 == toks.long()[:, None]).any(dim=-1).all()):
        raise AssertionError(f"sampled tokens {toks.tolist()} fall outside the top 40")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    device_ms = sum(_device_events(prof)[0].values()) / n
    return {"B": b, "V": vocab, "temperature": 0.8, "top_k": 40,
            "host_ms": host_ms, "device_ms": device_ms or None,
            "host_share_of_greedy_step": host_ms / step_ms}


def phase_offload(torch, n_fft: int = 256, n_lu: int = 192) -> dict:
    """The paper's function-block offload pipeline on the card, then the
    prior-work loop-offload GA and the Fig. 5 comparison.  Returns the
    launch counts of the path that runs each offload kernel, and the
    committed libcall applications and the inputs, for phases 7 and 12."""
    import numpy as np

    import repro_torch.kernels as kernels
    from repro_torch.apps import fourier, matrix
    from repro_torch.core import Discovery, OffloadEngine
    from repro_torch.core.pattern_db import default_db
    from repro_torch.offload import OffloadSession

    t_phase = time.perf_counter()
    inputs = {"fourier": fourier.make_input(n_fft), "matrix": matrix.make_input(n_lu)}
    apps = [(fourier, "fourier_app_libcall"), (fourier, "fourier_app_copied"),
            (matrix, "matrix_app_libcall"), (matrix, "matrix_app_copied")]
    results = {}
    kernels.reset_launches()
    for mod, name in apps:
        x = inputs[mod.__name__.rsplit(".", 1)[-1]]
        res = OffloadSession(getattr(mod, name), args=(x,), repeats=1).run()
        if not res.numerics_ok:
            raise AssertionError(f"{name}: the offloaded pattern failed the numerics check")
        results[name] = res
        emit({
            "phase": "offload", "app": name, "n": x.shape[0],
            "discoveries": [[d.kind, d.source_name, d.entry.name, d.score]
                            for d in res.discoveries],
            "pattern": list(res.pattern), "numerics_ok": res.numerics_ok,
            "baseline_seconds": res.baseline_seconds, "best_seconds": res.best_seconds,
            "speedup": res.speedup, "search_seconds": res.report.search_seconds,
        })
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("complex_matmul", "schur_update")}
    for name in ("complex_matmul", "schur_update"):
        if launches[name] <= 0:
            raise AssertionError(f"the offload pipeline never launched {name}: {launches}")

    # matmul: no application calls it, so its DB entry is resolved and
    # called through the C-2 adapter (f64 -> f32 casts, 1000 -> 1024 pads)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((1000, 1000)), rng.standard_normal((1000, 1000))
    entry = default_db().get("matmul")
    block = OffloadEngine().build_replacement(
        Discovery("libcall", "np.matmul", entry), {}, ((a, b), (a @ b,))
    )
    kernels.reset_launches()
    c = block(a, b)
    torch.cuda.synchronize()
    launches["matmul"] = kernels.launch_counts()["matmul"]
    err = float(np.abs(c - a @ b).max())
    if launches["matmul"] <= 0 or c.shape != (1000, 1000) or err > GEMM_TOL[0]:
        raise AssertionError(f"matmul DB entry: launches {launches['matmul']}, err {err}")
    emit({"phase": "offload", "db_entry": "matmul", "shape": list(c.shape),
          "dtype": str(c.dtype), "max_abs_err_vs_numpy_f64": err,
          "launches": launches["matmul"]})

    fig5 = _fig5(torch, inputs, results)
    out = {"phase": "fig5", **fig5, "offload_launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return {"launches": launches, "results": results, "inputs": inputs}


def _fig5(torch, inputs: dict, results: dict) -> dict:
    """The paper's Fig. 5: the prior-work loop-offload GA over the staged
    variants (each offloaded stage a captured program), beside the
    committed function blocks (``results``).  The searches time each
    candidate once, and the GA's best is a minimum over its samples, so the
    three versions are re-timed alike after the search (median of
    FIG5_REPEATS calls) before they are compared.  ``numerics_ok``: the
    loop and block outputs agree with the CPU program's (``verify``'s
    tolerance)."""
    import functools

    from repro_torch.apps import fourier, matrix
    from repro_torch.core import measure, planner, verify_numerics

    fig5 = {}
    for key, mod, build, n_genes, app in (
        ("fft", fourier, fourier.build_fft_variant, len(fourier.FFT_STAGES), "fourier_app_libcall"),
        ("lu", matrix, matrix.build_lu_variant, len(matrix.LU_STAGES), "matrix_app_libcall"),
    ):
        x = inputs[mod.__name__.rsplit(".", 1)[-1]]
        space = planner.SubsetSpace.from_genome_builder(
            functools.partial(build, device="cuda"), n_genes, tag=key)
        ga = planner.GeneticSearch(population=4, generations=2, seed=0).search(
            space, (x,), cache=planner.MeasurementCache(), repeats=1)
        block_res = results[app]
        versions = (("cpu", getattr(mod, app)), ("loop", space.build(ga.best.candidate)),
                    ("block", block_res.fn))
        secs = {version: measure(fn, (x,), repeats=FIG5_REPEATS).seconds
                for version, fn in versions}
        want = versions[0][1](x)
        numerics_ok = all(verify_numerics(lambda _x: want, fn, (x,)) for _, fn in versions[1:])
        if not numerics_ok:
            raise AssertionError(f"fig5 {key}: loop or block output disagrees with the CPU's")
        fig5[key] = {
            "n": x.shape[0], "repeats": FIG5_REPEATS,
            "cpu_seconds": secs["cpu"], "loop_seconds": secs["loop"],
            "block_seconds": secs["block"],
            "loop_speedup": secs["cpu"] / secs["loop"],
            "block_speedup": secs["cpu"] / secs["block"],
            "numerics_ok": numerics_ok,
            "loop_genome": list(ga.best.candidate), "ga_evaluations": ga.evaluations,
            "search_samples": {"cpu": block_res.baseline_seconds, "loop": ga.best.seconds,
                               "block": block_res.best_seconds},
            "ga_search_seconds": ga.search_seconds,
            "block_search_seconds": block_res.report.search_seconds,
        }
    return fig5


def phase_offload_full(torch, results: dict, n: int = 2048) -> dict:
    """The committed libcall applications at the paper's 2048 x 2048."""
    import numpy as np

    from repro_torch.apps import fourier, matrix
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()

    def wall(fn, reps: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    x = fourier.make_input(n)
    fft_app = results["fourier_app_libcall"].fn
    y = fft_app(x)
    want = np.fft.fft2(x)
    fft_err = float(np.abs(y - want).max() / np.abs(want).max())
    if y.shape != (n, n) or not np.isfinite(y).all() or fft_err > 1e-4:
        raise AssertionError(f"fft2d at {n}: relative error {fft_err}")
    xd = torch.from_numpy(x.astype(np.complex64)).cuda()
    fft_out = {
        "app": "fourier_app_libcall", "n": n, "max_err_over_max_ref": fft_err,
        "app_seconds": wall(lambda: fft_app(x)),
        "block_on_device_seconds": wall(lambda: ops.fft2d(xd)),
        "cufft_seconds": wall(lambda: torch.fft.fft2(xd)),
    }

    a = matrix.make_input(n)
    lu_app = results["matrix_app_libcall"].fn
    det = float(lu_app(a))
    ad = torch.from_numpy(a.astype(np.float32)).cuda()
    lu, indx, d = ops.lu_nr_compat(ad)
    rec_err = float((ref.lu_reconstruct(lu, indx) - ad).abs().max())
    # f32 rounding over 2048 pivots of an orthogonal (condition 1) matrix
    if abs(abs(det) - 1.0) > 1e-3 or rec_err > 1e-3:
        raise AssertionError(f"LU at {n}: |det| {abs(det)}, reconstruction error {rec_err}")
    lu_out = {
        "app": "matrix_app_libcall", "n": n, "abs_det": abs(det),
        "det_tol": 1e-3, "reconstruction_max_abs_err": rec_err,
        "app_seconds": wall(lambda: lu_app(a), reps=2),
        "block_on_device_seconds": wall(lambda: ops.lu_nr_compat(ad), reps=2),
        "cusolver_seconds": wall(lambda: torch.linalg.lu_factor(ad), reps=2),
    }
    out = {"phase": "offload_full", "fft": fft_out, "lu": lu_out,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


#: phase 12's LU programs: (n, nb) at the paper's size and at phase 6's
LU_PROGRAMS = ((2048, 128), (192, 32))


def phase_offload_programs(torch, offload: dict) -> dict:
    """The offload pipeline's compiled units.  The blocked LU as one
    captured program per (n, nb, trailing update) at LU_PROGRAMS on the
    cuda target: a replay against an eager ``lu_blocked`` call on the same
    input (lu and piv bit-identical), one capture a key, its capture
    seconds, replay seconds beside the eager call's and
    ``torch.linalg.lu_factor``'s, the launches one replay adds (Schur
    updates) and the phase's peak memory.  Then phase 6's Fig. 5 again,
    every staged and block program already captured."""
    import numpy as np

    from repro_torch.apps import matrix
    from repro_torch.kernels import lu as lu_mod
    from repro_torch.kernels.matmul import schur_update

    t_phase = time.perf_counter()
    _free_dead_engines(torch)
    torch.cuda.reset_peak_memory_stats()

    def seconds(fn, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return sorted(times)[len(times) // 2]

    rows = []
    for n, nb in LU_PROGRAMS:
        a = torch.from_numpy(matrix.make_input(n).astype(np.float32)).cuda()
        for _ in range(3):  # the key's eager call and capture, if not made yet
            lu_g, piv_g, par_g = lu_mod.lu_program(a, nb=nb, schur=schur_update)
        lu_e, piv_e, par_e = lu_mod.lu_blocked(a, nb=nb, schur=schur_update)
        torch.cuda.synchronize()
        err = float((lu_g - lu_e).abs().max())
        if not (torch.equal(lu_g, lu_e) and torch.equal(piv_g, piv_e)
                and torch.equal(par_g, par_e)):
            raise AssertionError(f"LU program at n={n}: replay differs from the eager "
                                 f"call (max abs err {err})")
        stats = next(p for p in lu_mod.program_stats()
                     if (p["n"], p["nb"], p["schur"]) == (n, nb, "schur_update"))
        if stats["captures"] != 1 or stats["replays"] < 1:
            raise AssertionError(f"LU program at n={n}: {stats}")
        reps = 3 if n >= 1024 else 10
        # one replay's span on the device's clock, beside its wall time
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        lu_mod.lu_program(a, nb=nb, schur=schur_update)
        end.record()
        torch.cuda.synchronize()
        rows.append({
            "n": n, "nb": nb, "max_abs_err_vs_eager": err, "bit_identical": True,
            "replay_seconds": seconds(lambda: lu_mod.lu_program(a, nb=nb, schur=schur_update),
                                      reps),
            "eager_seconds": seconds(lambda: lu_mod.lu_blocked(a, nb=nb, schur=schur_update),
                                     2 if n >= 1024 else 5),
            "replay_device_ms": start.elapsed_time(end),
            "cusolver_seconds": seconds(lambda: torch.linalg.lu_factor(a), reps),
            **{k: stats[k] for k in ("calls", "eager_calls", "captures", "replays",
                                     "capture_seconds", "launches_per_replay")},
        })
    fig5 = _fig5(torch, offload["inputs"], offload["results"])
    out = {"phase": "offload_programs", "lu": rows, "fig5": fig5,
           "lu_programs": lu_mod.program_stats(),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


#: each serving phase's blocks, and each block's kernel
PHASE_BLOCKS = {"prefill": ("rmsnorm", "attention"), "decode": ("rmsnorm", "paged_attention")}
BLOCK_KERNEL = {"rmsnorm": "rmsnorm", "attention": "flash_attention",
                "paged_attention": "paged_attention", "ssd_scan": "ssd_chunks"}
#: phase 13's zoo cells: llama3.2-1b at full width and depth
BINDING_BATCH, BINDING_SEQ = 8, 512


def _count_by_phase(engine) -> dict:
    """Wrap the engine's phase scope so each phase's kernel launches are
    counted apart (a replay adds its launches inside the scope)."""
    import contextlib

    import repro_torch.kernels as kernels

    counts = {phase: dict.fromkeys(kernels.KERNELS, 0) for phase in PHASE_BLOCKS}
    inner = engine._phase

    @contextlib.contextmanager
    def phase(name):
        before = kernels.launch_counts()
        with inner(name):
            yield
        for k, n in kernels.launch_counts().items():
            counts[name][k] += n - before[k]

    engine._phase = phase
    return counts


def _check_bound_launches(phase: str, bindings: dict, by_phase: dict) -> None:
    """A block a phase binds to ``torch`` launches no kernel from that
    phase; one it binds to ``cuda`` launches its kernel there."""
    for name, used in PHASE_BLOCKS.items():
        mapping = bindings.get(name) or {}
        for block in used:
            n = by_phase[name][BLOCK_KERNEL[block]]
            target = mapping.get(block)
            if (target == "torch" and n) or (target == "cuda" and not n):
                raise AssertionError(f"{phase}: {name} binds {block} to {target}, but "
                                     f"{BLOCK_KERNEL[block]} launched {n} times there")


def phase_binding(torch) -> dict:
    """The paper's per-environment selection on the serving path.  ``plan_zoo``
    searches llama3.2-1b's prefill and decode cells (full width and depth,
    batch BINDING_BATCH, seq BINDING_SEQ) over the torch and cuda targets,
    each trial timing replays of the cell's captured step, and commits a
    plan a cell with every axis pinned.  Phase 4's trace is then served
    under those plans, and again with ``decode_impl="torch"``; a block
    bound to torch in a phase launches no kernel there, and the torch-bound
    paged attention none at all.  Greedy f32 tokens of a 2-layer cut under
    the plans equal the same engine's under the default bindings."""
    import tempfile
    import warnings

    import numpy as np

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core.blocks import registry
    from repro_torch.core.planner import BindingSpace, PlanStore
    from repro_torch.models import lm
    from repro_torch.offload import OffloadSession, zoo
    from repro_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    _free_dead_engines(torch)
    targets = ("torch", "cuda")
    cells = [("llama3.2-1b", "prefill"), ("llama3.2-1b", "decode")]
    cfg = get_config("llama3.2-1b")
    with tempfile.TemporaryDirectory(prefix="plans-") as plan_dir:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            results = OffloadSession.plan_zoo(
                plan_dir, cells, reduced=False, layers=0, batch=BINDING_BATCH,
                seq=BINDING_SEQ, targets=targets, device="cuda", quiet=False)
            search_seconds = time.perf_counter() - t0
        if set(results) != set(cells):
            raise AssertionError(f"plan_zoo committed {sorted(results)} of {cells}: "
                                 f"{[str(w.message) for w in caught]}")
        plans, trials = {}, {}
        for (arch, kind), res in results.items():
            axes = zoo._cell_blocks(cfg, registry, targets, kind)
            space = BindingSpace(lambda: None, blocks=axes)
            stored = PlanStore(plan_dir).load(zoo.zoo_key(arch, kind))
            if stored is None or stored.mapping != res.mapping or set(res.mapping) != set(axes):
                raise AssertionError(f"{kind}: committed plan {stored} does not pin every "
                                     f"axis of {axes}")
            plans[kind] = res.mapping
            trials[kind] = [{"binding": space.binding_of(t.candidate), "seconds": t.seconds,
                             "compile_seconds": t.compile_seconds}
                            for t in res.trials]
        _free_dead_engines(torch)

        served = {}
        for label, kw in (("plans", {}), ("plans_decode_torch", {"decode_impl": "torch"})):
            by_phase = {}

            def prepare(engine, by_phase=by_phase):
                by_phase.update(_count_by_phase(engine))

            def report(engine, out, by_phase=by_phase, label=label):
                out["bindings"] = engine.bindings()
                out["launches"] = kernels.launch_counts()  # every kernel's, bound or not
                out["launches_by_phase"] = by_phase
                _check_bound_launches(label, out["bindings"], by_phase)
                if label == "plans_decode_torch" and out["launches"]["paged_attention"]:
                    raise AssertionError(f"{label}: paged_attention launched "
                                         f"{out['launches']['paged_attention']} times")

            bound = {phase: dict(plans[phase]) for phase in PHASE_BLOCKS}
            if kw:
                bound["decode"]["paged_attention"] = "torch"
            expect = tuple(sorted({BLOCK_KERNEL[b] for phase, used in PHASE_BLOCKS.items()
                                   for b in used if bound[phase].get(b) == "cuda"}))
            served[label] = phase_main_path(
                torch, phase=f"binding_{label}", expect=expect, report=report,
                prepare=prepare, plan_dir=plan_dir, **kw)
            _free_dead_engines(torch)

        # greedy f32 tokens of a 2-layer cut: bound against default
        f32 = dataclasses.replace(cfg.cut(2), compute_dtype="float32")
        params = lm.init_params(f32, seed=1, device="cuda")
        rng = np.random.default_rng(1)
        lens, gens = (37, 100, 16, 70, 37, 100), (12, 6, 10, 8, 5, 7)
        prompts = [rng.integers(0, f32.vocab_size, n).tolist() for n in lens]
        kw = dict(n_slots=2, max_len=128, page_size=16)
        bound, engine = _engine_trace(ServeEngine, Request, f32, params, prompts, gens,
                                      plan_dir=plan_dir, **kw)
        default, _ = _engine_trace(ServeEngine, Request, f32, params, prompts, gens, **kw)
        if engine.bindings() != plans or bound != default:
            raise AssertionError(f"f32 bound trace: bindings {engine.bindings()} (plans "
                                 f"{plans}); tokens {bound} vs default {default}")
    out = {"phase": "binding", "arch": cfg.name, "batch": BINDING_BATCH, "seq": BINDING_SEQ,
           "targets": list(targets), "search_seconds": search_seconds, "plans": plans,
           "trials": trials,
           "served": {label: {k: o[k] for k in ("bindings", "tok_per_s", "wall_seconds",
                                                "decode_median_ms", "ttft_p50_ms",
                                                "ttft_p99_ms", "launches", "launches_by_phase",
                                                "graphs")}
                      for label, o in served.items()},
           "f32_bound_tokens_identical": True,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


#: flash's route on each cut config's prefill: deepseek-v2's MLA attends
#: at qk 192 / v 128, arctic-480b and the zoo's dense configs at D = 128 or
#: 64, all on wgmma
FLASH_ROUTE = dict.fromkeys((*MOE_LAYERS, *ZOO_LAYERS), "wgmma")
#: paged attention's walk on each cut config's decode: deepseek-v2's latent
#: pool is keys and values (the latent walk), the others are GQA or MHA
PAGED_ROUTE = {**dict.fromkeys((*MOE_LAYERS, *ZOO_LAYERS), "split"),
               "deepseek-v2-236b": "latent"}
#: the cut configs whose bf16 path as a whole is held to the plain
#: attention's (``_bf16_path_vs_plain``)
PATH_CHECKED = ("deepseek-v2-236b", *ZOO_LAYERS)
#: the attention blocks' plain versions, against which the bf16 path is held
PLAIN_ATTENTION = {"attention": "torch", "paged_attention": "torch"}
#: the bf16 path's logits against the plain attention's with every MoE
#: layer's expert choices pinned to the kernel run's: max abs error over
#: the plain logits' largest |value|.  What is left differs only in the
#: attention kernels' rounding (P in bf16 among it) across 4 layers: 1.2%
#: at prefill and 1.3% at decode on the H100, where faults planted in the
#: latent walk (scripts/paged_variants.py bf16_path) read 18-135% at decode
PATH_TOL = 0.04
#: deeper stacks amplify any rounding: the plain path itself with one
#: rounding changed (each attention's P rounded to bf16 before P V, as the
#: wgmma kernels round it: ``floor``) moves by several % of the largest
#: |logit| at the zoo's 14-48 layers on the H100, and the kernels' path by
#: about as much (phase 27's ``floor`` and ``pinned``).  So the bf16 path is
#: held to PATH_TOL or, where the same run's rounding floor is larger, to
#: this many floors; faults planted in the split walk and in flash read far
#: over it at granite-3-8b's 40 layers (scripts/paged_variants.py zoo_path)
PATH_FLOOR_FACTOR = 2.0


def _check_routes(phase: str, routes: dict, launches: int, want: str) -> None:
    if routes.get(want, 0) != launches:
        raise AssertionError(f"{phase}: routes {routes}, all {launches} on {want} expected")


def _bf16_path_vs_plain(torch, engine, n_req: int = 8) -> dict:
    """The served path as a whole in bf16 on ``engine`` (idle): 8 new
    requests are admitted and decoding; then, from that state, one batch-1
    prefill of the longest prompt and one decode step of the slot batch run
    eagerly three times (the cache cloned and restored): with the default
    bindings (``kernels``), with ``attention`` and ``paged_attention``
    bound to ``torch`` (``PLAIN_ATTENTION``: ``plain``), and so bound with
    each MoE layer's expert choices pinned to the kernel run's (``pinned``:
    the gates outside them set to -inf, so each token's top-k takes the
    same experts at its own gate values).  A choice that flips between
    ``kernels`` and ``plain`` moves a token's whole expert output, so
    ``pinned`` holds the attention kernels alone: its logits must be
    within ``PATH_TOL`` of its largest |logit|, or within
    ``PATH_FLOOR_FACTOR`` times the rounding floor where that is larger
    (``within_bound``): the same pinned plain run with each attention's P
    rounded to bf16 before P V (``_plain_attention_as`` and
    ``_p_in_bf16``), against ``pinned``.  A fourth pinned plain run holds
    every attention call of the path to its kernel on the same inputs
    (``per_call``: each within the bf16 ``TOL``, ``_against_kernel``).
    ``within_tol`` holds if both steps are within their bound and no call
    disagrees.
    Each step reports the comparisons and the tokens whose expert set
    flipped (``routing_flips``: [flipped, token-layers]).  The requests
    then run to completion."""
    import numpy as np

    from repro_torch.core import blocks
    from repro_torch.models import moe
    from repro_torch.serve import Request

    rng = np.random.default_rng(1)
    vocab = engine.cfg.vocab_size
    prompts = [rng.integers(0, vocab, int(n)).tolist() for n in rng.integers(64, 513, n_req)]
    for p in prompts:
        engine.submit(Request(p, max_new_tokens=64))
    for _ in range(32):  # until every request is admitted, prefilled and decoding
        engine.step()
        if len(engine.scheduler.active) == n_req and not engine._prefilling:
            break
    else:
        raise AssertionError(f"bf16 path: {len(engine.scheduler.active)} of {n_req} active")
    dev = engine.device
    prompt = max(prompts, key=len)
    pre_in = [np.asarray([len(prompt) - 1], np.int32), np.zeros(1, np.int32),
              np.zeros(1, np.int32), np.ones(1, np.float32), np.zeros(1, np.int32),
              np.asarray([prompt], np.int32)]
    pre_in = [torch.from_numpy(a).to(dev) for a in pre_in]
    dec_in = [torch.from_numpy(a.copy()).to(dev) for a in _decode_inputs(engine, "greedy")]
    saved = _tree(torch.clone, engine.cache)
    route = moe.route

    def run(binding, pin=None):
        """(prefill logits, decode logits), and each step's expert choices
        (one (B, S, top_k) tensor per MoE layer)."""
        chosen = ([], [])
        step = [0]

        def routed(gates, top_k, capacity):
            picks = chosen[step[0]]
            top = torch.topk(gates, top_k, dim=-1).indices
            if pin is not None:
                top = pin[step[0]][len(picks)]
                keep = torch.zeros_like(gates, dtype=torch.bool).scatter_(-1, top, True)
                gates = gates.masked_fill(~keep, float("-inf"))
            picks.append(top)
            return route(gates, top_k, capacity)

        moe.route = routed
        try:
            with blocks.bind(binding) if binding else contextlib.nullcontext():
                _, pre = engine._prefill_step(*pre_in, policy="greedy")
                step[0] = 1
                _, dec = engine._decode_step(*dec_in, policy="greedy")
        finally:
            moe.route = route
        logits = (pre.float().clone(), dec.float().clone())
        _tree(lambda pair: pair[0].copy_(pair[1]), _zip_trees(engine.cache, saved))
        return logits, chosen

    per_call = []
    with torch.no_grad():
        kern, kern_chosen = run(None)
        plain, plain_chosen = run(PLAIN_ATTENTION)
        pinned, _ = run(PLAIN_ATTENTION, pin=kern_chosen)
        with _plain_attention_as(lambda block, fn: _p_in_bf16(torch, fn)):
            floor, _ = run(PLAIN_ATTENTION, pin=kern_chosen)
        with _plain_attention_as(lambda block, fn: _against_kernel(torch, block, fn, per_call)):
            run(PLAIN_ATTENTION, pin=kern_chosen)
        torch.cuda.synchronize()
    agree = [e for e in per_call if isinstance(e, float)]
    disagree = [e for e in per_call if not isinstance(e, float)]
    out = {"tol": PATH_TOL, "floor_factor": PATH_FLOOR_FACTOR, "prompt_tokens": len(prompt),
           "decode_slots": n_req, "within_tol": not disagree,
           "per_call": {"calls": len(per_call), "max_abs_err": max(agree, default=None),
                        "disagree": len(disagree), "first_disagreement": disagree[:1],
                        "tol": TOL["bfloat16"]}}
    for i, step in enumerate(("prefill", "decode")):
        got = kern[i]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"bf16 path: {step} logits are not finite")
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(kern_chosen[i], plain_chosen[i]))
        out[step] = {"routing_flips": [flips, sum(a[..., 0].numel() for a in kern_chosen[i])]}
        for name, a, want in (("pinned", got, pinned[i]), ("plain", got, plain[i]),
                              ("floor", floor[i], pinned[i])):
            err = float((a - want).abs().max())
            scale = float(want.abs().max())
            out[step][name] = {
                "max_abs_err": err, "max_abs_logit": scale, "rel": err / scale,
                "argmax_equal": float((a.argmax(-1) == want.argmax(-1)).float().mean())}
        bound = max(PATH_TOL, PATH_FLOOR_FACTOR * out[step]["floor"]["rel"])
        out[step]["bound"] = bound
        out[step]["within_bound"] = out[step]["pinned"]["rel"] <= bound
        out["within_tol"] &= out[step]["within_bound"]
    engine.run_until_idle(max_steps=1000)
    return out


@contextlib.contextmanager
def _plain_attention_as(wrap):
    """For the scope, the ``torch`` target of each ``PLAIN_ATTENTION``
    block is ``wrap(block, its function)``."""
    from repro_torch.core import blocks

    saved = {b: blocks.registry.implementation(b, t) for b, t in PLAIN_ATTENTION.items()}
    for b, impl in saved.items():
        blocks.registry.register(b, impl.target, wrap(b, impl.fn), impl.note, impl.no_backward)
    try:
        yield
    finally:
        for b, impl in saved.items():
            blocks.registry.register(b, impl.target, impl.fn, impl.note, impl.no_backward)


def _p_in_bf16(torch, fn):
    """``fn`` (a plain attention: scores, softmax and P V in f32, the
    output rounded once to its inputs' type) with one rounding changed:
    the softmax's P rounded to nearest bf16 before P V, as the wgmma
    kernels round it (``torch.softmax`` replaced for the call)."""
    softmax = torch.softmax

    def rounded(x, *args, **kw):
        return softmax(x, *args, **kw).to(torch.bfloat16).float()

    def call(*args, **kw):
        torch.softmax = rounded
        try:
            return fn(*args, **kw)
        finally:
            torch.softmax = softmax

    return call


def _against_kernel(torch, block, fn, errs):
    """``fn`` (a plain attention), with the block's kernel run on the same
    inputs and held to its output within the type's ``TOL``: each call's
    max abs error appended to ``errs``, or, where the kernel disagrees,
    the message (read after the run, beside the whole path's reading)."""
    from repro_torch.core import blocks

    kernel = blocks.registry.implementation(block, "cuda").fn

    def call(q, *args, **kw):
        want = fn(q, *args, **kw)
        try:
            errs.append(compare(torch, kernel(q, *args, **kw), want, str(q.dtype).split(".")[1]))
        except AssertionError as e:
            errs.append(str(e))
        return want

    return call


def phase_main_path_cut(torch, arch: str, phase: str, **engine_kw) -> dict:
    """``arch`` (depth cut by ``MOE_LAYERS`` or ``ZOO_LAYERS``) served as
    phase 4 serves llama: the same engine settings and trace, decode as
    graph replays, rmsnorm, paged attention (for deepseek-v2 every launch
    the MLA route: the latent pool as keys and values, the rope pool beside
    it) and flash each launched, every launch of flash and of paged
    attention on the config's route (``FLASH_ROUTE``, ``PAGED_ROUTE``);
    then one decode replay against its eager call, bit for bit, and for
    ``PATH_CHECKED`` the bf16 path against the plain attention's."""
    from repro_torch.configs import get_config

    def report(engine, out):
        _check_routes(phase, out["flash_routes"], out["launches"]["flash_attention"],
                      FLASH_ROUTE[arch])
        _check_routes(phase, out["paged_routes"], out["launches"]["paged_attention"],
                      PAGED_ROUTE[arch])
        out["cut"] = f"{engine.cfg.n_layers} of {get_config(arch).n_layers} layers, full width"
        check = _replay_vs_eager(torch, engine, "greedy")
        check["bit_identical"] = all(e == 0.0 for e in check["max_abs_err"].values())
        out["replay_vs_eager"] = [check]
        if not check["bit_identical"]:
            raise AssertionError(f"{phase}: a decode replay differs from its eager call: {check}")
        if arch in PATH_CHECKED:  # the bf16 path as a whole
            path = out["bf16_path_vs_plain"] = _bf16_path_vs_plain(torch, engine)
            if not path["within_tol"]:
                raise AssertionError(f"{phase}: bf16 logits with pinned routing over their "
                                     f"bound (PATH_TOL or the rounding floor), or an "
                                     f"attention call against its kernel over TOL: {path}")

    return phase_main_path(torch, arch, phase=phase, report=report, **engine_kw)


def phase_extend_mla(torch, main: dict) -> dict:
    """deepseek-v2 (``daaa``) with ``prefill_chunk=CHUNK`` on phase 4's
    trace: the chunk programs extend the MLA cache's latent and rope pools
    in place.  ``extend`` captures once and replays every later call; an
    MoE's final chunk runs at its exact width (no overlapped window), so
    ``extend_sample`` takes a key per width, each captured at its second
    call.  Paged attention launches more often than in ``main`` (the same
    config unchunked), and one replay of each chunk program equals its
    eager call from a cloned cache."""

    def report(engine, out):
        _check_routes("extend_mla", out["flash_routes"], out["launches"]["flash_attention"],
                      FLASH_ROUTE["deepseek-v2-236b"])
        _check_routes("extend_mla", out["paged_routes"], out["launches"]["paged_attention"],
                      PAGED_ROUTE["deepseek-v2-236b"])
        graphs = out["graphs"]
        ext, fin = graphs["extend"], graphs["extend_sample"]
        if ext["captures"] != 1 or ext["eager_calls"] != 1 or ext["replays"] != ext["calls"] - 1:
            raise AssertionError(f"extend_mla: extend {ext}")
        if fin["eager_calls"] + fin["replays"] != fin["calls"] or fin["captures"] > fin["calls"]:
            raise AssertionError(f"extend_mla: extend_sample {fin}")
        if engine.overlap_tokens != 0:
            raise AssertionError(f"extend_mla: {engine.overlap_tokens} overlapped tokens")
        if out["launches"]["paged_attention"] <= main["launches"]["paged_attention"]:
            raise AssertionError(f"extend_mla: paged_attention launched "
                                 f"{out['launches']['paged_attention']} times, unchunked "
                                 f"{main['launches']['paged_attention']}")
        out["prefill_chunk"] = CHUNK
        out["prefill_chunks"] = engine.stats.prefill_chunks
        out["main_path_mla_moe"] = {k: main[k] for k in (
            "wall_seconds", "tok_per_s", "prefill_seconds", "decode_median_ms",
            "ttft_p50_ms", "ttft_p99_ms", "launches")}
        out["replay_vs_eager"] = [_chunk_replay_vs_eager(torch, engine, name)
                                  for name in ("extend", "extend_sample")]

    return phase_main_path(torch, "deepseek-v2-236b", phase="extend_mla", report=report,
                           prefill_chunk=CHUNK)


#: the train path's kernel launches, each of which main_path_train needs
TRAIN_COUNTERS = ("flash_attention", "flash_attention_bwd", "rmsnorm/plain", "rmsnorm/add",
                  "rmsnorm_bwd/plain", "rmsnorm_bwd/add")
#: the bindings that take the train path's blocks off the kernels
PLAIN_TRAIN = {"attention": "torch", "rmsnorm": "torch"}


def _train_inputs(torch, cfg, batch: int, seq: int, step: int = 0) -> dict:
    """Step ``step``'s batch of ``SyntheticLMData``: tokens and labels, or
    for a patch-embed frontend (pixtral) seeded embeddings and labels."""
    from repro_torch.data.pipeline import SyntheticLMData

    data = SyntheticLMData(cfg.vocab_size, seq, batch, seed=0)
    host = (data.embeds_batch_at(step, cfg.d_model) if cfg.frontend == "patch_embed"
            else data.batch_at(step))
    return {k: torch.from_numpy(v).to("cuda") for k, v in host.items()}


def _loss_and_grads(torch, params, batch, cfg):
    """(loss, the gradient leaves) of ``lm.loss_fn`` at ``params``; a leaf
    the loss does not read (the token embedding of a batch of patch
    embeddings) has none and is left out."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    total, _ = lm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(total, leaves, allow_unused=cfg.frontend == "patch_embed")
    return total.detach(), tuple(g for g in grads if g is not None)


def _clone_tree(torch, tree):
    return _tree(lambda t: t.detach().clone(), tree)


def phase_train_f32(torch, arch: str = "llama3.2-1b", phase: str = "train_f32",
                    counters=None, plain=None, seq: int = 128, never=(),
                    defaults=()) -> dict:
    """``arch`` at full width cut to 2 layers in f32 compute (B 2, S
    ``seq``): the first step's loss and every gradient leaf on default
    bindings (llama: flash and RMSNorm forward and backward through the
    kernels) against the same with ``plain`` bound (each leaf within 1e-4
    of its largest |g|), then three ``make_train_step`` steps from the same
    weights each way, the losses within 1e-5 relative.  Every counter of
    ``counters`` counts in the first run and none in the second; the
    kernels of ``never`` launch in neither; the ``grad_default/`` counters
    of ``defaults`` (calls resolved to ``torch`` for a gradient their
    kernel cannot take) count in the first."""
    import math

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core import blocks
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    counters = TRAIN_COUNTERS if counters is None else counters
    plain = PLAIN_TRAIN if plain is None else plain
    _free_dead_engines(torch)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), compute_dtype="float32").cut(2)
    params = lm.init_params(cfg, seed=1, device="cuda")
    batch = _train_inputs(torch, cfg, 2, seq)
    kernels.reset_launches()
    loss_k, grads_k = _loss_and_grads(torch, params, batch, cfg)
    counted = kernels.counters()
    with blocks.bind(plain):
        loss_p, grads_p = _loss_and_grads(torch, params, batch, cfg)
    plain_counted = {k: n - counted.get(k, 0) for k, n in kernels.counters().items()}
    missing = [c for c in (*counters, *defaults) if counted.get(c, 0) <= 0]
    if (missing or any(plain_counted[c] for c in counters)
            or any(counted[c] or plain_counted[c] for c in never)):
        raise AssertionError(f"{phase}: kernel launches {counted}, plain run {plain_counted}")
    worst = 0.0
    for gk, gp in zip(grads_k, grads_p):
        scale = float(gp.abs().max())
        err = float((gk - gp).abs().max())
        # written so that a NaN (a gradient or its scale) fails
        if not (math.isfinite(scale) and err <= 1e-4 * max(scale, 1e-30)):
            raise AssertionError(
                f"{phase}: a gradient leaf differs by {err:.3g} (max |g| {scale:.3g})")
        worst = max(worst, err / max(scale, 1e-30))
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    if not loss_err <= 1e-5:
        raise AssertionError(f"{phase}: loss {float(loss_k)} vs plain {float(loss_p)}")

    hyper = TrainHyper(base_lr=1e-3, warmup_steps=2, total_steps=16)
    losses = {}
    for name, binding in (("kernels", {}), ("plain", plain)):
        opt = AdamW(moment_dtype=cfg.opt_dtype)
        step = make_train_step(cfg, opt, hyper)
        p = _clone_tree(torch, params)
        state = opt.init(p)
        losses[name] = []
        with blocks.bind(binding):
            for i in range(3):
                p, state, metrics = step(p, state, _train_inputs(torch, cfg, 2, seq, i))
                losses[name].append(float(metrics["loss"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["kernels"], losses["plain"])]
    if not all(r <= 1e-5 for r in rel):  # a NaN loss fails
        raise AssertionError(f"{phase}: losses {losses}")
    out = {"phase": phase, "arch": cfg.name, "layers": 2, "batch": 2, "seq": seq,
           "plain_bindings": plain,
           "first_loss_rel_err": loss_err, "max_grad_err_over_max_abs_g": worst,
           "grad_leaves": len(grads_k), "losses": losses, "loss_rel_err": rel,
           "launches": {c: counted[c] for c in (*counters, *never)},
           "grad_default": {k: n for k, n in counted.items() if k.startswith("grad_default/")},
           "flash_routes": {r: counted[f"flash_attention/{r}"] for r in ("cuda_cores", "wgmma")},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


#: the SSM train phase (mamba2-2.7b): default bindings against every block
#: bound to its plain version; the norms' plain and add forms run their
#: kernels forward and backward, the SSD scan and the gated norm resolve
#: to ``torch`` (their kernels have no backward) and launch nothing
PLAIN_SSM_TRAIN = {"ssd_scan": "torch", "rmsnorm": "torch", "attention": "torch"}
SSM_TRAIN_COUNTERS = ("rmsnorm/plain", "rmsnorm/add", "rmsnorm_bwd/plain", "rmsnorm_bwd/add")
SSM_GRAD_DEFAULTS = ("grad_default/ssd_scan", "grad_default/rmsnorm.gated")


def phase_train_ssm(torch) -> dict:
    """mamba2-2.7b at full width cut to 2 layers, f32, B 2, S 256, trained
    on default bindings against ``PLAIN_SSM_TRAIN`` as ``phase_train_f32``
    holds llama: ``ssd_chunks`` and the gated norm's kernel launch nothing,
    every SSD scan and gated norm resolves to ``torch``."""
    return phase_train_f32(torch, "mamba2-2.7b", "train_ssm", SSM_TRAIN_COUNTERS,
                           PLAIN_SSM_TRAIN, seq=256, never=("ssd_chunks", "rmsnorm/gated"),
                           defaults=SSM_GRAD_DEFAULTS)


#: phase 21b: deepseek-v2-236b at full width cut to its leading dense
#: layer (pattern ``d``: MLA, 128 heads at qk 192 / v 128, and the 12288-wide
#: FFN; 1.467 B parameters, bf16 params and moments as its config has them); its
#: kernels-vs-plain check reads the first step's batch
TRAIN_MLA = {"phase": "train_mla", "arch": "deepseek-v2-236b", "layers": 1, "batch": 2,
             "seq": 512, "steps": 4, "check_batch": 0}
#: phase 29: pixtral-12b at full width (d 5120, 32 heads over 8 at D 128,
#: the 14336-wide FFN, 131072 untied vocab) on seeded patch embeddings, f32
#: master weights and moments: ~18 B a parameter with the gradients and the
#: bf16 casts, over 1.34 B of embedding and head and 273 M a layer; cut to
#: 8 of 40 layers, the deepest whose step stays under ~72 GB.  Its
#: kernels-vs-plain check reads a batch the steps did not see: at these
#: widths one AdamW step fits a batch (its loss 12.9 -> 0.20 four steps
#: later), where TRAIN_BF16_TOL's 1e-3 relative, stated for a loss near
#: ln(vocab), is 2e-4 absolute, under the two bindings' rounding (3.7e-4
#: there, 8.6e-4 at the unseen batch's loss of 12.8 on the H100)
TRAIN_VLM = {"phase": "train_vlm", "arch": "pixtral-12b", "layers": 8, "batch": 2,
             "seq": 512, "steps": 4, "check_batch": 4}
#: the launches each cut train phase needs
TRAIN_CUT_COUNTERS = ("flash_attention", "flash_attention_bwd", "rmsnorm_bwd/plain",
                      "rmsnorm_bwd/add")


def train_cut_config(spec: dict):
    from repro_torch.configs import get_config

    return get_config(spec["arch"]).cut(spec["layers"])


def train_estimate(spec: dict, device: str = "cuda") -> dict:
    """The dry-run's record of a cut train phase's step
    (``launch/dryrun.run_cell`` on ``train_cut_config(spec)``, traced with
    fake tensors, nothing launched), as phase 24 takes a train step's: its
    estimated peak bytes beside the card's (``fits_device``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    shape = ShapeConfig(spec["phase"], spec["seq"], spec["batch"], "train")
    get = dryrun.get_config
    dryrun.get_config = lambda arch: train_cut_config(spec)
    try:
        return dryrun.run_cell(spec["arch"], shape, overrides={"microbatch": 1}, device=device)
    finally:
        dryrun.get_config = get


def _phase_train_cut(torch, spec: dict) -> dict:
    """``spec``'s config at full width cut in depth, ``spec["steps"]``
    steps of ``make_train_step`` on ``SyntheticLMData`` (tokens, or seeded
    patch embeddings): every loss finite, ms a step (median after the
    first), tok/s, peak memory over the steps beside the dry-run's estimate;
    flash's forward and backward and RMSNorm's backward launch, every flash
    launch forward and backward on wgmma.  Then, each from the trained
    state (copied to the host once: pixtral's f32 state cannot be held on
    the card twice): one step profiled (device ms, the top kernels, the
    flash backward's kernels); one step twice, bit-identical
    (``_repeat_step``); the loss and the global grad norm on batch
    ``spec["check_batch"]`` through the kernels against ``attention`` /
    ``rmsnorm`` bound to ``torch``, within ``TRAIN_BF16_TOL``."""
    import math

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core import blocks
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    t_phase = time.perf_counter()
    _free_dead_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    phase, cfg = spec["phase"], train_cut_config(spec)
    b, seq, n_steps = spec["batch"], spec["seq"], spec["steps"]
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = AdamW(moment_dtype=cfg.opt_dtype)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, TrainHyper(warmup_steps=2, total_steps=n_steps))
    batches = [_train_inputs(torch, cfg, b, seq, i) for i in range(n_steps)]

    kernels.reset_launches()
    losses, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))  # reads the loss: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counted = kernels.counters()
    routes = {f"{k}/{r}": counted[f"{k}/{r}"] for k in ("flash_attention", "flash_attention_bwd")
              for r in ("cuda_cores", "wgmma")}
    launches = {c: counted[c] for c in TRAIN_CUT_COUNTERS}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{phase}: losses {losses}")
    if (any(n <= 0 for n in launches.values()) or routes["flash_attention/cuda_cores"]
            or routes["flash_attention_bwd/cuda_cores"]):
        raise AssertionError(f"{phase}: launches {launches}, flash routes {routes}")

    trained = _host(params), _opt_map(lambda t: t.detach().cpu(), state)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, metrics = step_fn(params, state, batches[0])
        float(metrics["loss"])
        torch.cuda.synchronize()
    profiled_wall = (time.perf_counter() - t0) * 1e3
    del params, state
    device, events = _device_events(prof)
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    flash_bwd = {k[:80]: v for k, v in device.items() if "flash_bwd_" in k}

    repeat = _repeat_step(torch, step_fn, *trained, batches[0])
    if not repeat["bit_identical"]:
        raise AssertionError(f"{phase}: a repeated step differs: {repeat}")
    params = _tree(lambda t: t.to("cuda"), trained[0])
    del trained
    batch = _train_inputs(torch, cfg, b, seq, spec["check_batch"])
    loss_k, grads = _loss_and_grads(torch, params, batch, cfg)
    norm_k = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    del grads
    with blocks.bind(PLAIN_TRAIN):
        loss_p, grads = _loss_and_grads(torch, params, batch, cfg)
    norm_p = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    del grads, params
    check = {"batch": spec["check_batch"], "loss": float(loss_k), "plain_loss": float(loss_p),
             "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
             "grad_norm": norm_k, "plain_grad_norm": norm_p,
             "grad_norm_rel_err": abs(norm_k - norm_p) / norm_p, "tol": TRAIN_BF16_TOL}
    if not (check["loss_rel_err"] <= TRAIN_BF16_TOL["loss"]
            and check["grad_norm_rel_err"] <= TRAIN_BF16_TOL["grad_norm"]):  # NaN fails
        raise AssertionError(f"{phase}: kernels against plain: {check}")
    estimate = _unlaunched(torch, f"the {phase} trace", lambda: train_estimate(spec, "cuda"))
    median = float(np.median(step_ms[1:]))
    full = get_config(spec["arch"]).n_layers
    out = {"phase": phase, "arch": cfg.name, "pattern": cfg.pattern(),
           "layers": cfg.n_layers, "cut": f"{cfg.n_layers} of {full} layers, full width",
           "params": cfg.param_count(), "batch": b, "seq": seq, "frontend": cfg.frontend,
           "steps": n_steps, "param_dtype": cfg.param_dtype, "moment_dtype": cfg.opt_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "losses": losses, "step_ms": step_ms, "median_step_ms": median,
           "tok_per_s": b * seq / (median / 1e3), "peak_memory_gb": peak,
           "estimated_peak_gb": estimate.get("peak_bytes_per_device", 0) / 1e9,
           "estimate_status": estimate["status"],
           "launches": launches,
           "flash_bwd_routes": {r: routes[f"flash_attention_bwd/{r}"]
                                for r in ("cuda_cores", "wgmma")},
           "flash_routes": {r: routes[f"flash_attention/{r}"] for r in ("cuda_cores", "wgmma")},
           "kernels_vs_plain": check, "repeat_step": repeat,
           "profiled_step": {"wall_ms": profiled_wall, "device_ms": sum(device.values()),
                             "device_events": events,
                             "top_device_ms": {k[:80]: v for k, v in top},
                             "flash_bwd_device_ms": sum(flash_bwd.values()),
                             "flash_bwd_device_ms_by_kernel": flash_bwd},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_train_mla(torch) -> dict:
    """Phase 21b: ``TRAIN_MLA`` (deepseek-v2's dense layer: the flash
    backward's wgmma route at qk 192 / v 128) by ``_phase_train_cut``."""
    return _phase_train_cut(torch, TRAIN_MLA)


def phase_train_vlm(torch) -> dict:
    """Phase 29: ``TRAIN_VLM`` (pixtral-12b on patch embeddings, f32 master
    weights and moments, bf16 compute: flash at 32 heads over 8 at D 128,
    forward and backward on wgmma) by ``_phase_train_cut``."""
    return _phase_train_cut(torch, TRAIN_VLM)


#: phase 28: pixtral-12b's forward on patch embeddings in f32, cut to 2
#: layers, held to the plain bindings' logits within this share of their
#: largest |value| (phase 18's rule for a gradient leaf)
PIXTRAL_FORWARD = {"layers": 2, "batch": 2, "seq": 512, "tol": 1e-4}
PIXTRAL_COUNTERS = ("flash_attention", "rmsnorm/plain", "rmsnorm/add")


def phase_pixtral_forward(torch) -> dict:
    """Phase 28: the serving engine refuses pixtral-12b, as the reference's
    does (a patch-embed frontend has no token prompt); then pixtral at full
    width cut to 2 layers in f32 compute runs ``lm.forward`` on seeded
    patch embeddings (B 2, S 512, d 5120) through the kernels and with
    ``attention`` / ``rmsnorm`` bound to ``torch``: the logits within
    ``PIXTRAL_FORWARD["tol"]`` of the plain logits' largest |value|, flash
    and RMSNorm's plain and add forms launched by the first run and not by
    the second."""
    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core import blocks
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine

    t0 = time.perf_counter()
    _free_dead_engines(torch)
    full = get_config("pixtral-12b")
    try:
        ServeEngine(full, device="cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("pixtral_forward: the engine took a patch-embed config")
    spec = PIXTRAL_FORWARD
    cfg = dataclasses.replace(full, compute_dtype="float32").cut(spec["layers"])
    params = lm.init_params(cfg, seed=1, device="cuda")
    batch = {"embeds": _train_inputs(torch, cfg, spec["batch"], spec["seq"])["embeds"]}
    with torch.no_grad():
        kernels.reset_launches()
        got, _ = lm.forward(params, batch, cfg, mode="train")
        counted = kernels.counters()
        with blocks.bind(PLAIN_TRAIN):
            want, _ = lm.forward(params, batch, cfg, mode="train")
        plain_counted = {k: n - counted.get(k, 0) for k, n in kernels.counters().items()}
        torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("pixtral_forward: the logits are not finite")
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    launches = {c: counted[c] for c in PIXTRAL_COUNTERS}
    if any(n <= 0 for n in launches.values()) or any(plain_counted[c] for c in PIXTRAL_COUNTERS):
        raise AssertionError(f"pixtral_forward: launches {launches}, plain run {plain_counted}")
    if not err <= spec["tol"] * scale:  # a NaN fails
        raise AssertionError(f"pixtral_forward: logits differ by {err:.3g} (max {scale:.3g})")
    out = {"phase": "pixtral_forward", "arch": cfg.name, "layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of {full.n_layers} layers, full width",
           "batch": spec["batch"], "seq": spec["seq"], "d_model": cfg.d_model,
           "compute_dtype": cfg.compute_dtype, "logits_shape": list(got.shape),
           "max_abs_err": err, "max_abs_logit": scale, "rel": err / scale, "tol": spec["tol"],
           "launches": launches,
           "flash_routes": {r: counted[f"flash_attention/{r}"] for r in ("cuda_cores", "wgmma")},
           "engine_refuses": refusal, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


#: phase 22: the seconds of steady decode load the meter is held to NVML's
#: energy counter over (after ``METER_SETTLE_S`` of the same load: NVML's
#: board draw is an average over about one second), the largest relative
#: gap allowed, and the watts allowed above the card's power limit
METER_WINDOW_S, METER_SETTLE_S, METER_TOL, METER_LIMIT_SLACK = 10.0, 2.0, 0.25, 1.05


def _nvml_device(torch) -> tuple:
    """Step 1 of phase 22: ``autodetect()`` must be the NVML meter, on the
    card torch runs on (the same name, and the same PCI address where torch
    exposes one).  Returns (meter, power limit in watts)."""
    from repro_torch.metering import NvmlMeter, autodetect

    meter = autodetect()
    if not isinstance(meter, NvmlMeter):
        raise AssertionError(f"metering: autodetect() is {type(meter).__name__}, not NvmlMeter")
    nvml, handle = meter.nvml, meter.handle
    name = nvml.name(handle)
    if name != torch.cuda.get_device_name():
        raise AssertionError(f"metering: NVML device {meter.index} is {name!r}, "
                             f"torch runs on {torch.cuda.get_device_name()!r}")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    pci = [getattr(props, k, None) for k in ("pci_domain_id", "pci_bus_id", "pci_device_id")]
    bus_id = None if None in pci else "{:08x}:{:02x}:{:02x}.0".format(*pci)
    if bus_id is not None and nvml.handle_by_pci_bus_id(bus_id).value != handle.value:
        raise AssertionError(f"metering: NVML device {meter.index} is not torch's card "
                             f"(PCI {bus_id})")
    limit = nvml.power_limit_watts(handle)
    emit({"phase": "metering", "step": "device", "meter": type(meter).__name__,
          "nvml_index": meter.index, "nvml_name": name, "torch_pci_bus_id": bus_id,
          "nvml_power_limit_w": limit, "nvidia_smi": nvidia_smi()})
    return meter, limit


def _meter_vs_counter(torch, meter) -> dict:
    """Step 2 of phase 22: one ``meter_window`` of the NVML meter around
    ``METER_WINDOW_S`` of replays of llama3.2-1b's graphed B=8 decode step
    at full width, against the delta of the card's energy counter
    (``nvmlDeviceGetTotalEnergyConsumption``) over the same window."""
    import numpy as np

    from repro_torch.metering import NvmlMeter, meter_window
    from repro_torch.serve import Request, ServeEngine

    cfg = _serve_config("llama3.2-1b")
    _free_dead_engines(torch)
    engine = ServeEngine(cfg, seed=0, device="cuda", n_slots=8, max_len=1024, page_size=16)
    rng = np.random.default_rng(2)
    for _ in range(8):
        engine.submit(Request(rng.integers(0, cfg.vocab_size, 512).tolist(), max_new_tokens=64))
    for _ in range(3):  # admits all 8, then decode steps (the graph captured)
        engine.step()
    if len(engine.scheduler.active) != 8:
        raise AssertionError("metering: not all 8 slots are decoding")
    program = engine.programs["decode"]
    inputs = _decode_inputs(engine, "greedy")
    index0 = engine.cache["index"].clone()

    def load(seconds: float) -> int:
        steps, t0 = 0, time.perf_counter()
        with torch.no_grad():
            while time.perf_counter() - t0 < seconds:
                for _ in range(8):
                    program(inputs, policy="greedy")
                # back to the same positions: every step stays in the slots' pages
                engine.cache["index"].copy_(index0)
                steps += 8
            torch.cuda.synchronize()
        return steps

    load(METER_SETTLE_S)
    nvml, handle = meter.nvml, meter.handle
    replays = program.summary()["replays"]
    with meter_window(NvmlMeter(meter.index)) as tele:
        e0 = nvml.total_energy_joules(handle)
        steps = load(METER_WINDOW_S)
        e1 = nvml.total_energy_joules(handle)
    if program.summary()["replays"] - replays != steps:
        raise AssertionError("metering: the load's decode steps were not all replays")
    counter = e1 - e0
    if not (tele.joules is not None and tele.joules > 0 and counter > 0):
        raise AssertionError(f"metering: meter {tele.joules} J, counter {counter} J")
    gap = abs(tele.joules - counter) / counter
    out = {"phase": "metering", "step": "meter_vs_counter", "seconds": tele.seconds,
           "decode_steps": steps, "ms_per_step": tele.seconds * 1e3 / steps,
           "meter_joules": tele.joules, "counter_joules": counter,
           "meter_watts": tele.watts, "counter_watts": counter / tele.seconds,
           "relative_gap": gap, "tol": METER_TOL}
    emit(out)
    if gap > METER_TOL:
        raise AssertionError(f"metering: the meter is {gap:.1%} off NVML's energy counter")
    return out


def _metered_serving(torch, limit: float) -> dict:
    """Step 3 of phase 22: phase 4's configuration and trace served without
    a meter and with ``meter="nvml"``: identical tokens, each phase's joules
    measured, fed to ``serve_phase_joules_total``, at a believable wattage."""
    tokens, phases = {}, {}

    def report(label):
        def fill(engine, out):
            tokens[label] = [engine.completions[i].tokens for i in sorted(engine.completions)]
            per_phase = {}
            for name in ("prefill", "decode"):
                tele = engine.telemetry[name]
                per_phase[name] = {
                    "calls": tele.calls, "tokens": tele.tokens, "seconds": tele.seconds,
                    "joules": tele.joules, "j_per_token": tele.joules_per_token,
                    "watts": None if tele.joules is None else tele.joules / tele.seconds,
                    "provenance": tele.provenance,
                    "counter_joules": engine.registry.get("serve_phase_joules_total")
                    .labels(phase=name).value,
                }
            out["metering"] = phases[label] = per_phase
        return fill

    runs = {label: phase_main_path(torch, phase=f"main_path_meter_{label}", report=report(label),
                                   meter=None if label == "none" else label)
            for label in ("none", "nvml")}
    if tokens["none"] != tokens["nvml"]:
        raise AssertionError("metering: the metered run's tokens differ from the unmetered run's")
    for name, got in phases["nvml"].items():
        if not (got["joules"] and got["joules"] > 0 and got["provenance"] == "measured"):
            raise AssertionError(f"metering: {name} joules {got['joules']} ({got['provenance']})")
        if abs(got["counter_joules"] - got["joules"]) > 1e-9 * got["joules"]:
            raise AssertionError(f"metering: serve_phase_joules_total{{phase={name}}} "
                                 f"{got['counter_joules']} != telemetry {got['joules']}")
        if not 0 < got["watts"] <= METER_LIMIT_SLACK * limit:
            raise AssertionError(f"metering: {name} averaged {got['watts']} W (limit {limit} W)")
    for name, got in phases["none"].items():
        if got["joules"] is not None or got["counter_joules"] != 0:
            raise AssertionError(f"metering: the unmetered run has {name} joules")
    out = {"phase": "metering", "step": "serving",
           "tokens_identical": True, "power_limit_w": limit}
    for name in ("prefill", "decode"):
        got = phases["nvml"][name]
        out[name] = {"j_per_token": got["j_per_token"], "watts": got["watts"],
                     "joules": got["joules"], "provenance": got["provenance"]}
    for label, run in runs.items():
        out[f"tok_per_s_{label}"] = run["tok_per_s"]
        out[f"decode_median_ms_{label}"] = run["decode_median_ms"]
        out[f"launches_{label}"] = run["launches"]
    out["meter_ms_per_decode_step"] = (out["decode_median_ms_nvml"]
                                       - out["decode_median_ms_none"])
    out["empty_window_ms"] = _empty_window_ms()
    emit(out)
    return out


def _empty_window_ms(n: int = 50) -> dict:
    """The NVML meter's own host cost: the median ms of ``n`` empty
    ``meter_window``s, and of its ``begin`` and its ``end`` alone."""
    import statistics

    from repro_torch.core.verify import Measurement
    from repro_torch.metering import NvmlMeter, meter_window

    meter, window = NvmlMeter(), Measurement(seconds=1e-3, compile_seconds=0.0, repeats=1)
    whole, begin, end = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        with meter_window(meter):
            pass
        t1 = time.perf_counter()
        meter.begin()
        t2 = time.perf_counter()
        meter.end(window)
        t3 = time.perf_counter()
        whole.append(t1 - t0)
        begin.append(t2 - t1)
        end.append(t3 - t2)
    return {name: statistics.median(xs) * 1e3
            for name, xs in (("window", whole), ("begin", begin), ("end", end))}


def _offload_energy(torch, n_fft: int = 256, n_lu: int = 192) -> dict:
    """Step 4 of phase 22: the paper's offload pipeline on phase 6's apps
    under ``perf_per_watt`` with the NVML meter, through the serial, batched
    and device-parallel executors; then a ``latency`` and a ``perf_per_watt``
    store of the FFT app (trials of at least a second) and their trade-off
    table."""
    import tempfile

    import repro_torch.kernels as kernels
    from repro_torch.apps import fourier, matrix
    from repro_torch.metering import report
    from repro_torch.offload import OffloadSession

    inputs = {"fourier": fourier.make_input(n_fft), "matrix": matrix.make_input(n_lu)}
    apps = {"fourier_app_libcall": (fourier.fourier_app_libcall, inputs["fourier"]),
            "matrix_app_libcall": (matrix.matrix_app_libcall, inputs["matrix"])}
    provenance = {"serial": "measured", "batched": "estimated", "device_parallel": "measured"}
    winners: dict = {}
    rows = []
    kernels.reset_launches()
    for executor, want in provenance.items():
        for name, (app, x) in apps.items():
            t0 = time.perf_counter()
            res = OffloadSession(app, args=(x,), repeats=1, objective="perf_per_watt",
                                 meter="nvml", executor=executor).run()
            seconds = time.perf_counter() - t0
            if not res.numerics_ok:
                raise AssertionError(f"metering: {name} ({executor}) failed the numerics check")
            measured = [t for t in res.trials if not t.cached]
            bad = [(t.pattern, t.energy_joules, t.energy_provenance) for t in measured
                   if t.energy_joules is None or t.energy_provenance != want]
            if bad or not measured:
                raise AssertionError(f"metering: {name} ({executor}) trials without "
                                     f"{want} joules: {bad}")
            winners[(executor, name)] = res.pattern
            rows.append({"app": name, "executor": executor, "pattern": list(res.pattern),
                         "numerics_ok": res.numerics_ok, "search_seconds": seconds,
                         "trials": [{"pattern": list(t.pattern), "seconds": t.seconds,
                                     "joules": t.energy_joules,
                                     "provenance": t.energy_provenance} for t in measured]})
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("complex_matmul", "schur_update")}
    if min(launches.values()) <= 0:
        raise AssertionError(f"metering: an offload kernel never launched: {launches}")
    for name in apps:
        if winners[("device_parallel", name)] != winners[("serial", name)]:
            raise AssertionError(f"metering: {name}: device_parallel picked "
                                 f"{winners[('device_parallel', name)]}, serial "
                                 f"{winners[('serial', name)]}")
    emit({"phase": "metering", "step": "offload", "n_fft": n_fft, "n_lu": n_lu,
          "runs": rows, "launches": launches})

    app, x = apps["fourier_app_libcall"]
    with tempfile.TemporaryDirectory(prefix="energy-plans-") as root:
        stores = {}
        for objective in ("latency", "perf_per_watt"):
            stores[objective] = f"{root}/{objective}"
            OffloadSession(app, args=(x,), repeats=1, min_seconds=1.0, objective=objective,
                           meter="nvml", store=stores[objective],
                           key=f"zoo:fourier_app_libcall:n{n_fft}").run()
        diff = report.diff_stores(stores["latency"], stores["perf_per_watt"])
    if len(diff) != 1 or diff[0].joules_a is None or diff[0].joules_b is None:
        raise AssertionError(f"metering: the store diff lacks its row or joules: {diff}")
    print(report.render_table(diff, label_a="latency", label_b="perf_per_watt"), flush=True)
    out = {"phase": "metering", "step": "tradeoff", "rows": [r.to_json() for r in diff]}
    emit(out)
    return out


def phase_metering(torch) -> dict:
    """Phase 22: the port's power meters on the card (``repro_torch.metering``)."""
    t0 = time.perf_counter()
    meter, limit = _nvml_device(torch)
    counter = _meter_vs_counter(torch, meter)
    serving = _metered_serving(torch, limit)
    tradeoff = _offload_energy(torch)
    out = {"phase": "metering", "step": "done", "seconds": time.perf_counter() - t0,
           "meter_vs_counter_gap": counter["relative_gap"],
           "prefill_j_per_token": serving["prefill"]["j_per_token"],
           "decode_j_per_token": serving["decode"]["j_per_token"],
           "meter_ms_per_decode_step": serving["meter_ms_per_decode_step"],
           "winners_agree": tradeoff["rows"][0]["agree"]}
    emit(out)
    return out


#: phase 23's offload blocks in binding mode over (torch, cuda): the input
#: size of each and whether its traced working set passes ``tiny-32m``'s 32
#: MiB there.  The FFT at the paper's 2048 does (~208 MiB estimated: the
#: complex64 input, its DFT planes and stage products); the LU is traced
#: at 128 (well under 1 MiB, which fits): its blocked loop is Python, a few
#: ops a column, and a trace at 2048 takes ~150 s of host CPU
ANALYSIS_BLOCKS = {"fft2d": (2048, True), "lu": (128, False)}
#: phase 23's memory estimate of one eager decode step must bound the
#: measured peak from above, and by at most this factor (the reference's
#: bracket, tests/test_resources.py)
ESTIMATE_BRACKET = 4.0


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _analysis_capacity(torch, engine) -> dict:
    """Phase 4's engine planned against the probed card: its params and
    cache bytes equal the engine's tensors', its pool the live pool's."""
    plan = engine.plan_capacity("host")
    held = {"params_bytes": _tree_bytes(engine.params), "cache_bytes": _tree_bytes(engine.cache)}
    for key, n in held.items():
        if getattr(plan, key) != n:
            raise AssertionError(f"analysis: plan {key} {getattr(plan, key)} != the engine's {n}")
    if plan.pool_tokens != engine.kv.pool.token_capacity:
        raise AssertionError(f"analysis: plan pool {plan.pool_tokens} != live pool "
                             f"{engine.kv.pool.token_capacity}")
    if not plan.fits:
        raise AssertionError(f"analysis: phase 4's engine does not fit the card: {plan.summary()}")
    return {"params_bytes": plan.params_bytes, "cache_bytes": plan.cache_bytes,
            "per_slot_bytes": plan.per_slot_bytes, "per_page_bytes": plan.per_page_bytes,
            "pool_tokens": plan.pool_tokens, "max_slots": plan.max_slots,
            "max_pages": plan.max_pages, "max_prefill_tokens": plan.max_prefill_tokens,
            "budget_bytes": plan.budget_bytes, "headroom_bytes": plan.headroom_bytes}


def _analysis_lint(torch, engine) -> dict:
    """``engine.lint()`` after phase 4's trace: no warning or error, paged
    attention and rmsnorm among the decode program's traced kernels, and
    not one launch (the traces run nothing)."""
    import repro_torch.kernels as kernels

    torch.cuda.synchronize()
    before, traced_before = kernels.counters(), kernels.traced_counts()
    t0 = time.perf_counter()
    diags = engine.lint()
    seconds = time.perf_counter() - t0
    after = kernels.counters()
    if after != before:
        moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
        raise AssertionError(f"analysis: the lint launched kernels: {moved}")
    bad = [str(d) for d in diags if d.severity in ("warning", "error")]
    if bad:
        raise AssertionError(f"analysis: lint of phase 4's engine: {bad}")
    programs = {name: sorted(p.removeprefix("kernel:")
                             for p in engine.programs.features(name).primitives
                             if p.startswith("kernel:"))
                for name in engine.programs.records}
    missing = [k for k in ("paged_attention", "rmsnorm") if k not in programs["decode"]]
    if missing:
        raise AssertionError(f"analysis: the decode trace stood in for no {missing}: {programs}")
    traced = {k: n - traced_before[k] for k, n in kernels.traced_counts().items()
              if n != traced_before[k]}
    return {"lint_seconds": seconds, "diagnostics": [str(d) for d in diags],
            "traced_kernels": programs, "abstract_calls": traced,
            "signatures": {n: r["signatures"] for n, r in engine.programs.stats().items()}}


def _analysis_estimate(torch, engine) -> dict:
    """``estimate_memory`` of one eager decode step at B = n_slots (the
    engine state as its operands) against that call's measured peak, the
    operands resident: an upper bound within ``ESTIMATE_BRACKET``."""
    from repro_torch.analysis import estimate_memory

    rec = engine.programs.records["decode"]
    views = engine.programs["decode"].inputs(_decode_inputs(engine, "greedy"))
    fn, args = rec.trace((views,), {"policy": "greedy"})
    t0 = time.perf_counter()
    est = estimate_memory(fn, *args)
    est_s = time.perf_counter() - t0
    with torch.no_grad():
        fn(*args)  # warm: the library and cuBLAS are set up outside the window
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(*args)
        torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base + est.operand_bytes
    ratio = est.peak_live_bytes / measured
    if not 1.0 <= ratio <= ESTIMATE_BRACKET:
        raise AssertionError(f"analysis: estimate {est} against a measured peak of "
                             f"{measured} bytes (ratio {ratio:.4f})")
    return {"estimate": est.to_dict(), "measured_peak_bytes": measured,
            "transient_peak_bytes": measured - est.operand_bytes,
            "estimate_over_measured": ratio, "estimate_seconds": est_s}


def _analysis_sessions(torch) -> dict:
    """The offload session with the pre-filters on the card.  Phase 6's
    libcall apps (app mode: a ``SubsetSpace``, which the pre-filters leave
    alone, as the reference's) commit the same winner with
    ``legality=True, resources="host"`` as without.  The apps' blocks in
    binding mode over (torch, cuda) at ``ANALYSIS_BLOCKS``: the legality
    probes trace the cuda targets without a launch, and nothing is pruned
    against the card; against ``tiny-32m`` the cuda binding is pruned, with
    a ``memory:`` reason, where the block's working set passes 32 MiB."""
    import repro_torch.kernels as kernels
    from repro_torch.apps import fourier, matrix
    from repro_torch.core import blocks as blocks_mod
    from repro_torch.offload import OffloadSession

    out: dict = {"apps": {}, "blocks": {}}
    for app, x in ((fourier.fourier_app_libcall, fourier.make_input(256)),
                   (matrix.matrix_app_libcall, matrix.make_input(192))):
        plain = OffloadSession(app, args=(x,), repeats=1).run()
        pre = OffloadSession(app, args=(x,), repeats=1, legality=True, resources="host").run()
        pruned = getattr(pre.report, "pruned", 0) if pre.report else 0
        if pre.mapping != plain.mapping or pruned:
            raise AssertionError(f"analysis: {app.__name__} with the pre-filters committed "
                                 f"{pre.mapping} ({pruned} pruned), without {plain.mapping}")
        out["apps"][app.__name__] = {"winner": pre.mapping, "pruned": pruned,
                                    "numerics_ok": pre.numerics_ok}
    inputs = {"fft2d": lambda n: torch.randn(n, n, dtype=torch.complex64, device="cuda"),
              "lu": lambda n: torch.from_numpy(matrix.make_input(n)).float().cuda()}
    for block, (n, over) in ANALYSIS_BLOCKS.items():
        x = inputs[block](n)

        def builder(block=block):
            return lambda x: blocks_mod.registry.call(block, x)

        before = kernels.launch_counts()
        t0 = time.perf_counter()
        host = OffloadSession(builder, args=(x,), blocks={block: ["torch", "cuda"]},
                              legality=True, resources="host", device="cuda")
        host.analyze()
        host.discover()
        host_s = time.perf_counter() - t0
        verdicts = {v.target: v.status for v in host.legality_report.verdicts}
        if verdicts.get("cuda") != "legal" or host.space._illegal:
            raise AssertionError(f"analysis: {block} at {n} on the card: {verdicts}, "
                                 f"pruned {host.space._illegal}")
        tiny = OffloadSession(builder, args=(x,), blocks={block: ["torch", "cuda"]},
                              resources="tiny-32m", device="cuda")
        tiny.analyze()
        tiny.discover()
        reason = tiny.space._illegal.get((block, "cuda"), "")
        if reason.startswith("memory:") != over:
            raise AssertionError(f"analysis: {block} at {n} against tiny-32m: "
                                 f"{tiny.resources_report.to_dict()}")
        if kernels.launch_counts() != before:
            raise AssertionError(f"analysis: {block}'s pre-filters launched kernels")
        out["blocks"][block] = {"n": n, "verdicts": verdicts, "host_seconds": host_s,
                                "base_bytes": host.resources_report.base.peak_live_bytes,
                                "tiny_32m": reason or "fits"}
    return out


def _analysis_preflight() -> dict:
    """``--preflight --envelope host`` through the serve CLI, as processes:
    full llama3.2-1b fits the card (exit 0), full deepseek-v2-236b (236B
    parameters in bf16) does not (exit 2)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--page-size", "16",
            "--slots", "8", "--max-len", "1024", "--envelope", "host", "--preflight"]
    out = {}
    for arch, want in (("llama3.2-1b", 0), ("deepseek-v2-236b", 2)):
        proc = subprocess.run(base + ["--arch", arch], capture_output=True, text=True,
                              timeout=300, env=env, cwd=ROOT)
        if proc.returncode != want:
            raise AssertionError(f"analysis: preflight of {arch} exited {proc.returncode}, "
                                 f"not {want}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
        total = next(ln for ln in proc.stdout.splitlines() if ln.strip().startswith("total"))
        out[arch] = {"exit": proc.returncode, "total": total.strip()}
    return out


def phase_analysis(torch) -> dict:
    """Phase 23: static analysis on the card (``repro_torch.analysis``):
    the probed envelope, phase 4's engine planned, linted and its decode
    step's memory estimated, the offload session's pre-filters and the
    serve CLI's preflight."""
    import numpy as np

    from repro_torch.analysis import STATIC_ENVELOPES, resolve_envelope
    from repro_torch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    env = resolve_envelope("host")
    if env.platform != "gpu" or env.name != torch.cuda.get_device_name(0):
        raise AssertionError(f"analysis: the probed envelope is not torch's card: {env}")
    static = STATIC_ENVELOPES["h100-80g"]
    out: dict = {"phase": "analysis", "envelope": {
        "name": env.name, "memory_bytes": env.memory_bytes, "smem_bytes": env.smem_bytes,
        "h100_80g_memory_bytes": static.memory_bytes, "h100_80g_smem_bytes": static.smem_bytes}}

    # phase 4's engine and trace (llama3.2-1b full, page 16, 8 slots, max_len 1024)
    _free_dead_engines(torch)
    cfg = _serve_config("llama3.2-1b")
    engine = ServeEngine(cfg, seed=0, device="cuda", n_slots=8, max_len=1024, page_size=16)
    rng = np.random.default_rng(0)
    for _ in range(16):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(64, 513))).tolist()
        engine.submit(Request(prompt, max_new_tokens=32))
    if len(engine.run_until_idle(max_steps=10_000)) != 16:
        raise AssertionError("analysis: phase 4's trace did not complete")
    out["capacity"] = _analysis_capacity(torch, engine)
    out["lint"] = _analysis_lint(torch, engine)
    out["decode_estimate"] = _analysis_estimate(torch, engine)
    del engine
    _free_dead_engines(torch)
    out["sessions"] = _analysis_sessions(torch)
    out["preflight"] = _analysis_preflight()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


#: phase 24's two cells at shapes the card runs (``SHAPES`` keeps the
#: reference's four): llama's B=8 decode step with every slot at full
#: context (1024), and phase 19's B=8, S=512 train step (one microbatch)
COST_DECODE_SHAPE = ("decode_1k", 1024, 8, "decode")
COST_TRAIN_SHAPE = ("train_512", TRAIN_SEQ, TRAIN_BATCH, "train")
#: trials CostGuidedSearch measures in phase 24: the baseline and its top_k
COST_TOP_K = 2


def _record(rec: dict) -> dict:
    """A dry-run record without its traceback, kernels by name."""
    return {k: v for k, v in rec.items() if k != "traceback"}


def _unlaunched(torch, label: str, fn):
    """``fn()``, raising if any kernel launched meanwhile (a trace runs
    nothing: every wrapper takes its abstract path)."""
    import repro_torch.kernels as kernels

    torch.cuda.synchronize()
    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    if after != before:
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        raise AssertionError(f"cost_model: {label} launched kernels: {moved}")
    return out


def _replay_device_ms(torch, fn, n: int = 20) -> float:
    """Device ms of one replay of ``fn`` captured as a CUDA graph: CUDA
    events around ``n`` back-to-back replays, median of 5 windows."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return sorted(times)[2]


def _cost_decode(torch, cfg, shape) -> dict:
    """The dry-run's decode cell at ``shape`` against the same step function
    run on the card: its roofline against a CUDA-graph replay's device time
    (every slot at position len - 1, reset inside the graph)."""
    import numpy as np

    from repro_torch.launch import dryrun, steps
    from repro_torch.models import lm

    rec = _unlaunched(torch, "the decode cell's trace",
                      lambda: dryrun.run_cell(cfg.name, shape, device="cuda"))
    if rec["status"] != "ok":
        raise AssertionError(f"cost_model: decode cell: {rec.get('error')}")
    params = lm.init_params(cfg, seed=0, device="cuda")  # the cell's f32 parameters
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="cuda")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (shape.global_batch, 1))
                              .astype(np.int32)).to("cuda")
    step = steps.make_decode_step(cfg)

    def run():
        cache["index"].fill_(shape.seq_len - 1)
        return step(params, cache, {"tokens": tokens})

    with torch.no_grad():
        ms = _replay_device_ms(torch, run)
    del params, cache
    _free_dead_engines(torch)
    return {"record": _record(rec), "measured_device_ms": ms,
            "roofline_ms": rec["roofline_s"] * 1e3, "ratio": rec["roofline_s"] * 1e3 / ms}


def _cost_search(torch) -> dict:
    """``CostGuidedSearch(top_k=COST_TOP_K)`` with the default roofline over
    llama3.2-1b's full-width decode binding space (torch, cuda) through
    ``plan_zoo``, beside the zoo's default strategy on the same space."""
    import tempfile
    import warnings

    import repro_torch.kernels as kernels
    from repro_torch.core.planner import CostGuidedSearch, make_roofline_cost_fn
    from repro_torch.offload import OffloadSession

    roofline = make_roofline_cost_fn()
    ranked, moved = [], {}

    def cost_fn(space, cand, args):
        before, t0 = kernels.launch_counts(), time.perf_counter()
        seconds = roofline(space, cand, args)
        trace_seconds = time.perf_counter() - t0
        after = kernels.launch_counts()
        moved.update({k: after[k] - before[k] for k in after if after[k] != before[k]})
        ranked.append({"binding": space.binding_of(cand), "roofline_ms": seconds * 1e3,
                       "trace_seconds": trace_seconds})
        return seconds

    out = {}
    cell = ("llama3.2-1b", "decode")
    for label, strategy in (("cost_guided", CostGuidedSearch(top_k=COST_TOP_K, cost_fn=cost_fn)),
                            ("default", None)):
        _free_dead_engines(torch)
        with tempfile.TemporaryDirectory(prefix="plans-") as plan_dir, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            results = OffloadSession.plan_zoo(
                plan_dir, [cell], reduced=False, layers=0, batch=BINDING_BATCH,
                seq=BINDING_SEQ, targets=("torch", "cuda"), strategy=strategy, device="cuda")
            seconds = time.perf_counter() - t0
        if cell not in results:
            raise AssertionError(f"cost_model: plan_zoo with {label} committed no plan: "
                                 f"{[str(w.message) for w in caught]}")
        report = results[cell].report
        out[label] = {"strategy": report.strategy, "winner": results[cell].mapping,
                      "speedup": results[cell].speedup, "trials": len(report.trials),
                      "evaluations": report.evaluations, "search_seconds": report.search_seconds,
                      "plan_zoo_seconds": seconds,
                      "trial_ms": {"+".join(f"{k}={v}" for k, v in t.mapping.items()) or
                                   "baseline": t.seconds * 1e3 for t in report.trials}}
        if strategy is not None:
            out[label]["ranking_seconds"] = sum(r["trace_seconds"] for r in ranked)
            out[label]["ranking"] = sorted(ranked, key=lambda r: r["roofline_ms"])
    if moved:
        raise AssertionError(f"cost_model: ranking launched kernels: {moved}")
    if out["cost_guided"]["trials"] != 1 + COST_TOP_K:
        raise AssertionError(f"cost_model: CostGuidedSearch measured "
                             f"{out['cost_guided']['trials']} trials, not 1 + {COST_TOP_K}")
    out["winners_agree"] = out["cost_guided"]["winner"] == out["default"]["winner"]
    return out


def phase_cost_model(torch, train: dict) -> dict:
    """The cost model and the one-card dry-run (``repro_torch.launch.dryrun``,
    ``launch/graph_cost.py``) at full width: (a) the dry-run's records of
    llama3.2-1b's reference cells (``long_500k`` skipped by the
    reference's rule), no kernel launched by their traces; (b) the
    roofline as a lower bound, like for like: a B=8 decode step with every
    slot at full context (1024) against its CUDA-graph replay's device time,
    and phase 19's B=8, S=512 train step against that phase's profiled
    device ms, each ``roofline_s`` no more than the measured time, with the
    train step's estimated peak beside phase 19's measured one; (c)
    ``CostGuidedSearch(top_k=2)`` with the default roofline through
    ``plan_zoo`` on llama3.2-1b's decode bindings, exactly the baseline and
    two trials measured, no kernel launched while ranking, its winner and
    seconds beside the zoo's default strategy's."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    _free_dead_engines(torch)
    arch = "llama3.2-1b"
    cfg = get_config(arch)
    cells = []
    for name in SHAPES:
        rec = _unlaunched(torch, f"the {name} trace",
                          lambda: dryrun.run_cell(arch, name, device="cuda"))
        want = "skipped" if name == "long_500k" else "ok"
        if rec["status"] != want:
            raise AssertionError(f"cost_model: {arch} x {name}: {rec['status']} "
                                 f"{rec.get('error')}")
        cells.append(_record(rec))
        emit({"phase": "cost_model_cell", **_record(rec)})

    decode = _cost_decode(torch, cfg, ShapeConfig(*COST_DECODE_SHAPE))
    train_rec = _unlaunched(torch, "the train cell's trace", lambda: dryrun.run_cell(
        arch, ShapeConfig(*COST_TRAIN_SHAPE), overrides={"microbatch": 1}, device="cuda"))
    if train_rec["status"] != "ok":
        raise AssertionError(f"cost_model: train cell: {train_rec.get('error')}")
    train_ms = train["profiled_step"]["device_ms"]
    bound = {
        "decode": decode,
        "train": {"record": _record(train_rec), "measured_device_ms": train_ms,
                  "roofline_ms": train_rec["roofline_s"] * 1e3,
                  "ratio": train_rec["roofline_s"] * 1e3 / train_ms,
                  "peak_bytes_estimated": train_rec["peak_bytes_per_device"],
                  "peak_bytes_measured": train["peak_memory_gb"] * 1e9},
    }
    over = {k: v["ratio"] for k, v in bound.items() if not v["ratio"] <= 1.0}
    if over:
        raise AssertionError(f"cost_model: roofline above the measured device time: {over}")
    out = {"phase": "cost_model", "cells": [(c["shape"], c["status"], c.get("fits_device"),
                                             c.get("roofline_s")) for c in cells],
           "lower_bound": bound, "search": _cost_search(torch),
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


#: phase 25's full-size bf16 step, sharded (a one-card mesh) against
#: unsharded: the loss within 1e-5 relative, the gradients' global norm
#: within 1e-4 relative and each stepped parameter leaf within 1e-3 of its
#: max |p|.  On one rank every local op is the unsharded op on the same
#: tensor; the sums that change order are the loss's one-hot gold logit
#: (exact: one non-zero term) and the reductions of the placement changes
MESH_BF16_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "param": 1e-3}
#: phase 25 (b): (arch, shape, mesh, overrides, depth cut or None)
MESH_CELLS = tuple(("llama3.2-1b", shape, mesh, None, None)
                   for mesh in ("16x16", "2x16x16")
                   for shape in ("train_4k", "prefill_32k", "decode_32k")) + tuple(
    ("deepseek-v2-236b", "decode_32k", "16x16", {"ep_mode": ep}, 4) for ep in ("gather", "psum"))
MESH_SETTINGS = (("propagation", (False, False)), ("manual", (True, True)))


@contextlib.contextmanager
def _one_rank_group(torch):
    """A one-rank NCCL process group (a ``FileStore`` in a temp dir), torn
    down after."""
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", store=dist.FileStore(f"{store_dir}/store", 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sharded_grads(torch, params, batch, cfg, mesh, rules):
    """(loss, gradient leaves) of ``lm.loss_fn`` on ``DTensor`` placements
    of ``params`` / ``batch``, whole."""
    from repro_torch.models import params as pm
    from repro_torch.sharding import use_sharding

    from repro_torch.models import lm

    sp = pm.shard_params(params, lm.build_metas(cfg), mesh, rules)
    sb = pm.shard_batch(batch, mesh, rules)
    with use_sharding(mesh, rules):
        loss, grads = _loss_and_grads(torch, sp, sb, cfg)
    return loss.full_tensor(), [g.full_tensor() for g in grads]


def _grad_check(phase: str, grads_s, grads_u) -> float:
    """The largest leaf error over its max |g| (each within 1e-4)."""
    import math

    worst = 0.0
    for gs, gu in zip(grads_s, grads_u):
        scale = float(gu.abs().max())
        err = float((gs.float() - gu.float()).abs().max())
        if not (math.isfinite(scale) and err <= 1e-4 * max(scale, 1e-30)):
            raise AssertionError(f"{phase}: a gradient leaf differs by {err:.3g} "
                                 f"(max |g| {scale:.3g})")
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def phase_distributed(torch, train: dict) -> dict:
    """Phase 25: the port's distribution on the card (see the module
    docstring): (a) the sharded train step on a one-rank NCCL mesh against
    the unsharded one, (b) the mesh dry-run's cells."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import layers, lm
    from repro_torch.models import params as pm
    from repro_torch.optim.adamw import AdamW, tree_leaves
    from repro_torch.sharding import rules_for, use_sharding

    t_phase = time.perf_counter()
    _free_dead_engines(torch)
    out: dict = {"phase": "distributed", "card": nvidia_smi()}
    with _one_rank_group(torch):
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        # (a1) phase 18's cell: 2 layers, f32, B 2, S 128
        cfg = dataclasses.replace(get_config("llama3.2-1b"), compute_dtype="float32").cut(2)
        rules = rules_for(cfg, ShapeConfig("t", 128, 2, "train"), {"data": 1, "model": 1})
        params = lm.init_params(cfg, seed=1, device="cuda")
        batch = _train_inputs(torch, cfg, 2, 128)
        kernels.reset_launches()
        loss_u, grads_u = _loss_and_grads(torch, params, batch, cfg)
        counted_u = {c: kernels.counters()[c] for c in TRAIN_COUNTERS}
        f32 = {}
        try:
            for name, flags in MESH_SETTINGS:
                layers.BF16_TP_REDUCE, layers.MEGATRON_MLP = flags
                kernels.reset_launches()
                loss_s, grads_s = _sharded_grads(torch, params, batch, cfg, mesh, rules)
                counted = {c: kernels.counters()[c] for c in TRAIN_COUNTERS}
                loss_err = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
                if not loss_err <= 1e-5:
                    raise AssertionError(f"distributed {name}: f32 loss {float(loss_s)} "
                                         f"vs unsharded {float(loss_u)}")
                if counted != counted_u or not all(counted.values()):
                    raise AssertionError(f"distributed {name}: f32 launches {counted} "
                                         f"vs unsharded {counted_u}")
                f32[name] = {"loss_rel_err": loss_err, "launches": counted,
                             "max_grad_err_over_max_abs_g": _grad_check(
                                 f"distributed {name} f32", grads_s, grads_u)}
        finally:
            layers.BF16_TP_REDUCE = layers.MEGATRON_MLP = False
        del params, grads_u, grads_s
        out["f32_2_layers"] = f32
        _free_dead_engines(torch)

        # (a2) phase 19's step at full size, sharded against unsharded
        cfg = get_config("llama3.2-1b")
        shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
        rules = rules_for(cfg, shape, {"data": 1, "model": 1})
        metas = lm.build_metas(cfg)
        opt = AdamW(moment_dtype=cfg.opt_dtype)
        hyper = TrainHyper(warmup_steps=2, total_steps=TRAIN_STEPS)
        params0 = lm.init_params(cfg, seed=0, device="cuda")
        batches = [_train_inputs(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, i) for i in range(4)]
        step_u = make_train_step(cfg, opt, hyper)
        kernels.reset_launches()
        p_u, _, m_u = step_u(_clone_tree(torch, params0), opt.init(params0), batches[0])
        loss_u = float(m_u["loss"])
        counted_u = {c: kernels.counters()[c] for c in TRAIN_COUNTERS}
        _, grads_u = _loss_and_grads(torch, params0, batches[0], cfg)
        norm_u = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_u)))
        del grads_u
        full = {}
        try:
            for name, flags in MESH_SETTINGS:
                layers.BF16_TP_REDUCE, layers.MEGATRON_MLP = flags
                step = make_train_step(cfg, opt, hyper,
                                       grad_shardings=pm.placement_tree(metas, mesh, rules))
                sp = pm.shard_params(_clone_tree(torch, params0), metas, mesh, rules)
                so = pm.shard_opt_state(opt.init(params0), metas, mesh, rules)
                sb = [pm.shard_batch(b, mesh, rules) for b in batches]
                kernels.reset_launches()
                with use_sharding(mesh, rules):
                    sp, so, m_s = step(sp, so, sb[0])
                loss_s = float(m_s["loss"])
                counted = {c: kernels.counters()[c] for c in TRAIN_COUNTERS}
                param_err = max(
                    float((a.full_tensor() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(tree_leaves(sp), tree_leaves(p_u)))
                _, grads_s = _sharded_grads(torch, params0, batches[0], cfg, mesh, rules)
                norm_s = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads_s)))
                del grads_s
                check = {"loss": loss_s, "unsharded_loss": loss_u,
                         "loss_rel_err": abs(loss_s - loss_u) / abs(loss_u),
                         "grad_norm": norm_s, "unsharded_grad_norm": norm_u,
                         "grad_norm_rel_err": abs(norm_s - norm_u) / norm_u,
                         "param_err_over_max_abs": param_err, "tol": MESH_BF16_TOL}
                if not (check["loss_rel_err"] <= MESH_BF16_TOL["loss"]
                        and check["grad_norm_rel_err"] <= MESH_BF16_TOL["grad_norm"]
                        and param_err <= MESH_BF16_TOL["param"]):
                    raise AssertionError(f"distributed {name}: sharded against unsharded "
                                         f"{check}")
                if counted != counted_u or not all(counted.values()):
                    raise AssertionError(f"distributed {name}: launches {counted} "
                                         f"vs unsharded {counted_u}")
                # wall ms of two more steps, then one profiled step
                wall = []
                with use_sharding(mesh, rules):
                    for b in sb[1:3]:
                        t0 = time.perf_counter()
                        sp, so, m = step(sp, so, b)
                        float(m["loss"])
                        wall.append((time.perf_counter() - t0) * 1e3)
                    t0 = time.perf_counter()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        sp, so, m = step(sp, so, sb[3])
                        float(m["loss"])
                        torch.cuda.synchronize()
                    profiled_wall = (time.perf_counter() - t0) * 1e3
                device, events = _device_events(prof)
                full[name] = {**check, "launches": counted,
                              "step_wall_ms": wall, "median_step_ms": float(np.median(wall)),
                              "profiled_wall_ms": profiled_wall,
                              "device_ms": sum(device.values()), "device_events": events,
                              "nccl_device_ms": sum(v for k, v in device.items()
                                                    if "nccl" in k.lower())}
                del sp, so, sb
                _free_dead_engines(torch)
        finally:
            layers.BF16_TP_REDUCE = layers.MEGATRON_MLP = False
        out["full_size"] = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                            "unsharded_launches": counted_u, "settings": full,
                            "phase19_median_step_ms": train["median_step_ms"],
                            "phase19_device_ms": train["profiled_step"]["device_ms"]}
        del params0, p_u
    _free_dead_engines(torch)
    emit({**out, "phase": "distributed_step"})
    out["mesh_cells"] = _distributed_cells(torch, out["card"])
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "distributed", "card": out["card"], "seconds": out["seconds"],
          "mesh_cells": out["mesh_cells"]})
    return out


def _distributed_cells(torch, card: str) -> list:
    """Phase 25 (b): the mesh dry-run's cells, traced on a fake process
    group with nothing launched."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    cells = []
    for arch, shape, mesh_name, overrides, depth in MESH_CELLS:
        get = dryrun.get_config
        if depth:
            dryrun.get_config = lambda a, depth=depth: get_config(a).cut(depth)
        try:
            rec = _unlaunched(torch, f"the {arch} {shape} {mesh_name} trace",
                              lambda: dryrun.run_cell(arch, shape, overrides=overrides,
                                                      device="cuda", mesh=mesh_name))
        finally:
            dryrun.get_config = get
        if rec["status"] != "ok":
            raise AssertionError(f"distributed: {arch} x {shape} x {mesh_name}: "
                                 f"{rec.get('error')}\n{rec.get('traceback', '')}")
        cell = {"arch": arch, "shape": shape, "mesh": mesh_name, "layers": depth,
                "overrides": overrides, "chips": rec["chips"], "trace_s": rec["trace_s"],
                "peak_bytes_per_device": rec["peak_bytes_per_device"],
                "fits_device": rec["fits_device"],
                "collectives_per_device": rec["collectives_per_device"],
                "collective_bytes_per_device": rec["collective_bytes_per_device"],
                "graph_flops_per_device": rec["graph_flops_per_device"],
                "roofline_s": rec["roofline_s"], "bound_by": rec["bound_by"]}
        emit({"phase": "distributed_cell", "card": card, **cell})
        cells.append(cell)
    return [(c["arch"], c["shape"], c["mesh"], c["overrides"], c["peak_bytes_per_device"],
             c["fits_device"], c["collective_bytes_per_device"], c["trace_s"]) for c in cells]


#: phase 26: each example's arguments (its fast size on the card)
EXAMPLES = (("quickstart_torch.py", ["--fast"]),
            ("offload_existing_app_torch.py", []),
            ("train_lm_torch.py", ["--steps", "40", "--d-model", "128", "--layers", "2"]))


def phase_examples(torch) -> dict:
    """Phase 26: each example as a process on the card (``PYTHONPATH`` the
    checkout's ``src``), its exit code 0; ``train_lm_torch.py`` checkpoints
    into a fresh temp dir."""
    import os
    import tempfile

    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        for name, args in EXAMPLES:
            if name == "train_lm_torch.py":
                args = [*args, "--ckpt-dir", f"{tmp}/ckpt"]
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), *args],
                                  capture_output=True, text=True, timeout=300, env=env,
                                  cwd=str(ROOT))
            runs.append({"example": name, "args": args, "returncode": proc.returncode,
                         "seconds": time.perf_counter() - t0,
                         "last_lines": proc.stdout.strip().splitlines()[-3:]})
            if proc.returncode != 0:
                raise AssertionError(f"examples: {name} exited {proc.returncode}: "
                                     f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    out = {"phase": "examples", "runs": runs, "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_main_path_train(torch) -> dict:
    """The train path: full llama3.2-1b (16 layers, d 2048, vocab 128256;
    f32 master weights and moments, bf16 compute, full remat) for
    ``TRAIN_STEPS`` steps of ``make_train_step`` on ``SyntheticLMData`` at B
    8, S 512.  Every loss finite; ms a step (median after the first), tok/s,
    peak memory; the launches of flash forward and backward and of
    rmsnorm's plain and add forms forward and backward, each > 0; one
    profiled step (busy share, device ms by kernel); then, from the
    trained state, the loss and the global gradient norm through the
    kernels against ``attention`` / ``rmsnorm`` bound to ``torch``, held
    to ``TRAIN_BF16_TOL``."""
    import math

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels as kernels
    from repro_torch.configs import get_config
    from repro_torch.core import blocks
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    _free_dead_engines(torch)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device="cuda")
    opt = AdamW(moment_dtype=cfg.opt_dtype)
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, TrainHyper(warmup_steps=2, total_steps=TRAIN_STEPS))
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in data.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0

    kernels.reset_launches()
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, batches[i])
        losses.append(float(metrics["loss"]))  # reads the loss: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counted = {c: kernels.counters()[c] for c in TRAIN_COUNTERS}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"main_path_train: losses {losses}")
    missing = [c for c, n in counted.items() if n <= 0]
    if missing:
        raise AssertionError(f"main_path_train: never launched {missing}: {counted}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    median = float(np.median(step_ms[1:]))

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        params, state, metrics = step_fn(params, state, batches[TRAIN_STEPS])
        float(metrics["loss"])
        torch.cuda.synchronize()
    profiled_wall = (time.perf_counter() - t0) * 1e3
    device, events = _device_events(prof)
    total = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:10]
    # the wgmma route's delta pass, dK / dV and dQ (flash_bwd_*): every
    # backward launch so far (the 10 steps and the profiled one) took it
    flash_bwd = {k: v for k, v in device.items() if "flash_bwd_" in k}
    flash_bwd_routes = dict(kernels.KERNELS["flash_attention_bwd"].routes)
    if not flash_bwd or flash_bwd_routes["cuda_cores"] or not flash_bwd_routes["wgmma"]:
        raise AssertionError(f"main_path_train: flash backward routes {flash_bwd_routes}, "
                             f"device kernels {sorted(flash_bwd)}")

    # the restart check at full size: one step twice from one state and
    # one batch; every parameter leaf bit-identical, or the leaves named
    repeat = _repeat_step(torch, step_fn, params, state, batches[0])

    # one step's loss and gradient from the trained state, each binding
    batch = batches[0]
    loss_k, grads = _loss_and_grads(torch, params, batch, cfg)
    norm_k = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    del grads
    with blocks.bind(PLAIN_TRAIN):
        loss_p, grads = _loss_and_grads(torch, params, batch, cfg)
    norm_p = float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads)))
    del grads
    check = {"loss": float(loss_k), "plain_loss": float(loss_p),
             "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
             "grad_norm": norm_k, "plain_grad_norm": norm_p,
             "grad_norm_rel_err": abs(norm_k - norm_p) / norm_p, "tol": TRAIN_BF16_TOL}
    if (check["loss_rel_err"] > TRAIN_BF16_TOL["loss"]
            or check["grad_norm_rel_err"] > TRAIN_BF16_TOL["grad_norm"]):
        raise AssertionError(f"main_path_train: kernels against plain: {check}")
    out = {
        "phase": "main_path_train", "arch": cfg.name, "layers": cfg.n_layers,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "compute_dtype": cfg.compute_dtype, "param_dtype": cfg.param_dtype,
        "moment_dtype": cfg.opt_dtype, "remat": cfg.remat, "setup_seconds": setup,
        "losses": losses, "step_ms": step_ms, "median_step_ms": median,
        "tok_per_s": TRAIN_BATCH * TRAIN_SEQ / (median / 1e3),
        "peak_memory_gb": peak, "launches": counted,
        "flash_routes": dict(kernels.KERNELS["flash_attention"].routes),
        "flash_bwd_routes": flash_bwd_routes,
        "profiled_step": {
            "wall_ms": profiled_wall, "device_ms": total,
            "device_busy_share": total / profiled_wall, "device_events": events,
            "top_device_ms": {k[:80]: v for k, v in top},
            "flash_bwd_device_ms": sum(flash_bwd.values()),
            "flash_bwd_device_ms_by_kernel": {k[:80]: v for k, v in flash_bwd.items()},
            # a PDL dependent (flash's dQ, RMSNorm's dw pass) starts early and
            # waits: its duration overlaps its primary's, so the busy time
            # of a kernel family is the union of its events' intervals
            "flash_bwd_busy_ms": _busy_ms(prof, ("flash_bwd_",)),
            "norm_bwd_device_ms": sum(v for k, v in device.items()
                                      if any(n in k for n in NORM_BWD_KERNEL_NAMES)),
            "norm_bwd_device_ms_by_kernel": {k[:100]: v for k, v in device.items()
                                             if any(n in k for n in NORM_BWD_KERNEL_NAMES)},
            "norm_bwd_busy_ms": _busy_ms(prof, NORM_BWD_KERNEL_NAMES),
        },
        "kernels_vs_plain": check,
        "repeat_step": repeat,
    }
    emit(out)
    return out


def _opt_map(fn, state):
    """``state`` (an ``OptState``: its moments and step) with ``fn``
    applied to each tensor."""
    from repro_torch.optim.adamw import OptState

    return OptState(_tree(fn, state.mu), _tree(fn, state.nu), fn(state.step))


def _host(tree):
    return _tree(lambda t: t.detach().cpu(), tree)


def _repeat_step(torch, step_fn, params, state, batch) -> dict:
    """``step_fn`` twice on one batch, each time from a copy on the card
    of (``params``, ``state``), which may lie on the card or, for a state
    the card cannot hold twice, on the host: whether every parameter leaf
    comes out bit-identical (a restart replays its steps exactly only if
    so), the largest |difference| and the leaves that differ.  The first
    run's parameters are held on the host while the second runs."""
    from repro_torch.checkpoint.manager import flatten

    card = lambda t: t.detach().to("cuda", copy=True)  # noqa: E731

    def one():
        p, _, _ = step_fn(_tree(card, params), _opt_map(card, state), batch)
        return flatten(p)

    first = _host(one())
    second = one()
    differ, worst = [], 0.0
    for k, b in second.items():
        a, b = first[k].to("cuda"), b.detach()
        if not torch.equal(a, b):
            differ.append(k)
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return {"bit_identical": not differ, "leaves": len(first),
            "leaves_that_differ": sorted(differ), "max_abs_diff": worst}


def phase_train_loop(torch) -> dict:
    """The training CLI's ``build`` at ``--reduced`` on the card, run by
    ``FaultTolerantLoop`` with a checkpoint every 4 steps and an injected
    failure at step 6, against an uninterrupted run: the restarts and the
    largest |difference| of every leaf (parameters and moments; on the
    card the embedding's backward scatter-adds with atomics, so a leaf may
    differ: they are named).  Then ``python -m repro_torch.launch.train``
    as a process for reduced llama3.2-1b and reduced mamba2-2.7b (two
    steps on default bindings, its ``grad_default:`` line naming
    ``ssd_scan``), each of which must exit 0."""
    import os
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager, flatten
    from repro_torch.launch import train
    from repro_torch.runtime.fault import FaultTolerantLoop, InjectedFailure

    t0 = time.perf_counter()
    argv = ["--arch", "llama3.2-1b", "--reduced", "--steps", "10", "--batch", "2", "--seq", "16"]
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fail_at in (("clean", None), ("failed", 6)):
            args = train.build_parser().parse_args(argv)
            _, data, step_fn, params, opt_state, device = train.build(args)
            fails = {fail_at} - {None}

            def hook(step, fails=fails):
                if step in fails:
                    fails.discard(step)
                    raise InjectedFailure(f"node lost at step {step}")

            def one_step(state, batch, step, step_fn=step_fn, device=device):
                b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
                p, o, _ = step_fn(state["params"], state["opt"], b)
                return {"params": p, "opt": o}

            loop = FaultTolerantLoop(one_step, data.batch_at,
                                     CheckpointManager(os.path.join(tmp, name)),
                                     ckpt_every=4, failure_hook=hook)
            results[name] = loop.run({"params": params, "opt": opt_state}, args.steps)
        clean, failed = (flatten(results[k].state) for k in ("clean", "failed"))
        diffs = {k: float((clean[k].detach().float() - failed[k].detach().float()).abs().max())
                 for k in clean}
        if results["failed"].restarts != 1:
            raise AssertionError(f"train_loop: {results['failed'].restarts} restarts")
        env = dict(os.environ, PYTHONPATH=str(SRC))
        procs = {arch: subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--reduced", "--steps", steps, "--batch", "2", "--seq", seq,
             "--ckpt-dir", os.path.join(tmp, f"cli-{arch}")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        ) for arch, steps, seq in (("llama3.2-1b", "6", "16"), ("mamba2-2.7b", "2", "32"))}
    for arch, proc in procs.items():
        if proc.returncode != 0:
            raise AssertionError(f"train_loop: the train CLI exited {proc.returncode} on "
                                 f"{arch}: {proc.stderr[-2000:]}")
    # mamba2 trains on default bindings: the SSD scan and the gated norm
    # resolve to torch, and the CLI names them
    ssm_tail = procs["mamba2-2.7b"].stdout.splitlines()[-2:]
    if not (ssm_tail and ssm_tail[0].startswith("grad_default: ") and "ssd_scan (" in ssm_tail[0]):
        raise AssertionError(f"train_loop: the mamba2 CLI printed {ssm_tail}")
    out = {"phase": "train_loop", "arch": "llama3.2-1b-reduced", "steps": 10, "ckpt_every": 4,
           "fail_at": 6, "restarts": results["failed"].restarts,
           "completed_steps": results["failed"].completed_steps,
           "max_abs_diff": max(diffs.values()),
           "leaves_that_differ": sorted(k for k, v in diffs.items() if v != 0.0),
           "leaves": len(diffs),
           "cli_stdout_tail": procs["llama3.2-1b"].stdout.splitlines()[-3:],
           "ssm_cli_stdout_tail": ssm_tail,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC}/repro_torch not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; it needs the H100",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False

    phase_device(torch)
    rows = phase_kernels(torch)
    phase_served_f32(torch)
    phase_served_f32(torch, prefill_bucket=16)
    phase_served_f32(torch, prefill_chunk=16)
    main = phase_main_path(torch)
    phase_decode_profile(torch)
    offload = phase_offload(torch)
    phase_offload_full(torch, offload["results"])
    # the SSM path (contiguous slots: its state has no sequence axis) and
    # the hybrid (paged K/V at the shared-attention sites)
    # a 300-token prompt pads to 384 and runs three chunks with their carry
    phase_served_f32(torch, "mamba2-2.7b", (37, 100, 16, 70, 300, 100), (12, 6, 10, 8, 8, 5),
                     page_size=None, max_len=320)
    ssm = phase_main_path(torch, "mamba2-2.7b", SSM_KERNELS, "main_path_ssm", page_size=None)
    phase_decode_profile(torch, "mamba2-2.7b", sampled=False, phase="decode_profile_ssm",
                         page_size=None)
    phase_main_path(torch, "zamba2-7b", HYBRID_KERNELS, "hybrid")
    phase_decode_profile(torch, "zamba2-7b", sampled=False, phase="decode_profile_hybrid")
    phase_main_path_chunked(torch, main)
    phase_offload_programs(torch, offload)
    phase_binding(torch)
    # MoE and MLA serving: deepseek-v2 (MLA, MoE after one dense layer) in
    # f32 kernels-vs-plain on the paged cache, exact / bucketed / chunked,
    # then full width cut in depth, and arctic-480b (MoE beside a dense FFN)
    for kw in ({}, {"prefill_bucket": 16}, {"prefill_chunk": 16}):
        phase_served_f32(torch, "deepseek-v2-236b", **kw)
    mla = phase_main_path_cut(torch, "deepseek-v2-236b", "main_path_mla_moe")
    phase_extend_mla(torch, mla)
    phase_main_path_cut(torch, "arctic-480b", "main_path_moe_residual")
    # training: llama3.2-1b's train step through the forward and backward
    # kernels, f32 against the plain bindings, at full size, and the loop
    phase_train_f32(torch)
    train = phase_main_path_train(torch)
    phase_train_loop(torch)
    # an SSM trains on default bindings (the SSD scan and gated norm on torch)
    phase_train_ssm(torch)
    # MLA trains through the backward's wgmma route at qk 192 / v 128
    train_mla = phase_train_mla(torch)
    # the power meters: NVML on the card, the metered serving and offload paths
    phase_metering(torch)
    # static analysis: envelopes, capacity, lint, estimates, pre-filters, preflight
    phase_analysis(torch)
    # the cost model and the dry-run: records, the roofline as a lower
    # bound, the cost-guided search
    phase_cost_model(torch, train)
    # distribution: the sharded train step on a one-card mesh, the mesh
    # dry-run's 256- and 512-GPU cells; then the examples
    phase_distributed(torch, train)
    phase_examples(torch)
    # the rest of the zoo at full width: each dense config's 2-layer f32
    # trace (kernels against plain), then its bf16 main path; pixtral's
    # patch-embed forward and its train step
    for arch in ZOO_LAYERS:
        phase_served_f32(torch, arch)
        phase_main_path_cut(torch, arch, f"zoo_{arch}")
    phase_pixtral_forward(torch)
    phase_train_vlm(torch)

    # each kernel's launches come from the path that runs it
    launches = {**main["launches"], **offload["launches"],
                "ssd_chunks": ssm["launches"]["ssd_chunks"],
                "flash_attention_bwd": (train["launches"]["flash_attention_bwd"]
                                        + train_mla["launches"]["flash_attention_bwd"]),
                "rmsnorm_bwd": (train["launches"]["rmsnorm_bwd/plain"]
                                + train["launches"]["rmsnorm_bwd/add"])}
    summary = []
    for name, (source, replaces) in SOURCES.items():
        head = rows[name][0]  # the main path's headline shape
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    print(nvidia_smi())
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
