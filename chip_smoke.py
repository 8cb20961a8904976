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
   attention (its MLA route: the latent pool as keys and values, the rope
   pool beside it, G = 128 rows) and flash (its CUDA-core route, qk 192 /
   v 128) launch counts, each > 0, and one decode replay against its
   eager call (``replay_vs_eager``);
16. extend_mla: phase 15 with ``prefill_chunk=128``: the chunk programs
   extend the latent and rope pools; ``extend`` captures once and replays
   every later call; an MoE's final chunk runs at its exact width (no
   overlapped tokens, a key per width); one replay of each chunk program
   equals its eager call from a cloned cache;
17. main_path_moe_residual: arctic-480b at full width cut to 1 layer
   (~28 GB: 128 experts of d_ff 4864 beside the dense residual FFN), as
   phase 15, flash on its wgmma route.  Phases 15-17 cut depth so the
   weights and the init's transient f32 leaf fit the card's 80 GB
   (``MOE_LAYERS``).

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

The offload kernels (complex matmul, Schur update, matmul) are held
against their plain versions in phase 2 at the paper's scale (2048^2 f32),
matmul also at (96, 160, 96) at blocks of 32, and each at a ragged shape
whose N or K is not a multiple of 4 (matmul and complex matmul at 99^3,
the Schur update at (100, 100, 30)); the SSD chunk kernel
at mamba2's and zamba2's prefill shapes, at chunk 256 (bf16 and f32) and
at N = 256 with P = 128; paged and flash attention at zamba2's head dim
112 too (flash also at B=2 and a ragged S=300, and on its CUDA-core route
at qk 48 / v 32, deepseek-v2's qk 192 / v 128 and a bf16 D = 100).  Each
flash and SSD row names the route it ran; each paged row names its split
plan's ``n_splits`` (paged attention also runs with all eight slots near
1024 positions, at B=1 with a one-page table, and on phase 11's extend
chunk: B=1, S=128 from position 384; and at deepseek-v2's MLA decode, B=8,
H=128 over one 512-wide latent that is both keys and values, rope 64,
and its S=16 (phase 14's) and S=128 (phase 16's) extend chunks from
position 384; at arctic-480b's decode, H=56, KH=8, D=128;
flash also at arctic's prefill, H=56 over KH=8, D=128).  Phase 5 sums the
device time of paged attention's split and merge kernels per step.

The last lines are the card as ``nvidia-smi`` reports it, the kernels'
summary and ``{"ok": true, "device": {...}}``.  Needs CUDA and the rest of
the repository next to this file; exits non-zero without either.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; flop/s by type
# ("float32" on the CUDA cores, "tf32" on the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}

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
              "arctic-480b": ("plain", "add")}
#: zamba2-7b at full width, cut to 12 layers (two shared-attention sites)
ZAMBA2_PATTERN = "mmmmmsmmmmms"
#: the MoE configs at full width, cut in depth to fit one card's 80 GB with
#: their init's transient f32 leaf: deepseek-v2 to its dense layer and three
#: MoE layers (``daaa``, ~27 GB of bf16 weights), arctic-480b to one layer
#: (~28 GB, 26.8 of them experts; two layers' init would pass 80 GB)
MOE_LAYERS = {"deepseek-v2-236b": 4, "arctic-480b": 1}

#: calls per version when Fig. 5's cpu / loop / block are re-timed (median)
FIG5_REPEATS = 5


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


def bound_ms(nbytes: float, flops: float, peak: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
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


def _case(torch, name, dtype, shape, got, want, timer, run, plain, library, nbytes, flops,
          tol=None, peak=None, extra=None):
    """``got`` and ``want`` are one tensor, or dicts of named outputs that
    are each held to ``tol[name]``.  The bound takes the peak of ``peak``
    (default: the inputs' type); ``extra`` adds keys to the printed row."""
    if isinstance(got, dict):
        errs = {k: compare(torch, got[k], want[k], dtype, tol[k]) for k in got}
        err = max(errs.values())
    else:
        errs, err = None, compare(torch, got, want, dtype, tol)
    bound, by = bound_ms(nbytes, flops, peak or dtype)
    row = {
        "phase": "kernel", "name": name, "dtype": dtype, "shape": shape,
        "max_abs_err": err, "tol": tol or TOL[dtype],
        "ms": timer.ms(run), "plain_ms": timer.ms(plain),
        "bound_ms": bound, "bound_by": by,
        "library_ms": timer.ms(library) if library is not None else None,
    }
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

    from repro_torch.kernels.attention import flash_attention, flash_attention_torch

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = Timer(torch)
    rows: dict[str, list] = {k: [] for k in SOURCES}
    d, h, kh, dh = 2048, 32, 8, 64

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    rows["rmsnorm"] = (_norm_plain_cases(torch, timer, randn)
                       + _norm_fused_cases(torch, timer, randn)
                       + _norm_zoo_cases(torch, timer, randn))

    rows["paged_attention"] = _paged_cases(torch, timer, randn, gen)

    # flash attention: prefill B=1 at S=512 and a ragged S=300
    for s, dtype in ((512, torch.bfloat16), (300, torch.bfloat16), (300, torch.float32)):
        q = randn(1, h, s, dh, dtype=dtype)
        k = randn(1, kh, s, dh, dtype=dtype)
        v = randn(1, kh, s, dh, dtype=dtype)
        e = q.element_size()
        got, route = flash_routed(flash_attention, q, k, v)
        rows["flash_attention"].append(_case(
            torch, "flash_attention", str(dtype).split(".")[1], [1, h, kh, s, dh],
            got, flash_attention_torch(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            nbytes=e * (2 * q.numel() + k.numel() + v.numel()),
            flops=4 * dh * h * s * (s + 1) // 2, extra=route,
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
        nbytes=2 * (2 * q.numel() + k.numel() + v.numel()),
        flops=4 * 128 * 56 * 512 * 513 // 2, extra=route,
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
        nbytes=2 * 4 * q.numel(), flops=4 * zd * zh * 512 * 513 // 2, extra=route,
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
        nbytes=2 * 4 * q.numel(), flops=2 * 4 * zd * zh * 300 * 301 // 2, extra=route,
    ))
    # the shapes the wgmma route does not take, on the CUDA-core route: v's
    # head dim apart from q's (the reference test's qk 48 / v 32, in f32
    # and bf16; deepseek-v2's MLA prefill, H = KH = 128, qk 192 / v 128),
    # and a bf16 head dim that is not a multiple of 8
    for (hh, s, dqk, dv), dtype in (((4, 128, 48, 32), torch.float32),
                                    ((4, 128, 48, 32), torch.bfloat16),
                                    ((128, 512, 192, 128), torch.bfloat16),
                                    ((8, 300, 100, 100), torch.bfloat16)):
        q, k = randn(1, hh, s, dqk, dtype=dtype), randn(1, hh, s, dqk, dtype=dtype)
        v = randn(1, hh, s, dv, dtype=dtype)
        e = q.element_size()
        got, route = flash_routed(flash_attention, q, k, v)
        rows["flash_attention"].append(_case(
            torch, "flash_attention", str(dtype).split(".")[1],
            {"B": 1, "H": hh, "KH": hh, "S": s, "Dqk": dqk, "Dv": dv},
            got, flash_attention_torch(q, k, v), timer,
            lambda: flash_attention(q, k, v), lambda: flash_attention_torch(q, k, v),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            nbytes=e * (q.numel() + k.numel() + 2 * v.numel()),
            flops=2 * (dqk + dv) * hh * s * (s + 1) // 2, extra=route,
        ))
    rows["flash_attention"].append(arctic_row)
    rows["ssd_chunks"] = _ssd_cases(torch, timer, randn, gen)
    rows.update(_offload_kernel_cases(torch, timer, randn))
    return rows


def _norm_plain_cases(torch, timer, randn) -> list:
    """RMSNorm's plain form with an f32 weight (the cases the first kernel
    also takes): llama3.2-1b's decode (8 rows) and prefill (512 rows) of d
    = 2048 in bf16 (the headline first), f32 decode, then the scalar path at
    ragged widths (f32 d = 100, bf16 d = 2050) and a bf16 row past the
    registers (d = 20480, the two-pass loop).  ``F.rms_norm`` is the
    library call (weight in x's type)."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_torch

    rows, eps = [], 1e-5
    bf16, f32 = torch.bfloat16, torch.float32
    for n_rows, d, dtype in ((8, 2048, bf16), (512, 2048, bf16), (8, 2048, f32),
                             (8, 100, f32), (8, 2050, bf16), (8, 20480, bf16)):
        x = randn(n_rows, d, dtype=dtype)
        w = 1.0 + 0.1 * randn(d, dtype=f32)
        w_lib = w.to(dtype)
        e = x.element_size()
        rows.append(_case(
            torch, "rmsnorm", str(dtype).split(".")[1], [n_rows, d],
            rmsnorm(x, w, eps), rmsnorm_torch(x, w, eps), timer,
            lambda: rmsnorm(x, w, eps), lambda: rmsnorm_torch(x, w, eps),
            lambda: F.rms_norm(x, (d,), w_lib, eps),
            nbytes=2 * n_rows * d * e + 4 * d, flops=4 * n_rows * d,
            extra={"form": "plain", "w": "float32"},
        ))
    return rows


def _norm_zoo_cases(torch, timer, randn) -> list:
    """RMSNorm with a bf16 weight (the MoE configs' parameter type) at the
    MoE paths' widths: the plain form at deepseek-v2's latent ``kv_norm``
    (512 wide) and at deepseek-v2's d = 5120 and arctic-480b's d = 7168;
    the add form (the fused residual chain; s bit for bit) at 5120 and
    7168.  Rows: decode's 8 and a 512-token prefill."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    rows, eps = [], 1e-5
    bf16 = torch.bfloat16
    for n_rows, d in ((8, 512), (512, 512), (8, 5120), (512, 5120), (8, 7168), (512, 7168)):
        x = randn(n_rows, d, dtype=bf16)
        w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(bf16)
        rows.append(_case(
            torch, "rmsnorm", "bfloat16", [n_rows, d],
            rn.rmsnorm(x, w, eps), rn.rmsnorm_torch(x, w, eps), timer,
            lambda: rn.rmsnorm(x, w, eps), lambda: rn.rmsnorm_torch(x, w, eps),
            lambda: F.rms_norm(x, (d,), w, eps),
            nbytes=4 * n_rows * d + 2 * d, flops=4 * n_rows * d,
            extra={"form": "plain", "w": "bfloat16"},
        ))
    for n_rows, d in ((8, 5120), (512, 5120), (8, 7168), (512, 7168)):
        x, delta = randn(n_rows, d, dtype=bf16), randn(n_rows, d, dtype=bf16)
        w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(bf16)
        got = dict(zip("sy", rn.add_rmsnorm(x, delta, w, eps)))
        want = dict(zip("sy", rn.add_rmsnorm_torch(x, delta, w, eps)))
        rows.append(_case(
            torch, "rmsnorm", "bfloat16", [n_rows, d], got, want, timer,
            lambda: rn.add_rmsnorm(x, delta, w, eps),
            lambda: rn.add_rmsnorm_torch(x, delta, w, eps), None,
            nbytes=2 * 4 * n_rows * d + 2 * d, flops=5 * n_rows * d,
            tol={"s": (0.0, 0.0), "y": TOL["bfloat16"]}, extra={"form": "add", "w": "bfloat16"},
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
            lambda: F.rms_norm(x, (d,), w, eps),
            nbytes=4 * n_rows * d + 2 * d, flops=4 * n_rows * d,
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
            nbytes=2 * 4 * n_rows * d + 4 * d, flops=5 * n_rows * d,
            tol={"s": (0.0, 0.0), "y": TOL["bfloat16"]}, extra={"form": "add", "w": "float32"},
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
        e = x.element_size()
        name = str(dtype).split(".")[1]
        rows.append(_case(
            torch, "rmsnorm", name, {"B": b, "S": s, "H": h, "P": p, "N": n},
            rn.gated_rmsnorm(*args), rn.gated_rmsnorm_torch(*args), timer,
            lambda: rn.gated_rmsnorm(*args), lambda: rn.gated_rmsnorm_torch(*args), None,
            nbytes=b * s * di * (4 + 3 * e) + 4 * (di + h), flops=12 * b * s * di,
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
    head).  Null pages are poisoned.  Each row names the split plan's
    ``n_splits``."""
    from repro_torch.kernels import paged_attention as pa

    h, kh, dh = 32, 8, 64
    dev = "cuda"

    def paged_case(b, hh, kkh, s, dk, dv, lengths, dtype, dr=0, ps=16, mp=None, latent=False):
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
        e = q.element_size()
        seen = [min(ln + si + 1, mp * ps) for ln in lengths for si in range(s)]
        n_pos = [min(ln + s, mp * ps) for ln in lengths]
        g = hh // kkh
        # each input read once (only the K/V rows the lengths reach; a
        # latent pool once for keys and values), the output written once;
        # flops: q.k, q_rope.k_rope and p.v per seen row
        nbytes = (
            e * (q.numel() + b * hh * s * dv + (kw["q_rope"].numel() if dr else 0))
            + e * sum(n_pos) * (kkh * (dk if latent else dk + dv) + dr)
            + 4 * (pages.numel() + b)
        )
        flops = 2 * kkh * g * sum(seen) * (dk + dv + dr)
        # the parent of a comparison (scripts/ab_parent_change.py) has no plan
        extra = None
        if hasattr(pa, "sm_count"):
            plan = pa.split_plan(b, kkh, mp, ps, dk, dv, pa.sm_count(q.device))
            extra = {"n_splits": plan.n_splits, "pages_per_split": plan.pages_per_split}
        return _case(
            torch, "paged_attention", str(dtype).split(".")[1],
            {"B": b, "H": hh, "KH": kkh, "S": s, "Dk": dk, "Dv": dv, "Dr": dr,
             "page_size": ps, "max_pages": mp, "lengths": list(lengths),
             **({"latent": True} if latent else {})},
            pa.paged_attention(*args, **kw), pa.paged_attention_torch(*args, **kw), timer,
            lambda: pa.paged_attention(*args, **kw), lambda: pa.paged_attention_torch(*args, **kw),
            None, nbytes=nbytes, flops=flops, extra=extra,
        )

    bf16 = torch.bfloat16
    decode_lengths = [1022, 700, 511, 256, 95, 16, 15, 0]
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
        # 16's); arctic-480b's GQA decode (H=56, KH=8)
        paged_case(8, 128, 1, 1, 512, 512, decode_lengths, bf16, dr=64, latent=True),
        paged_case(1, 128, 1, 16, 512, 512, [384], bf16, dr=64, latent=True),
        paged_case(1, 128, 1, CHUNK, 512, 512, [384], bf16, dr=64, latent=True),
        paged_case(8, 56, 8, 1, 128, 128, decode_lengths, bf16),
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
    from repro_torch.kernels.ssd import ssd_chunks, ssd_chunks_torch

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
        nc = s // chunk
        e = x.element_size()
        # inputs read once (x/B/C, f32 dt and a), the four f32 outputs
        # written once; flops: the L(L+1)/2 entries of C B^T (N products
        # each) once per (batch, chunk), and per head those of W x (P each)
        # and the state product
        nbytes = (e * (x.numel() + bm.numel() + cm.numel()) + 4 * (dt.numel() + h)
                  + 4 * (x.numel() + b * nc * h * n * p + dt.numel() + b * nc * h))
        tri = chunk * (chunk + 1)  # twice the triangle's entries: 2 flops a product
        flops = b * nc * (tri * n + h * (tri * p + 2 * chunk * n * p))
        shape = {"B": b, "S": s, "H": h, "P": p, "N": n, "L": chunk,
                 "dt": [dt0, dt1], "minus_a": [a0, a1]}
        name = str(dtype).split(".")[1]
        rows.append(_case(
            torch, "ssd_chunks", name, shape,
            dict(zip(names, ssd_chunks(*args, chunk=chunk))),
            dict(zip(names, ssd_chunks_torch(*args, chunk=chunk))),
            timer, lambda: ssd_chunks(*args, chunk=chunk),
            lambda: ssd_chunks_torch(*args, chunk=chunk), None,
            nbytes=nbytes, flops=flops, tol=SSD_TOL,
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
    from repro_torch.kernels.fft import complex_matmul, complex_matmul_torch
    from repro_torch.kernels.matmul import matmul, matmul_torch, schur_update, schur_update_torch

    f32 = torch.float32
    rows: dict[str, list] = {"complex_matmul": [], "schur_update": [], "matmul": []}

    def floor(flops):
        return {"floor_3xtf32_ms": 3 * flops / PEAK_FLOPS["tf32"] * 1e3}

    for m, nn, k in ((2048, 2048, 2048), (99, 99, 99)):
        ar, ai = randn(m, k, dtype=f32), randn(m, k, dtype=f32)
        br, bi = randn(k, nn, dtype=f32), randn(k, nn, dtype=f32)
        ac, bc = torch.complex(ar, ai), torch.complex(br, bi)
        kw = dict(block_m=min(m, 128), block_n=min(nn, 128), block_k=min(k, 128))
        flops = 8 * m * nn * k
        rows["complex_matmul"].append(_case(
            torch, "complex_matmul", "float32", [m, nn, k],
            torch.cat(complex_matmul(ar, ai, br, bi, **kw)), torch.cat(complex_matmul_torch(ar, ai, br, bi)),
            timer, lambda: complex_matmul(ar, ai, br, bi, **kw), lambda: complex_matmul_torch(ar, ai, br, bi),
            lambda: torch.matmul(ac, bc),
            nbytes=4 * (2 * m * k + 2 * k * nn + 2 * m * nn), flops=flops, tol=GEMM_TOL,
            peak="tf32", extra=floor(flops),
        ))
    # the trailing update A22 -= L21 @ U12 right after the first panel, and
    # a ragged one
    for (m, nn, k), (bm, bn) in (((1920, 1920, 128), (128, 128)), ((160, 160, 32), (32, 32)),
                                  ((100, 100, 30), (100, 100))):
        c, a, b = randn(m, nn, dtype=f32), randn(m, k, dtype=f32), randn(k, nn, dtype=f32)
        blk = dict(block_m=bm, block_n=bn, block_k=k)
        flops = 2 * m * nn * k
        rows["schur_update"].append(_case(
            torch, "schur_update", "float32", [m, nn, k],
            schur_update(c, a, b, **blk), schur_update_torch(c, a, b), timer,
            lambda: schur_update(c, a, b, **blk), lambda: schur_update_torch(c, a, b),
            lambda: torch.addmm(c, a, b, alpha=-1),
            nbytes=4 * (2 * m * nn + m * k + k * nn), flops=flops, tol=GEMM_TOL,
            peak="tf32", extra=floor(flops),
        ))
    for (m, nn, k), blk in (((2048, 2048, 2048), 128), ((96, 160, 96), 32), ((99, 99, 99), 99)):
        a, b = randn(m, k, dtype=f32), randn(k, nn, dtype=f32)
        kw = dict(block_m=blk, block_n=blk, block_k=blk)
        flops = 2 * m * nn * k
        rows["matmul"].append(_case(
            torch, "matmul", "float32", [m, nn, k], matmul(a, b, **kw), matmul_torch(a, b), timer,
            lambda: matmul(a, b, **kw), lambda: matmul_torch(a, b), lambda: torch.matmul(a, b),
            nbytes=4 * (m * k + k * nn + m * nn), flops=flops, tol=GEMM_TOL, peak="tf32",
            extra=floor(flops),
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
    if arch in MOE_LAYERS:  # full width, depth cut (first_k_dense keeps the dense layer)
        cfg = cfg.cut(MOE_LAYERS[arch])
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
    t0 = time.perf_counter()
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
    if report is not None:
        report(engine, out)
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
    from torch.profiler import ProfilerActivity, profile

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
    counted, replays = kernels.counters(), engine.graph_stats()["decode"]["replays"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
    if engine.graph_stats()["decode"]["replays"] - replays != n:
        raise AssertionError(f"{phase}: the {n} profiled decode steps were not all replays")
    added = {k: v - counted[k] for k, v in kernels.counters().items()}
    replay_launches = _replay_launches(phase, prof, added, n)
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


def _replay_launches(phase: str, prof, added: dict, n: int) -> dict:
    """Hold the launches that ``n`` profiled decode replays added to the
    wrappers' counts (the capture's counts, added at each replay) against
    the profiler's device events of those kernels: each counted launch
    must be one event of each of its kernel's names.  Returns the launches
    per step."""
    import re

    from torch.autograd import DeviceType

    names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    out = {}
    for counter, kernel_names in KERNEL_EVENTS.items():
        for name in kernel_names:
            seen = sum(1 for ev in names if re.search(rf"(?<!\w){name}(?!\w)", ev))
            if seen != added[counter]:
                raise AssertionError(f"{phase}: {n} replays counted {added[counter]} "
                                     f"{counter} launches, the profiler saw {seen} {name}")
        out[counter] = added[counter] / n
    return out


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


#: flash's route on each MoE config's prefill: deepseek-v2's MLA attends
#: at qk 192 / v 128 (the CUDA cores), arctic-480b at D = 128 (wgmma)
MOE_FLASH_ROUTE = {"deepseek-v2-236b": "cuda_cores", "arctic-480b": "wgmma"}


def phase_main_path_moe(torch, arch: str, phase: str, **engine_kw) -> dict:
    """``arch`` (an MoE config, depth cut by ``MOE_LAYERS``) served as phase
    4 serves llama: the same engine settings and trace, decode as graph
    replays, rmsnorm, paged attention (for deepseek-v2 every launch the MLA
    route: the latent pool as keys and values, the rope pool beside it)
    and flash each launched, every prefill launch of flash on the config's
    route; then one decode replay against its eager call."""
    from repro_torch.configs import get_config

    def report(engine, out):
        routes = out["flash_routes"]
        want = MOE_FLASH_ROUTE[arch]
        if routes[want] != out["launches"]["flash_attention"]:
            raise AssertionError(f"{phase}: flash routes {routes}, all {want} expected")
        out["cut"] = f"{MOE_LAYERS[arch]} of {get_config(arch).n_layers} layers, full width"
        check = _replay_vs_eager(torch, engine, "greedy")
        check["bit_identical"] = all(e == 0.0 for e in check["max_abs_err"].values())
        out["replay_vs_eager"] = [check]

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
    mla = phase_main_path_moe(torch, "deepseek-v2-236b", "main_path_mla_moe")
    phase_extend_mla(torch, mla)
    phase_main_path_moe(torch, "arctic-480b", "main_path_moe_residual")

    # each kernel's launches come from the path that runs it
    launches = {**main["launches"], **offload["launches"],
                "ssd_chunks": ssm["launches"]["ssd_chunks"]}
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
