#!/usr/bin/env python3
"""Parent against change on one H100, in turns parent, change, change,
parent, each in a process of its own:

- ``main_path``: chip_smoke.py's phase 4 (llama3.2-1b served from the paged
  KV cache, 16 requests), twice per process (the second run is warm), then
  its phase-5 decode profile (device ms per step, paged attention's share);
- ``main_path_ssm``: chip_smoke.py's phase 9 (full-depth mamba2-2.7b from
  contiguous slots, the same 16 requests), twice per process, then its
  decode profile; ``main_path_hybrid`` the same for phase 10 (zamba2-7b
  cut to 12 layers, paged);
- ``prefill``: one 512-token llama3.2-1b prefill (paged, prompts bucketed
  by 64, batch 1, one new token) served by ``ServeEngine``: host wall ms
  (median of 7, after 3 warm-up requests: with step programs the key's
  eager call, its capture and a replay, so the 7 are replays) and device
  ms by kernel from ``torch.profiler``;
- ``prefill_ssm``: the same for full-depth mamba2-2.7b (64 layers) from
  contiguous slots (exact lengths: an SSM refuses buckets), with the
  ``ssd_chunks`` kernels' device ms;
- ``served_recurring``: 256 requests, prompt lengths drawn from phase 4's
  U[64, 512] so that some recur, 8 new tokens each, 8 in flight (a request
  is submitted as one completes), after 8 warm-up requests of 32 tokens:
  llama3.2-1b paged at exact lengths and bucketed by 64, and full-depth
  mamba2-2.7b: prefill seconds, TTFT (from submission, and from
  admission) p50 / p99, tok/s and the step programs' ``graphs``;
- ``ssd_kernels``: chip_smoke.py's phase-2 cases of the SSD chunk kernel
  (CUDA graphs, cold L2), each case's ms beside its plain version's;
- ``flash_kernels``: the flash kernel at phase 2's main shapes (f32 at
  S=300, bf16 at S=512 with D 64 and 112, arctic's D 128 and deepseek-v2's
  qk 192 / v 128; CUDA graphs, cold L2), each row with its route;
- ``paged_kernels``: this tree's chip_smoke.py phase-2 cases of paged
  attention (CUDA graphs, cold L2), run against each version's kernel;
- ``offload_kernels``: chip_smoke.py's phase-2 cases of the offload GEMM
  kernels (complex matmul, Schur update, matmul; CUDA graphs, cold L2),
  each kernel's ms beside its PyTorch call's;
- ``norm_kernels``: this tree's chip_smoke.py phase-2 cases of rmsnorm's
  plain form with an f32 weight (the cases every version's wrapper takes;
  CUDA graphs, cold L2), run against each version's kernel;
- ``flash_bwd_kernels``: this tree's chip_smoke.py phase-2 cases of the
  flash backward (CUDA graphs, cold L2), run against each version's kernel,
  each row with the route that version's wrapper took;
- ``norm_bwd_kernels``: this tree's chip_smoke.py phase-2 cases of
  RMSNorm's backward (CUDA graphs, cold L2), run against each version's
  kernels, each row with its kernels' own device ms (``ms_by_kernel``);
- ``train_step``: each version's own chip_smoke.py phase 19 (full
  llama3.2-1b, B 8, S 512, 10 steps and a profiled one): ms a step, tok/s,
  device ms of the profiled step and the flash backward's share of it.

    git archive <parent commit> | tar -x -C build/parent
    python3 scripts/ab_parent_change.py main_path|main_path_ssm|main_path_hybrid|prefill|prefill_ssm|served_recurring|ssd_kernels|flash_kernels|paged_kernels|offload_kernels|norm_kernels|flash_bwd_kernels|norm_bwd_kernels|train_step
        [build/parent]

``paged_kernels``, ``norm_kernels``, ``flash_bwd_kernels`` and
``norm_bwd_kernels`` run this tree's cases against the other version's
``src/``: the cases read each kernel's declared work (``paged_work``,
``norm_work``, ``flash_bwd_work``, ``norm_bwd_work``) and the card's peaks
(``repro_torch.launch.mesh``) from that version, so these four modes need
a version in which the kernels declare their work (``kernels/build.py``'s
``Work``); an older one fails with ImportError or AttributeError.

Prints one JSON line per measurement with its version, with the step
programs' ``graphs`` (captures, replays) and ``peak_memory_gb`` where the
version has them.  Compare versions
only within one call: the host's speed varies between machines.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAIN_PATH = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke as c; "
             "torch.backends.cuda.matmul.allow_tf32 = False; c.phase_device(torch); "
             "c.phase_main_path(torch); c.phase_main_path(torch); "
             "c.phase_decode_profile(torch, sampled=False)")
PREFILL = r'''
import json, statistics, sys, time, torch
sys.path.insert(0, "src")
import numpy as np
import chip_smoke as c
from torch.profiler import ProfilerActivity, profile
from repro_torch.serve import Request, ServeEngine
torch.backends.cuda.matmul.allow_tf32 = False
cfg = c._serve_config("ARCH")
torch.cuda.reset_peak_memory_stats()
engine = ServeEngine(cfg, seed=0, device="cuda", n_slots=8, max_len=1024, page_size=PAGE,
                     prefill_bucket=BUCKET)
prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 512).tolist()
def one():
    engine.submit(Request(prompt, max_new_tokens=1))
    torch.cuda.synchronize(); t0 = time.perf_counter()
    engine.run_until_idle(max_steps=100); torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3
for _ in range(3): one()
walls = [one() for _ in range(7)]
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    one()
dev, n = c._device_events(prof)
flash = sum(v for k, v in dev.items() if "flash" in k)
ssd = sum(v for k, v in dev.items() if "ssd" in k)
print(json.dumps({"phase": "prefill", "arch": cfg.name,
                  "wall_ms_median": statistics.median(walls),
                  "wall_ms": walls, "device_ms": sum(dev.values()), "device_events": n,
                  "flash_device_ms": flash, "ssd_device_ms": ssd,
                  # a version without step programs has no graphs
                  "graphs": engine.graph_stats() if hasattr(engine, "graph_stats") else None,
                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "top": {k[:60]: v for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:6]}}))
'''
SERVED_RECURRING = r'''
import json, sys, time, torch
sys.path.insert(0, "src")
import numpy as np
import chip_smoke as c
from repro_torch.serve import Completion, Request, ServeEngine
torch.backends.cuda.matmul.allow_tf32 = False
for arch, kw in (("llama3.2-1b", dict(page_size=16)),
                 ("llama3.2-1b", dict(page_size=16, prefill_bucket=64)),
                 ("mamba2-2.7b", dict(page_size=None))):
    cfg = c._serve_config(arch)
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, seed=0, device="cuda", n_slots=8, max_len=1024, **kw)
    rng = np.random.default_rng(0)
    for _ in range(8):  # builds the kernels; the decode key's eager call and capture
        engine.submit(Request(rng.integers(0, cfg.vocab_size, 32).tolist(), max_new_tokens=2))
    engine.run_until_idle(max_steps=1000)
    prefill0 = engine.telemetry["prefill"].seconds
    decode0 = engine.telemetry["decode"].seconds
    graphs0 = engine.graph_stats() if hasattr(engine, "graph_stats") else None
    lens = rng.integers(64, 513, 256)
    todo = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    done = []
    torch.cuda.synchronize(); t0 = time.perf_counter()
    for _ in range(8):
        engine.submit(Request(todo.pop(), max_new_tokens=8))
    while engine.scheduler.has_work:
        for ev in engine.step():
            if isinstance(ev, Completion):
                done.append(ev)
                if todo:
                    engine.submit(Request(todo.pop(), max_new_tokens=8))
    torch.cuda.synchronize(); wall = time.perf_counter() - t0
    pct = lambda xs, q: float(np.percentile(xs, q))
    ttft = [d.ttft * 1e3 for d in done]
    admitted = [d.ttft_admitted * 1e3 for d in done]
    graphs = None
    if graphs0 is not None:
        graphs = {name: {k: v - graphs0[name][k] for k, v in g.items()
                         if isinstance(v, (int, float))}
                  for name, g in engine.graph_stats().items()}
    print(json.dumps({"phase": "served_recurring", "arch": cfg.name,
                      "prefill_bucket": kw.get("prefill_bucket"), "requests": len(done),
                      "distinct_lengths": len(set(lens.tolist())),
                      "distinct_padded": len({engine._padded_len(int(n)) for n in lens}),
                      "wall_seconds": wall, "tok_per_s": 8 * len(done) / wall,
                      "prefill_seconds": engine.telemetry["prefill"].seconds - prefill0,
                      "decode_seconds": engine.telemetry["decode"].seconds - decode0,
                      "ttft_p50_ms": pct(ttft, 50), "ttft_p99_ms": pct(ttft, 99),
                      "ttft_admitted_p50_ms": pct(admitted, 50),
                      "ttft_admitted_p99_ms": pct(admitted, 99),
                      "graphs": graphs, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}),
          flush=True)
    del engine
    torch.cuda.empty_cache()
'''
OFFLOAD_KERNELS = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke as c; "
                   "torch.backends.cuda.matmul.allow_tf32 = False; "
                   "g = torch.Generator(device='cuda').manual_seed(0); "
                   "c._offload_kernel_cases(torch, c.Timer(torch), lambda *shape, dtype: "
                   "torch.randn(shape, generator=g, device='cuda').to(dtype))")
SSD_KERNELS = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke as c; "
               "g = torch.Generator(device='cuda').manual_seed(0); "
               "c._ssd_cases(torch, c.Timer(torch), lambda *shape, dtype: "
               "torch.randn(shape, generator=g, device='cuda').to(dtype), g)")
FLASH_KERNELS = r'''
import json, sys, torch
sys.path.insert(0, "src")
import chip_smoke as c
from repro_torch.kernels.attention import flash_attention
g = torch.Generator(device="cuda").manual_seed(0)
timer = c.Timer(torch)
for h, kh, s, d, dv, dtype in ((32, 8, 300, 64, 64, torch.float32),
                               (32, 8, 512, 64, 64, torch.bfloat16),
                               (32, 32, 512, 112, 112, torch.bfloat16),
                               (56, 8, 512, 128, 128, torch.bfloat16),
                               (128, 128, 512, 192, 128, torch.bfloat16)):
    q, k, v = (torch.randn((1, n, s, e), generator=g, device="cuda").to(dtype)
               for n, e in ((h, d), (kh, d), (kh, dv)))
    before = dict(flash_attention.routes)
    flash_attention(q, k, v)
    route = [r for r, n in flash_attention.routes.items() if n > before[r]]
    print(json.dumps({"phase": "kernel", "name": "flash_attention", "shape": [1, h, kh, s, d, dv],
                      "dtype": str(dtype), "route": route[0],
                      "ms": timer.ms(lambda: flash_attention(q, k, v))}))
'''
MAIN_PATH_SSM = MAIN_PATH.replace(
    "c.phase_main_path(torch); c.phase_main_path(torch); c.phase_decode_profile(torch, sampled=False)",
    "kw = dict(arch='mamba2-2.7b', expect=c.SSM_KERNELS, phase='main_path_ssm', page_size=None); "
    "c.phase_main_path(torch, **kw); c.phase_main_path(torch, **kw); "
    "c.phase_decode_profile(torch, 'mamba2-2.7b', sampled=False, phase='decode_profile_ssm', "
    "page_size=None)")
MAIN_PATH_HYBRID = MAIN_PATH.replace(
    "c.phase_main_path(torch); c.phase_main_path(torch); c.phase_decode_profile(torch, sampled=False)",
    "kw = dict(arch='zamba2-7b', expect=c.HYBRID_KERNELS, phase='main_path_hybrid'); "
    "c.phase_main_path(torch, **kw); c.phase_main_path(torch, **kw); "
    "c.phase_decode_profile(torch, 'zamba2-7b', sampled=False, phase='decode_profile_hybrid')")
# the cases come from this tree's chip_smoke.py, the kernels from the
# version's own src/
THIS_TREES_CASES = f"""
import importlib.util, sys, torch
sys.path.insert(0, "src")
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
c = importlib.util.module_from_spec(spec)
spec.loader.exec_module(c)
g = torch.Generator(device="cuda").manual_seed(0)
randn = lambda *shape, dtype: torch.randn(shape, generator=g, device="cuda").to(dtype)
"""
PAGED_KERNELS = THIS_TREES_CASES + "c._paged_cases(torch, c.Timer(torch), randn, g)"
NORM_KERNELS = THIS_TREES_CASES + "c._norm_plain_cases(torch, c.Timer(torch), randn)"
FLASH_BWD_KERNELS = THIS_TREES_CASES + "c._flash_bwd_cases(torch, c.Timer(torch), randn)"
NORM_BWD_KERNELS = THIS_TREES_CASES + "c._norm_bwd_cases(torch, c.Timer(torch), randn)"
TRAIN_STEP = ("import sys, torch; sys.path.insert(0, 'src'); import chip_smoke as c; "
              "torch.backends.cuda.matmul.allow_tf32 = False; c.phase_device(torch); "
              "c.phase_main_path_train(torch)")
CODE = {"main_path": MAIN_PATH, "main_path_ssm": MAIN_PATH_SSM,
        "main_path_hybrid": MAIN_PATH_HYBRID,
        "prefill": PREFILL.replace("ARCH", "llama3.2-1b").replace("PAGE", "16")
                          .replace("BUCKET", "64"),
        "prefill_ssm": PREFILL.replace("ARCH", "mamba2-2.7b").replace("PAGE", "None")
                              .replace("BUCKET", "None"),
        "served_recurring": SERVED_RECURRING,
        "ssd_kernels": SSD_KERNELS, "flash_kernels": FLASH_KERNELS,
        "paged_kernels": PAGED_KERNELS, "offload_kernels": OFFLOAD_KERNELS,
        "norm_kernels": NORM_KERNELS, "flash_bwd_kernels": FLASH_BWD_KERNELS,
        "norm_bwd_kernels": NORM_BWD_KERNELS,
        "train_step": TRAIN_STEP}
KERNEL_KEYS = ("name", "dtype", "shape", "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
               "n_splits", "pages_per_split", "form", "w", "ms_by_kernel")
PROFILE_KEYS = ("arch", "wall_ms_per_step", "device_ms_per_step", "device_busy_share",
                "device_events_per_step", "replay_ms_per_step", "peak_memory_gb", "graphs")
TRAIN_KEYS = ("median_step_ms", "tok_per_s", "step_ms", "peak_memory_gb", "launches",
              "flash_bwd_routes", "kernels_vs_plain")
PROFILED_KEYS = ("wall_ms", "device_ms", "device_busy_share", "flash_bwd_device_ms",
                 "norm_bwd_device_ms", "norm_bwd_busy_ms", "flash_bwd_busy_ms")
MAIN_PATH_KEYS = ("tok_per_s", "prefill_tok_per_s", "decode_tok_per_s", "prefill_seconds",
                  "decode_seconds", "decode_median_ms",
                  "ttft_p50_ms", "ttft_p99_ms", "wall_seconds", "launches", "graphs",
                  "peak_memory_gb")


def main() -> int:
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what not in CODE:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"parent": Path(sys.argv[2] if len(sys.argv) > 2 else ROOT / "build" / "parent"),
             "change": ROOT}
    for tag in ("parent", "change", "change", "parent"):
        out = subprocess.run([sys.executable, "-c", CODE[what]],
                             cwd=roots[tag], capture_output=True, text=True, timeout=400)
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            if what.startswith("main_path") and row.get("phase") == what:
                # keys a version lacks (a parent without graphs) print as null
                print(json.dumps({"version": tag, **{k: row.get(k) for k in MAIN_PATH_KEYS}}),
                      flush=True)
            elif what.startswith("main_path") and row.get("phase", "").startswith("decode_profile"):
                # the parent's profile may not sum paged attention's kernels
                paged = row.get("paged_device_ms_per_step", sum(
                    v for k, v in row["top_device_ms_per_step"].items() if "paged" in k))
                print(json.dumps({"version": tag, "phase": row["phase"],
                                  **{k: row.get(k) for k in PROFILE_KEYS},
                                  "paged_device_ms_per_step": paged,
                                  "top_device_ms_per_step": row["top_device_ms_per_step"]}),
                      flush=True)
            elif what == "train_step" and row.get("phase") == "main_path_train":
                prof = row["profiled_step"]
                print(json.dumps({"version": tag, **{k: row.get(k) for k in TRAIN_KEYS},
                                  **{k: prof.get(k) for k in PROFILED_KEYS}}), flush=True)
            elif what.startswith("prefill") or what == "served_recurring":
                print(json.dumps({"version": tag, **row}), flush=True)
            elif what.endswith("_kernels") and row.get("phase") == "kernel":
                print(json.dumps({"version": tag, **{k: row.get(k) for k in KERNEL_KEYS},
                                  "route": row.get("route")}), flush=True)
        if out.returncode:
            print(tag, "failed", out.stderr[-3000:])
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
