"""Run the paged-attention kernel against copies of itself with one line
of its source changed, on one card.  The split walk's forks:

- ``cp_async_only``: every page staged by cp.async (no TMA);
- ``core_walk_only``: every shape scored on the CUDA cores (no mma.sync);
- ``tc_walk_at_decode``: bf16 on the tensor cores at any row count (the
  tree takes them only past 4 query rows a kv head).

The latent walk's (MLA's) split plan:

- ``latent_one_cta_an_sm``: every plan aims at one CTA an SM (the tree
  aims at two where one CTA an SM would take more than one split).

The latent walk with one stage taken out (its output is wrong by
construction; its time bounds what the stage costs):

- ``latent_one_warpgroup_scores``: the second consumer warpgroup skips
  Q K^T (each warpgroup otherwise scores the whole tile);
- ``latent_no_scores``: neither warpgroup runs Q K^T;
- ``latent_no_pv``: neither runs P V;
- ``latent_no_partials``: no partial is written.

Faults planted in the latent walk, which phase 15's bf16 path check must
catch:

- ``latent_fault_no_rope``: the scores leave out the rope term;
- ``latent_fault_one_half``: the second warpgroup's 256 columns get no
  P V (they stay zero);
- ``latent_fault_causal``: a query row does not see its own position.

Faults planted in the split walk and in flash's wgmma forward, which the
zoo's bf16 path check (phase 27's ``bf16_path_vs_plain``) must catch at
full depth:

- ``split_fault_causal``: on the CUDA-core walk (G <= 4 at decode: the
  granite decode's) a query row does not see its own position;
- ``flash_fault_peek``: a prefill row also sees the key after its own.

Each variant is this tree's ``src/repro_torch`` and ``chip_smoke.py``
copied into ``build/paged_variants/<variant>`` with one line of a kernel
file edited.  The modes:

- ``paged_kernels`` (default): chip_smoke.py's phase-2 paged cases (CUDA
  graphs, cold L2, each held against its plain version), variant against
  the tree by ``ab_parent_change.py`` in turns V C C V, the variant in the
  parent's place;
- ``main_path``: the same turns, phase 4 and llama's decode profile
  (paged attention's device ms a step);
- ``latent_times``: deepseek-v2's three MLA shapes of phase 2 (decode B=8,
  16- and 128-token chunks from position 384), unchecked: call ms (CUDA
  graphs, cold L2) and device ms by kernel (``torch.profiler``: the latent
  walk apart from the merge), the tree's first, then each variant's, each
  in a process of its own;
- ``bf16_path``: chip_smoke.py's phase-15 check of deepseek-v2's bf16 path
  (4 layers, full width) on a fresh engine, the tree's first, then each
  variant's: the logits against the plain attention with the MoE's
  expert choices pinned, and ``within_tol`` against ``PATH_TOL``;
- ``zoo_path``: the same check of granite-3-8b's bf16 path (all 40
  layers, full width): the kernels' path and the rounding floor against
  the pinned plain path, each step's ``within_bound`` (``PATH_TOL`` or
  ``PATH_FLOOR_FACTOR`` floors) and the attention calls that disagree
  with their kernel (``per_call``); its variants by default the two faults
  above.

    python3 scripts/paged_variants.py [paged_kernels|main_path|latent_times|bf16_path|zoo_path] [VARIANT ...]

Prints one JSON line per case and version, ``version`` naming the variant
or ``change`` / ``tree`` (this tree).  Compare versions only within one
call.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = Path("repro_torch") / "kernels"
CU = "csrc/paged_attention.cu"
FLASH = "csrc/flash_attention.cu"
#: variant -> (file under src/repro_torch/kernels, its text, the replacement)
VARIANTS = {
    "cp_async_only": (CU, "  p.tma = p.bh > 0;\n", "  p.tma = 0;\n"),
    "core_walk_only": (CU, "  const bool tc = e == 2 &&", "  const bool tc = false && e == 2 &&"),
    "tc_walk_at_decode": (CU, "p.Dv <= 128 && p.R > 4;", "p.Dv <= 128;"),
    "latent_one_cta_an_sm": ("paged_attention.py", "LATENT_CTAS_PER_SM = 2\n",
                             "LATENT_CTAS_PER_SM = 1\n"),
    "latent_one_warpgroup_scores": (CU, "    for (int c = 0; c < kBoxes; ++c) {\n",
                                    "    for (int c = 0; c < (wg == 0 ? kBoxes : 0); ++c) {\n"),
    "latent_no_scores": (CU, "    for (int c = 0; c < kBoxes; ++c) {\n",
                         "    for (int c = 0; c < 0; ++c) {\n"),
    "latent_no_pv": (CU, "      mma_bf16_rs_n256(o, a,", "      if (kk < 0) mma_bf16_rs_n256(o, a,"),
    "latent_no_partials": (CU, "    if (r < rows && col < p.Dv) {\n      *reinterpret_cast<float2*>",
                           "    if (r < 0) {\n      *reinterpret_cast<float2*>"),
    "latent_fault_no_rope": (CU, "    for (int c = 0; c < kBoxes; ++c) {\n",
                             "    for (int c = 0; c < kLatBoxes; ++c) {\n"),
    "latent_fault_one_half": (CU, "      mma_bf16_rs_n256(o, a,",
                              "      if (wg == 0) mma_bf16_rs_n256(o, a,"),
    "latent_fault_causal": (CU, "t0 + j <= qpos[(i / 2) % 2];", "t0 + j < qpos[(i / 2) % 2];"),
    "split_fault_causal": (CU, "tile.t0 + lane <= qpos[r];", "tile.t0 + lane < qpos[r];"),
    "flash_fault_peek": (FLASH, "(causal && key > row)) x = kNeg;",
                         "(causal && key > row + 1)) x = kNeg;"),
}
#: each mode's variants when none is named
DEFAULT_VARIANTS = {"zoo_path": ["split_fault_causal", "flash_fault_peek"]}
#: modes run through ab_parent_change.py (V C C V), and modes that run
#: each version once, by this code
AB_MODES = ("paged_kernels", "main_path")
LATENT_TIMES = r'''
import json, sys, torch
sys.path.insert(0, ".")
sys.path.insert(0, "src")
import chip_smoke as c
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import paged_attention as pa

g = torch.Generator(device="cuda").manual_seed(0)
timer = c.Timer(torch)
bf = torch.bfloat16

def randn(*shape):
    return torch.randn(shape, generator=g, device="cuda").to(bf)

for b, s, lengths in ((8, 1, [1022, 700, 511, 256, 95, 16, 15, 0]), (1, 16, [384]),
                      (1, 128, [384])):
    mp, ps = 64, 16
    pool, kr = randn(b * mp + 1, 1, ps, 512), randn(b * mp + 1, 1, ps, 64)
    pages = torch.randperm(b * mp, generator=g, device="cuda").to(torch.int32).reshape(b, mp)
    index = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    q, qr = randn(b, 128, s, 512), randn(b, 128, s, 64)
    call = lambda: pa.paged_attention(q, pool, pool, pages, index, q_rope=qr, kr_pool=kr,
                                      scale=576 ** -0.5)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type.name == "CUDA" and "paged" in ev.key:
            name = "latent" if "latent" in ev.key else "merge" if "merge" in ev.key else ev.key
            by_kernel[name] = ev.device_time_total / 20 / 1e3
    plan = pa.latent_plan(b, 128 * s, mp, ps, 512, pa.sm_count(q.device))
    print(json.dumps({"shape": {"B": b, "S": s, "lengths": lengths}, "plan": list(plan),
                      "ms": timer.ms(call), "device_ms_by_kernel": by_kernel}), flush=True)
'''
BF16_PATH = r'''
import json, sys, torch
arch = sys.argv[1]
sys.path.insert(0, ".")
sys.path.insert(0, "src")
import chip_smoke as c
from repro_torch.serve import ServeEngine

engine = ServeEngine(c._serve_config(arch), seed=0, device="cuda", n_slots=8,
                     max_len=1024, page_size=16)
print(json.dumps({"shape": "bf16_path", "arch": arch, **c._bf16_path_vs_plain(torch, engine)}),
      flush=True)
'''
#: modes that run each version once: (script, its arguments)
ONCE = {"latent_times": (LATENT_TIMES,), "bf16_path": (BF16_PATH, "deepseek-v2-236b"),
        "zoo_path": (BF16_PATH, "granite-3-8b")}


def make_variant(name: str) -> Path:
    root = ROOT / "build" / "paged_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", root)  # the modes import it from the version's root
    file, old, new = VARIANTS[name]
    path = root / "src" / KERNELS / file
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {old!r} is not in {file} exactly once")
    path.write_text(text.replace(old, new))
    return root


def run_ab(mode: str, names: list) -> int:
    for name in names:
        out = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "ab_parent_change.py"), mode,
             str(make_variant(name))],
            cwd=ROOT, capture_output=True, text=True, timeout=1800,
        )
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                if row.get("version") == "parent":
                    row["version"] = name
                print(json.dumps(row), flush=True)
            else:
                print(line, flush=True)
        if out.returncode:
            print(name, "failed", out.stderr[-3000:], flush=True)
            return 1
    return 0


def run_once(mode: str, names: list) -> int:
    for name, root in [("tree", ROOT)] + [(n, make_variant(n)) for n in names]:
        script, *script_args = ONCE[mode]
        out = subprocess.run([sys.executable, "-c", script, *script_args], cwd=root,
                             capture_output=True, text=True, timeout=900)
        for line in out.stdout.splitlines():
            if line.startswith("{") and '"shape"' in line:
                print(json.dumps({"version": name, **json.loads(line)}), flush=True)
        if out.returncode:
            print(name, "failed", out.stderr[-3000:], flush=True)
            return 1
    return 0


def main() -> int:
    args = sys.argv[1:]
    mode = args.pop(0) if args and args[0] in AB_MODES + tuple(ONCE) else AB_MODES[0]
    names = args or DEFAULT_VARIANTS.get(mode, list(VARIANTS))
    if any(name not in VARIANTS for name in names):
        print(__doc__, file=sys.stderr)
        return 2
    return run_ab(mode, names) if mode in AB_MODES else run_once(mode, names)


if __name__ == "__main__":
    sys.exit(main())
