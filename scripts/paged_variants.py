"""Time the paged-attention kernel against copies of itself with one of its
two forks taken out, on one card:

- ``cp_async_only``: every page staged by cp.async (no TMA);
- ``core_walk_only``: every shape scored on the CUDA cores (no mma.sync);
- ``tc_walk_at_decode``: bf16 on the tensor cores at any row count (the
  tree takes them only past 4 query rows a kv head).

Each variant is this tree's ``src/repro_torch`` and ``chip_smoke.py``
copied into ``build/paged_variants/<variant>`` with one line of
``csrc/paged_attention.cu`` edited, then held against the tree by
``ab_parent_change.py`` in turns V C C V, the variant in the parent's
place: by default in mode ``paged_kernels`` (chip_smoke.py's phase-2 paged
cases, CUDA graphs, cold L2), or in the mode given first (``main_path``:
phase 4 and llama's decode profile, paged attention's device ms a step).

    python3 scripts/paged_variants.py [paged_kernels|main_path] [VARIANT ...]

Prints one JSON line per case and version, ``version`` naming the variant
or ``change`` (the tree).  Compare versions only within one call.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("repro_torch") / "kernels" / "csrc" / "paged_attention.cu"
#: variant -> (line of the source, its replacement)
VARIANTS = {
    "cp_async_only": ("  p.tma = p.bh > 0;\n", "  p.tma = 0;\n"),
    "core_walk_only": ("  const bool tc = e == 2 &&", "  const bool tc = false && e == 2 &&"),
    "tc_walk_at_decode": ("p.Dv <= 128 && p.R > 4;", "p.Dv <= 128;"),
}
MODES = ("paged_kernels", "main_path")


def make_variant(name: str) -> Path:
    root = ROOT / "build" / "paged_variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", root)  # main_path imports it from the version's root
    path = root / "src" / SOURCE
    text = path.read_text()
    old, new = VARIANTS[name]
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the line {old!r} is not in {SOURCE} exactly once")
    path.write_text(text.replace(old, new))
    return root


def main() -> int:
    args = sys.argv[1:]
    mode = args.pop(0) if args and args[0] in MODES else MODES[0]
    names = args or list(VARIANTS)
    for name in names:
        if name not in VARIANTS:
            print(__doc__, file=sys.stderr)
            return 2
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


if __name__ == "__main__":
    sys.exit(main())
