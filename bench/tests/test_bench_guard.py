"""Import guard: nothing the harness runs loads JAX or the JAX package
(top-level names compared whole: ``repro_torch`` is the port, ``repro``
is not), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN_A_CELL = """
import json, sys
sys.path[:0] = [{src!r}, {root!r}]
from bench.harness import driver
out = driver.run_cell("granite-3-8b.long-decode", 3, 0.5, False, device="cpu", reduced=True,
                      clock=driver.VirtualClock())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE_ALONE = """
import json, sys
sys.path[:0] = [{root!r}]
import bench.harness.reference, bench.harness.check, bench.harness.work
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set[str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300, check=True)
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    loaded = _top_level(RUN_A_CELL.format(src=str(ROOT / "src"), root=str(ROOT)))
    assert "repro_torch" in loaded  # the port ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(REFERENCE_ALONE.format(root=str(ROOT)))
    assert "torch" in loaded
    assert not loaded & (FORBIDDEN | {"repro_torch"}), loaded & (FORBIDDEN | {"repro_torch"})


def test_run_refuses_without_a_card():
    # this sandbox's torch has no CUDA: the entry point prints no result
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), "--workload",
                           "granite-3-8b.long-decode", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
