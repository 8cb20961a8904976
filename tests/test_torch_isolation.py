"""Import isolation of the port: ``repro_torch``, ``chip_smoke.py`` and the
port's examples import ``torch`` and never ``jax``, anything of the JAX package ``repro``, or
``pynvml``."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("*.py"))
              + sorted((ROOT / "examples").glob("*_torch.py")))
#: pynvml too: the port reads NVML through libnvidia-ml.so.1 with ctypes
FORBIDDEN = ("jax", "jaxlib", "repro", "pynvml")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference_package(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.bridge, repro_torch.serve, "
        "repro_torch.launch.serve, repro_torch.kernels.build, repro_torch.kernels.ops, "
        "repro_torch.apps, repro_torch.core, repro_torch.offload, repro_torch.metering\n"
        "repro_torch.core.pattern_db.default_db()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env
    )
    assert out.returncode == 0, out.stderr


def test_chip_smoke_alone_fails_without_printing_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
