"""pytest settings of the benchmark's own tests (``bench/tests``).

The tests run on the CPU with the program's plain paths.  A test that
needs the CUDA card carries the ``chip`` marker and takes the ``chip``
fixture, which decides at run time (never at import) whether a card is
there and skips otherwise.  On the card: ``python -m pytest -m chip bench``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _path in (ROOT / "src", ROOT):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs the CUDA card; skipped without one")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced runs are far too small to gain from intra-op threads, and
    a test run's workers share the machine: one thread each, restored."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
