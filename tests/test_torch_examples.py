"""The port's examples (``examples/*_torch.py``), each ``main`` at its
smallest size on the CPU (``--device cpu``): they drive the port's
``OffloadSession``, ``run_ga``, ``CheckpointManager``,
``FaultTolerantLoop`` and train step, and print the reference examples'
lines."""

import importlib.util
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    assert _load("quickstart_torch").main(["--fast", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "discovered: fft2d_nr -> fft2d" in out
    assert "numerics verified: True" in out
    assert "function-block offload is" in out and "GA best genome" in out


def test_offload_existing_app(capsys):
    assert _load("offload_existing_app_torch").main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ludcmp_nr -> lu via libcall" in out and "my_ludcmp -> lu via similar" in out
    assert "blocked as expected" in out and "dropped=('b',)" in out


def test_train_lm(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "20", "--d-model", "64", "--layers", "2",
            "--seq", "32", "--ckpt-dir", str(tmp_path / "ckpt")]
    assert _load("train_lm_torch").main(argv) == 0
    out = capsys.readouterr().out
    assert "trained 20 steps" in out and "loss decreased: OK" in out


@pytest.mark.parametrize("name", ["quickstart_torch", "offload_existing_app_torch",
                                  "train_lm_torch"])
def test_examples_default_to_the_card(name):
    """Without ``--device`` an example runs on the card, and raises here."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load(name).main(["--fast"] if name == "quickstart_torch" else
                         ["--steps", "1"] if name == "train_lm_torch" else [])
