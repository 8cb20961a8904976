"""Architecture registry of the port.  Only the architectures whose model
path is ported are registered; the reference's other names raise."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

#: the reference's architectures whose mixers the port has not reached yet
_NOT_PORTED = (
    "stablelm-1.6b", "command-r-35b", "granite-3-8b", "arctic-480b",
    "deepseek-v2-236b", "pixtral-12b", "musicgen-large",
)

ARCH_NAMES = tuple(_MODULES)


def _canonical(name: str, known: "tuple[str, ...]") -> str:
    key = name.replace("_", "-").lower()
    alt = {k.replace("-", "").replace(".", ""): k for k in known}
    return alt.get(key.replace("-", "").replace(".", ""), key)


def get_config(name: str) -> ArchConfig:
    key = _canonical(name, ARCH_NAMES + _NOT_PORTED)
    if key in _NOT_PORTED:
        raise KeyError(f"arch '{name}' is not ported yet; ported: {ARCH_NAMES}")
    if key not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[key]).CONFIG
