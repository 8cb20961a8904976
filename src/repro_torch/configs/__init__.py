"""Architecture registry of the port: the reference's ten architectures
(``repro/configs/__init__.py``), each config a copy of the reference's."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-").lower()
    if key not in _MODULES:
        alt = {k.replace("-", "").replace(".", ""): k for k in _MODULES}
        key = alt.get(key.replace("-", "").replace(".", ""), key)
    if key not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[key]).CONFIG
