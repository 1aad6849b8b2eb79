"""Architecture registry: --arch <id> resolution for the port.

Only the architectures the port can run are listed; the reference's
registry (`repro/configs/registry.py`) names all eleven.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "pythia-1.4b": "pythia_1p4b",
    "mamba2-2.7b": "mamba2_2p7b",
}


def get_config(arch: str, smoke: bool = False, **kw) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return (mod.smoke if smoke else mod.full)(**kw)
