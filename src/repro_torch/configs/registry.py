"""Architecture registry: --arch <id> resolution for the port.

Only the architectures the port can run are listed: pythia-1.4b, the
dense qwen2.5-3b, stablelm-1.6b, chatglm3-6b and granite-20b, the moe
moonshot-v1-16b-a3b and deepseek-v2-236b (the MLA mixer), the ssm
mamba2-2.7b and the hybrid zamba2-7b; the reference's registry
(`repro/configs/registry.py`) names all eleven.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "pythia-1.4b": "pythia_1p4b",
    "mamba2-2.7b": "mamba2_2p7b",
    "qwen2.5-3b": "qwen2p5_3b",
    "stablelm-1.6b": "stablelm_1p6b",
    "chatglm3-6b": "chatglm3_6b",
    "granite-20b": "granite_20b",
    "zamba2-7b": "zamba2_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-v2-236b": "deepseek_v2_236b",
}


def get_config(arch: str, smoke: bool = False, **kw) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return (mod.smoke if smoke else mod.full)(**kw)

