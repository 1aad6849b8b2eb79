"""Architecture registry: --arch <id> resolution for the port.

The eleven architectures of the reference's registry
(`repro/configs/registry.py`): pythia-1.4b, the dense qwen2.5-3b,
stablelm-1.6b, chatglm3-6b and granite-20b, the moe moonshot-v1-16b-a3b
and deepseek-v2-236b (the MLA mixer), the ssm mamba2-2.7b, the hybrid
zamba2-7b, the vlm qwen2-vl-7b (M-RoPE) and the encdec whisper-large-v3.
The reference's `input_specs` goes with the dry-run launcher (ROADMAP.md
queue 1 item 11), its only user.
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
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(arch: str, smoke: bool = False, **kw) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return (mod.smoke if smoke else mod.full)(**kw)

