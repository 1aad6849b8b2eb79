"""granite-20b [dense] — llama-arch code model, MQA (kv=1).

52L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152  [arXiv:2405.04324]
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
        d_ff=24576, vocab_size=49152,
        attention_backend="linear", la=LACfg(),
        rope_kind="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256,
        attention_backend="linear", la=LACfg(chunk=16),
        rope_kind="standard", remat=False, compute_dtype="float32",
    )
