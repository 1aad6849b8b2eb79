"""stablelm-1.6b [dense] — partial RoPE (25%), layernorm.

24L d_model=2048 32H (kv=32) d_ff=5632 vocab=100352
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        attention_backend="linear", la=LACfg(),
        norm="layernorm", rope_kind="partial", rope_fraction=0.25,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        attention_backend="linear", la=LACfg(chunk=16),
        norm="layernorm", rope_kind="partial", rope_fraction=0.25,
        remat=False, compute_dtype="float32",
    )
