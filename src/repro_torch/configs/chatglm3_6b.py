"""chatglm3-6b [dense] — 2d (half-dim) RoPE, GQA kv=2, QKV bias.

28L d_model=4096 32H (kv=2) d_ff=13696 vocab=65024  [arXiv:2406.12793]
ChatGLM applies rotary to half the head dim — modeled as partial RoPE 0.5.
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=65024, qkv_bias=True,
        attention_backend="linear", la=LACfg(),
        rope_kind="partial", rope_fraction=0.5,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, qkv_bias=True,
        attention_backend="linear", la=LACfg(chunk=16),
        rope_kind="partial", rope_fraction=0.5, remat=False, compute_dtype="float32",
    )
