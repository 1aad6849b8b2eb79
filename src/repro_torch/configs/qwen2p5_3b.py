"""qwen2.5-3b [dense] — GQA (kv=2), QKV bias, tied embeddings.

36L d_model=2048 16H (kv=2) d_ff=11008 vocab=151936  [hf:Qwen/Qwen2.5]
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936, qkv_bias=True,
        attention_backend="linear", la=LACfg(),
        rope_kind="standard", rope_theta=1e6, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, qkv_bias=True,
        attention_backend="linear", la=LACfg(chunk=16),
        rope_kind="standard", rope_theta=1e6, tie_embeddings=True,
        remat=False, compute_dtype="float32",
    )
