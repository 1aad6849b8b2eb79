"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution (frontend stubbed).

28L d_model=3584 28H (kv=4) d_ff=18944 vocab=152064  [arXiv:2409.12191]
The vision tower is a STUB: the model takes the merged token stream and
(3, B, N) t/h/w M-RoPE positions (`models/frontends.py`).
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
        d_ff=18944, vocab_size=152064, qkv_bias=True,
        attention_backend="linear", la=LACfg(),
        rope_kind="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        frontend="vision",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, qkv_bias=True,
        attention_backend="linear", la=LACfg(chunk=16),
        rope_kind="mrope", mrope_sections=(2, 3, 3), rope_theta=1e6,
        frontend="vision", remat=False, compute_dtype="float32",
    )
