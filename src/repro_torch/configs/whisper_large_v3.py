"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed.

32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866  [arXiv:2212.04356]
The transformer backbone only: the encoder takes 1500 precomputed frame
embeddings (`models/frontends.py`); sinusoidal positions; layernorm +
gelu (whisper-style).
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        mixer="attention", attention_backend="linear", la=LACfg(),
        mlp_act="gelu", norm="layernorm", rope_kind="sinusoid",
        encoder_layers=32, encoder_seq=1500, cross_attention=True,
        frontend="audio", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        mixer="attention", attention_backend="linear", la=LACfg(chunk=16),
        mlp_act="gelu", norm="layernorm", rope_kind="sinusoid",
        encoder_layers=2, encoder_seq=12, cross_attention=True,
        frontend="audio", tie_embeddings=True, remat=False,
        compute_dtype="float32",
    )
