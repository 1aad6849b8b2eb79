"""pythia-1.4b — the paper's own end-to-end LLM (§5.2).

24L d_model=2048 16H d_ff=8192 vocab=50304, parallel residual, partial
RoPE 0.25, layernorm (Biderman et al. 2023).  Same presets as
`repro/configs/pythia_1p4b.py`.
"""
from repro_torch.configs.base import LACfg, ModelConfig


def full(attention_backend: str = "linear") -> ModelConfig:
    return ModelConfig(
        name="pythia-1.4b", family="dense",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304,
        attention_backend=attention_backend, la=LACfg(),
        mlp_act="gelu", norm="layernorm", parallel_residual=True,
        rope_kind="partial", rope_fraction=0.25,
    )


def smoke(attention_backend: str = "linear") -> ModelConfig:
    return ModelConfig(
        name="pythia-1.4b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=256,
        attention_backend=attention_backend, la=LACfg(chunk=16),
        mlp_act="gelu", norm="layernorm", parallel_residual=True,
        rope_kind="partial", rope_fraction=0.25, remat=False,
        compute_dtype="float32",
    )
