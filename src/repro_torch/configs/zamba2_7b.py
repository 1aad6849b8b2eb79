"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block.

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242]: 81 mamba layers as 13 groups of 6 + 3 tail; ONE
shared attention+FFN block (reused weights) applied after each group,
with per-application serving caches.
"""
from repro_torch.configs.base import LACfg, ModelConfig, SSMCfg


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        mixer="mamba2", ssm=SSMCfg(state_dim=64, head_dim=64, expand=2),
        attention_backend="linear", la=LACfg(),
        hybrid_groups=13, hybrid_mamba_per_group=6, hybrid_tail=3,
        rope_kind="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        mixer="mamba2", ssm=SSMCfg(state_dim=16, head_dim=32, expand=2),
        attention_backend="linear", la=LACfg(chunk=16),
        hybrid_groups=2, hybrid_mamba_per_group=2, hybrid_tail=1,
        rope_kind="standard", remat=False, compute_dtype="float32",
    )
