"""moonshot-v1-16b-a3b [moe] — Moonlight-style: 64 experts top-6.

48L d_model=2048 16H (kv=16) d_ff=1408(expert) vocab=163840
[hf:moonshotai/Moonlight-16B-A3B]: 2 shared experts, first layer dense
(d_ff 11264), expert parallelism over the "model" mesh axis.
"""
from repro_torch.configs.base import LACfg, ModelConfig, MoECfg


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=163840,
        attention_backend="linear", la=LACfg(),
        moe=MoECfg(num_experts=64, top_k=6, d_expert=1408, num_shared=2,
                   first_dense_layers=1, dense_d_ff=11264),
        rope_kind="standard", rope_theta=50000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256,
        attention_backend="linear", la=LACfg(chunk=16),
        moe=MoECfg(num_experts=8, top_k=2, d_expert=32, num_shared=2,
                   first_dense_layers=1, dense_d_ff=128, capacity_factor=8.0),
        rope_kind="standard", remat=False, compute_dtype="float32",
    )
