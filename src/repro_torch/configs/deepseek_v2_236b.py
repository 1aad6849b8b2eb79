"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 160 routed experts top-6.

60L d_model=5120 128H d_ff=1536(expert) vocab=102400  [arXiv:2405.04434]
2 shared + 160 routed experts; first layer dense (d_ff 12288); MLA
rope/nope head split kept, attention computed with the paper's linear
backend after per-head decompression (`repro_torch/mixers/mla.py`).
"""
from repro_torch.configs.base import LACfg, MLACfg, ModelConfig, MoECfg


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b", family="moe",
        num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
        d_ff=1536, vocab_size=102400,
        mixer="mla", attention_backend="linear", la=LACfg(),
        mla=MLACfg(kv_lora_rank=512, q_lora_rank=1536, rope_head_dim=64,
                   nope_head_dim=128, v_head_dim=128),
        moe=MoECfg(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                   first_dense_layers=1, dense_d_ff=12288),
        rope_kind="standard",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256,
        mixer="mla", attention_backend="linear", la=LACfg(chunk=16),
        mla=MLACfg(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                   nope_head_dim=16, v_head_dim=16),
        moe=MoECfg(num_experts=8, top_k=2, d_expert=32, num_shared=2,
                   first_dense_layers=1, dense_d_ff=128, capacity_factor=8.0),
        rope_kind="standard", remat=False, compute_dtype="float32",
    )
