"""mamba2-2.7b [ssm] — attention-free SSD (state-space duality).

64L d_model=2560 d_ff=0 vocab=50280 ssm_state=128  [arXiv:2405.21060]
Same presets as `repro/configs/mamba2_2p7b.py`.  SSD *is* decay-gated
linear attention (paper Table 3, Mamba-2 row): the mixer runs the
chunked SSD scan and, in training, the SSD kernels (kernels/ssd.py), not
the paper's normalized un-decayed LA.  q and k (Mamba-2's C and B) are
shared by all 80 heads (G = 1); embeddings are tied.
"""
from repro_torch.configs.base import LACfg, ModelConfig, SSMCfg


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=80, num_kv_heads=80,
        d_ff=0, vocab_size=50280,
        mixer="mamba2", ssm=SSMCfg(state_dim=128, head_dim=64, expand=2),
        la=LACfg(), rope_kind="none", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=256,
        mixer="mamba2", ssm=SSMCfg(state_dim=16, head_dim=32, expand=2),
        la=LACfg(chunk=16), rope_kind="none", tie_embeddings=True,
        remat=False, compute_dtype="float32",
    )
