"""Config schema for the port (a copy of `repro/configs/base.py`).

Only what the ported paths read is kept: `LACfg`, `ModelConfig` (its
fields, `resolved_head_dim` and `param_count`), the optional blocks
`ModelConfig` names, `TrainConfig`, and the workload shapes `SHAPES`
(read by `repro_torch.check.smem`).  `SSMCfg` is read by the mamba2
mixer, the `hybrid_*` fields by the hybrid family (zamba2-7b), `moe`
and `mla` by the MoE family, `mrope_sections` by M-RoPE (qwen2-vl-7b)
and the `encoder_*` fields by the enc-dec family (whisper-large-v3).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LACfg:
    """Paper's linear-attention kernel f(x) = a + b x (§2.2, §3.3).

    `backend` names a kernel impl of the port's registry
    (kernels/ops.py): "torch" (plain PyTorch), "cuda" (the hand-written
    Hopper kernels) or "auto" (picked per call by the tensors' device).
    """

    a: float = 1.0
    b: float = 1.0
    normalize_qk: bool = True
    # tokens per chunked-scan iteration (kernels/defaults.py)
    chunk: int = 512
    backend: str = "auto"  # auto | torch | cuda
    learnable_coeffs: bool = False
    # route decode through the fused single-kernel step family
    # (kernels/decode_fused.py); False pins the plain composition
    fused_decode: bool = True


@dataclasses.dataclass(frozen=True)
class PagingCfg:
    page_size: int = 16
    num_pages: int = 0


@dataclasses.dataclass(frozen=True)
class TuneCfg:
    enabled: bool = False
    cache_path: str = "artifacts/tune_cache.json"


@dataclasses.dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    analytic_bwd: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 => d_model // num_heads
    mixer: str = "attention"       # attention | mla | mamba2
    attention_backend: str = "linear"
    la: LACfg = LACfg()
    paging: Optional[PagingCfg] = None
    tune: Optional[TuneCfg] = None
    qkv_bias: bool = False
    mlp_act: str = "swiglu"        # swiglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    parallel_residual: bool = False
    # standard | partial | mrope | none | sinusoid
    rope_kind: str = "standard"
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid_groups: int = 0
    hybrid_mamba_per_group: int = 0
    hybrid_tail: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False
    frontend: str = "none"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    logit_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Approximate total parameter count (same formula as the
        reference's `ModelConfig.param_count`)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.mixer == "attention":
            per_layer += d * hd * (self.num_heads + 2 * self.num_kv_heads)
            per_layer += self.num_heads * hd * d
        elif self.mixer == "mla":
            m = self.mla
            per_layer += d * m.q_lora_rank
            per_layer += m.q_lora_rank * self.num_heads * (
                m.nope_head_dim + m.rope_head_dim)
            per_layer += d * (m.kv_lora_rank + m.rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (
                m.nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        elif self.mixer == "mamba2":
            s = self.ssm
            d_in = s.expand * d
            conv_ch = d_in + 2 * s.state_dim
            nheads = d_in // s.head_dim
            per_layer += d * (2 * d_in + 2 * s.state_dim + nheads)
            per_layer += conv_ch * s.conv_width
            per_layer += d_in * d
        mult = 3 if self.mlp_act == "swiglu" else 2
        if self.moe is not None:
            moe_ffn = 3 * self.moe.d_expert * d
            per_layer += (self.moe.num_experts * moe_ffn
                          + self.moe.num_shared * moe_ffn
                          + d * self.moe.num_experts)
        elif self.mixer != "mamba2":
            per_layer += mult * d * self.d_ff
        total = emb + self.num_layers * per_layer
        if self.moe is not None and self.moe.first_dense_layers:
            moe_ffn = 3 * self.moe.d_expert * d
            per_moe = ((self.moe.num_experts + self.moe.num_shared)
                       * moe_ffn + d * self.moe.num_experts)
            dense_ff = mult * d * (self.moe.dense_d_ff or self.d_ff)
            total += self.moe.first_dense_layers * (dense_ff - per_moe)
        if self.family == "hybrid":
            shared = (d * hd * (self.num_heads + 2 * self.num_kv_heads)
                      + self.num_heads * hd * d + mult * d * self.d_ff)
            total += shared
        if self.encoder_layers:
            enc_attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) \
                + self.num_heads * hd * d
            total += self.encoder_layers * (enc_attn + mult * d * self.d_ff)
            total += self.num_layers * enc_attn
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3       # paper §5.2
    min_learning_rate: float = 5e-5
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0               # 0 = no gradient accumulation
    # the reference's sharding, compression and checkpoint fields; the
    # multi-GPU and checkpoint slices read them (ROADMAP.md queue 1)
    zero1: bool = True
    grad_compression: str = "none"    # none | int8
    seed: int = 0
    checkpoint_every: int = 200
    checkpoint_dir: str = "checkpoints"
    straggler_threshold: float = 3.0  # x median step time
