"""The command-line launchers' shared checks."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_fused import GROUPS as SOFTMAX_DECODE_GROUPS
from repro_torch.models.model import prefix_layers

# attention backends whose card kernels do not take a hybrid's shared
# attention yet (zamba2-7b's head dim 112: flash and the softmax decode
# kernels, the GLA kernels)
HYBRID_REFUSED_BACKENDS = ("softmax", "gla")


def backend_refusal(cfg: ModelConfig, backend: str,
                    serving: bool) -> str | None:
    """Why the launchers refuse `--backend` on `cfg`, or None.  As the
    reference, the flag sets `attention_backend`, and an architecture
    whose mixer is not attention ignores it (mamba2-2.7b; deepseek-v2-236b,
    whose MLA mixer always runs the paper's linear attention).  Refused
    are the backends whose card kernels do not take the model's shapes:
    on the hybrid family softmax and gla (its shared block's head dim),
    and in serving softmax where the query group is not one the softmax
    decode kernels take (qwen2-vl-7b's 7, granite-20b's 48)."""
    todo = ("(ROADMAP.md queue 1, 'softmax and gla on zamba2'); use "
            "linear")
    if cfg.family == "hybrid" and backend in HYBRID_REFUSED_BACKENDS:
        return (f"--backend {backend} on {cfg.name}: the {backend} kernels "
                f"do not take the shared attention's head dim at full "
                f"width (zamba2-7b: 112) yet {todo}")
    if not (serving and backend == "softmax" and cfg.mixer == "attention"):
        return None
    group = cfg.num_heads // cfg.num_kv_heads
    if group not in SOFTMAX_DECODE_GROUPS:
        return (f"--backend softmax on {cfg.name}: the softmax decode "
                f"kernels take query groups {SOFTMAX_DECODE_GROUPS}, not "
                f"{group}, yet {todo}")
    return None


def family_refusal(cfg: ModelConfig, serving: bool) -> str | None:
    """Why the launchers refuse `cfg`'s family, or None: the
    encoder-decoder (whisper-large-v3) needs each request's or batch's
    encoder frames, which neither launcher makes, as the reference's do
    not (its engine raises on the family, its trainer feeds tokens
    alone); `chip_smoke.py` drives it through `models/model.py` with
    frames from `models/frontends.py`."""
    if cfg.family != "encdec":
        return None
    what = ("the engine serves decoder-only families" if serving else
            "SyntheticLM feeds tokens, not encoder frames")
    return (f"{cfg.name} is an encoder-decoder: {what}; drive it through "
            f"repro_torch.models.model (prefill/decode_step, loss_fn) with "
            f"frames from repro_torch.models.frontends.audio_frames_stub")


def paging_refusal(cfg: ModelConfig) -> str | None:
    """Why the serving launcher refuses `--page-size` on `cfg`, or None:
    the MoE family's dense first layers keep caches of their own
    ("prefix") whose page tables the engine does not manage, and the
    engine refuses them as the reference's does."""
    n_prefix = prefix_layers(cfg)
    if n_prefix:
        return (f"--page-size on {cfg.name}: its {n_prefix} dense first "
                f"layer(s) keep prefix caches the engine does not page (as "
                f"in the reference); serve it contiguous")
    return None
