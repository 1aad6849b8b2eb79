"""Rotary position embeddings: standard, partial (pythia, stablelm,
chatglm3) and M-RoPE (qwen2-vl).

Port of `repro/models/rope.py`.  q/k are (B, H, N, D); positions are
(B, N), or (3, B, N) for M-RoPE: the temporal, height and width streams
(equal for text).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _rope_angles(positions, dim: int, theta: float):
    """positions (..., N) -> cos/sin (..., N, dim/2)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=F32,
                                       device=positions.device) / dim)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Rotate-half (GPT-NeoX style) on the last dim. x: (..., N, dim)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def apply_rope(x, positions, kind: str = "standard", fraction: float = 1.0,
               theta: float = 10000.0, mrope_sections=(16, 24, 24)):
    """x: (B, H, N, D); positions: (B, N), or (3, B, N) for mrope.
    Computed in f32, cast back; `partial` rotates the first int(D *
    fraction) dims (even-rounded); `mrope` takes stream i's angles (over
    the whole head dim) for its mrope_sections[i] of the D/2 frequency
    slots, in order."""
    if kind in ("none", "sinusoid"):
        return x
    if kind not in ("standard", "partial", "mrope"):
        raise ValueError(f"unknown rope kind {kind!r}")
    d = x.shape[-1]
    xf = x.float()
    if kind == "mrope":
        if positions.dim() != 3:
            raise ValueError(f"mrope needs (3, B, N) positions, got "
                             f"{tuple(positions.shape)}")
        cos_l, sin_l, start = [], [], 0
        for s, pos in zip(mrope_sections, positions):
            cos, sin = _rope_angles(pos, d, theta)       # (B, N, d/2)
            cos_l.append(cos[..., start:start + s])
            sin_l.append(sin[..., start:start + s])
            start += s
        cos = torch.cat(cos_l, -1)[:, None]              # (B, 1, N, d/2)
        sin = torch.cat(sin_l, -1)[:, None]
        return _rotate(xf, cos, sin).to(x.dtype)
    rot_dim = d if kind == "standard" else int(d * fraction)
    rot_dim -= rot_dim % 2
    cos, sin = _rope_angles(positions, rot_dim, theta)   # (B, N, rot/2)
    cos, sin = cos[:, None], sin[:, None]                # broadcast heads
    x_rot = _rotate(xf[..., :rot_dim], cos, sin)
    if rot_dim < d:
        x_rot = torch.cat([x_rot, xf[..., rot_dim:]], -1)
    return x_rot.to(x.dtype)
