"""Fused single-kernel decode steps: linear attention and softmax.

Port of `repro/kernels/decode_fused.py::la_decode_fused_pallas` (linear
variant) and `softmax_decode_fused_pallas` (contiguous cache).

Linear: one call per layer and decode step: rank-1 update of the slot's
f32 recurrent state, the grouped q.S and normalizer dots, and the
safe_div divide, with the state updated IN PLACE (the TPU kernel
donates it through input_output_aliases).

  la_decode_fused_cuda   the hand-written Hopper kernel
                         (csrc/la_decode_fused.cu), launched on the
                         current stream; CUDA tensors only
  la_decode_fused_torch  its plain PyTorch version, same contract; the
                         CPU path and the kernel's reference

Both take s (B, Hkv, Dk, Dv+1) f32, p (B, Hkv, Dv+1) f32, q (B, H, Dk),
k (B, Hkv, Dk) and v (B, Hkv, Dv) in the compute dtype, update s and p
in place and return o (B, H, Dv) in q.dtype.

Softmax: one call per layer and decode step attends each slot's query
token to the first lengths[b] keys of its contiguous KV cache, the
GQA head-fold and the finalize divide inside the kernel:

  softmax_decode_fused_cuda   the hand-written Hopper kernel
                              (csrc/softmax_decode_fused.cu); CUDA only
  softmax_decode_fused_torch  its plain PyTorch version: the reference's
                              unfused composition (`ops.py`'s
                              `_softmax_decode_xla`)

Both take q (B, H, 1, D), k and v (B, Hkv, S, D) in the compute dtype
and lengths (B,) int32, and return o (B, H, 1, D) in q.dtype.  Lengths
past S attend to all S keys.  They differ on a slot of length 0: the
kernel writes zeros, as the Pallas kernel does, while the plain version
(like the reference's xla impl) averages all S value rows of a wholly
masked softmax.  A live serving slot always has length >= 1.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.numerics import safe_div
from repro_torch.kernels import build
from repro_torch.kernels.defaults import SOFTMAX_DECODE_WARPS

F32 = torch.float32
KERNEL = "la_decode_fused"
SOFTMAX_KERNEL = "softmax_decode_fused"
# query heads per KV head the kernels are instantiated for
GROUPS = (1, 2, 4, 8, 16)
# head dims the softmax kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its decode steps went through
# the kernels)
launches = {KERNEL: 0, SOFTMAX_KERNEL: 0}


def la_decode_fused_torch(s, p, q, k, v, a: float, b: float):
    """Plain PyTorch version of the fused step (s, p updated in place)."""
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    vaug = torch.cat([v.float(), torch.ones((bsz, hkv, 1), dtype=F32,
                                            device=v.device)], -1)
    s.add_(k.float()[..., :, None] * vaug[..., None, :])
    p.add_(vaug)
    qg = q.reshape(bsz, hkv, h // hkv, dk).float()
    f = a * p[:, :, None, :] + b * torch.einsum("bhgd,bhde->bhge", qg, s)
    o = safe_div(f[..., :dv], f[..., dv:])
    return o.reshape(bsz, h, dv).to(q.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LA_SYMBOLS = {KERNEL: [_P] * 6 + [_I] * 5 + [_F] * 2 + [_I, _P]}
_SOFTMAX_SYMBOLS = {SOFTMAX_KERNEL: [_P] * 5 + [_I] * 6 + [_F, _I, _P]}


def _check(s, p, q, k, v) -> None:
    """Raise on anything the kernel does not take."""
    build.check_tensors(KERNEL, {"s": s, "p": p, "q": q, "k": k, "v": v},
                        ("q", "k", "v"), ("s", "p"))
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be 3-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (bsz, hkv, dk) or tuple(v.shape[:2]) != (bsz, hkv):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % hkv != 0 or h // hkv not in GROUPS:
        raise ValueError(f"H={h} over Hkv={hkv} is not a query group of "
                         f"{GROUPS}")
    if tuple(s.shape) != (bsz, hkv, dk, dv + 1) \
            or tuple(p.shape) != (bsz, hkv, dv + 1):
        raise ValueError(
            f"state shapes s {tuple(s.shape)}, p {tuple(p.shape)} do not "
            f"match (B, Hkv, Dk, Dv+1) = {(bsz, hkv, dk, dv + 1)}")


def la_decode_fused_cuda(s, p, q, k, v, a: float, b: float):
    """Launch the CUDA kernel: s and p updated in place, returns o."""
    _check(s, p, q, k, v)
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    lib = build.bind(KERNEL, _LA_SYMBOLS)
    o = torch.empty((bsz, h, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.la_decode_fused(
            s.data_ptr(), p.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), bsz, h, hkv, dk, dv, float(a),
            float(b), build.DTYPE_CODE[q.dtype],
            build.current_stream(q.device))
    build.raise_on(lib, KERNEL, KERNEL, err)
    launches[KERNEL] += 1
    return o


# ---------------------------------------------------------------------------
# Softmax decode over a contiguous KV cache
# ---------------------------------------------------------------------------

def softmax_decode_fused_torch(q, k, v, lengths):
    """Plain version: grouped-native masked softmax over each slot's first
    lengths[b] keys, f32 accumulation (the reference's
    `_softmax_decode_xla`)."""
    b, hkv, s_len, d = k.shape
    h = q.shape[1]
    live = torch.arange(s_len, device=k.device)[None, :] \
        < lengths.to(k.device)[:, None]                        # (B, S)
    qg = q.reshape(b, hkv, h // hkv, 1, d).float()
    s_ = torch.einsum("bhgid,bhjd->bhgij", qg, k.float()) / d ** 0.5
    s_ = s_.masked_fill(~live[:, None, None, None, :], -1e30)
    o = torch.einsum("bhgij,bhjd->bhgid", torch.softmax(s_, dim=-1),
                     v.float())
    return o.reshape(b, h, 1, v.shape[-1]).to(q.dtype)


def _check_softmax(q, k, v, lengths) -> None:
    """Raise on anything the kernel does not take."""
    build.check_tensors(SOFTMAX_KERNEL, {"q": q, "k": k, "v": v,
                                         "lengths": lengths},
                        ("q", "k", "v"), i32=("lengths",))
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, H, 1, D), k and v (B, Hkv, S, D) expected; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bsz, h, nq, d = q.shape
    hkv = k.shape[1]
    if nq != 1 or k.shape[0] != bsz or k.shape[3] != d \
            or tuple(lengths.shape) != (bsz,):
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / "
                         f"lengths {tuple(lengths.shape)} do not match "
                         f"(one query token per slot)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if h % hkv != 0 or h // hkv not in GROUPS:
        raise ValueError(f"H={h} over Hkv={hkv} is not a query group of "
                         f"{GROUPS}")


def softmax_decode_fused_cuda(q, k, v, lengths):
    """Launch the CUDA kernel: o (B, H, 1, D) in q.dtype."""
    _check_softmax(q, k, v, lengths)
    bsz, h, _, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    lib = build.bind(SOFTMAX_KERNEL, _SOFTMAX_SYMBOLS)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.softmax_decode_fused(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), bsz, h, hkv, s_len, d, SOFTMAX_DECODE_WARPS,
            1.0 / d ** 0.5, build.DTYPE_CODE[q.dtype],
            build.current_stream(q.device))
    build.raise_on(lib, SOFTMAX_KERNEL, SOFTMAX_KERNEL, err)
    launches[SOFTMAX_KERNEL] += 1
    return o
