"""Fused single-kernel decode steps: linear attention, GLA and softmax.

Port of `repro/kernels/decode_fused.py::la_decode_fused_pallas` (linear
variant), `gla_decode_fused_pallas` (decay-gated variant),
`softmax_decode_fused_pallas` (contiguous cache) and
`paged_decode_fused_pallas` (paged cache).

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

GLA: the same step with the decay gate, log_decay (B, Hkv) f32: first
S, P <- exp(log_decay) (S, P), then the rank-1 update and the readout.

  gla_decode_fused_cuda   the gated instantiation of the same kernel
                          (csrc/la_decode_fused.cu, entry
                          `gla_decode_fused`); CUDA only
  gla_decode_fused_torch  its plain version, state in place

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

Paged softmax: the same step over a paged KV arena (the contract of
kernels/paged_attention.py, without the scale argument: 1/sqrt(D)),
head-folded so each page is read once per KV head:

  paged_decode_fused_cuda   the hand-written Hopper kernel
                            (csrc/paged_decode.cu, entry
                            `paged_decode_fused`: one block per (slot,
                            KV head) for its G query rows); CUDA only
  paged_decode_fused_torch  its plain version, the same as
                            `paged_attention_torch` (zeros at length 0
                            on both, as in the reference)
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import softmax as _softmax
from repro_torch.core.numerics import safe_div
from repro_torch.kernels import build
from repro_torch.kernels import paged_attention as _pg
from repro_torch.kernels.defaults import SOFTMAX_DECODE_WARPS

F32 = torch.float32
KERNEL = "la_decode_fused"
GLA_KERNEL = "gla_decode_fused"
SOFTMAX_KERNEL = "softmax_decode_fused"
PAGED_KERNEL = "paged_decode_fused"
# query heads per KV head the kernels are instantiated for
GROUPS = (1, 2, 4, 8, 16)
# head dims the softmax kernel is instantiated for
HEAD_DIMS = (32, 64, 128)

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its decode steps went through
# the kernels)
launches = {KERNEL: 0, GLA_KERNEL: 0, SOFTMAX_KERNEL: 0, PAGED_KERNEL: 0}


def la_decode_fused_torch(s, p, q, k, v, a: float, b: float):
    """Plain PyTorch version of the fused step (s, p updated in place)."""
    return _recurrent_step_torch(s, p, q, k, v, None, a, b)


def gla_decode_fused_torch(s, p, q, k, v, log_decay, a: float, b: float):
    """Plain PyTorch version of the fused GLA step (s, p updated in
    place)."""
    return _recurrent_step_torch(s, p, q, k, v, log_decay, a, b)


def _recurrent_step_torch(s, p, q, k, v, log_decay, a, b):
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    vaug = torch.cat([v.float(), torch.ones((bsz, hkv, 1), dtype=F32,
                                            device=v.device)], -1)
    if log_decay is not None:
        gamma = torch.exp(log_decay.float())              # (B, Hkv)
        s.mul_(gamma[..., None, None])
        p.mul_(gamma[..., None])
    s.add_(k.float()[..., :, None] * vaug[..., None, :])
    p.add_(vaug)
    qg = q.reshape(bsz, hkv, h // hkv, dk).float()
    f = a * p[:, :, None, :] + b * torch.einsum("bhgd,bhde->bhge", qg, s)
    o = safe_div(f[..., :dv], f[..., dv:])
    return o.reshape(bsz, h, dv).to(q.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LA_SYMBOLS = {KERNEL: [_P] * 6 + [_I] * 5 + [_F] * 2 + [_I, _P],
               GLA_KERNEL: [_P] * 7 + [_I] * 5 + [_F] * 2 + [_I, _P]}
_SOFTMAX_SYMBOLS = {SOFTMAX_KERNEL: [_P] * 5 + [_I] * 6 + [_F, _I, _P]}


def _check(s, p, q, k, v, log_decay=None) -> None:
    """Raise on anything the kernel does not take."""
    named = {"s": s, "p": p, "q": q, "k": k, "v": v}
    f32 = ("s", "p")
    if log_decay is not None:
        named["log_decay"] = log_decay
        f32 += ("log_decay",)
    build.check_tensors(KERNEL if log_decay is None else GLA_KERNEL, named,
                        ("q", "k", "v"), f32)
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
    if log_decay is not None and tuple(log_decay.shape) != (bsz, hkv):
        raise ValueError(f"log_decay {tuple(log_decay.shape)} does not "
                         f"match (B, Hkv) = {(bsz, hkv)}")


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


def gla_decode_fused_cuda(s, p, q, k, v, log_decay, a: float, b: float):
    """Launch the gated kernel: s and p updated in place, returns o."""
    _check(s, p, q, k, v, log_decay)
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    lib = build.bind(KERNEL, _LA_SYMBOLS)
    o = torch.empty((bsz, h, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.gla_decode_fused(
            s.data_ptr(), p.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), log_decay.data_ptr(), o.data_ptr(), bsz, h, hkv,
            dk, dv, float(a), float(b), build.DTYPE_CODE[q.dtype],
            build.current_stream(q.device))
    build.raise_on(lib, KERNEL, GLA_KERNEL, err)
    launches[GLA_KERNEL] += 1
    return o


# ---------------------------------------------------------------------------
# Softmax decode over a contiguous KV cache
# ---------------------------------------------------------------------------

def softmax_decode_fused_torch(q, k, v, lengths):
    """Plain version: grouped-native masked softmax over each slot's first
    lengths[b] keys, f32 accumulation (the reference's
    `_softmax_decode_xla`)."""
    return _softmax.softmax_decode_masked(q, k, v, lengths)


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


# ---------------------------------------------------------------------------
# Softmax decode over a paged KV arena, head-folded
# ---------------------------------------------------------------------------

def paged_decode_fused_torch(q, k_pages, v_pages, page_table, lengths):
    """Plain version: `paged_attention_torch` at scale 1/sqrt(D)."""
    return _pg.paged_attention_torch(q, k_pages, v_pages, page_table,
                                     lengths)


def paged_decode_fused_cuda(q, k_pages, v_pages, page_table, lengths):
    """Launch the `paged_decode_fused` kernel: o (B, H, 1, D) in
    q.dtype."""
    _pg.check_paged(PAGED_KERNEL, q, k_pages, v_pages, page_table, lengths)
    h, d = q.shape[1], q.shape[3]
    hkv = k_pages.shape[1]
    if h // hkv not in GROUPS:
        raise ValueError(f"H={h} over Hkv={hkv} is not a query group of "
                         f"{GROUPS}")
    o = _pg.launch_paged(PAGED_KERNEL, q, k_pages, v_pages, page_table,
                         lengths, 1.0 / d ** 0.5)
    launches[PAGED_KERNEL] += 1
    return o
