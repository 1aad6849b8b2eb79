"""Fused single-kernel linear-attention decode step.

Port of `repro/kernels/decode_fused.py::la_decode_fused_pallas` (linear
variant only).  One call per layer and decode step: rank-1 update of
the slot's f32 recurrent state, the grouped q.S and normalizer dots, and
the safe_div divide, with the state updated IN PLACE (the TPU kernel
donates it through input_output_aliases).

  la_decode_fused_cuda   the hand-written Hopper kernel
                         (csrc/la_decode_fused.cu), launched on the
                         current stream; CUDA tensors only
  la_decode_fused_torch  its plain PyTorch version, same contract; the
                         CPU path and the kernel's reference

Both take s (B, Hkv, Dk, Dv+1) f32, p (B, Hkv, Dv+1) f32, q (B, H, Dk),
k (B, Hkv, Dk) and v (B, Hkv, Dv) in the compute dtype, update s and p
in place and return o (B, H, Dv) in q.dtype.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.numerics import safe_div
from repro_torch.kernels import build

F32 = torch.float32
KERNEL = "la_decode_fused"
# C code of each compute dtype the kernel is instantiated for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# query heads per KV head the kernel is instantiated for
GROUPS = (1, 2, 4, 8, 16)

# kernel launches made by la_decode_fused_cuda (a run sets it to 0 and
# reads it back to show that its decode steps went through the kernel)
launches = 0


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


def _check(s, p, q, k, v) -> None:
    """Raise on anything the kernel does not take."""
    named = {"s": s, "p": p, "q": q, "k": k, "v": v}
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(
                f"la_decode_fused_cuda needs CUDA tensors; {name} is on "
                f"{t.device} (the plain version is la_decode_fused_torch)")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"la_decode_fused_cuda needs contiguous "
                             f"tensors; {name} has strides {t.stride()}")
    if s.dtype != F32 or p.dtype != F32:
        raise ValueError(f"state must be float32, got s {s.dtype}, "
                         f"p {p.dtype}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"q, k, v must share one dtype of {list(_DTYPE_CODE)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
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


def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.la_decode_fused
    if fn.argtypes is None:
        # c_void_p for every pointer and the stream: undeclared, ctypes
        # would pass them as 32-bit ints and cut the address
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                 ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.la_decode_fused_error_string.argtypes = [ctypes.c_int]
        lib.la_decode_fused_error_string.restype = ctypes.c_char_p
    return lib


def la_decode_fused_cuda(s, p, q, k, v, a: float, b: float):
    """Launch the CUDA kernel: s and p updated in place, returns o."""
    global launches
    _check(s, p, q, k, v)
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    lib = _lib()
    o = torch.empty((bsz, h, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.la_decode_fused(
            s.data_ptr(), p.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), bsz, h, hkv, dk, dv, float(a),
            float(b), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        msg = lib.la_decode_fused_error_string(err).decode()
        raise RuntimeError(f"la_decode_fused launch failed: {msg} "
                           f"(cudaError {err})")
    launches += 1
    return o
