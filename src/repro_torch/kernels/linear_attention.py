"""Causal linear attention, forward and analytic backward, on Hopper.

Port of `repro/kernels/linear_attention.py` (`la_fwd_pallas`,
`la_bwd_pallas`).  Three hand-written CUDA kernels, each launched by a
wrapper on the current stream, and beside each its plain PyTorch
version (the chunked scans of core/chunked.py):

  kernel      wrapper                                   plain version
  la_fwd      la_fwd_cuda(q, k, v, a, b) -> (o, g)      la_fwd_torch
  la_bwd_q    la_bwd_q_cuda(k, v, om_hat, h, b) -> dq   la_bwd_q_torch
  la_bwd_kv   la_bwd_kv_cuda(q, k, v, om_hat, h, a, b)  la_bwd_kv_torch

`la_bwd_cuda(q, k, v, o, g, omega, a, b) -> (dq, dk, dv)` prepares
Ω̂ = safe_div(ω, g) and h = Σ o·Ω̂ in plain PyTorch (as the reference
does outside its kernels) and launches both backward kernels;
`la_bwd_torch` is the whole plain backward.  Sources: csrc/la_fwd.cu
and csrc/la_bwd.cu; their headers say what bounds each kernel and how
it is laid out.

Shapes: q (B, H, N, D), k and v (B, Hkv, N, D) with Hkv | H, float32 or
bfloat16, D in `HEAD_DIMS`; o, dq, dk and dv come back in their
inputs' dtypes, g, Ω̂ and h are float32.  The wrappers take contiguous
CUDA tensors only and raise on anything else; nothing falls back to the
plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import chunked as _chunked
from repro_torch.kernels import build
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK, \
    LA_STAGE_TOKENS

F32 = torch.float32
# head dims the kernels are instantiated for (a state row in registers)
HEAD_DIMS = (32, 64, 128)

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"la_fwd": 0, "la_bwd_q": 0, "la_bwd_kv": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def la_fwd_torch(q, k, v, a: float, b: float,
                 chunk: int = DEFAULT_SCAN_CHUNK):
    """Plain forward: (o, g) of the chunked scan."""
    o, g, _ = _chunked.la_fwd_chunked(q, k, v, a, b, chunk)
    return o, g


la_bwd_q_torch = _chunked.la_bwd_q_chunked
la_bwd_kv_torch = _chunked.la_bwd_kv_chunked
la_bwd_torch = _chunked.la_bwd_chunked


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _dims(q, k, v):
    """(B, H, Hkv, N, D) of a (q, k, v) triple, raising on shapes the
    kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, h, n, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (bsz, hkv, n, d) or tuple(v.shape) != (bsz, hkv,
                                                               n, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (Dk = Dv = D)")
    if h % hkv != 0:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    return bsz, h, hkv, n, d


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SYMBOLS = {"la_fwd": [_P] * 5 + [_I] * 6 + [_F] * 2 + [_I, _P]}
_BWD_SYMBOLS = {"la_bwd_q": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
                "la_bwd_kv": [_P] * 7 + [_I] * 6 + [_F] * 2 + [_I, _P]}


def la_fwd_cuda(q, k, v, a: float, b: float):
    """Launch `la_fwd`: returns (o in q.dtype, g f32)."""
    build.check_tensors("la_fwd", {"q": q, "k": k, "v": v}, ("q", "k", "v"))
    bsz, h, hkv, n, d = _dims(q, k, v)
    lib = build.bind("la_fwd", _FWD_SYMBOLS)
    o = torch.empty_like(q)
    g = torch.empty((bsz, h, n), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.la_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), g.data_ptr(), bsz, h, hkv, n, d,
                         LA_STAGE_TOKENS, float(a), float(b),
                         build.DTYPE_CODE[q.dtype],
                         build.current_stream(q.device))
    build.raise_on(lib, "la_fwd", "la_fwd", err)
    launches["la_fwd"] += 1
    return o, g


def la_bwd_q_cuda(k, v, om_hat, h_vec, b: float):
    """Launch `la_bwd_q`: dq (B, H, N, D) in k.dtype (the dtype q shares
    with k and v) from k, v and the f32 om_hat (B, H, N, D), h (B, H, N).
    """
    build.check_tensors("la_bwd_q", {"k": k, "v": v, "om_hat": om_hat,
                                     "h": h_vec}, ("k", "v"),
                        ("om_hat", "h"))
    bsz, h, hkv, n, d = _dims(om_hat, k, v)
    if tuple(h_vec.shape) != (bsz, h, n):
        raise ValueError(f"h {tuple(h_vec.shape)} does not match "
                         f"{(bsz, h, n)}")
    lib = build.bind("la_bwd", _BWD_SYMBOLS)
    dq = torch.empty((bsz, h, n, d), dtype=k.dtype, device=k.device)
    with torch.cuda.device(k.device):
        err = lib.la_bwd_q(k.data_ptr(), v.data_ptr(), om_hat.data_ptr(),
                           h_vec.data_ptr(), dq.data_ptr(), bsz, h, hkv, n,
                           d, LA_STAGE_TOKENS, float(b),
                           build.DTYPE_CODE[k.dtype],
                           build.current_stream(k.device))
    build.raise_on(lib, "la_bwd", "la_bwd_q", err)
    launches["la_bwd_q"] += 1
    return dq


def la_bwd_kv_cuda(q, k, v, om_hat, h_vec, a: float, b: float):
    """Launch `la_bwd_kv`: (dk, dv), each (B, Hkv, N, D) in its input's
    dtype."""
    build.check_tensors("la_bwd_kv", {"q": q, "k": k, "v": v,
                                      "om_hat": om_hat, "h": h_vec},
                        ("q", "k", "v"), ("om_hat", "h"))
    bsz, h, hkv, n, d = _dims(q, k, v)
    if tuple(om_hat.shape) != tuple(q.shape) \
            or tuple(h_vec.shape) != (bsz, h, n):
        raise ValueError(f"om_hat {tuple(om_hat.shape)} / h "
                         f"{tuple(h_vec.shape)} do not match q "
                         f"{tuple(q.shape)}")
    lib = build.bind("la_bwd", _BWD_SYMBOLS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.la_bwd_kv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            om_hat.data_ptr(), h_vec.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), bsz, h, hkv, n, d,
                            LA_STAGE_TOKENS, float(a), float(b),
                            build.DTYPE_CODE[q.dtype],
                            build.current_stream(q.device))
    build.raise_on(lib, "la_bwd", "la_bwd_kv", err)
    launches["la_bwd_kv"] += 1
    return dk, dv


def la_bwd_cuda(q, k, v, o, g, omega, a: float, b: float):
    """The analytic backward through both kernels: (dq, dk, dv)."""
    om_hat, h_vec = _chunked.la_bwd_prep(o, g, omega)
    dq = la_bwd_q_cuda(k, v, om_hat, h_vec, b)
    dk, dv = la_bwd_kv_cuda(q, k, v, om_hat, h_vec, a, b)
    return dq, dk, dv
