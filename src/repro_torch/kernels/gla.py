"""Decay-gated (GLA) linear attention, forward and analytic backward, on
Hopper.

Port of `repro/kernels/gla.py` (`gla_fwd_pallas`, `gla_bwd_pallas`).
Three hand-written CUDA kernels, the `kGated` instantiations of the
linear-attention kernels' bodies (csrc/la_fwd.cu entry `gla_fwd`,
csrc/la_bwd.cu entries `gla_bwd_q` and `gla_bwd_kv`; in bf16 at D = 128
all three run the gated instances of the chunked wgmma bodies,
`linear_attention.la_fwd_body` and `la_bwd_body` say which),
each launched by a wrapper on the current stream, and beside each its
plain PyTorch version (the chunked scans of core/gla.py):

  kernel      wrapper                                     plain version
  gla_fwd     gla_fwd_cuda(q, k, v, ld, a, b) -> (o, g)   gla_fwd_torch
  gla_bwd_q   gla_bwd_q_cuda(k, v, ld, om_hat, h, b)      gla_bwd_q_torch
  gla_bwd_kv  gla_bwd_kv_cuda(q, k, v, ld, om_hat, h,     gla_bwd_kv_torch
              a, b) -> (dk, dV' f32)

`gla_bwd_cuda(q, k, v, ld, o, g, omega, a, b) -> (dq, dk, dv, dld)`
prepares Ω̂ and h in plain PyTorch, launches both backward kernels, and
finishes in PyTorch as the reference does (`gla_bwd_epilogue`: dv from
dV', dcl = -[v, 1]·dV' and dld its reverse cumsum); `gla_bwd_torch` is
the whole plain backward.  The kernels' headers say what bounds them and
how they are laid out.

Shapes: q (B, H, N, D), k and v (B, Hkv, N, D) with Hkv | H, float32 or
bfloat16, D in `HEAD_DIMS`; log_decay (B, Hkv, N) float32; o, dq, dk and
dv come back in their inputs' dtypes, g, dV', dld (in log_decay's
dtype), Ω̂ and h are float32.  The wrappers take contiguous CUDA tensors
only and raise on anything else; nothing falls back to the plain
version.  Beside each wrapper, `plan_<entry>` gives the entry's launch
plan (kernels/plan.py), the linear entries' plans with the decay.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import chunked as _chunked
from repro_torch.core import gla as _gla
from repro_torch.kernels import build
from repro_torch.kernels import linear_attention as _la
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK, \
    GLA_STAGE_TOKENS
from repro_torch.kernels.linear_attention import _dims

F32 = torch.float32

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"gla_fwd": 0, "gla_bwd_q": 0, "gla_bwd_kv": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def gla_fwd_torch(q, k, v, log_decay, a: float, b: float,
                  chunk: int = DEFAULT_SCAN_CHUNK):
    """Plain forward: (o, g) of the chunked scan."""
    o, g, _ = _gla.gla_fwd_chunked(q, k, v, log_decay, a, b, chunk)
    return o, g


gla_bwd_q_torch = _gla.gla_bwd_q_chunked
gla_bwd_kv_torch = _gla.gla_bwd_kv_chunked
gla_bwd_torch = _gla.gla_bwd_chunked


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check_ld(log_decay, bsz, hkv, n) -> None:
    if tuple(log_decay.shape) != (bsz, hkv, n):
        raise ValueError(f"log_decay {tuple(log_decay.shape)} does not "
                         f"match (B, Hkv, N) = {(bsz, hkv, n)}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SYMBOLS = {"gla_fwd": [_P] * 6 + [_I] * 6 + [_F] * 2 + [_I, _P]}
_BWD_SYMBOLS = {"gla_bwd_q": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
                "gla_bwd_kv": [_P] * 8 + [_I] * 6 + [_F] * 2 + [_I, _P]}


def gla_fwd_cuda(q, k, v, log_decay, a: float, b: float):
    """Launch `gla_fwd`: returns (o in q.dtype, g f32)."""
    build.check_tensors("gla_fwd", {"q": q, "k": k, "v": v,
                                    "log_decay": log_decay},
                        ("q", "k", "v"), ("log_decay",))
    bsz, h, hkv, n, d = _dims(q, k, v)
    _check_ld(log_decay, bsz, hkv, n)
    lib = build.bind("la_fwd", _FWD_SYMBOLS)
    o = torch.empty_like(q)
    g = torch.empty((bsz, h, n), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.gla_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          log_decay.data_ptr(), o.data_ptr(), g.data_ptr(),
                          bsz, h, hkv, n, d, _la.fwd_stage(q.dtype, d,
                                                           "gla_fwd"),
                          float(a), float(b), build.DTYPE_CODE[q.dtype],
                          build.current_stream(q.device))
    build.raise_on(lib, "la_fwd", "gla_fwd", err)
    launches["gla_fwd"] += 1
    return o, g


def gla_bwd_q_cuda(k, v, log_decay, om_hat, h_vec, b: float):
    """Launch `gla_bwd_q`: dq (B, H, N, D) in k.dtype from k, v, the
    f32 log decay, om_hat (B, H, N, D) and h (B, H, N)."""
    build.check_tensors("gla_bwd_q", {"k": k, "v": v,
                                      "log_decay": log_decay,
                                      "om_hat": om_hat, "h": h_vec},
                        ("k", "v"), ("log_decay", "om_hat", "h"))
    bsz, h, hkv, n, d = _dims(om_hat, k, v)
    _check_ld(log_decay, bsz, hkv, n)
    if tuple(h_vec.shape) != (bsz, h, n):
        raise ValueError(f"h {tuple(h_vec.shape)} does not match "
                         f"{(bsz, h, n)}")
    lib = build.bind("la_bwd", _BWD_SYMBOLS)
    dq = torch.empty((bsz, h, n, d), dtype=k.dtype, device=k.device)
    with torch.cuda.device(k.device):
        err = lib.gla_bwd_q(k.data_ptr(), v.data_ptr(),
                            log_decay.data_ptr(), om_hat.data_ptr(),
                            h_vec.data_ptr(), dq.data_ptr(), bsz, h, hkv, n,
                            d, _la.bwd_stage("gla_bwd_q", k.dtype, d),
                            float(b), build.DTYPE_CODE[k.dtype],
                            build.current_stream(k.device))
    build.raise_on(lib, "la_bwd", "gla_bwd_q", err)
    launches["gla_bwd_q"] += 1
    return dq


def gla_bwd_kv_cuda(q, k, v, log_decay, om_hat, h_vec, a: float,
                    b: float):
    """Launch `gla_bwd_kv`: (dk (B, Hkv, N, D) in k.dtype, dV'
    (B, Hkv, N, D+1) f32)."""
    build.check_tensors("gla_bwd_kv", {"q": q, "k": k, "v": v,
                                       "log_decay": log_decay,
                                       "om_hat": om_hat, "h": h_vec},
                        ("q", "k", "v"), ("log_decay", "om_hat", "h"))
    bsz, h, hkv, n, d = _dims(q, k, v)
    _check_ld(log_decay, bsz, hkv, n)
    if tuple(om_hat.shape) != tuple(q.shape) \
            or tuple(h_vec.shape) != (bsz, h, n):
        raise ValueError(f"om_hat {tuple(om_hat.shape)} / h "
                         f"{tuple(h_vec.shape)} do not match q "
                         f"{tuple(q.shape)}")
    lib = build.bind("la_bwd", _BWD_SYMBOLS)
    dk = torch.empty_like(k)
    dva = torch.empty((bsz, hkv, n, d + 1), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.gla_bwd_kv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             log_decay.data_ptr(), om_hat.data_ptr(),
                             h_vec.data_ptr(), dk.data_ptr(), dva.data_ptr(),
                             bsz, h, hkv, n, d,
                             _la.bwd_stage("gla_bwd_kv", q.dtype, d),
                             float(a), float(b), build.DTYPE_CODE[q.dtype],
                             build.current_stream(q.device))
    build.raise_on(lib, "la_bwd", "gla_bwd_kv", err)
    launches["gla_bwd_kv"] += 1
    return dk, dva


def gla_bwd_cuda(q, k, v, log_decay, o, g, omega, a: float, b: float):
    """The analytic gated backward through both kernels: (dq, dk, dv,
    dlog_decay)."""
    om_hat, h_vec = _chunked.la_bwd_prep(o, g, omega)
    ld = log_decay.float().contiguous()
    dq = gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, b)
    dk, dva = gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, a, b)
    dv, dld = _gla.gla_bwd_epilogue(v, dva, log_decay)
    return dq, dk, dv, dld


# ---------------------------------------------------------------------------
# Launch plans (kernels/plan.py): the linear entries' plans, gated
# ---------------------------------------------------------------------------

def plan_gla_fwd(q, k, v, log_decay, a: float, b: float):
    return _la.plan_fwd("gla_fwd", q, k, v, log_decay, a, b,
                        GLA_STAGE_TOKENS, _FWD_SYMBOLS["gla_fwd"])


def plan_gla_bwd_q(k, v, log_decay, om_hat, h_vec, b: float):
    return _la.plan_bwd_q("gla_bwd_q", k, v, log_decay, om_hat, h_vec, b,
                          GLA_STAGE_TOKENS, _BWD_SYMBOLS["gla_bwd_q"])


def plan_gla_bwd_kv(q, k, v, log_decay, om_hat, h_vec, a: float, b: float):
    return _la.plan_bwd_kv("gla_bwd_kv", q, k, v, log_decay, om_hat, h_vec,
                           a, b, GLA_STAGE_TOKENS,
                           _BWD_SYMBOLS["gla_bwd_kv"])
