"""SSD (Mamba-2) forward and analytic backward on Hopper.

Port of `repro/kernels/ssd.py` (`ssd_fwd_pallas`, `ssd_bwd_pallas`).
Three hand-written CUDA kernels (csrc/ssd.cu entries `ssd_fwd`,
`ssd_bwd_q`, `ssd_bwd_kv`), each launched by a wrapper on the current
stream, and beside each its plain PyTorch version (the chunked scans of
core/ssd.py):

  kernel      wrapper                                  plain version
  ssd_fwd     ssd_fwd_cuda(q, k, v, ld) -> o           ssd_fwd_torch
  ssd_bwd_q   ssd_bwd_q_cuda(k, v, ld, omega)          ssd_bwd_q_torch
              -> dq per-head partials f32
  ssd_bwd_kv  ssd_bwd_kv_cuda(q, k, v, ld, omega)      ssd_bwd_kv_torch
              -> (dk per-head partials f32, dv f32)

`ssd_bwd_cuda(q, k, v, ld, o, omega) -> (dq, dk, dv, dld)` launches
both backward kernels and finishes in PyTorch as the reference does
(`ssd_bwd_epilogue`: dq and dk summed over each group, dcl = Ω.o - v.dv
and dld its reverse cumsum); `ssd_bwd_torch` is the whole plain
backward.  The kernels' header says what bounds them and how they are
laid out.

Shapes: q and k (B, G, N, Dk) with G | H, shared by the H/G heads of a
group; v and omega (B, H, N, Dv); all four float32 or bfloat16 alike;
log_decay (B, H, N) float32; (Dk, Dv) one of `STATE_DIMS`.  o comes back
in v's dtype; the partials and dv in float32.  The wrappers take
contiguous CUDA tensors only and raise on anything else; nothing falls
back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ssd as _ssd
from repro_torch.kernels import build
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK, \
    SSD_STAGE_TOKENS

F32 = torch.float32
# (Dk, Dv) the kernels are instantiated for: mamba2-2.7b (state 128, head
# dim 64) and its smoke config (state 16, head dim 32)
STATE_DIMS = ((128, 64), (16, 32))

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"ssd_fwd": 0, "ssd_bwd_q": 0, "ssd_bwd_kv": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def ssd_fwd_torch(q, k, v, log_decay, chunk: int = DEFAULT_SCAN_CHUNK):
    """Plain forward: o of the chunked scan."""
    return _ssd.ssd_fwd_chunked(q, k, v, log_decay, chunk)[0]


ssd_bwd_q_torch = _ssd.ssd_bwd_q_chunked
ssd_bwd_kv_torch = _ssd.ssd_bwd_kv_chunked
ssd_bwd_torch = _ssd.ssd_bwd_chunked


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _dims(qk, v, log_decay):
    """(B, G, H, N, Dk, Dv) from q or k (B, G, N, Dk), v (B, H, N, Dv) and
    log_decay (B, H, N); raises on shapes the kernels do not take."""
    bsz, g, n, dk = qk.shape
    if v.dim() != 4 or v.shape[0] != bsz or v.shape[2] != n:
        raise ValueError(f"v {tuple(v.shape)} does not match (B, H, N, Dv) "
                         f"for q/k {tuple(qk.shape)}")
    h, dv = v.shape[1], v.shape[3]
    if h % g:
        raise ValueError(f"H={h} is not a multiple of G={g}")
    if (dk, dv) not in STATE_DIMS:
        raise ValueError(f"(Dk, Dv) = {(dk, dv)} not in {STATE_DIMS}: the "
                         f"CUDA SSD kernels are instantiated for those only")
    if tuple(log_decay.shape) != (bsz, h, n):
        raise ValueError(f"log_decay {tuple(log_decay.shape)} does not "
                         f"match (B, H, N) = {(bsz, h, n)}")
    return bsz, g, h, n, dk, dv


_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"ssd_fwd": [_P] * 5 + [_I] * 8 + [_P],
            "ssd_bwd_q": [_P] * 5 + [_I] * 8 + [_P],
            "ssd_bwd_kv": [_P] * 7 + [_I] * 8 + [_P]}


def ssd_fwd_cuda(q, k, v, log_decay):
    """Launch `ssd_fwd`: o (B, H, N, Dv) in v.dtype."""
    build.check_tensors("ssd_fwd", {"q": q, "k": k, "v": v,
                                    "log_decay": log_decay},
                        ("q", "k", "v"), ("log_decay",))
    if k.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} != q {tuple(q.shape)}")
    bsz, g, h, n, dk, dv = _dims(q, v, log_decay)
    lib = build.bind("ssd", _SYMBOLS)
    o = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.ssd_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          log_decay.data_ptr(), o.data_ptr(), bsz, h, g, n,
                          dk, dv, SSD_STAGE_TOKENS,
                          build.DTYPE_CODE[q.dtype],
                          build.current_stream(q.device))
    build.raise_on(lib, "ssd", "ssd_fwd", err)
    launches["ssd_fwd"] += 1
    return o


def ssd_bwd_q_cuda(k, v, log_decay, omega):
    """Launch `ssd_bwd_q`: per-head dq partials (B, H, N, Dk) f32."""
    build.check_tensors("ssd_bwd_q", {"k": k, "v": v,
                                      "log_decay": log_decay,
                                      "omega": omega},
                        ("k", "v", "omega"), ("log_decay",))
    if omega.shape != v.shape:
        raise ValueError(f"omega {tuple(omega.shape)} != v "
                         f"{tuple(v.shape)}")
    bsz, g, h, n, dk, dv = _dims(k, v, log_decay)
    lib = build.bind("ssd", _SYMBOLS)
    dq = torch.empty((bsz, h, n, dk), dtype=F32, device=k.device)
    with torch.cuda.device(k.device):
        err = lib.ssd_bwd_q(k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
                            omega.data_ptr(), dq.data_ptr(), bsz, h, g, n,
                            dk, dv, SSD_STAGE_TOKENS,
                            build.DTYPE_CODE[k.dtype],
                            build.current_stream(k.device))
    build.raise_on(lib, "ssd", "ssd_bwd_q", err)
    launches["ssd_bwd_q"] += 1
    return dq


def ssd_bwd_kv_cuda(q, k, v, log_decay, omega):
    """Launch `ssd_bwd_kv`: (per-head dk partials (B, H, N, Dk) f32, dv
    (B, H, N, Dv) f32)."""
    build.check_tensors("ssd_bwd_kv", {"q": q, "k": k, "v": v,
                                       "log_decay": log_decay,
                                       "omega": omega},
                        ("q", "k", "v", "omega"), ("log_decay",))
    if k.shape != q.shape or omega.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} / omega {tuple(omega.shape)} "
                         f"do not match q {tuple(q.shape)} / v "
                         f"{tuple(v.shape)}")
    bsz, g, h, n, dk, dv = _dims(q, v, log_decay)
    lib = build.bind("ssd", _SYMBOLS)
    dk_p = torch.empty((bsz, h, n, dk), dtype=F32, device=q.device)
    dv_o = torch.empty((bsz, h, n, dv), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.ssd_bwd_kv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             log_decay.data_ptr(), omega.data_ptr(),
                             dk_p.data_ptr(), dv_o.data_ptr(), bsz, h, g, n,
                             dk, dv, SSD_STAGE_TOKENS,
                             build.DTYPE_CODE[q.dtype],
                             build.current_stream(q.device))
    build.raise_on(lib, "ssd", "ssd_bwd_kv", err)
    launches["ssd_bwd_kv"] += 1
    return dk_p, dv_o


def ssd_bwd_cuda(q, k, v, log_decay, o, omega):
    """The analytic SSD backward through both kernels: (dq, dk, dv,
    dlog_decay), dq and dk group-summed."""
    ld = log_decay.float().contiguous()
    dq_p = ssd_bwd_q_cuda(k, v, ld, omega)
    dk_p, dv = ssd_bwd_kv_cuda(q, k, v, ld, omega)
    return _ssd.ssd_bwd_epilogue(q, k, v, log_decay, o, omega, dq_p, dk_p,
                                 dv)
