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

Each kernel has two bodies, chosen by `ssd_body(entry, dtype, dk, dv)`:
"wgmma" (bf16 at (Dk, Dv) = (128, 64), mamba2-2.7b's training instance,
and for `ssd_fwd` also (64, 64), zamba2-7b's Mamba-2 layers, there with
its non-input operands as hi + lo bf16 pairs: a chunked scan on the
tensor cores, `ssd_fwd`'s and `ssd_bwd_q`'s in chunk order,
`ssd_bwd_kv`'s in reverse, the backward's non-input operands as hi + lo
bf16 pairs; fed by TMA, so q, k, v and Ω must be 16-byte aligned, which
the wrappers check) and "walk" (f32, bf16 at (16, 32), and the backward's
bf16 at (64, 64): the token walk).

Beside each wrapper, `plan_<entry>` gives the entry's launch plan
(kernels/plan.py) from the same arguments' shapes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ssd as _ssd
from repro_torch.kernels import build, plan
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK, \
    SSD_BWD_KV_QO_RING, SSD_BWD_KV_WGMMA_STATE_DIMS, SSD_BWD_Q_K_RING, \
    SSD_BWD_Q_WGMMA_STATE_DIMS, SSD_CHUNK_RING, SSD_CHUNK_TOKENS, \
    SSD_FWD_PAIR_STATE_DIMS, SSD_STAGE_TOKENS, SSD_WGMMA_STATE_DIMS

F32 = torch.float32
# (Dk, Dv) the kernels are instantiated for: mamba2-2.7b (state 128, head
# dim 64), zamba2-7b's Mamba-2 layers (state 64, head dim 64) and the smoke
# configs (state 16, head dim 32)
STATE_DIMS = ((128, 64), (64, 64), (16, 32))

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"ssd_fwd": 0, "ssd_bwd_q": 0, "ssd_bwd_kv": 0}


# (Dk, Dv) at which an entry runs its wgmma body in bf16
_WGMMA_DIMS = {"ssd_fwd": SSD_WGMMA_STATE_DIMS,
               "ssd_bwd_q": SSD_BWD_Q_WGMMA_STATE_DIMS,
               "ssd_bwd_kv": SSD_BWD_KV_WGMMA_STATE_DIMS}


def ssd_body(entry: str, dtype, dk: int, dv: int) -> str:
    """The body an SSD entry runs for this compute dtype and (Dk, Dv):
    "wgmma" (`ssd_fwd` in bf16 at (Dk, Dv) in SSD_WGMMA_STATE_DIMS,
    `ssd_bwd_q` at (Dk, Dv) in SSD_BWD_Q_WGMMA_STATE_DIMS, `ssd_bwd_kv` at
    (Dk, Dv) in SSD_BWD_KV_WGMMA_STATE_DIMS: chunked scans on the tensor
    cores) or "walk" (the token walk: f32, and bf16 at the other dims)."""
    return ("wgmma" if dtype == torch.bfloat16
            and (dk, dv) in _WGMMA_DIMS.get(entry, ()) else "walk")


def _stage(entry: str, dtype, dk: int, dv: int) -> int:
    """The `stage` argument of an entry's C call: the wgmma body's chunk,
    or the tokens the walk stages per iteration."""
    return (SSD_CHUNK_TOKENS if ssd_body(entry, dtype, dk, dv) == "wgmma"
            else SSD_STAGE_TOKENS)


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
                          dk, dv, _stage("ssd_fwd", q.dtype, dk, dv),
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
                            dk, dv, _stage("ssd_bwd_q", k.dtype, dk, dv),
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
                             dk, dv, _stage("ssd_bwd_kv", q.dtype, dk, dv),
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


# ---------------------------------------------------------------------------
# Launch plans (kernels/plan.py)
# ---------------------------------------------------------------------------

# (column groups, row groups) of csrc/ssd.cu's register tilings `Tiles<Dk, Dv>`
_TILINGS = {(128, 64): (8, 4), (64, 64): (8, 8), (16, 32): (4, 8)}


# the wgmma body: one warpgroup; beside the tiles the barriers and the pad
# to their 1024-byte alignment
_WGMMA_THREADS = 128
_WGMMA_EXTRA = 2048


def _wgmma_block(entry, dk, dv):
    """(threads, dynamic shared memory) of an entry's wgmma body block.
    `ssd_fwd`, as csrc/ssd.cu's `sc::Layout<Dk, pairs>::kSmem`:
    SSD_CHUNK_RING chunks of bf16 q, k (Dk wide) and v (Dv wide), the bf16
    (w v) tile of a chunk and the bf16 copy of S^T (Dv x Dk), each twice
    (hi, lo) at SSD_FWD_PAIR_STATE_DIMS, and the barriers and pad.  `ssd_bwd_q`, as
    `sq::kSmem`: the hi and lo bf16 copies of S^T, SSD_BWD_Q_K_RING chunks
    of k, one of v and Ω, the hi and lo (w v) tiles, and the barriers and
    pad.  `ssd_bwd_kv`, as `sk::kSmem`: the hi and lo bf16 copies of U^T
    (Dv x Dk), SSD_BWD_KV_QO_RING chunks of q and Ω, one of k and v, and
    the barriers and pad."""
    c = SSD_CHUNK_TOKENS
    if entry == "ssd_bwd_q":
        return _WGMMA_THREADS, (2 * 2 * dv * dk + SSD_BWD_Q_K_RING * 2 * c
                                * dk + 2 * 2 * c * dv + 2 * 2 * c * dv
                                + _WGMMA_EXTRA)
    if entry == "ssd_bwd_kv":
        pair = 2 * (c * dk + c * dv)   # q and Ω, or k and v, of a chunk
        return _WGMMA_THREADS, (2 * 2 * dv * dk + SSD_BWD_KV_QO_RING * pair
                                + pair + _WGMMA_EXTRA)
    stage = 2 * (2 * c * dk + c * dv)
    copies = 2 if (dk, dv) in SSD_FWD_PAIR_STATE_DIMS else 1
    return _WGMMA_THREADS, (SSD_CHUNK_RING * stage
                            + copies * (2 * c * dv + 2 * dv * dk)
                            + _WGMMA_EXTRA)


def _block(entry, dk, dv):
    """(threads, staged floats per token) of an entry's token-walk block at
    (Dk, Dv), as csrc/ssd.cu's `Block<K, Dk, Dv>`: column tiles of
    Dk / col_groups rows (the forward, dv), row tiles of Dv / row_groups
    columns (dq, dk); staged rows padded by 4 floats after every
    tile-wide slice."""
    col_groups, row_groups = _TILINGS[(dk, dv)]
    col_threads, row_threads = dv // 4 * col_groups, dk // 4 * row_groups
    pad_k = dk + 4 * col_groups
    pad_v = dv + 4 * row_groups
    if entry == "ssd_fwd":
        return col_threads, 2 * pad_k + pad_v + dv + 1
    if entry == "ssd_bwd_q":
        return row_threads, pad_k + 2 * pad_v + dk + 1
    return row_threads + col_threads, 2 * pad_k + 2 * pad_v + dk + dv + 1


def _plan(entry, q, k, v, log_decay, omega):
    """One block per (batch, head), walking all N tokens of its head and of
    its group's q and k (the forward and dq forwards, dk and dv in
    reverse; the wgmma bodies by chunks, TMA zero-filling the rows of the
    last chunk past N, so they read and write nothing past N either)."""
    bsz, g, h, n, dk, dv = _dims(k, v, log_decay)
    if (q is not None and q.shape != k.shape) \
            or (omega is not None and omega.shape != v.shape):
        raise ValueError(f"q / k / omega / v shapes do not match: "
                         f"{None if q is None else tuple(q.shape)}, "
                         f"{tuple(k.shape)}, "
                         f"{None if omega is None else tuple(omega.shape)}, "
                         f"{tuple(v.shape)}")
    code = plan.dtype_code(k.dtype)
    arg = _stage(entry, k.dtype, dk, dv)
    if ssd_body(entry, k.dtype, dk, dv) == "wgmma":
        (threads, smem), stage = _wgmma_block(entry, dk, dv), arg
    else:
        threads, per_token = _block(entry, dk, dv)
        stage, smem = plan.fit(arg, per_token * 4)

    def head(blk):
        bi, hi = divmod(blk[0], h)
        return bi, hi, hi // (h // g)

    def qk_rows(blk):
        bi, _, grp = head(blk)
        return plan.box((bi, bi + 1), (grp, grp + 1), (0, n), (0, dk))

    def head_rows(width):
        def tile(blk):
            bi, hi, _ = head(blk)
            return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (0, width))
        return tile

    def ld_row(blk):
        bi, hi, _ = head(blk)
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n))

    qk_shape, v_shape = plan.shape_of(k), plan.shape_of(v)
    accesses = []
    if q is not None:
        accesses.append(plan.Access("q", "in", qk_shape, k.dtype, qk_rows))
    accesses += [plan.Access("k", "in", qk_shape, k.dtype, qk_rows),
                 plan.Access("v", "in", v_shape, k.dtype, head_rows(dv)),
                 plan.Access("log_decay", "in", (bsz, h, n), F32, ld_row)]
    if omega is not None:
        accesses.append(plan.Access("omega", "in", v_shape, k.dtype,
                                    head_rows(dv)))
    partials = (bsz, h, n, dk)
    accesses += {
        "ssd_fwd": [plan.Access("o", "out", v_shape, k.dtype,
                                head_rows(dv))],
        "ssd_bwd_q": [plan.Access("dq", "out", partials, F32,
                                  head_rows(dk))],
        "ssd_bwd_kv": [plan.Access("dk", "out", partials, F32,
                                   head_rows(dk)),
                       plan.Access("dv", "out", v_shape, F32,
                                   head_rows(dv))]}[entry]
    return plan.make(entry, "ssd", (bsz * h,), threads, smem, accesses,
                     (bsz, h, g, n, dk, dv, arg, code), _SYMBOLS[entry],
                     (bsz, h, g, n, dk, dv, arg, code), stage=stage)


def plan_ssd_fwd(q, k, v, log_decay):
    return _plan("ssd_fwd", q, k, v, log_decay, None)


def plan_ssd_bwd_q(k, v, log_decay, omega):
    return _plan("ssd_bwd_q", None, k, v, log_decay, omega)


def plan_ssd_bwd_kv(q, k, v, log_decay, omega):
    return _plan("ssd_bwd_kv", q, k, v, log_decay, omega)
