"""Causal flash attention, forward and recomputation backward, on Hopper.

Port of `repro/kernels/flash_attention.py` (`flash_attention_pallas`,
`flash_attention_bwd_pallas`): the softmax baseline's kernels.  Four
hand-written CUDA kernels, each launched by a wrapper on the current
stream, and beside each its plain PyTorch version:

  kernel           wrapper                             plain version
  flash_fwd        flash_fwd_cuda(q, k, v, q_offset,   flash_fwd_torch
                   return_lse) -> (o, lse | None)
  flash_bwd_delta  flash_bwd_delta_cuda(o, do)         flash_bwd_delta_torch
                   -> delta
  flash_bwd_q      flash_bwd_q_cuda(q, k, v, do, lse,  flash_bwd_q_torch
                   delta) -> dq
  flash_bwd_kv     flash_bwd_kv_cuda(q, k, v, do, lse, flash_bwd_kv_torch
                   delta) -> (dk, dv)

`flash_bwd_cuda(q, k, v, o, lse, do) -> (dq, dk, dv)` launches the three
backward kernels; `flash_bwd_torch` is the whole plain backward.  The
plain forward is `core.softmax.softmax_chunked` with the logsumexp; the
plain backward is a chunked recomputation (delta, then dq over KV chunks
at or below the diagonal, then dk/dv with the group's query heads folded
in) that never holds an (N, N) score matrix.  Sources: csrc/flash_fwd.cu
and csrc/flash_bwd.cu; their headers say what bounds each kernel and how
it is laid out.

Shapes: q (B, H, Nq, D), k and v (B, Hkv, Nk, D) with Hkv | H, float32
or bfloat16, D in `HEAD_DIMS`; lse and delta (B, H, Nq) float32;
q_offset (B,) int32 or None (the training convention, query i at
position i + Nk - Nq).  The backward is the training convention only
(Nq = Nk).  The wrappers take contiguous CUDA tensors only and raise on
anything else; nothing falls back to the plain version.

Beside each wrapper, `plan_<entry>` gives the entry's launch plan
(kernels/plan.py) from the same arguments' shapes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.softmax import softmax_chunked
from repro_torch.kernels import build, plan
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK, \
    FLASH_BLOCK_K, FLASH_BLOCK_Q

F32 = torch.float32
# head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_q": 0,
            "flash_bwd_kv": 0}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def flash_fwd_torch(q, k, v, q_offset: Optional[torch.Tensor] = None,
                    chunk: int = DEFAULT_SCAN_CHUNK):
    """Plain forward: (o, lse) of the chunked online softmax."""
    return softmax_chunked(q, k, v, causal=True, chunk=chunk,
                           q_offset=q_offset, return_lse=True)


def flash_bwd_delta_torch(o, do):
    """delta = Σ_d dO·O per row, f32 (B, H, N)."""
    return (do.float() * o.float()).sum(-1)


def _grouped(q, k, lse, delta, do):
    b, h, n, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    return (q.reshape(b, hkv, g, n, d).float(),
            do.reshape(b, hkv, g, n, d).float(),
            lse.reshape(b, hkv, g, n), delta.reshape(b, hkv, g, n))


def _p_ds(qc, kc, vc, doc, lse_c, delta_c, i0, j0, scale):
    """P = exp(s - lse) under the causal mask and dS = P (dO Vᵀ - delta)
    for query rows from i0 and keys from j0: (B, Hkv, G, ci, cj) f32."""
    s = scale * torch.einsum("bhgid,bhjd->bhgij", qc, kc)
    ii = i0 + torch.arange(qc.shape[3], device=qc.device)[:, None]
    jj = j0 + torch.arange(kc.shape[2], device=qc.device)[None, :]
    p = torch.where(ii >= jj, torch.exp(s - lse_c[..., None]),
                    torch.zeros((), dtype=F32, device=qc.device))
    dp = torch.einsum("bhgid,bhjd->bhgij", doc, vc)
    return p, p * (dp - delta_c[..., None])


def flash_bwd_q_torch(q, k, v, do, lse, delta,
                      chunk: int = DEFAULT_SCAN_CHUNK):
    """dq (B, H, N, D) in q.dtype: each query chunk walks the KV chunks at
    or below its diagonal."""
    b, h, n, d = q.shape
    scale = 1.0 / d ** 0.5
    qg, dog, lse_g, delta_g = _grouped(q, k, lse, delta, do)
    c = max(1, min(chunk, n))
    dq = torch.zeros_like(qg)
    for i0 in range(0, n, c):
        i1 = min(i0 + c, n)
        for j0 in range(0, i1, c):
            kc = k[:, :, j0:j0 + c].float()
            _, ds = _p_ds(qg[:, :, :, i0:i1], kc, v[:, :, j0:j0 + c].float(),
                          dog[:, :, :, i0:i1], lse_g[..., i0:i1],
                          delta_g[..., i0:i1], i0, j0, scale)
            dq[:, :, :, i0:i1] += torch.einsum("bhgij,bhjd->bhgid", ds, kc)
    return (scale * dq).reshape(b, h, n, d).to(q.dtype)


def flash_bwd_kv_torch(q, k, v, do, lse, delta,
                       chunk: int = DEFAULT_SCAN_CHUNK):
    """(dk, dv), each (B, Hkv, N, D) in its input's dtype: each KV chunk
    walks the query chunks at or below its diagonal, the group's query
    heads summed in (the grads land on the unexpanded KV heads)."""
    b, h, n, d = q.shape
    scale = 1.0 / d ** 0.5
    qg, dog, lse_g, delta_g = _grouped(q, k, lse, delta, do)
    c = max(1, min(chunk, n))
    dk = torch.zeros(k.shape, dtype=F32, device=k.device)
    dv = torch.zeros(v.shape, dtype=F32, device=v.device)
    for j0 in range(0, n, c):
        kc, vc = k[:, :, j0:j0 + c].float(), v[:, :, j0:j0 + c].float()
        for i0 in range(j0, n, c):
            i1 = min(i0 + c, n)
            p, ds = _p_ds(qg[:, :, :, i0:i1], kc, vc, dog[:, :, :, i0:i1],
                          lse_g[..., i0:i1], delta_g[..., i0:i1], i0, j0,
                          scale)
            dv[:, :, j0:j0 + c] += torch.einsum("bhgij,bhgid->bhjd", p,
                                                dog[:, :, :, i0:i1])
            dk[:, :, j0:j0 + c] += torch.einsum("bhgij,bhgid->bhjd", ds,
                                                qg[:, :, :, i0:i1])
    return (scale * dk).to(k.dtype), dv.to(v.dtype)


def flash_bwd_torch(q, k, v, o, lse, do, chunk: int = DEFAULT_SCAN_CHUNK):
    """The plain recomputation backward: (dq, dk, dv)."""
    delta = flash_bwd_delta_torch(o, do)
    dq = flash_bwd_q_torch(q, k, v, do, lse, delta, chunk)
    dk, dv = flash_bwd_kv_torch(q, k, v, do, lse, delta, chunk)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _dims(q, k, v, same_len: bool = False):
    """(B, H, Hkv, Nq, Nk, D) of a (q, k, v) triple, raising on shapes the
    kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, h, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (bsz, hkv, nk, d) or tuple(v.shape) != (bsz, hkv,
                                                                nk, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (Dk = Dv = D)")
    if h % hkv != 0:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if same_len and nq != nk:
        raise ValueError(f"the flash backward is the training convention "
                         f"(Nq = Nk); got Nq={nq}, Nk={nk}")
    return bsz, h, hkv, nq, nk, d


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SYMBOLS = {"flash_fwd": [_P] * 6 + [_I] * 8 + [_F, _I, _P]}
_BWD_SYMBOLS = {"flash_bwd_delta": [_P] * 3 + [_I] * 5 + [_P],
                "flash_bwd_q": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
                "flash_bwd_kv": [_P] * 8 + [_I] * 7 + [_F, _I, _P]}


def flash_fwd_cuda(q, k, v, q_offset: Optional[torch.Tensor] = None,
                   return_lse: bool = True):
    """Launch `flash_fwd`: returns (o in q.dtype, lse f32 or None)."""
    named = {"q": q, "k": k, "v": v}
    if q_offset is not None:
        named["q_offset"] = q_offset
    build.check_tensors("flash_fwd", named, ("q", "k", "v"),
                        i32=("q_offset",) if q_offset is not None else ())
    bsz, h, hkv, nq, nk, d = _dims(q, k, v)
    if q_offset is not None and tuple(q_offset.shape) != (bsz,):
        raise ValueError(f"q_offset {tuple(q_offset.shape)} is not "
                         f"({bsz},)")
    lib = build.bind("flash_fwd", _FWD_SYMBOLS)
    o = torch.empty_like(q)
    lse = torch.empty((bsz, h, nq), dtype=F32, device=q.device) \
        if return_lse else None
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            q_offset.data_ptr() if q_offset is not None else None,
            bsz, h, hkv, nq, nk, d, FLASH_BLOCK_Q, FLASH_BLOCK_K,
            1.0 / d ** 0.5, build.DTYPE_CODE[q.dtype],
            build.current_stream(q.device))
    build.raise_on(lib, "flash_fwd", "flash_fwd", err)
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd_delta_cuda(o, do):
    """Launch `flash_bwd_delta`: delta (B, H, N) f32."""
    build.check_tensors("flash_bwd_delta", {"o": o, "do": do}, ("o", "do"))
    if o.dim() != 4 or do.shape != o.shape or o.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)}: "
                         f"need equal (B, H, N, D) with D in {HEAD_DIMS}")
    bsz, h, n, d = o.shape
    lib = build.bind("flash_bwd", _BWD_SYMBOLS)
    delta = torch.empty((bsz, h, n), dtype=F32, device=o.device)
    with torch.cuda.device(o.device):
        err = lib.flash_bwd_delta(o.data_ptr(), do.data_ptr(),
                                  delta.data_ptr(), bsz, h, n, d,
                                  build.DTYPE_CODE[o.dtype],
                                  build.current_stream(o.device))
    build.raise_on(lib, "flash_bwd", "flash_bwd_delta", err)
    launches["flash_bwd_delta"] += 1
    return delta


def _check_bwd(kernel, q, k, v, do, lse, delta):
    build.check_tensors(kernel, {"q": q, "k": k, "v": v, "do": do,
                                 "lse": lse, "delta": delta},
                        ("q", "k", "v", "do"), ("lse", "delta"))
    dims = _dims(q, k, v, same_len=True)
    bsz, h, _, n, _, _ = dims
    if do.shape != q.shape or tuple(lse.shape) != (bsz, h, n) \
            or tuple(delta.shape) != (bsz, h, n):
        raise ValueError(f"do {tuple(do.shape)} / lse {tuple(lse.shape)} / "
                         f"delta {tuple(delta.shape)} do not match q "
                         f"{tuple(q.shape)}")
    return dims


def flash_bwd_q_cuda(q, k, v, do, lse, delta):
    """Launch `flash_bwd_q`: dq (B, H, N, D) in q.dtype."""
    bsz, h, hkv, n, _, d = _check_bwd("flash_bwd_q", q, k, v, do, lse, delta)
    lib = build.bind("flash_bwd", _BWD_SYMBOLS)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_q(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bsz, h, hkv, n,
            d, FLASH_BLOCK_Q, FLASH_BLOCK_K, 1.0 / d ** 0.5,
            build.DTYPE_CODE[q.dtype], build.current_stream(q.device))
    build.raise_on(lib, "flash_bwd", "flash_bwd_q", err)
    launches["flash_bwd_q"] += 1
    return dq


def flash_bwd_kv_cuda(q, k, v, do, lse, delta):
    """Launch `flash_bwd_kv`: (dk, dv), each (B, Hkv, N, D) in its input's
    dtype."""
    bsz, h, hkv, n, _, d = _check_bwd("flash_bwd_kv", q, k, v, do, lse,
                                      delta)
    lib = build.bind("flash_bwd", _BWD_SYMBOLS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_kv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bsz, h, hkv, n, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, 1.0 / d ** 0.5,
            build.DTYPE_CODE[q.dtype], build.current_stream(q.device))
    build.raise_on(lib, "flash_bwd", "flash_bwd_kv", err)
    launches["flash_bwd_kv"] += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, o, lse, do):
    """The recomputation backward through the three kernels: (dq, dk,
    dv)."""
    delta = flash_bwd_delta_cuda(o, do)
    dq = flash_bwd_q_cuda(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_kv_cuda(q, k, v, do, lse, delta)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Launch plans (kernels/plan.py)
# ---------------------------------------------------------------------------

# compiled into csrc/flash_common.cuh and flash_bwd.cu: 4 warps a block, 16
# rows a warp, 32 query columns per flash_bwd_kv sub-tile, one warp per row
# of flash_bwd_delta and 8 rows a block
_THREADS = 128
_WARP_ROWS = 16
_SUB_Q = 32
_DELTA_ROWS = 8


def _tile_smem(dtype, d: int, rows: int, p_cols: int) -> int:
    """Shared memory of `rows` staged rows of D and a per-warp tile of
    p_cols columns, each row padded by 16 bytes (`flash::kPad`)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    pad = 16 // itemsize
    return (rows * (d + pad)
            + _THREADS // 32 * _WARP_ROWS * (p_cols + pad)) * itemsize


def _scale(d: int) -> float:
    return 1.0 / d ** 0.5


def plan_flash_fwd(q, k, v, q_offset: Optional[torch.Tensor] = None,
                   return_lse: bool = True):
    """One block per (query tile, head, slot), deepest tiles first; it
    stages its Q tile and walks the KV tiles up to its causal frontier
    min(Nk, q_offset[b] + its last row + 1).  Ragged edges are masked."""
    bsz, h, hkv, nq, nk, d = _dims(q, k, v)
    if q_offset is not None and tuple(q_offset.shape) != (bsz,):
        raise ValueError(f"q_offset {tuple(q_offset.shape)} is not ({bsz},)")
    group, code = h // hkv, plan.dtype_code(q.dtype)
    q_tiles = -(-nq // FLASH_BLOCK_Q)

    def walk(blk, *q_off):
        x, hh, bi = blk
        q0 = (q_tiles - 1 - x) * FLASH_BLOCK_Q
        off = int(q_off[0][bi]) if q_off else nk - nq
        last_key = min(nk, off + min(q0 + FLASH_BLOCK_Q, nq)) - 1
        kv_tiles = 0 if last_key < 0 else last_key // FLASH_BLOCK_K + 1
        return bi, hh, q0, kv_tiles

    def q_rows(blk, *q_off):
        bi, hh, q0, _ = walk(blk, *q_off)
        return plan.box((bi, bi + 1), (hh, hh + 1),
                        (q0, q0 + FLASH_BLOCK_Q), (0, d), masked=True)

    def lse_rows(blk, *q_off):
        bi, hh, q0, _ = walk(blk, *q_off)
        return plan.box((bi, bi + 1), (hh, hh + 1),
                        (q0, q0 + FLASH_BLOCK_Q), masked=True)

    def kv_rows(blk, *q_off):
        bi, hh, _, kv_tiles = walk(blk, *q_off)
        hk = hh // group
        return plan.box((bi, bi + 1), (hk, hk + 1),
                        (0, kv_tiles * FLASH_BLOCK_K), (0, d),
                        masked=True) if kv_tiles else []

    def offset(blk, *q_off):
        return plan.box((blk[2], blk[2] + 1))

    accesses = [plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
                plan.Access("k", "in", plan.shape_of(k), q.dtype, kv_rows),
                plan.Access("v", "in", plan.shape_of(v), q.dtype, kv_rows),
                plan.Access("o", "out", plan.shape_of(q), q.dtype, q_rows)]
    if return_lse:
        accesses.append(plan.Access("lse", "out", (bsz, h, nq), F32,
                                    lse_rows))
    if q_offset is not None:
        accesses.append(plan.Access("q_offset", "in", (bsz,), plan.I32,
                                    offset))
    smem = _tile_smem(q.dtype, d, FLASH_BLOCK_Q + 2 * FLASH_BLOCK_K,
                      FLASH_BLOCK_K)
    return plan.make(
        "flash_fwd", "flash_fwd", (q_tiles, h, bsz), _THREADS, smem,
        accesses,
        (bsz, h, hkv, nq, nk, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, _scale(d),
         code), _FWD_SYMBOLS["flash_fwd"],
        (bsz, h, hkv, nq, nk, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, code),
        pointers=("q", "k", "v", "o", "lse" if return_lse else None,
                  None if q_offset is None else "q_offset"),
        gathered=() if q_offset is None else ("q_offset",))


def plan_flash_bwd_delta(o, do):
    """One warp per row of the flattened (B * H * N, D) rows, 8 rows a
    block; rows past the end return at once."""
    if o.dim() != 4 or do.shape != o.shape or o.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)}: "
                         f"need equal (B, H, N, D) with D in {HEAD_DIMS}")
    bsz, h, n, d = o.shape
    rows = bsz * h * n

    def row_block(blk):
        return plan.box((blk[0] * _DELTA_ROWS, (blk[0] + 1) * _DELTA_ROWS),
                        (0, d), masked=True)

    def delta_rows(blk):
        return plan.box((blk[0] * _DELTA_ROWS, (blk[0] + 1) * _DELTA_ROWS),
                        masked=True)

    code = plan.dtype_code(o.dtype)
    accesses = [plan.Access("o", "in", (rows, d), o.dtype, row_block),
                plan.Access("do", "in", (rows, d), o.dtype, row_block),
                plan.Access("delta", "out", (rows,), F32, delta_rows)]
    return plan.make(
        "flash_bwd_delta", "flash_bwd", (-(-rows // _DELTA_ROWS),),
        _DELTA_ROWS * 32, 0, accesses, (bsz, h, n, d, code),
        _BWD_SYMBOLS["flash_bwd_delta"],
        (bsz, h, h, n, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, code))


def plan_flash_bwd_q(q, k, v, do, lse, delta):
    """One block per (query tile, head, slot), deepest first; it walks the
    KV tiles up to its diagonal."""
    bsz, h, hkv, n, _, d = _dims(q, k, v, same_len=True)
    group, code = h // hkv, plan.dtype_code(q.dtype)
    q_tiles = -(-n // FLASH_BLOCK_Q)

    def walk(blk):
        x, hh, bi = blk
        q0 = (q_tiles - 1 - x) * FLASH_BLOCK_Q
        kv_tiles = (min(n, q0 + FLASH_BLOCK_Q) - 1) // FLASH_BLOCK_K + 1
        return bi, hh, q0, kv_tiles

    def q_rows(blk):
        bi, hh, q0, _ = walk(blk)
        return plan.box((bi, bi + 1), (hh, hh + 1),
                        (q0, q0 + FLASH_BLOCK_Q), (0, d), masked=True)

    def row_stats(blk):
        bi, hh, q0, _ = walk(blk)
        return plan.box((bi, bi + 1), (hh, hh + 1),
                        (q0, q0 + FLASH_BLOCK_Q), masked=True)

    def kv_rows(blk):
        bi, hh, _, kv_tiles = walk(blk)
        return plan.box((bi, bi + 1), (hh // group, hh // group + 1),
                        (0, kv_tiles * FLASH_BLOCK_K), (0, d), masked=True)

    accesses = [plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
                plan.Access("k", "in", plan.shape_of(k), q.dtype, kv_rows),
                plan.Access("v", "in", plan.shape_of(v), q.dtype, kv_rows),
                plan.Access("do", "in", plan.shape_of(q), q.dtype, q_rows),
                plan.Access("lse", "in", (bsz, h, n), F32, row_stats),
                plan.Access("delta", "in", (bsz, h, n), F32, row_stats),
                plan.Access("dq", "out", plan.shape_of(q), q.dtype, q_rows)]
    smem = _tile_smem(q.dtype, d, 2 * FLASH_BLOCK_Q + 2 * FLASH_BLOCK_K,
                      FLASH_BLOCK_K)
    return plan.make(
        "flash_bwd_q", "flash_bwd", (q_tiles, h, bsz), _THREADS, smem,
        accesses,
        (bsz, h, hkv, n, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, _scale(d), code),
        _BWD_SYMBOLS["flash_bwd_q"],
        (bsz, h, hkv, n, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, code))


def plan_flash_bwd_kv(q, k, v, do, lse, delta):
    """One block per (KV tile, KV head, slot); it walks every query head
    of its group and every query tile from its diagonal on."""
    bsz, h, hkv, n, _, d = _dims(q, k, v, same_len=True)
    group, code = h // hkv, plan.dtype_code(q.dtype)
    q_tiles = -(-n // FLASH_BLOCK_Q)

    def kv_rows(blk):
        kt, hk, bi = blk
        return plan.box((bi, bi + 1), (hk, hk + 1),
                        (kt * FLASH_BLOCK_K, (kt + 1) * FLASH_BLOCK_K),
                        (0, d), masked=True)

    def q_span(blk):
        kt, hk, bi = blk
        q0 = kt * FLASH_BLOCK_K // FLASH_BLOCK_Q * FLASH_BLOCK_Q
        return ((bi, bi + 1), (hk * group, (hk + 1) * group),
                (q0, q_tiles * FLASH_BLOCK_Q))

    def q_rows(blk):
        return plan.box(*q_span(blk), (0, d), masked=True)

    def row_stats(blk):
        return plan.box(*q_span(blk), masked=True)

    accesses = [plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
                plan.Access("k", "in", plan.shape_of(k), q.dtype, kv_rows),
                plan.Access("v", "in", plan.shape_of(v), q.dtype, kv_rows),
                plan.Access("do", "in", plan.shape_of(q), q.dtype, q_rows),
                plan.Access("lse", "in", (bsz, h, n), F32, row_stats),
                plan.Access("delta", "in", (bsz, h, n), F32, row_stats),
                plan.Access("dk", "out", plan.shape_of(k), q.dtype, kv_rows),
                plan.Access("dv", "out", plan.shape_of(v), q.dtype, kv_rows)]
    smem = (_tile_smem(q.dtype, d, 2 * FLASH_BLOCK_K + 2 * FLASH_BLOCK_Q,
                       _SUB_Q) + 2 * FLASH_BLOCK_Q * 4)
    return plan.make(
        "flash_bwd_kv", "flash_bwd", (-(-n // FLASH_BLOCK_K), hkv, bsz),
        _THREADS, smem, accesses,
        (bsz, h, hkv, n, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, _scale(d), code),
        _BWD_SYMBOLS["flash_bwd_kv"],
        (bsz, h, hkv, n, d, FLASH_BLOCK_Q, FLASH_BLOCK_K, code))
