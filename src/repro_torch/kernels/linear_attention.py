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

Each kernel has two bodies, chosen by `la_fwd_body(dtype, d, entry)` and
`la_bwd_body(entry, dtype, d)`: "wgmma" (bf16 at D = 128, the paper's
training instance: chunked scans on the tensor cores fed by TMA, so
their operands must be 16-byte aligned, which the wrappers check;
`la_fwd` two blocks per head by halves of the value columns, `la_bwd_q`
two by halves of dq's columns, `la_bwd_kv` four per KV head, by halves
of dk's and of dv's columns; `gla_fwd`, `gla_bwd_q` and `gla_bwd_kv`
run the gated instances of the forward's, the dq and the dk/dv body) and
"walk" (f32, and bf16 at D < 128: the token walk).

Shapes: q (B, H, N, D), k and v (B, Hkv, N, D) with Hkv | H, float32 or
bfloat16, D in `HEAD_DIMS`; o, dq, dk and dv come back in their
inputs' dtypes, g, Ω̂ and h are float32.  The wrappers take contiguous
CUDA tensors only and raise on anything else; nothing falls back to the
plain version.

Beside each wrapper, `plan_<entry>` gives the entry's launch plan
(kernels/plan.py) from the same arguments' shapes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import chunked as _chunked
from repro_torch.kernels import build, plan
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK, \
    GLA_BWD_KV_WGMMA_HEAD_DIMS, GLA_BWD_Q_WGMMA_HEAD_DIMS, \
    GLA_STAGE_TOKENS, GLA_WGMMA_HEAD_DIMS, \
    LA_BWD_KV_SPLIT, LA_BWD_Q_SPLIT, LA_BWD_RING, LA_BWD_WGMMA_HEAD_DIMS, \
    LA_CHUNK_RING, LA_CHUNK_TOKENS, LA_STAGE_TOKENS, LA_WGMMA_HEAD_DIMS, \
    LA_WGMMA_SPLIT

F32 = torch.float32
# head dims the kernels are instantiated for (a state row in registers)
HEAD_DIMS = (32, 64, 128)

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"la_fwd": 0, "la_bwd_q": 0, "la_bwd_kv": 0}


def la_fwd_body(dtype, d: int, entry: str = "la_fwd") -> str:
    """The body forward entry `entry` ("la_fwd" or "gla_fwd") runs for
    this compute dtype and head dim: "wgmma" (bf16 at D in
    LA_WGMMA_HEAD_DIMS, or for `gla_fwd` GLA_WGMMA_HEAD_DIMS: the gated
    instance) or "walk"."""
    dims = GLA_WGMMA_HEAD_DIMS if entry == "gla_fwd" else LA_WGMMA_HEAD_DIMS
    return "wgmma" if dtype == torch.bfloat16 and d in dims else "walk"


# the head dims of each backward entry's "wgmma" body
_BWD_WGMMA_HEAD_DIMS = {"la_bwd_q": LA_BWD_WGMMA_HEAD_DIMS,
                        "la_bwd_kv": LA_BWD_WGMMA_HEAD_DIMS,
                        "gla_bwd_q": GLA_BWD_Q_WGMMA_HEAD_DIMS,
                        "gla_bwd_kv": GLA_BWD_KV_WGMMA_HEAD_DIMS}


def la_bwd_body(entry: str, dtype, d: int) -> str:
    """The body backward entry `entry` runs for this compute dtype and head
    dim: "wgmma" (`la_bwd_q` and `la_bwd_kv` in bf16 at D in
    LA_BWD_WGMMA_HEAD_DIMS, `gla_bwd_q` at D in GLA_BWD_Q_WGMMA_HEAD_DIMS
    and `gla_bwd_kv` at D in GLA_BWD_KV_WGMMA_HEAD_DIMS: the gated
    instances) or "walk"."""
    return ("wgmma" if dtype == torch.bfloat16
            and d in _BWD_WGMMA_HEAD_DIMS.get(entry, ()) else "walk")


def _walk_stage(entry: str) -> int:
    """The tokens a token walk stages per iteration."""
    return GLA_STAGE_TOKENS if entry.startswith("gla_") else LA_STAGE_TOKENS


def fwd_stage(dtype, d: int, entry: str = "la_fwd") -> int:
    """The `stage` argument of a forward entry's C call: the wgmma body's
    chunk, or the tokens the walk stages per iteration."""
    return (LA_CHUNK_TOKENS if la_fwd_body(dtype, d, entry) == "wgmma"
            else _walk_stage(entry))


def bwd_stage(entry: str, dtype, d: int) -> int:
    """The `stage` argument of a backward entry's C call, as
    `fwd_stage`."""
    return (LA_CHUNK_TOKENS if la_bwd_body(entry, dtype, d) == "wgmma"
            else _walk_stage(entry))


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
                         fwd_stage(q.dtype, d), float(a), float(b),
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
                           d, bwd_stage("la_bwd_q", k.dtype, d), float(b),
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
                            bwd_stage("la_bwd_kv", q.dtype, d), float(a),
                            float(b),
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


# ---------------------------------------------------------------------------
# Launch plans (kernels/plan.py), shared with the gated entries (gla.py)
# ---------------------------------------------------------------------------

def _padded(d: int) -> int:
    """Floats of one staged row: D in 4 row groups, each followed by 4
    floats of padding (`Rows<D>::kPadded`)."""
    return d + 16


# the wgmma body: one warpgroup; beside the tiles and sums the barriers and
# the pad to their 1024-byte alignment
_WGMMA_THREADS = 128
_WGMMA_EXTRA = 2048


def _wgmma_smem(d: int, gated: bool = False) -> int:
    """Dynamic shared memory of the forward's wgmma block, as
    csrc/la_fwd.cu's `lc::Layout<gated>::kSmem`: LA_CHUNK_RING chunks of
    bf16 q, k (D wide) and the block's share of v, the bf16 copy of S^T
    (its value columns x D; gated, its hi + lo pair and the hi and lo
    (w o v) tiles), z and P twice in f32, and the barriers and pad."""
    c, part = LA_CHUNK_TOKENS, d // LA_WGMMA_SPLIT
    return (LA_CHUNK_RING * 2 * (2 * c * d + c * part) + 2 * part * d
            + (2 * part * d + 2 * 2 * c * part if gated else 0)
            + 2 * 4 * (d + part) + _WGMMA_EXTRA)


def _bwd_q_smem(d: int, gated: bool = False) -> int:
    """Dynamic shared memory of the dq wgmma block, as csrc/la_bwd.cu's
    `bq::Layout<gated>::kSmem`: LA_BWD_RING chunks of the block's half of
    k and of v in bf16 and of Ω̂ in f32, Ω̂'s hi and lo bf16 tiles, the hi
    and lo copies of the block's half of A = Σ k^T v, gated the hi and lo
    (w o v) tiles, z twice and h in f32, and the barriers and pad."""
    c, half = LA_CHUNK_TOKENS, d // LA_BWD_Q_SPLIT
    return (LA_BWD_RING * (2 * c * half + 2 * c * d + 4 * c * d)
            + 2 * 2 * c * d + 2 * 2 * half * d
            + (2 * 2 * c * d if gated else 0) + 2 * 4 * half + 4 * c
            + _WGMMA_EXTRA)


def _bwd_kv_smem(d: int, gated: bool = False) -> int:
    """Dynamic shared memory of the dk/dv wgmma block, as
    `bkv::Layout<gated>::kSmem`: LA_BWD_RING steps of a bf16 k or v tile,
    a bf16 q tile and an f32 Ω̂ tile, Ω̂'s hi and lo bf16 tiles, the hi and
    lo copies of the block's slice of U = Σ q^T Ω̂, its f32 sums twice, h,
    gated the sums of dV''s augmented column (u_h over D and Σ h, twice,
    in 16-byte rows) and the step's token weights 2^cl and 2^cl h, and
    the barriers and pad."""
    c, half = LA_CHUNK_TOKENS, d // (LA_BWD_KV_SPLIT // 2)
    return (LA_BWD_RING * (2 * c * d + 2 * c * d + 4 * c * d)
            + 2 * 2 * c * d + 2 * 2 * half * d + 2 * 4 * half + 4 * c
            + (2 * 4 * d + 16 + 2 * 4 * c if gated else 0) + _WGMMA_EXTRA)


def plan_fwd(entry, q, k, v, log_decay, a, b, stage_tokens, argtypes):
    """la_fwd (log_decay None) or gla_fwd: the token walk's one block per
    (batch, query head) walking all N tokens of its query head and of its
    KV head; the wgmma body LA_WGMMA_SPLIT such blocks, each with its
    share of the value columns (of v and o; the first writes g), walking
    chunks (TMA zero-fills the rows of the last chunk past N; gated, each
    block reads its KV head's log decays)."""
    bsz, h, hkv, n, d = _dims(q, k, v)
    group, gated = h // hkv, log_decay is not None
    code = plan.dtype_code(q.dtype)
    split, threads = 1, d + 32
    if la_fwd_body(q.dtype, d, entry) == "wgmma":
        stage_tokens = stage = LA_CHUNK_TOKENS
        split, threads, smem = LA_WGMMA_SPLIT, _WGMMA_THREADS, \
            _wgmma_smem(d, gated)
    else:
        # the staging's floats per token: q, k and v padded, f, and the
        # decay
        stage, smem = plan.fit(
            stage_tokens, (3 * _padded(d) + d + 1 + int(gated)) * 4)
    part = d // split

    def head(blk):
        bi, hi = divmod(blk[0], h)
        return bi, hi, hi // group

    def q_rows(blk):
        bi, hi, _ = head(blk)
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (0, d))

    def kv_rows(blk):
        bi, _, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n), (0, d))

    def v_part(blk):
        bi, _, hk = head(blk)
        lo = blk[1] * part
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n), (lo, lo + part))

    def o_part(blk):
        bi, hi, _ = head(blk)
        lo = blk[1] * part
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (lo, lo + part))

    def ld_row(blk):
        bi, _, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n))

    def g_row(blk):
        bi, hi, _ = head(blk)
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n if blk[1] == 0
                                                       else 0))

    accesses = [plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
                plan.Access("k", "in", plan.shape_of(k), q.dtype, kv_rows),
                plan.Access("v", "in", plan.shape_of(v), q.dtype, v_part)]
    if gated:
        accesses.append(plan.Access("log_decay", "in", (bsz, hkv, n), F32,
                                    ld_row))
    accesses += [plan.Access("o", "out", plan.shape_of(q), q.dtype, o_part),
                 plan.Access("g", "out", (bsz, h, n), F32, g_row)]
    return plan.make(entry, "la_fwd", (bsz * h, split), threads, smem,
                     accesses,
                     (bsz, h, hkv, n, d, stage_tokens, float(a), float(b),
                      code), argtypes,
                     (bsz, h, hkv, n, d, stage_tokens, code), stage=stage)


def plan_bwd_q(entry, k, v, log_decay, om_hat, h_vec, b, stage_tokens,
               argtypes):
    """la_bwd_q (log_decay None) or gla_bwd_q: the token walk's one block
    per (batch, query head), the forward scan over all N tokens; the
    wgmma body (gla_bwd_q its gated instance) LA_BWD_Q_SPLIT such
    blocks, each with its share of dq's columns (and of k's), walking
    chunks (TMA zero-fills the rows of the last chunk past N)."""
    bsz, h, hkv, n, d = _dims(om_hat, k, v)
    group, gated = h // hkv, log_decay is not None
    code = plan.dtype_code(k.dtype)
    split, threads = 1, d
    if la_bwd_body(entry, k.dtype, d) == "wgmma":
        stage_tokens = stage = LA_CHUNK_TOKENS
        split, threads, smem = LA_BWD_Q_SPLIT, _WGMMA_THREADS, \
            _bwd_q_smem(d, gated)
    else:
        # k, v and Ω̂ padded, h, and the decay
        stage, smem = plan.fit(stage_tokens,
                               (3 * _padded(d) + 1 + int(gated)) * 4)
    part = d // split

    def head(blk):
        bi, hi = divmod(blk[0], h)
        return bi, hi, hi // group

    def q_rows(blk):
        bi, hi, _ = head(blk)
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (0, d))

    def q_part(blk):
        bi, hi, _ = head(blk)
        lo = blk[1] * part
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (lo, lo + part))

    def kv_rows(blk):
        bi, _, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n), (0, d))

    def k_part(blk):
        bi, _, hk = head(blk)
        lo = blk[1] * part
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n), (lo, lo + part))

    def ld_row(blk):
        bi, _, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n))

    def h_row(blk):
        bi, hi, _ = head(blk)
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n))

    accesses = [plan.Access("k", "in", plan.shape_of(k), k.dtype, k_part),
                plan.Access("v", "in", plan.shape_of(v), k.dtype, kv_rows)]
    if gated:
        accesses.append(plan.Access("log_decay", "in", (bsz, hkv, n), F32,
                                    ld_row))
    accesses += [
        plan.Access("om_hat", "in", (bsz, h, n, d), F32, q_rows),
        plan.Access("h_vec", "in", (bsz, h, n), F32, h_row),
        plan.Access("dq", "out", (bsz, h, n, d), k.dtype, q_part)]
    return plan.make(entry, "la_bwd", (bsz * h, split), threads, smem,
                     accesses,
                     (bsz, h, hkv, n, d, stage_tokens, float(b), code),
                     argtypes, (bsz, h, hkv, n, d, stage_tokens, code),
                     stage=stage)


def plan_bwd_kv(entry, q, k, v, log_decay, om_hat, h_vec, a, b,
                stage_tokens, argtypes):
    """la_bwd_kv (log_decay None) or gla_bwd_kv: the token walk's one
    block per (batch, KV head), the reverse scan over all N tokens of its
    G query heads (its staging grows with G, so large groups stage fewer
    tokens); the wgmma body LA_BWD_KV_SPLIT blocks per (batch, KV head):
    y = 0, 1 write dk's column half y from v, their half of q, Ω̂ and h;
    y = 2, 3 dv's half y - 2 from k, q and their half of Ω̂ (gated: dV''s
    columns of that half, from h too, and y = 2 also its column D), each
    walking the group's chunks from the last."""
    bsz, h, hkv, n, d = _dims(q, k, v)
    group, gated = h // hkv, log_decay is not None
    code = plan.dtype_code(q.dtype)
    wgmma = la_bwd_body(entry, q.dtype, d) == "wgmma"
    if wgmma:
        stage_tokens = stage = LA_CHUNK_TOKENS
        split, threads, smem = LA_BWD_KV_SPLIT, _WGMMA_THREADS, \
            _bwd_kv_smem(d, gated)
    else:
        # q and Ω̂ of the G query heads, k and v, padded; h of the G heads;
        # gated: the decay, the row warps' shares of k.U[:Dk, Dv] and
        # U[Dk, Dv]
        stage, smem = plan.fit(
            stage_tokens, ((2 * group + 2) * _padded(d) + group
                           + (d // 32 + 2 if gated else 0)) * 4)
        split, threads = 1, 2 * d
    half = d // (LA_BWD_KV_SPLIT // 2)   # dk's halves, then dv's

    def part(blk):
        """The block's roles and the columns of its half: the walk's one
        block does both, over all D columns."""
        if not wgmma:
            return ("dk", "dv"), (0, d)
        lo = (blk[1] % 2) * half
        return ("dk",) if blk[1] < 2 else ("dv",), (lo, lo + half)

    def operand(grouped, role=None, halved=None, width=d):
        """Tiles of an operand over the block's query group (grouped) or
        KV head: rows [0, N) where `role` is None or one of the block's
        roles, else none; of `width` columns (None: a 3-D operand), the
        block's half where `halved` is one of its roles."""
        def tile(blk):
            bi, hk = divmod(blk[0], hkv)
            roles, cols = part(blk)
            ranges = [(bi, bi + 1), (hk * group, (hk + 1) * group)
                      if grouped else (hk, hk + 1),
                      (0, n) if role is None or role in roles else (0, 0)]
            if width is not None:
                ranges.append(cols if halved in roles else (0, width))
            return plan.box(*ranges)
        return tile

    accesses = [
        plan.Access("q", "in", plan.shape_of(q), q.dtype,
                    operand(True, halved="dk")),
        plan.Access("k", "in", plan.shape_of(k), q.dtype,
                    operand(False, "dv")),
        plan.Access("v", "in", plan.shape_of(v), q.dtype,
                    operand(False, "dk"))]
    if gated:
        accesses.append(plan.Access("log_decay", "in", (bsz, hkv, n), F32,
                                    operand(False, width=None)))
    accesses += [
        plan.Access("om_hat", "in", (bsz, h, n, d), F32,
                    operand(True, halved="dv")),
        plan.Access("h_vec", "in", (bsz, h, n), F32,
                    operand(True, None if gated else "dk", width=None)),
        plan.Access("dk", "out", plan.shape_of(k), q.dtype,
                    operand(False, "dk", "dk"))]
    if gated:   # dV' with its augmented column, f32
        def dva_tile(blk):
            """The walk's block writes whole rows; a wgmma dv block its
            half's columns, the first half also column D."""
            if not wgmma:
                return operand(False, width=d + 1)(blk)
            bi, hk = divmod(blk[0], hkv)
            roles, cols = part(blk)
            head = ((bi, bi + 1), (hk, hk + 1),
                    (0, n) if "dv" in roles else (0, 0))
            tiles = plan.box(*head, cols)
            if "dv" in roles and cols[0] == 0:
                tiles += plan.box(*head, (d, d + 1))
            return tiles
        accesses.append(plan.Access("dva", "out", (bsz, hkv, n, d + 1), F32,
                                    dva_tile))
    else:
        accesses.append(plan.Access("dv", "out", plan.shape_of(v), q.dtype,
                                    operand(False, "dv", "dv")))
    return plan.make(entry, "la_bwd", (bsz * hkv, split), threads, smem,
                     accesses,
                     (bsz, h, hkv, n, d, stage_tokens, float(a), float(b),
                      code), argtypes,
                     (bsz, h, hkv, n, d, stage_tokens, code), stage=stage)


def plan_la_fwd(q, k, v, a: float, b: float):
    return plan_fwd("la_fwd", q, k, v, None, a, b, LA_STAGE_TOKENS,
                    _FWD_SYMBOLS["la_fwd"])


def plan_la_bwd_q(k, v, om_hat, h_vec, b: float):
    return plan_bwd_q("la_bwd_q", k, v, None, om_hat, h_vec, b,
                      LA_STAGE_TOKENS, _BWD_SYMBOLS["la_bwd_q"])


def plan_la_bwd_kv(q, k, v, om_hat, h_vec, a: float, b: float):
    return plan_bwd_kv("la_bwd_kv", q, k, v, None, om_hat, h_vec, a, b,
                       LA_STAGE_TOKENS, _BWD_SYMBOLS["la_bwd_kv"])
