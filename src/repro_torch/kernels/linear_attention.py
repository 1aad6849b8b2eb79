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

Each kernel has two bodies, chosen by `la_fwd_body(dtype, d, entry, dv)`
and `la_bwd_body(entry, dtype, d, dv)`: "wgmma" (bf16 at Dk = Dv = 128,
the paper's training instance, and 64, stablelm-1.6b's and
whisper-large-v3's decoder's: chunked scans on the tensor cores fed by
TMA, so their operands must be 16-byte aligned, which the wrappers
check; blocks of 64 columns, `wgmma_parts(D)` of them: `la_fwd` per head
by parts of the value columns, `la_bwd_q` by parts of dq's columns,
`la_bwd_kv` per KV head by parts of dk's and of dv's columns (four at
D = 128, two at 64); `gla_fwd`, `gla_bwd_q` and `gla_bwd_kv` run the
gated instances of the forward's, the dq and the dk/dv body at D = 128)
and "walk" (f32, and bf16 at every other pair: the token walk;
`la_bwd_kv`'s walk at (192, 128) runs its two roles in two blocks per
KV head).

Shapes: q (B, H, N, Dk), k (B, Hkv, N, Dk) and v (B, Hkv, N, Dv) with
Hkv | H, float32 or bfloat16, (Dk, Dv) in `HEAD_DIM_PAIRS`: Dk = Dv = D
for D in `HEAD_DIMS`, and (192, 128), deepseek-v2-236b's MLA heads (the
gated entries of kernels/gla.py: Dk = Dv in `GLA_HEAD_DIMS`); o, dq, dk
and dv come back in their inputs' dtypes, g, Ω̂ and h are float32; Ω̂ and
o are (.., Dv), dq and dk (.., Dk).  The wrappers take contiguous
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
    GLA_STAGE_TOKENS, GLA_WGMMA_HEAD_DIMS, H100_SMS, LA_BWD_KV_SPLIT_GROUP, \
    LA_BWD_RING, LA_BWD_WGMMA_HEAD_DIMS, LA_CHUNK_RING, LA_CHUNK_TOKENS, \
    LA_STAGE_TOKENS, LA_WGMMA_HEAD_DIMS, LA_WGMMA_PART

F32 = torch.float32
# head dims the kernels are instantiated for (a state row in registers):
# the linear entries' walks also at 112 (zamba2-7b's shared attention),
# the gated entries (kernels/gla.py) not
HEAD_DIMS = (32, 64, 112, 128)
GLA_HEAD_DIMS = (32, 64, 128)
# the (Dk, Dv) pairs of the linear entries: Dk = Dv and the token walks'
# (192, 128), deepseek-v2-236b's MLA (q and k nope 128 + rope 64, v 128)
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
GLA_HEAD_DIM_PAIRS = tuple((d, d) for d in GLA_HEAD_DIMS)


def head_dims(entry: str) -> tuple:
    """The (Dk, Dv) pairs entry `entry` takes."""
    return GLA_HEAD_DIM_PAIRS if entry.startswith("gla_") else HEAD_DIM_PAIRS

# kernel launches made by the wrappers, by kernel name (a run sets them
# to 0 and reads them back to show that its steps went through the
# kernels)
launches = {"la_fwd": 0, "la_bwd_q": 0, "la_bwd_kv": 0}


def la_fwd_body(dtype, d: int, entry: str = "la_fwd", dv=None) -> str:
    """The body forward entry `entry` ("la_fwd" or "gla_fwd") runs for
    this compute dtype and head dims (Dk = d, Dv = dv, default d): "wgmma"
    (bf16 at Dk = Dv in LA_WGMMA_HEAD_DIMS, or for `gla_fwd`
    GLA_WGMMA_HEAD_DIMS: the gated instance) or "walk"."""
    dims = GLA_WGMMA_HEAD_DIMS if entry == "gla_fwd" else LA_WGMMA_HEAD_DIMS
    return ("wgmma" if dtype == torch.bfloat16 and d in dims
            and dv in (None, d) else "walk")


# the head dims of each backward entry's "wgmma" body
_BWD_WGMMA_HEAD_DIMS = {"la_bwd_q": LA_BWD_WGMMA_HEAD_DIMS,
                        "la_bwd_kv": LA_BWD_WGMMA_HEAD_DIMS,
                        "gla_bwd_q": GLA_BWD_Q_WGMMA_HEAD_DIMS,
                        "gla_bwd_kv": GLA_BWD_KV_WGMMA_HEAD_DIMS}


def la_bwd_body(entry: str, dtype, d: int, dv=None) -> str:
    """The body backward entry `entry` runs for this compute dtype and head
    dims (Dk = d, Dv = dv, default d): "wgmma" (`la_bwd_q` and `la_bwd_kv`
    in bf16 at Dk = Dv in LA_BWD_WGMMA_HEAD_DIMS, `gla_bwd_q` in
    GLA_BWD_Q_WGMMA_HEAD_DIMS and `gla_bwd_kv` in
    GLA_BWD_KV_WGMMA_HEAD_DIMS: the gated instances) or "walk"."""
    return ("wgmma" if dtype == torch.bfloat16 and dv in (None, d)
            and d in _BWD_WGMMA_HEAD_DIMS.get(entry, ()) else "walk")


def kv_slices(entry: str, dtype, b: int, h: int, hkv: int, d: int,
              dv=None) -> int:
    """The slices S of the query group over which `la_bwd_kv` or
    `gla_bwd_kv` (`entry`) spreads its chunked body's blocks (grid z;
    csrc/la_bwd.cu `bkv::slice_count`): 1 for the walks and for groups of
    fewer than LA_BWD_KV_SPLIT_GROUP query heads; otherwise the smallest S
    that keeps the largest slice's share ⌈G / min(G, fit)⌉, fit being the
    blocks per (batch, KV head, part) that keep the grid within one block
    on each of H100_SMS SMs."""
    group = h // hkv
    if la_bwd_body(entry, dtype, d, dv) != "wgmma" \
            or group < LA_BWD_KV_SPLIT_GROUP:
        return 1
    fit = min(group, max(1, H100_SMS // (b * hkv * 2 * wgmma_parts(d))))
    per = -(-group // fit)
    return -(-group // per)


def slice_heads(group: int, slices: int, s: int) -> tuple:
    """The query heads [lo, hi) of the group that slice s walks."""
    return s * group // slices, (s + 1) * group // slices


def kv_partials(slices: int, b: int, hkv: int, n: int, dk: int, dv: int,
                device):
    """The f32 partials of a split `la_bwd_kv` or `gla_bwd_kv` launch, dk's
    (B, Hkv, S, N, Dk) and dv's (B, Hkv, S, N, dv: Dv, or D + 1 for the
    gated dV'); (None, None) where S = 1."""
    if slices == 1:
        return None, None
    return (torch.empty((b, hkv, slices, n, dk), dtype=F32, device=device),
            torch.empty((b, hkv, slices, n, dv), dtype=F32, device=device))


def _walk_stage(entry: str) -> int:
    """The tokens a token walk stages per iteration."""
    return GLA_STAGE_TOKENS if entry.startswith("gla_") else LA_STAGE_TOKENS


def fwd_stage(dtype, d: int, entry: str = "la_fwd", dv=None) -> int:
    """The `stage` argument of a forward entry's C call: the wgmma body's
    chunk, or the tokens the walk stages per iteration."""
    return (LA_CHUNK_TOKENS if la_fwd_body(dtype, d, entry, dv) == "wgmma"
            else _walk_stage(entry))


def bwd_stage(entry: str, dtype, d: int, dv=None) -> int:
    """The `stage` argument of a backward entry's C call, as
    `fwd_stage`."""
    return (LA_CHUNK_TOKENS if la_bwd_body(entry, dtype, d, dv) == "wgmma"
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

def _dims(q, k, v, pairs=HEAD_DIM_PAIRS, q_width="dk"):
    """(B, H, Hkv, N, Dk, Dv) of a (q, k, v) triple, raising on shapes
    the kernels do not take ((Dk, Dv) outside `pairs`).  q is (B, H, N,
    Dk), or with q_width "dv" a per-query-head operand of Dv columns (Ω̂)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, hkv, n, dk = k.shape
    h, dv = q.shape[1], v.shape[-1]
    width = dk if q_width == "dk" else dv
    if tuple(q.shape) != (bsz, h, n, width) \
            or tuple(v.shape) != (bsz, hkv, n, dv):
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match: q and k (.., Dk), "
                         f"v (.., Dv), q of {q_width} columns")
    if h % hkv != 0:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if (dk, dv) not in pairs:
        raise ValueError(f"head dim {dk} with Dv {dv}: (Dk, Dv) is not one "
                         f"of {pairs}")
    return bsz, h, hkv, n, dk, dv


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the linear entries take Dv after the dtype code
_FWD_SYMBOLS = {"la_fwd": [_P] * 5 + [_I] * 6 + [_F] * 2 + [_I, _I, _P]}
_BWD_SYMBOLS = {"la_bwd_q": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
                "la_bwd_kv": [_P] * 9 + [_I] * 6 + [_F] * 2 + [_I, _I, _P]}


def la_fwd_cuda(q, k, v, a: float, b: float):
    """Launch `la_fwd`: returns (o in q.dtype, g f32)."""
    build.check_tensors("la_fwd", {"q": q, "k": k, "v": v}, ("q", "k", "v"))
    bsz, h, hkv, n, dk, dv = _dims(q, k, v)
    lib = build.bind("la_fwd", _FWD_SYMBOLS)
    o = torch.empty((bsz, h, n, dv), dtype=q.dtype, device=q.device)
    g = torch.empty((bsz, h, n), dtype=F32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.la_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), g.data_ptr(), bsz, h, hkv, n, dk,
                         fwd_stage(q.dtype, dk, dv=dv), float(a), float(b),
                         build.DTYPE_CODE[q.dtype], dv,
                         build.current_stream(q.device))
    build.raise_on(lib, "la_fwd", "la_fwd", err)
    launches["la_fwd"] += 1
    return o, g


def la_bwd_q_cuda(k, v, om_hat, h_vec, b: float):
    """Launch `la_bwd_q`: dq (B, H, N, Dk) in k.dtype (the dtype q shares
    with k and v) from k, v and the f32 om_hat (B, H, N, Dv), h (B, H, N).
    """
    build.check_tensors("la_bwd_q", {"k": k, "v": v, "om_hat": om_hat,
                                     "h": h_vec}, ("k", "v"),
                        ("om_hat", "h"))
    bsz, h, hkv, n, dk, dv = _dims(om_hat, k, v, q_width="dv")
    if tuple(h_vec.shape) != (bsz, h, n):
        raise ValueError(f"h {tuple(h_vec.shape)} does not match "
                         f"{(bsz, h, n)}")
    lib = build.bind("la_bwd", _BWD_SYMBOLS)
    dq = torch.empty((bsz, h, n, dk), dtype=k.dtype, device=k.device)
    with torch.cuda.device(k.device):
        err = lib.la_bwd_q(k.data_ptr(), v.data_ptr(), om_hat.data_ptr(),
                           h_vec.data_ptr(), dq.data_ptr(), bsz, h, hkv, n,
                           dk, bwd_stage("la_bwd_q", k.dtype, dk, dv),
                           float(b), build.DTYPE_CODE[k.dtype], dv,
                           build.current_stream(k.device))
    build.raise_on(lib, "la_bwd", "la_bwd_q", err)
    launches["la_bwd_q"] += 1
    return dq


def la_bwd_kv_cuda(q, k, v, om_hat, h_vec, a: float, b: float):
    """Launch `la_bwd_kv`: (dk (B, Hkv, N, Dk), dv (B, Hkv, N, Dv)), each
    in its input's dtype; a launch split over the query group
    (`kv_slices`) takes f32 partials allocated here."""
    build.check_tensors("la_bwd_kv", {"q": q, "k": k, "v": v,
                                      "om_hat": om_hat, "h": h_vec},
                        ("q", "k", "v"), ("om_hat", "h"))
    bsz, h, hkv, n, d_k, d_v = _dims(q, k, v)
    if tuple(om_hat.shape) != (bsz, h, n, d_v) \
            or tuple(h_vec.shape) != (bsz, h, n):
        raise ValueError(f"om_hat {tuple(om_hat.shape)} / h "
                         f"{tuple(h_vec.shape)} do not match (B, H, N, Dv) "
                         f"= {(bsz, h, n, d_v)}")
    lib = build.bind("la_bwd", _BWD_SYMBOLS)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dk_part, dv_part = kv_partials(
        kv_slices("la_bwd_kv", q.dtype, bsz, h, hkv, d_k, d_v), bsz, hkv, n,
        d_k, d_v, q.device)
    with torch.cuda.device(q.device):
        err = lib.la_bwd_kv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            om_hat.data_ptr(), h_vec.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(),
                            dk_part.data_ptr() if dk_part is not None
                            else None,
                            dv_part.data_ptr() if dv_part is not None
                            else None, bsz, h, hkv, n,
                            d_k, bwd_stage("la_bwd_kv", q.dtype, d_k, d_v),
                            float(a), float(b), build.DTYPE_CODE[q.dtype],
                            d_v,
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

def _padded(d: int, groups: int = 4) -> int:
    """Floats of one staged row: D in `groups` row groups, each followed by
    4 floats of padding (`Rows<D, G>::kPadded`)."""
    return d + 4 * groups


def _walk_row_groups(dk: int, dv: int) -> int:
    """Row groups of the state column a walk's value thread (la_fwd) or
    column-role thread (la_bwd_kv) tiles: 4 where Dk = Dv, 8 where Dk > Dv
    (`Walk` / `KvWalk`)."""
    return 4 if dk == dv else 8


# the wgmma body: one warpgroup; beside the tiles and sums the barriers and
# the pad to their 1024-byte alignment
_WGMMA_THREADS = 128
_WGMMA_EXTRA = 2048


def wgmma_parts(d: int) -> int:
    """Blocks of the wgmma bodies per (batch, query head) of `la_fwd` and
    `la_bwd_q`, and per (batch, KV head) and role of `la_bwd_kv`: one per
    LA_WGMMA_PART columns of D (1 at D = 64, 2 at D = 128)."""
    return d // LA_WGMMA_PART


def _wgmma_smem(d: int, gated: bool = False) -> int:
    """Dynamic shared memory of the forward's wgmma block, as
    csrc/la_fwd.cu's `lc::Layout<d, gated>::kSmem`: LA_CHUNK_RING chunks of
    bf16 q, k (D wide) and the block's part of v, the bf16 copy of S^T
    (its value columns x D; gated, its hi + lo pair and the hi and lo
    (w o v) tiles), z and P twice in f32, and the barriers and pad."""
    c, part = LA_CHUNK_TOKENS, LA_WGMMA_PART
    return (LA_CHUNK_RING * 2 * (2 * c * d + c * part) + 2 * part * d
            + (2 * part * d + 2 * 2 * c * part if gated else 0)
            + 2 * 4 * (d + part) + _WGMMA_EXTRA)


def _bwd_q_smem(d: int, gated: bool = False) -> int:
    """Dynamic shared memory of the dq wgmma block, as csrc/la_bwd.cu's
    `bq::Layout<d, gated>::kSmem`: LA_BWD_RING chunks of the block's part
    of k and of v in bf16 and of Ω̂ in f32, Ω̂'s hi and lo bf16 tiles, the
    hi and lo copies of the block's part of A = Σ k^T v, gated the hi and
    lo (w o v) tiles, z twice and h in f32, and the barriers and pad."""
    c, half = LA_CHUNK_TOKENS, LA_WGMMA_PART
    return (LA_BWD_RING * (2 * c * half + 2 * c * d + 4 * c * d)
            + 2 * 2 * c * d + 2 * 2 * half * d
            + (2 * 2 * c * d if gated else 0) + 2 * 4 * half + 4 * c
            + _WGMMA_EXTRA)


def _bwd_kv_smem(d: int, gated: bool = False) -> int:
    """Dynamic shared memory of the dk/dv wgmma block, as
    `bkv::Layout<d, gated>::kSmem`: LA_BWD_RING steps of a bf16 k or v tile,
    a bf16 q tile and an f32 Ω̂ tile, Ω̂'s hi and lo bf16 tiles, the hi and
    lo copies of the block's slice of U = Σ q^T Ω̂, its f32 sums twice, h,
    gated the sums of dV''s augmented column (u_h over D and Σ h, twice,
    in 16-byte rows) and the step's token weights 2^cl and 2^cl h, and
    the barriers and pad."""
    c, half = LA_CHUNK_TOKENS, LA_WGMMA_PART
    return (LA_BWD_RING * (2 * c * d + 2 * c * d + 4 * c * d)
            + 2 * 2 * c * d + 2 * 2 * half * d + 2 * 4 * half + 4 * c
            + (2 * 4 * d + 16 + 2 * 4 * c if gated else 0) + _WGMMA_EXTRA)


def plan_fwd(entry, q, k, v, log_decay, a, b, stage_tokens, argtypes):
    """la_fwd (log_decay None) or gla_fwd: the token walk's one block per
    (batch, query head) walking all N tokens of its query head and of its
    KV head; the wgmma body `wgmma_parts(D)` such blocks, each with its
    part of the value columns (of v and o; the first writes g), walking
    chunks (TMA zero-fills the rows of the last chunk past N; gated, each
    block reads its KV head's log decays)."""
    bsz, h, hkv, n, d, dv = _dims(q, k, v, head_dims(entry))
    group, gated = h // hkv, log_decay is not None
    code = plan.dtype_code(q.dtype)
    # the walk: RG Dv / 4 value threads rounded up to warps, the
    # normalizer warp
    rg = _walk_row_groups(d, dv)
    split, threads = 1, -(-(rg * dv // 4) // 32) * 32 + 32
    if la_fwd_body(q.dtype, d, entry, dv) == "wgmma":
        stage_tokens = stage = LA_CHUNK_TOKENS
        split, threads, smem = wgmma_parts(d), _WGMMA_THREADS, \
            _wgmma_smem(d, gated)
    else:
        # the staging's floats per token: q and k, v padded, f, and the
        # decay
        stage, smem = plan.fit(
            stage_tokens, (2 * _padded(d, rg) + _padded(dv) + dv + 1
                           + int(gated)) * 4)
    part = dv // split

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
    accesses += [plan.Access("o", "out", (bsz, h, n, dv), q.dtype, o_part),
                 plan.Access("g", "out", (bsz, h, n), F32, g_row)]
    return plan.make(entry, "la_fwd", (bsz * h, split), threads, smem,
                     accesses,
                     (bsz, h, hkv, n, d, stage_tokens, float(a), float(b),
                      code, *_dv_arg(gated, dv)), argtypes,
                     (bsz, h, hkv, n, d, stage_tokens, code, dv), stage=stage)


def plan_bwd_q(entry, k, v, log_decay, om_hat, h_vec, b, stage_tokens,
               argtypes):
    """la_bwd_q (log_decay None) or gla_bwd_q: the token walk's one block
    per (batch, query head), the forward scan over all N tokens; the
    wgmma body (gla_bwd_q its gated instance) `wgmma_parts(D)` such
    blocks, each with its part of dq's columns (and of k's), walking
    chunks (TMA zero-fills the rows of the last chunk past N)."""
    bsz, h, hkv, n, d, dv = _dims(om_hat, k, v, head_dims(entry),
                                  q_width="dv")
    group, gated = h // hkv, log_decay is not None
    code = plan.dtype_code(k.dtype)
    split, threads = 1, d
    if la_bwd_body(entry, k.dtype, d, dv) == "wgmma":
        stage_tokens = stage = LA_CHUNK_TOKENS
        split, threads, smem = wgmma_parts(d), _WGMMA_THREADS, \
            _bwd_q_smem(d, gated)
    else:
        # k, v and Ω̂ padded, h, and the decay
        stage, smem = plan.fit(stage_tokens,
                               (_padded(d) + 2 * _padded(dv) + 1
                                + int(gated)) * 4)
    part = d // split

    def head(blk):
        bi, hi = divmod(blk[0], h)
        return bi, hi, hi // group

    def q_rows(blk):
        bi, hi, _ = head(blk)
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (0, dv))

    def q_part(blk):
        bi, hi, _ = head(blk)
        lo = blk[1] * part
        return plan.box((bi, bi + 1), (hi, hi + 1), (0, n), (lo, lo + part))

    def kv_rows(blk):
        bi, _, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, n), (0, dv))

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
        plan.Access("om_hat", "in", (bsz, h, n, dv), F32, q_rows),
        plan.Access("h_vec", "in", (bsz, h, n), F32, h_row),
        plan.Access("dq", "out", (bsz, h, n, d), k.dtype, q_part)]
    return plan.make(entry, "la_bwd", (bsz * h, split), threads, smem,
                     accesses,
                     (bsz, h, hkv, n, d, stage_tokens, float(b), code,
                      *_dv_arg(gated, dv)),
                     argtypes, (bsz, h, hkv, n, d, stage_tokens, code, dv),
                     stage=stage)


def plan_bwd_kv(entry, q, k, v, log_decay, om_hat, h_vec, a, b,
                stage_tokens, argtypes):
    """la_bwd_kv (log_decay None) or gla_bwd_kv: the token walk's one block
    per (batch, KV head), the reverse scan over all N tokens of its G query
    heads (its staging grows with G, so large groups stage fewer tokens);
    where Dk > Dv its two roles in two blocks per (batch, KV head), y = 0
    writing dk and y = 1 dv, each staging every operand; the wgmma body
    2 P blocks per (batch, KV head), P = `wgmma_parts(D)`: y < P write
    dk's columns part y from v, their part of q, Ω̂ and h; y >= P dv's part
    y - P from k, q and their part of Ω̂ (gated: dV''s columns of that
    part, from h too, and y = P also its column D), each walking the
    group's chunks from the last.  Split over the query group
    (`kv_slices`, S > 1): block z walks only slice z's query heads and
    stores its part of dk or dv unrounded into its slice's rows of the f32
    partials ("scratch"); the slice sum, on the same grid, then writes rows
    [z N / S, (z + 1) N / S) of that part from all S slices."""
    bsz, h, hkv, n, d, dv = _dims(q, k, v, head_dims(entry))
    group, gated = h // hkv, log_decay is not None
    code = plan.dtype_code(q.dtype)
    wgmma = la_bwd_body(entry, q.dtype, d, dv) == "wgmma"
    slices = kv_slices(entry, q.dtype, bsz, h, hkv, d, dv)
    split_roles = not wgmma and d != dv
    if wgmma:
        stage_tokens = stage = LA_CHUNK_TOKENS
        split, threads, smem = 2 * wgmma_parts(d), _WGMMA_THREADS, \
            _bwd_kv_smem(d, gated)
    else:
        # q and Ω̂ of the G query heads, k and v, padded; h of the G heads;
        # gated: the decay, the row warps' shares of k.U[:Dk, Dv] and
        # U[Dk, Dv]
        rg = _walk_row_groups(d, dv)
        stage, smem = plan.fit(
            stage_tokens, ((group + 1) * (_padded(d, rg) + _padded(dv))
                           + group + (d // 32 + 2 if gated else 0)) * 4)
        split, threads = ((2, max(d, rg * dv // 4)) if split_roles
                          else (1, 2 * d))
    parts = wgmma_parts(d)   # dk's parts, then dv's

    def part(blk):
        """The block's roles and the columns its output takes: the walk's
        one block does both over all columns, a split walk's block y its
        role; a wgmma block its part."""
        if not wgmma:
            if split_roles:
                return ("dk",) if blk[1] == 0 else ("dv",), None
            return ("dk", "dv"), None
        lo = (blk[1] % parts) * LA_WGMMA_PART
        return ("dk",) if blk[1] < parts else ("dv",), \
            (lo, lo + LA_WGMMA_PART)

    def operand(grouped, role=None, halved=None, width=d):
        """Tiles of an operand over the block's query group (grouped) or
        KV head: rows [0, N) where `role` is None, the walk stages every
        operand, or `role` is one of the block's roles, else none; of
        `width` columns (None: a 3-D operand), the block's part where
        `halved` is one of its roles."""
        def tile(blk):
            bi, hk = divmod(blk[0], hkv)
            roles, cols = part(blk)
            reads = role is None or (not wgmma and halved is None) \
                or role in roles
            lo, hi = slice_heads(group, slices, blk[2])
            ranges = [(bi, bi + 1), (hk * group + lo, hk * group + hi)
                      if grouped else (hk, hk + 1),
                      (0, n) if reads else (0, 0)]
            if width is not None:
                ranges.append(cols if cols is not None and halved in roles
                              else (0, width))
            return plan.box(*ranges)
        return tile

    def rows(blk):
        """The rows of dk and dv the block's index writes: all of them,
        or split, the slice sum's share [z N / S, (z + 1) N / S)."""
        return blk[2] * n // slices, (blk[2] + 1) * n // slices

    def output(role, width, aug=False):
        """dk or dv (`aug`: the gated dV', width D + 1): the block's part
        of the columns (the walk: all) over its rows, where `role` is its
        own; dV''s first part also column D."""
        def tile(blk):
            bi, hk = divmod(blk[0], hkv)
            roles, cols = part(blk)
            mine = role in roles
            head = ((bi, bi + 1), (hk, hk + 1),
                    rows(blk) if mine else (0, 0))
            tiles = plan.box(*head, cols if cols is not None
                             and (mine or aug) else (0, width))
            if aug and mine and cols is not None and cols[0] == 0:
                tiles += plan.box(*head, (d, d + 1))
            return tiles
        return tile

    def partial(role, width):
        """A role's f32 partials (B, Hkv, S, N, width): the block writes
        its part's columns of slice z's rows and the slice sum reads them
        at its rows from every slice (gated dV': the first part also
        column D)."""
        def tile(blk):
            bi, hk = divmod(blk[0], hkv)
            roles, cols = part(blk)
            if role not in roles:
                return []
            spans = [cols] + ([(d, d + 1)] if width == d + 1
                              and cols[0] == 0 else [])
            cell = ((bi, bi + 1), (hk, hk + 1))
            return [t for c in spans
                    for t in plan.box(*cell, (blk[2], blk[2] + 1), (0, n),
                                      c)
                    + plan.box(*cell, (0, slices), rows(blk), c)]
        return tile

    accesses = [
        plan.Access("q", "in", plan.shape_of(q), q.dtype,
                    operand(True, halved="dk")),
        plan.Access("k", "in", plan.shape_of(k), q.dtype,
                    operand(False, "dv")),
        plan.Access("v", "in", plan.shape_of(v), q.dtype,
                    operand(False, "dk", width=dv))]
    if gated:
        accesses.append(plan.Access("log_decay", "in", (bsz, hkv, n), F32,
                                    operand(False, width=None)))
    accesses += [
        plan.Access("om_hat", "in", (bsz, h, n, dv), F32,
                    operand(True, halved="dv", width=dv)),
        plan.Access("h_vec", "in", (bsz, h, n), F32,
                    operand(True, None if gated else "dk", width=None)),
        plan.Access("dk", "out", plan.shape_of(k), q.dtype,
                    output("dk", d))]
    dv_name, dv_width = ("dva", d + 1) if gated else ("dv", dv)
    accesses.append(plan.Access(dv_name, "out", (bsz, hkv, n, dv_width),
                                F32 if gated else q.dtype,
                                output("dv", dv_width, gated)))
    pointers = [a.name for a in accesses] + [None, None]
    if slices > 1:
        accesses += [
            plan.Access("dk_part", "scratch", (bsz, hkv, slices, n, d), F32,
                        partial("dk", d)),
            plan.Access(dv_name + "_part", "scratch",
                        (bsz, hkv, slices, n, dv_width), F32,
                        partial("dv", dv_width))]
        pointers = [a.name for a in accesses]
    return plan.make(entry, "la_bwd", (bsz * hkv, split, slices), threads,
                     smem, accesses,
                     (bsz, h, hkv, n, d, stage_tokens, float(a), float(b),
                      code, *_dv_arg(gated, dv)), argtypes,
                     (bsz, h, hkv, n, d, stage_tokens, code, dv),
                     pointers=pointers, stage=stage)


def _dv_arg(gated: bool, dv: int) -> tuple:
    """The last argument before the stream of an entry's C call: the
    linear entries take Dv after the dtype code, the gated ones nothing
    (Dk = Dv = D)."""
    return () if gated else (dv,)


def plan_la_fwd(q, k, v, a: float, b: float):
    return plan_fwd("la_fwd", q, k, v, None, a, b, LA_STAGE_TOKENS,
                    _FWD_SYMBOLS["la_fwd"])


def plan_la_bwd_q(k, v, om_hat, h_vec, b: float):
    return plan_bwd_q("la_bwd_q", k, v, None, om_hat, h_vec, b,
                      LA_STAGE_TOKENS, _BWD_SYMBOLS["la_bwd_q"])


def plan_la_bwd_kv(q, k, v, om_hat, h_vec, a: float, b: float):
    return plan_bwd_kv("la_bwd_kv", q, k, v, None, om_hat, h_vec, a, b,
                       LA_STAGE_TOKENS, _BWD_SYMBOLS["la_bwd_kv"])
