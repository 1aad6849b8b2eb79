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

  gla_decode_fused_cuda   the gated kernel (csrc/la_decode_fused.cu,
                          entry `gla_decode_fused`); CUDA only
  gla_decode_fused_torch  its plain version, state in place

Both entries take a query group G in `RECURRENT_GROUPS` (1 to 16, 7 for
qwen2-vl-7b's 28 heads on 4, and 48 for granite-20b's multi-query
attention) and any head dims, and have
two bodies, chosen from the dims and the group by
`recurrent_decode_body(dk, dv, group)`: "stream" (Dk % 4 == 0 and 4 (Dv
+ 1) <= 1024, at most GLA_DECODE_WIDE_THREADS for a group of more than
GLA_DECODE_WIDE_GROUP: each (slot, KV head)'s f32 state slab goes
through a ring of row chunks in shared memory by 1-D bulk copies,
updated there exactly as the walk updates it, so the new state carries
the walk's bits; the linear instance reads no log decay) and "walk" (the
column walk, with its gated instantiation).

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
                            `paged_decode_fused`); CUDA only
  paged_decode_fused_torch  its plain version, the same as
                            `paged_attention_torch` (zeros at length 0
                            on both, as in the reference)

Both softmax kernels run the tile stream of csrc/decode_common.cuh, as
`paged_attention` does (kernels/paged_attention.py): a cluster of
PAGED_DECODE_CLUSTER blocks per (slot, KV head), each streaming a
contiguous span of the cell's live tiles of at most DECODE_TILE_ROWS
rows through a ring of 1-D bulk copies, the blocks' partial softmaxes
merged in rank order by rank 0 through distributed shared memory.  A
contiguous cache is a paged one with one page of S rows per slot and
the identity table: its tiles are DECODE_TILE_ROWS rows of the slot's
(S, D) block for the KV head, and no table is read.

Beside each wrapper, `plan_<entry>` gives the entry's launch plan
(kernels/plan.py) from the same arguments' shapes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import softmax as _softmax
from repro_torch.core.numerics import safe_div
from repro_torch.kernels import build, plan
from repro_torch.kernels import paged_attention as _pg
from repro_torch.kernels.defaults import DECODE_TILE_ROWS, \
    GLA_DECODE_RING, GLA_DECODE_ROW_CLASSES, GLA_DECODE_ROWS, \
    GLA_DECODE_WIDE_GROUP, GLA_DECODE_WIDE_THREADS, PAGED_DECODE_CLUSTER, \
    PAGED_DECODE_WARPS

F32 = torch.float32
KERNEL = "la_decode_fused"
GLA_KERNEL = "gla_decode_fused"
SOFTMAX_KERNEL = "softmax_decode_fused"
PAGED_KERNEL = "paged_decode_fused"
# query heads per KV head the softmax kernels are instantiated for
GROUPS = (1, 2, 4, 8, 16)
# ... and the recurrent steps (la_decode_fused, gla_decode_fused)
RECURRENT_GROUPS = GROUPS + (7, 48)
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


def _recurrent_dims(s, p, q, k, v, log_decay=None):
    """(B, H, Hkv, Dk, Dv) of a decode step, raising on shapes the kernel
    does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be 3-D; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    if tuple(k.shape) != (bsz, hkv, dk) or tuple(v.shape[:2]) != (bsz, hkv):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % hkv != 0 or h // hkv not in RECURRENT_GROUPS:
        raise ValueError(f"H={h} over Hkv={hkv} is not a query group of "
                         f"{RECURRENT_GROUPS}")
    if tuple(s.shape) != (bsz, hkv, dk, dv + 1) \
            or tuple(p.shape) != (bsz, hkv, dv + 1):
        raise ValueError(
            f"state shapes s {tuple(s.shape)}, p {tuple(p.shape)} do not "
            f"match (B, Hkv, Dk, Dv+1) = {(bsz, hkv, dk, dv + 1)}")
    if log_decay is not None and tuple(log_decay.shape) != (bsz, hkv):
        raise ValueError(f"log_decay {tuple(log_decay.shape)} does not "
                         f"match (B, Hkv) = {(bsz, hkv)}")
    return bsz, h, hkv, dk, dv


def _check(s, p, q, k, v, log_decay=None) -> None:
    """Raise on anything the kernel does not take."""
    named = {"s": s, "p": p, "q": q, "k": k, "v": v}
    f32 = ("s", "p")
    if log_decay is not None:
        named["log_decay"] = log_decay
        f32 += ("log_decay",)
    build.check_tensors(KERNEL if log_decay is None else GLA_KERNEL, named,
                        ("q", "k", "v"), f32)
    _recurrent_dims(s, p, q, k, v, log_decay)


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


def _softmax_dims(q, k, v, lengths):
    """(B, H, Hkv, S, D) of a contiguous softmax decode step, raising on
    shapes the kernel does not take."""
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
    if k.shape[2] < 1:
        raise ValueError(f"a cache of S={k.shape[2]} positions")
    return bsz, h, hkv, k.shape[2], d


def _check_softmax(q, k, v, lengths) -> None:
    """Raise on anything the kernel does not take."""
    build.check_tensors(SOFTMAX_KERNEL, {"q": q, "k": k, "v": v,
                                         "lengths": lengths},
                        ("q", "k", "v"), i32=("lengths",))
    _softmax_dims(q, k, v, lengths)


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
            o.data_ptr(), bsz, h, hkv, s_len, d, DECODE_TILE_ROWS,
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


def _check_group(q, k_pages) -> None:
    h, hkv = q.shape[1], k_pages.shape[1]
    if h // hkv not in GROUPS:
        raise ValueError(f"H={h} over Hkv={hkv} is not a query group of "
                         f"{GROUPS}")


def paged_decode_fused_cuda(q, k_pages, v_pages, page_table, lengths):
    """Launch the `paged_decode_fused` kernel: o (B, H, 1, D) in
    q.dtype."""
    _pg.check_paged(PAGED_KERNEL, q, k_pages, v_pages, page_table, lengths)
    _check_group(q, k_pages)
    d = q.shape[3]
    o = _pg.launch_paged(PAGED_KERNEL, q, k_pages, v_pages, page_table,
                         lengths, 1.0 / d ** 0.5)
    launches[PAGED_KERNEL] += 1
    return o


# ---------------------------------------------------------------------------
# Launch plans (kernels/plan.py)
# ---------------------------------------------------------------------------

# la_decode_fused.cu's limit: the launcher refuses more (it stays within the
# shared memory every block may use without opting in), but for the stream
# of a wide group (more than GLA_DECODE_WIDE_GROUP query heads), whose query
# rows, rows f and partial dots alone take more: the card's opt-in maximum
RECURRENT_MAX_SMEM = 48 * 1024


def _wide(group: int) -> bool:
    return group > GLA_DECODE_WIDE_GROUP


def recurrent_smem_limit(group: int, body: str) -> int:
    """The shared memory the launcher takes for `body` at this group."""
    return plan.MAX_SMEM if body == "stream" and _wide(group) \
        else RECURRENT_MAX_SMEM


def recurrent_decode_body(dk: int, dv: int, group: int = 1) -> str:
    """The body `la_decode_fused` and `gla_decode_fused` run at these
    dims and group: "stream" where the state's row chunks start 16-byte
    aligned (Dk % 4 == 0) and a block holds one thread per column and row
    class (at most GLA_DECODE_WIDE_THREADS for a wide group, whose G
    partial dots a thread need the registers), else "walk"."""
    most = GLA_DECODE_WIDE_THREADS if _wide(group) else plan.MAX_THREADS
    return ("stream" if dk % 4 == 0
            and GLA_DECODE_ROW_CLASSES * (dv + 1) <= most else "walk")


def _stream_smem(dk: int, dv: int, group: int) -> int:
    """Dynamic shared memory of the stream body, as csrc/la_decode_fused.cu's
    `ds::layout` with `ds::stages_for`'s stages: the ring of row chunks
    (after the stream, the partial dots of all row classes but the
    first), k, [v, 1], the G query rows and the G rows f in f32, and an
    mbarrier per stage; as many stages (at most one a chunk and
    GLA_DECODE_RING, at least two) as fit the launcher's limit."""
    dv1 = dv + 1
    chunk = GLA_DECODE_ROWS * dv1 * 4
    parts = (GLA_DECODE_ROW_CLASSES - 1) * group * dv1 * 4

    def total(stages):
        region = -(-max(stages * chunk, parts) // 16) * 16
        end = region + (dk + dv1 + group * dk + group * dv1) * 4
        return -(-end // 8) * 8 + 8 * stages

    stages = min(GLA_DECODE_RING, -(-dk // GLA_DECODE_ROWS))
    limit = recurrent_smem_limit(group, "stream")
    while stages > 2 and total(stages) > limit:
        stages -= 1
    return total(stages)


def _plan_recurrent(entry, s, p, q, k, v, log_decay, a, b):
    """la_decode_fused (log_decay None) or gla_decode_fused: one block per
    (slot, KV head) updating its whole state slab and P row and writing
    its G rows of o.  The stream's threads go over a row chunk's columns
    and row classes, GLA_DECODE_ROW_CLASSES (Dv+1) threads rounded up to
    warps; the walk's over the Dv+1 state columns, each down all Dk
    rows."""
    bsz, h, hkv, dk, dv = _recurrent_dims(s, p, q, k, v, log_decay)
    group = h // hkv
    code = plan.dtype_code(q.dtype)

    def head(blk):
        return divmod(blk[0], hkv)

    def slab(blk):
        bi, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1), (0, dk), (0, dv + 1))

    def row(width):
        def tile(blk):
            bi, hk = head(blk)
            return plan.box((bi, bi + 1), (hk, hk + 1), (0, width))
        return tile

    def group_rows(width):
        def tile(blk):
            bi, hk = head(blk)
            return plan.box((bi, bi + 1), (hk * group, (hk + 1) * group),
                            (0, width))
        return tile

    def ld_cell(blk):
        bi, hk = head(blk)
        return plan.box((bi, bi + 1), (hk, hk + 1))

    accesses = [
        plan.Access("s", "inout", plan.shape_of(s), F32, slab),
        plan.Access("p", "inout", plan.shape_of(p), F32, row(dv + 1)),
        plan.Access("q", "in", plan.shape_of(q), q.dtype, group_rows(dk)),
        plan.Access("k", "in", plan.shape_of(k), q.dtype, row(dk)),
        plan.Access("v", "in", plan.shape_of(v), q.dtype, row(dv))]
    if log_decay is not None:
        accesses.append(plan.Access("log_decay", "in", (bsz, hkv), F32,
                                    ld_cell))
    accesses.append(plan.Access("o", "out", (bsz, h, dv), q.dtype,
                                group_rows(dv)))
    body = recurrent_decode_body(dk, dv, group)
    if body == "stream":
        threads = -(-GLA_DECODE_ROW_CLASSES * (dv + 1) // 32) * 32
        smem = _stream_smem(dk, dv, group)
    else:
        threads = min((dv + 1 + 31) // 32 * 32, plan.MAX_THREADS)
        smem = (dk + dv + 1 + group * dk + group * (dv + 1)) * 4
    return plan.make(entry, KERNEL, (bsz * hkv,), threads, smem, accesses,
                     (bsz, h, hkv, dk, dv, float(a), float(b), code),
                     _LA_SYMBOLS[entry], (bsz, h, hkv, dk, dv, code),
                     smem_limit=recurrent_smem_limit(group, body))


def plan_la_decode_fused(s, p, q, k, v, a: float, b: float):
    return _plan_recurrent(KERNEL, s, p, q, k, v, None, a, b)


def plan_gla_decode_fused(s, p, q, k, v, log_decay, a: float, b: float):
    return _plan_recurrent(GLA_KERNEL, s, p, q, k, v, log_decay, a, b)


def plan_softmax_decode_fused(q, k, v, lengths):
    """The tile stream with one page of S rows per slot: a cell per (slot,
    KV head) holds its G query rows, block r of it takes its span of the
    live prefix's tiles (`paged_attention.live_tiles`, `spans`), one box
    of rows of the (S, D) block for the KV head; rank 0 writes o."""
    bsz, h, hkv, s_len, d = _softmax_dims(q, k, v, lengths)
    group = h // hkv
    code = plan.dtype_code(q.dtype)

    def count_tiles(lengths):
        return lambda bi: _pg.live_tiles(int(lengths[bi]), s_len, 1)

    def kv_tiles(bi, h0, span, lengths):
        hk = h0 // group
        return plan.box((bi, bi + 1), (hk, hk + 1),
                        (span[0][1], span[-1][1] + span[-1][2]),
                        (0, d)) if span else []

    q_rows, o_rows, length, keys = _pg.stream_accesses(q, group, count_tiles,
                                                       kv_tiles)
    accesses = [
        plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
        plan.Access("k", "in", plan.shape_of(k), q.dtype, keys),
        plan.Access("v", "in", plan.shape_of(v), q.dtype, keys),
        plan.Access("lengths", "in", (bsz,), plan.I32, length),
        plan.Access("o", "out", plan.shape_of(q), q.dtype, o_rows)]
    stages, smem = _pg.stream_smem(q.element_size(), d, group, s_len, 1,
                                   False)
    return plan.make(
        SOFTMAX_KERNEL, SOFTMAX_KERNEL,
        (bsz * hkv * PAGED_DECODE_CLUSTER,), PAGED_DECODE_WARPS * 32,
        smem, accesses,
        (bsz, h, hkv, s_len, d, DECODE_TILE_ROWS, 1.0 / d ** 0.5, code),
        _SOFTMAX_SYMBOLS[SOFTMAX_KERNEL],
        (bsz, h, hkv, s_len, d, DECODE_TILE_ROWS, code),
        gathered=("lengths",), stage=stages)


def plan_paged_decode_fused(q, k_pages, v_pages, page_table, lengths):
    """The tile stream with a cell per (slot, KV head): PAGED_DECODE_CLUSTER
    blocks, each a span of the slot's live tiles; rank 0 writes the G rows
    of o."""
    _check_group(q, k_pages)
    return _pg.plan_paged(PAGED_KERNEL, q, k_pages, v_pages, page_table,
                          lengths, 1.0 / q.shape[-1] ** 0.5)
