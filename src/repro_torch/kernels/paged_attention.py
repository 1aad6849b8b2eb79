"""Paged-KV softmax decode (port of `repro/kernels/paged_attention.py`).

The serving engine's paged softmax path keeps each layer's KV in a
shared arena of fixed-size pages, (P, Hkv, ps, D), addressed by a
per-slot page table (B, Pmax) int32: key j of slot b lives at row
j % ps of page `page_table[b, j // ps]`.  One call attends every slot's
new query token to its first lengths[b] keys:

  gather_pages           the arena + table -> a contiguous (B, Hkv,
                         Pmax * ps, D) cache (the plain path and the
                         paged prefill's view of the context)
  paged_attention_torch  the plain version: gather, the masked softmax
                         decode (`core/softmax.py::softmax_decode_masked`),
                         then zeros for length-0 slots, exactly as the
                         reference's `paged_attention_xla`
  paged_attention_cuda   the hand-written Hopper kernel
                         (csrc/paged_decode.cu, entry `paged_attention`:
                         a cell per (slot, query head), reading KV head
                         h // G through the table); CUDA only

Both take q (B, H, 1, D) and the arenas in the compute dtype, the table
and lengths (B,) int32, and an optional score scale (default 1/sqrt(D),
as `paged_attention_pallas`'s); they return o (B, H, 1, D) in q.dtype.
Lengths past Pmax * ps attend to all Pmax * ps keys; a slot of length 0
yields zeros on both.  Every table entry a slot's live keys reach must
name an arena page: the engine points unallocated entries at its sink
page, and the kernel traps on an entry outside the arena.

Every softmax decode entry (`paged_attention`, the head-folded
`paged_decode_fused` and the contiguous `softmax_decode_fused`,
decode_fused.py) runs one body, the tile stream of csrc/decode_common.cuh
(`pc::stream_kernel`): a cluster of PAGED_DECODE_CLUSTER blocks per cell
(a slot's query rows reading one KV head), each streaming a contiguous
span of the cell's live tiles by 1-D bulk copies, merged in rank order
through distributed shared memory.  A tile is at most DECODE_TILE_ROWS
rows contiguous in memory: a page of ps <= DECODE_TILE_ROWS rows is one
tile, a larger page (and a contiguous cache's S rows) ceil(ps /
DECODE_TILE_ROWS) tiles.  `tiling`, `live_tiles`, `spans` and
`stream_smem` mirror the kernel's; `launch_paged` and `plan_paged` (the
launch plan, kernels/plan.py) serve both paged entries.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import softmax as _softmax
from repro_torch.kernels import build, plan
from repro_torch.kernels.defaults import DECODE_TILE_ROWS, \
    PAGED_DECODE_CLUSTER, PAGED_DECODE_RING, PAGED_DECODE_WARPS

LIB = "paged_decode"
KERNEL = "paged_attention"
# head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)
# the most rows of one tile the C entries admit (csrc/decode_common.cuh
# `pc::kMaxTileRows`): a ring of two such tiles fits at f32, D = 128, R = 16
MAX_TILE_ROWS = 64

# kernel launches made by `paged_attention_cuda` (a run sets it to 0 and
# reads it back to show that its decode steps went through the kernel)
launches = {KERNEL: 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURE = [_P] * 6 + [_I] * 8 + [_F, _I, _P]
_SYMBOLS = {"paged_attention": _SIGNATURE, "paged_decode_fused": _SIGNATURE}


def gather_pages(pages, page_table):
    """(P, Hkv, ps, d) arena + (B, Pmax) table -> contiguous (B, Hkv, S, d)
    with S = Pmax * ps.  Entries past a slot's allocation gather the
    engine's sink page: callers mask by length before reading them."""
    b, pmax = page_table.shape
    _, hkv, ps, d = pages.shape
    gat = pages[page_table.long()]              # (B, Pmax, Hkv, ps, d)
    return gat.transpose(1, 2).reshape(b, hkv, pmax * ps, d)


def paged_attention_torch(q, k_pages, v_pages, page_table, lengths,
                          scale: float | None = None):
    """Plain version: gather, masked softmax decode, zeros at length 0."""
    lengths = lengths.to(q.device)
    o = _softmax.softmax_decode_masked(
        q, gather_pages(k_pages, page_table),
        gather_pages(v_pages, page_table), lengths, scale)
    return torch.where((lengths > 0)[:, None, None, None], o,
                       torch.zeros((), dtype=o.dtype, device=o.device))


def paged_dims(q, k_pages, v_pages, page_table, lengths):
    """(B, H, Hkv, P, ps, Pmax, D) of a paged decode step, raising on
    shapes the paged kernels do not take."""
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q (B, H, 1, D), k_pages and v_pages (P, Hkv, ps, "
                         f"D) expected; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    bsz, h, nq, d = q.shape
    num_pages, hkv, ps = k_pages.shape[:3]
    if nq != 1 or k_pages.shape[3] != d or page_table.dim() != 2 \
            or page_table.shape[0] != bsz or tuple(lengths.shape) != (bsz,):
        raise ValueError(f"q {tuple(q.shape)} / k_pages "
                         f"{tuple(k_pages.shape)} / page_table "
                         f"{tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match (one query "
                         f"token per slot, a (B, Pmax) table)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if h % hkv != 0:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    return bsz, h, hkv, num_pages, ps, page_table.shape[1], d


def check_paged(kernel: str, q, k_pages, v_pages, page_table,
                lengths) -> None:
    """Raise on anything the paged kernels do not take."""
    build.check_tensors(kernel, {"q": q, "k_pages": k_pages,
                                 "v_pages": v_pages,
                                 "page_table": page_table,
                                 "lengths": lengths},
                        ("q", "k_pages", "v_pages"),
                        i32=("page_table", "lengths"))
    paged_dims(q, k_pages, v_pages, page_table, lengths)


def launch_paged(symbol: str, q, k_pages, v_pages, page_table, lengths,
                 scale: float):
    """Launch `symbol` of csrc/paged_decode.cu on the current stream (the
    caller has checked the tensors); returns o (B, H, 1, D) in q.dtype."""
    bsz, h, _, d = q.shape
    num_pages, hkv, ps, _ = k_pages.shape
    lib = build.bind(LIB, _SYMBOLS)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(lib, symbol)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), o.data_ptr(), bsz, h,
            hkv, num_pages, ps, page_table.shape[1], d, DECODE_TILE_ROWS,
            float(scale), build.DTYPE_CODE[q.dtype],
            build.current_stream(q.device))
    build.raise_on(lib, LIB, symbol, err)
    return o


def paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                         scale: float | None = None):
    """Launch the `paged_attention` kernel: o (B, H, 1, D) in q.dtype."""
    check_paged(KERNEL, q, k_pages, v_pages, page_table, lengths)
    d = q.shape[-1]
    o = launch_paged(KERNEL, q, k_pages, v_pages, page_table, lengths,
                     1.0 / d ** 0.5 if scale is None else scale)
    launches[KERNEL] += 1
    return o


def tiling(ps: int) -> tuple[int, int]:
    """(rows of a tile, tiles of a page) for pages of `ps` rows, as
    `pc::Tiling`: min(ps, DECODE_TILE_ROWS) rows, ceil(ps / that) tiles."""
    tr = min(ps, DECODE_TILE_ROWS)
    return tr, -(-ps // tr)


def live_tiles(length: int, ps: int, pmax: int) -> list:
    """The tiles of a cell's first min(length, pmax ps) keys, in order:
    (page index in the slot's table row, first row in the page, rows)."""
    tr, sub = tiling(ps)
    n = max(0, min(int(length), pmax * ps))
    full = n // ps
    out = []
    for t in range(full * sub + -(-(n - full * ps) // tr)):
        i, r0 = t // sub, t % sub * tr
        out.append((i, r0, min(tr, ps - r0, n - i * ps - r0)))
    return out


def spans(count: int) -> list:
    """Block r's span [first, end) of a cell's `count` tiles, r in [0,
    PAGED_DECODE_CLUSTER): contiguous spans of ceil(count /
    PAGED_DECODE_CLUSTER) tiles, the last ones shorter or empty."""
    n = -(-count // PAGED_DECODE_CLUSTER)
    return [(min(r * n, count), min((r + 1) * n, count))
            for r in range(PAGED_DECODE_CLUSTER)]


def stream_smem(itemsize: int, d: int, rows: int, ps: int, pmax: int,
                paged: bool) -> tuple[int, int]:
    """(stages, dynamic shared memory) of the tile stream, as
    csrc/decode_common.cuh's `pc::shape_of` and `pc::layout`: a ring of
    `stages` tiles of K and V rows (after the stream, the block's R x D
    f32 acc), the scaled query rows (R x D f32), the scores and
    probabilities (R x tile rows f32 each), the warps' tile maxima
    (PAGED_DECODE_WARPS x R f32), the running max by tile parity (2 x R),
    l and the final max (R each), the span's table entries (paged only)
    and an mbarrier per stage.  Stages: at most PAGED_DECODE_RING and one
    per tile of the longest span, at least 2, as many as fit."""
    tr, sub = tiling(ps)
    span = -(-(pmax * sub) // PAGED_DECODE_CLUSTER)
    table = span if paged else 0

    def total(stages):
        ring = stages * 2 * tr * d * itemsize
        acc = rows * d * 4
        end = -(-max(ring, acc) // 16) * 16 + acc + 2 * rows * tr * 4 \
            + (PAGED_DECODE_WARPS + 4) * rows * 4 + table * 4
        return -(-end // 8) * 8 + 8 * stages

    stages = max(2, min(PAGED_DECODE_RING, span))
    while stages > 2 and total(stages) > plan.MAX_SMEM:
        stages -= 1
    return stages, total(stages)


def _cell(blk, h: int, rows: int, count_tiles):
    """(slot, first query row, this block's span of the cell's live
    tiles, rank) of block `blk`: cell blk // PAGED_DECODE_CLUSTER holds
    slot b's query rows [h0, h0 + rows)."""
    cell, rank = divmod(blk[0], PAGED_DECODE_CLUSTER)
    bi, r = divmod(cell, h // rows)
    tiles = count_tiles(bi)
    first, end = spans(len(tiles))[rank]
    return bi, r * rows, tiles[first:end], rank


def stream_accesses(q, rows: int, count_tiles, kv_tiles):
    """The tile functions of a stream launch's q, o and lengths (a cell's
    rows of q and o, o written by rank 0) and K/V (kv_tiles(slot, first
    query row, span, *gathered) -> tiles).  The lengths are the last
    gathered operand; count_tiles(lengths)(slot) gives the cell's live
    tiles."""
    h, d = q.shape[1], q.shape[3]

    def span_of(blk, lengths):
        return _cell(blk, h, rows, count_tiles(lengths))

    def q_rows(blk, *gathered):
        bi, h0, _, _ = span_of(blk, gathered[-1])
        return plan.box((bi, bi + 1), (h0, h0 + rows), (0, 1), (0, d))

    def o_rows(blk, *gathered):
        # the cluster's rank 0 writes the merged rows
        return q_rows(blk, *gathered) if blk[0] % PAGED_DECODE_CLUSTER == 0 \
            else []

    def length(blk, *gathered):
        bi = span_of(blk, gathered[-1])[0]
        return plan.box((bi, bi + 1))

    def keys(blk, *gathered):
        bi, h0, span, _ = span_of(blk, gathered[-1])
        return kv_tiles(bi, h0, span, *gathered)

    return q_rows, o_rows, length, keys


def plan_paged(entry, q, k_pages, v_pages, page_table, lengths,
               scale: float):
    """`paged_attention` (a cell per (slot, query head)) or
    `paged_decode_fused` (a cell per (slot, KV head), its G rows): the
    tile stream.  Block r of a cell takes its span of the cell's live
    tiles (`live_tiles`, `spans`): those tiles' table entries and their
    live rows of each page; rank 0 writes o."""
    bsz, h, hkv, num_pages, ps, pmax, d = paged_dims(q, k_pages, v_pages,
                                                     page_table, lengths)
    group = h // hkv
    rows = group if entry == "paged_decode_fused" else 1
    code = plan.dtype_code(q.dtype)

    def count_tiles(lengths):
        return lambda bi: live_tiles(int(lengths[bi]), ps, pmax)

    def kv_tiles(bi, h0, span, page_table, lengths):
        hk = h0 // group
        tiles = []
        for i, r0, n in span:
            page = int(page_table[bi, i])
            tiles += plan.box((page, page + 1), (hk, hk + 1), (r0, r0 + n),
                              (0, d))
        return tiles

    q_rows, o_rows, length, keys = stream_accesses(q, rows, count_tiles,
                                                   kv_tiles)

    def table_row(blk, page_table, lengths):
        bi, _, span, _ = _cell(blk, h, rows, count_tiles(lengths))
        return plan.box((bi, bi + 1), (span[0][0], span[-1][0] + 1)) \
            if span else []

    accesses = [
        plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
        plan.Access("k_pages", "in", plan.shape_of(k_pages), q.dtype, keys),
        plan.Access("v_pages", "in", plan.shape_of(v_pages), q.dtype, keys),
        plan.Access("page_table", "in", plan.shape_of(page_table), plan.I32,
                    table_row),
        plan.Access("lengths", "in", (bsz,), plan.I32, length),
        plan.Access("o", "out", plan.shape_of(q), q.dtype, o_rows)]
    stages, smem = stream_smem(q.element_size(), d, rows, ps, pmax, True)
    return plan.make(
        entry, LIB, (bsz * (h // rows) * PAGED_DECODE_CLUSTER,),
        PAGED_DECODE_WARPS * 32, smem, accesses,
        (bsz, h, hkv, num_pages, ps, pmax, d, DECODE_TILE_ROWS, float(scale),
         code), _SIGNATURE,
        (bsz, h, hkv, num_pages, ps, pmax, d, DECODE_TILE_ROWS, code),
        gathered=("page_table", "lengths"), stage=stages)


def plan_paged_attention(q, k_pages, v_pages, page_table, lengths,
                         scale: float | None = None):
    return plan_paged(KERNEL, q, k_pages, v_pages, page_table, lengths,
                      1.0 / q.shape[-1] ** 0.5 if scale is None else scale)
