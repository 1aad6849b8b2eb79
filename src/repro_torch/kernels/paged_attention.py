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
                         one block per (slot, query head), reading KV
                         head h // G through the table); CUDA only

Both take q (B, H, 1, D) and the arenas in the compute dtype, the table
and lengths (B,) int32, and an optional score scale (default 1/sqrt(D),
as `paged_attention_pallas`'s); they return o (B, H, 1, D) in q.dtype.
Lengths past Pmax * ps attend to all Pmax * ps keys; a slot of length 0
yields zeros on both.  Every table entry a slot's live keys reach must
name an arena page: the engine points unallocated entries at its sink
page, and the kernel traps on an entry outside the arena.

`launch_paged` is shared with the head-folded variant
(`decode_fused.py::paged_decode_fused_cuda`, entry `paged_decode_fused`),
and so is `plan_paged`, the launch plan (kernels/plan.py) of either
entry.  `paged_decode_body` says which body the head-folded entry runs:
"cluster" (a cluster of PAGED_DECODE_CLUSTER blocks per (slot, KV head),
each streaming a contiguous span of the slot's live pages by 1-D bulk
copies, merged in rank order through distributed shared memory) or
"walk" (one block per (slot, KV head), the walk `paged_attention`
runs).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import softmax as _softmax
from repro_torch.kernels import build, plan
from repro_torch.kernels.defaults import PAGED_DECODE_CLUSTER, \
    PAGED_DECODE_RING, PAGED_DECODE_WARPS, SOFTMAX_DECODE_WARPS

LIB = "paged_decode"
KERNEL = "paged_attention"
# head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)

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
            hkv, num_pages, ps, page_table.shape[1], d, SOFTMAX_DECODE_WARPS,
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


def _span_max(pmax: int) -> int:
    """The most live pages one block of a cluster takes."""
    return -(-pmax // PAGED_DECODE_CLUSTER)


def _cluster_smem(itemsize: int, d: int, ps: int, pmax: int, group: int,
                  stages: int) -> int:
    """Dynamic shared memory of the cluster body, as csrc/paged_decode.cu's
    `pc::layout`: the ring of `stages` pages of K and V rows (after the
    stream, the block's G x D f32 acc), the scaled query rows (G x D
    f32), the scores and probabilities (G x ps f32 each), the warps' page
    maxima (PAGED_DECODE_WARPS x G f32), the running max by page parity
    (2 x G), l and the final max (G each), the span's table entries, and
    an mbarrier per stage."""
    ring = stages * 2 * ps * d * itemsize
    acc = group * d * 4
    end = -(-max(ring, acc) // 16) * 16 + acc + 2 * group * ps * 4 \
        + (PAGED_DECODE_WARPS + 4) * group * 4 + _span_max(pmax) * 4
    return -(-end // 8) * 8 + 8 * stages


def _cluster_stages(itemsize, d, ps, pmax, group) -> int:
    """`pc::stages_for`: at most PAGED_DECODE_RING and one per page of the
    longest span, at least 2, as many as fit."""
    stages = max(2, min(PAGED_DECODE_RING, _span_max(pmax)))
    while stages > 2 and _cluster_smem(itemsize, d, ps, pmax, group,
                                       stages) > plan.MAX_SMEM:
        stages -= 1
    return stages


def paged_decode_body(dtype: torch.dtype, d: int, ps: int, pmax: int,
                      group: int) -> str:
    """The body `paged_decode_fused` runs at these shapes: "cluster" where
    a ring of two pages fits, else "walk" (`paged_attention` always
    walks).  A page's rows for one KV head are 16-byte-aligned contiguous
    bytes at every head dim the launcher admits (32, 64, 128)."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return ("cluster" if _cluster_smem(itemsize, d, ps, pmax, group, 2)
            <= plan.MAX_SMEM else "walk")


def plan_paged(entry, q, k_pages, v_pages, page_table, lengths,
               scale: float):
    """`paged_attention` (one block per (slot, query head)) or
    `paged_decode_fused` (its G rows per (slot, KV head)).  The walk's
    block stages the slot's live table entries, ceil(min(lengths[b], Pmax
    ps) / ps) of them, and reads the live rows of each such page.  The
    cluster body's block r of (slot, KV head) takes the span [r n, min((r
    + 1) n, live)) of those pages, n = ceil(live / PAGED_DECODE_CLUSTER):
    its table entries and each page's live rows; rank 0 writes o."""
    bsz, h, hkv, num_pages, ps, pmax, d = paged_dims(q, k_pages, v_pages,
                                                     page_table, lengths)
    group = h // hkv
    fused = entry == "paged_decode_fused"
    rows = group if fused else 1
    code = plan.dtype_code(q.dtype)
    cluster = fused and paged_decode_body(q.dtype, d, ps, pmax,
                                          group) == "cluster"
    ranks = PAGED_DECODE_CLUSTER if cluster else 1

    def slot(blk, lengths):
        """(slot, first query head, live keys, first page, pages) of a
        block: the walk's whole slot, or the cluster rank's span."""
        cell, rank = divmod(blk[0], ranks)
        bi, r = divmod(cell, h // rows)
        live = max(0, min(int(lengths[bi]), pmax * ps))
        pages = -(-live // ps)
        span = -(-pages // ranks)
        first = min(rank * span, pages)
        return bi, r * rows, live, first, min(first + span, pages) - first

    def q_rows(blk, page_table, lengths):
        bi, h0, *_ = slot(blk, lengths)
        return plan.box((bi, bi + 1), (h0, h0 + rows), (0, 1), (0, d))

    def o_rows(blk, page_table, lengths):
        # the cluster's rank 0 writes the merged rows
        return q_rows(blk, page_table, lengths) if blk[0] % ranks == 0 \
            else []

    def table_row(blk, page_table, lengths):
        bi, _, _, first, n = slot(blk, lengths)
        return plan.box((bi, bi + 1), (first, first + n)) if n else []

    def pages(blk, page_table, lengths):
        bi, h0, live, first, n = slot(blk, lengths)
        hk = h0 // group
        tiles = []
        for i in range(first, first + n):
            page = int(page_table[bi, i])
            tiles += plan.box((page, page + 1), (hk, hk + 1),
                              (0, min(ps, live - i * ps)), (0, d))
        return tiles

    def length(blk, page_table, lengths):
        bi = slot(blk, lengths)[0]
        return plan.box((bi, bi + 1))

    accesses = [
        plan.Access("q", "in", plan.shape_of(q), q.dtype, q_rows),
        plan.Access("k_pages", "in", plan.shape_of(k_pages), q.dtype, pages),
        plan.Access("v_pages", "in", plan.shape_of(v_pages), q.dtype, pages),
        plan.Access("page_table", "in", plan.shape_of(page_table), plan.I32,
                    table_row),
        plan.Access("lengths", "in", (bsz,), plan.I32, length),
        plan.Access("o", "out", plan.shape_of(q), q.dtype, o_rows)]
    warps = SOFTMAX_DECODE_WARPS
    if cluster:
        itemsize = q.element_size()
        stages = _cluster_stages(itemsize, d, ps, pmax, group)
        threads, stage = PAGED_DECODE_WARPS * 32, stages
        smem = _cluster_smem(itemsize, d, ps, pmax, group, stages)
    else:
        threads, stage = warps * 32, None
        smem = warps * rows * (d + 2) * 4 + pmax * 4
    return plan.make(
        entry, LIB, (bsz * (h // rows) * ranks,), threads, smem, accesses,
        (bsz, h, hkv, num_pages, ps, pmax, d, warps, float(scale), code),
        _SIGNATURE, (bsz, h, hkv, num_pages, ps, pmax, d, warps, code),
        gathered=("page_table", "lengths"), stage=stage)


def plan_paged_attention(q, k_pages, v_pages, page_table, lengths,
                         scale: float | None = None):
    return plan_paged(KERNEL, q, k_pages, v_pages, page_table, lengths,
                      1.0 / q.shape[-1] ** 0.5 if scale is None else scale)
