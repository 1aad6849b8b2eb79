"""The tile stream of the softmax decode kernels: `softmax_decode_fused`
(contiguous cache), `paged_attention` (a cell per (slot, query head)) and
`paged_decode_fused` (a cell per (slot, KV head)) at shapes beyond the
page stream's (tests/test_torch_paged_stream_sm90.py): their launch
plans, the tile split and merge emulated on the CPU against the JAX
package, and on the card the kernels against their plain versions.

All three run csrc/decode_common.cuh's `pc::stream_kernel`: a cell's live
keys are a run of tiles of at most DECODE_TILE_ROWS rows contiguous in
memory (a page of at most that many rows is one tile, a larger page and
a contiguous cache's S rows are cut into tiles of that many rows, the
last shorter); PAGED_DECODE_CLUSTER blocks split them into contiguous
spans, each streams its tiles with one max and one rescale per tile, and
rank 0 merges the blocks in rank order (a slot of length 0 gives zeros).

  * plan tests on meta tensors: the contiguous cache at S = 544 and a
    ragged S, `paged_attention` at G = 1 (the same launch as
    `paged_decode_fused`) and G = 4, and pages of 256 rows in bf16 and
    f32 (16 tiles a page): tiles cover [0, live) once, one writer per o
    element, only live rows and live table entries are read;
  * the split and merge emulated in f32 against the JAX package's
    `softmax_decode_fused` and `paged_attention` (impl "xla") at lengths
    1, ragged, full and past S or the table, and against their Pallas
    kernels in interpret mode at one small case each, within 1e-5 of
    max |o|; length 0 gives zeros, as the Pallas kernels do;
  * a `gpu`-marked test (skips without a card): each entry against its
    plain version, a second launch bit-equal, the plan equal to the
    launcher's C export.

A few seconds on the CPU.  Where JAX is installed the reference runs on
the CPU, in f32 (JAX on a card computes an f32 dot in TF32 by default);
the machine with the card has JAX with a CUDA backend, so the pin
matters there.
"""
import numpy as np
import pytest
import torch

try:
    import jax

    # the reference on the CPU, where an f32 dot is an f32 dot
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from repro.kernels import ops as jops
except ImportError:   # the port alone
    jnp = None

from repro_torch.check import bounds
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import paged_attention as tpg
from repro_torch.kernels import plan
from repro_torch.kernels.defaults import DECODE_TILE_ROWS, \
    PAGED_DECODE_CLUSTER, PAGED_DECODE_RING, PAGED_DECODE_WARPS

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32
C = PAGED_DECODE_CLUSTER
F32_REL = 1e-5
BF16_REL = 2.0 ** -7
NEG = -1e30          # the kernel's running max before any key


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _smem(itemsize, d, rows, tr, span, table, stages):
    """`pc::layout`'s total, written out."""
    ring = stages * 2 * tr * d * itemsize
    end = -(-max(ring, rows * d * 4) // 16) * 16 + rows * d * 4 \
        + 2 * rows * tr * 4 + (PAGED_DECODE_WARPS + 4) * rows * 4 \
        + table * 4
    return -(-end // 8) * 8 + 8 * stages


def _table(rng, b, pmax, ps, lengths, num_pages):
    """Each slot's live pages drawn from a shuffled arena, the sink page
    (the last) beyond them."""
    perm = rng.permutation(num_pages - 1)[:b * pmax].reshape(b, pmax)
    table = np.full((b, pmax), num_pages - 1, np.int32)
    for i, n in enumerate(lengths):
        live = -(-min(n, pmax * ps) // ps)
        table[i, :live] = perm[i, :live]
    return table


def _reads(p, gathered, n_cells):
    """Per cell, the rows its C blocks read through the first K/V operand
    (in rank order, each a (leading ranges, row) pair), the table
    entries they read, and how often each o element is written (by rank
    0 alone)."""
    acc = {a.name: a for a in p.accesses}
    kv = p.accesses[1]
    written = np.zeros(acc["o"].shape, int)
    cells = []
    for cell in range(n_cells):
        rows, entries = [], []
        for rank in range(C):
            blk = (cell * C + rank, 0, 0)
            for t in kv.tile(blk, *gathered):
                *lead, (r0, r1), cols = t.ranges
                assert not t.masked and cols == (0, kv.shape[-1])
                rows += [(tuple(lead), r) for r in range(r0, r1)]
            if "page_table" in acc:
                for t in acc["page_table"].tile(blk, *gathered):
                    (b0, b1), (e0, e1) = t.ranges
                    entries += [(b0, e) for e in range(e0, e1)]
            for t in acc["o"].tile(blk, *gathered):
                assert rank == 0
                written[tuple(slice(*r) for r in t.ranges)] += 1
        cells.append((rows, entries))
    return cells, written


def _paged_rows(table, bi, hk, n, ps):
    """The (leading ranges, row) pairs of a paged cell's first n keys, in
    key order, and the table entries that hold them."""
    rows = [(((int(table[bi, j // ps]), int(table[bi, j // ps]) + 1),
              (hk, hk + 1)), j % ps) for j in range(n)]
    return rows, [(bi, e) for e in range(-(-n // ps))]


def test_contiguous_plan():
    """softmax_decode_fused at the serving shape (B = 8, D = 128, bf16) at
    G = 1 and 4: a cluster of C blocks of PAGED_DECODE_WARPS warps per
    (slot, KV head), tiles of DECODE_TILE_ROWS rows, a ring of up to
    PAGED_DECODE_RING tiles, no table.  On a small cache (S ragged
    against the tile) at lengths 0, 1, ragged, full and past S: each
    cell's blocks read its live prefix once, in order, and rank 0 alone
    writes o."""
    tr = DECODE_TILE_ROWS
    for s_len in (544, 537):
        for g in (1, 4):
            hkv = 16 // g
            q, kv = _meta(8, 16, 1, 128), _meta(8, hkv, s_len, 128)
            p = tdf.plan_softmax_decode_fused(q, kv, kv,
                                              _meta(8, dtype=I32))
            span = -(-(-(-s_len // tr)) // C)
            stages = min(PAGED_DECODE_RING, span)
            assert (p.grid, p.threads, p.stage) == (
                (8 * hkv * C, 1, 1), 32 * PAGED_DECODE_WARPS, stages)
            assert p.smem == _smem(2, 128, g, tr, span, 0, stages)
            assert p.args[5] == tr and p.plan_args[5] == tr

        b, h, hkv, d = 5, 4, 2, 32
        s = s_len - 500          # 44 and 37 rows: 3 tiles, the last ragged
        lengths = np.array([0, 1, s // 2 + 3, s, s + 7], np.int32)
        q, kv = _meta(b, h, 1, d, dtype=F32), _meta(b, hkv, s, d, dtype=F32)
        p = tdf.plan_softmax_decode_fused(q, kv, kv, _meta(b, dtype=I32))
        assert p.gathered == ("lengths",)
        cells, written = _reads(p, (lengths,), b * hkv)
        for cell, (rows, entries) in enumerate(cells):
            bi, hk = divmod(cell, hkv)
            assert rows == [(((bi, bi + 1), (hk, hk + 1)), r)
                            for r in range(min(int(lengths[bi]), s))], cell
        assert (written == 1).all()


def test_paged_attention_plan():
    """paged_attention (a cell per (slot, query head), R = 1) at the
    serving shape (B = 8, H = 16, D = 128, ps = 16, Pmax = 34): at G = 1
    the very launch of paged_decode_fused, block by block.  On a small
    shuffled arena at page sizes 5 and 16, lengths 0, 1, ragged, full and
    past the table: each cell's blocks read the live rows of KV head h //
    G once, in key order, and only the live table entries; rank 0 alone
    writes o."""
    for g in (1, 4):
        hkv = 16 // g
        arena = _meta(8 * 34 + 1, hkv, 16, 128)
        args = (_meta(8, 16, 1, 128), arena, arena, _meta(8, 34, dtype=I32),
                _meta(8, dtype=I32))
        p = tpg.plan_paged_attention(*args)
        span = -(-34 // C)
        assert (p.grid, p.threads, p.stage) == ((8 * 16 * C, 1, 1),
                                                32 * PAGED_DECODE_WARPS, 4)
        assert p.smem == _smem(2, 128, 1, 16, span, span, 4)
        if g == 1:
            f = tdf.plan_paged_decode_fused(*args)
            assert (f.grid, f.threads, f.smem, f.stage, f.plan_args[1:]) == (
                p.grid, p.threads, p.smem, p.stage, p.plan_args[1:])

        rng = np.random.default_rng(71)
        b, h, hkv, d = 5, 2 * g, 2, 32
        for ps, pmax in ((5, 7), (16, 3)):
            lengths = np.array([0, 1, 2 * ps + 2, pmax * ps, pmax * ps + 7],
                               np.int32)
            num_pages = b * pmax + 1
            table = _table(rng, b, pmax, ps, lengths, num_pages)
            arena = _meta(num_pages, hkv, ps, d, dtype=F32)
            q = _meta(b, h, 1, d, dtype=F32)
            tb, ln = _meta(b, pmax, dtype=I32), _meta(b, dtype=I32)
            p = tpg.plan_paged_attention(q, arena, arena, tb, ln)
            cells, written = _reads(p, (table, lengths), b * h)
            for cell, (rows, entries) in enumerate(cells):
                bi, hq = divmod(cell, h)
                n = min(int(lengths[bi]), pmax * ps)
                assert (rows, entries) == _paged_rows(table, bi, hq // g, n,
                                                      ps)
            assert (written == 1).all()
            if g == 1:
                f = tdf.plan_paged_decode_fused(q, arena, arena, tb, ln)
                assert _reads(f, (table, lengths), b * hkv)[0] == cells


def test_large_page_plan():
    """Pages of 256 rows, beyond a ring of two pages at D = 128 (the page
    stream's limit, ~194-224 rows in bf16): both paged entries cut each
    page into 16 tiles of DECODE_TILE_ROWS rows, a block's span and its
    staged entries counted in tiles.  On a small arena at lengths 0, 1,
    ragged, full and past the table: each cell reads its live rows once,
    in key order, through its live table entries; rank 0 writes o."""
    for dtype in (BF16, F32):
        tr = DECODE_TILE_ROWS
        assert tpg.tiling(256) == (tr, 256 // tr)
        itemsize = torch.tensor([], dtype=dtype).element_size()
        for g in (1, 4):
            hkv = 16 // g
            arena = _meta(8 * 3 + 1, hkv, 256, 128, dtype=dtype)
            args = (_meta(8, 16, 1, 128, dtype=dtype), arena, arena,
                    _meta(8, 3, dtype=I32), _meta(8, dtype=I32))
            span = -(-3 * (256 // tr) // C)
            for fn, rows, cells in ((tdf.plan_paged_decode_fused, g, hkv),
                                    (tpg.plan_paged_attention, 1, 16)):
                p = fn(*args)
                assert (p.grid, p.stage) == ((8 * cells * C, 1, 1), 4)
                assert p.smem == _smem(itemsize, 128, rows, tr, span, span, 4)
                assert p.smem <= plan.MAX_SMEM
        # a ring of two tiles of the most rows the C entries admit fits at
        # f32, D = 128, G = 16
        assert _smem(4, 128, 16, tpg.MAX_TILE_ROWS, 1, 1, 2) <= plan.MAX_SMEM

        rng = np.random.default_rng(72)
        b, h, hkv, d, ps, pmax = 5, 2, 2, 32, 256, 3
        lengths = np.array([0, 1, 300, pmax * ps, pmax * ps + 7], np.int32)
        num_pages = b * pmax + 1
        table = _table(rng, b, pmax, ps, lengths, num_pages)
        arena = _meta(num_pages, hkv, ps, d, dtype=dtype)
        for fn in (tdf.plan_paged_decode_fused, tpg.plan_paged_attention):
            p = fn(_meta(b, h, 1, d, dtype=dtype), arena, arena,
                   _meta(b, pmax, dtype=I32), _meta(b, dtype=I32))
            cells, written = _reads(p, (table, lengths), b * hkv)
            for cell, (rows, entries) in enumerate(cells):
                bi, hk = divmod(cell, hkv)
                n = min(int(lengths[bi]), pmax * ps)
                want_rows, want_entries = _paged_rows(table, bi, hk, n, ps)
                assert rows == want_rows
                # a block stages the entry of each of its tiles
                assert sorted(set(entries)) == want_entries
            assert (written == 1).all()


def _emulate(q, cells, rows):
    """The stream in f32: per cell (slot, first query row, KV tiles), block
    r scores its span of tiles one at a time (scale 1/sqrt(D) on q),
    takes the tile's max, m_new = max(m, tile max), corr = exp(m -
    m_new), p = exp(s - m_new), l = corr l + sum p, acc = corr acc + p V;
    rank 0 then merges the blocks in rank order, f_r = exp(m_r - max m),
    l = f_r l_r + l, a = f_r acc_r + a, and o = a / l with l <= 0 read as
    1."""
    d = q.shape[-1]
    o = torch.zeros(q.shape)
    for bi, h0, tiles in cells:
        qf = q[bi, h0:h0 + rows, 0].float() / d ** 0.5
        parts = []
        for first, end in tpg.spans(len(tiles)):
            m = torch.full((rows, 1), NEG)
            l_run, acc = torch.zeros(rows, 1), torch.zeros(rows, d)
            for kk, vv in tiles[first:end]:
                s = qf @ kk.float().T
                m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l_run = corr * l_run + p.sum(1, keepdim=True)
                acc = corr * acc + p @ vv.float()
                m = m_new
            parts.append((m, l_run, acc))
        m_all = torch.stack([x[0] for x in parts]).max(0).values
        l_all, a_all = torch.zeros(rows, 1), torch.zeros(rows, d)
        for m, l_run, acc in parts:
            f = torch.exp(m - m_all)
            l_all = f * l_run + l_all
            a_all = f * acc + a_all
        o[bi, h0:h0 + rows, 0] = a_all / torch.where(l_all <= 0, 1.0, l_all)
    return o


def _emulate_contiguous(q, k, v, lengths):
    """softmax_decode_fused: a cell per (slot, KV head), its G rows, the
    tiles of rows of the slot's (S, D) block."""
    b, h = q.shape[:2]
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    cells = [(bi, hk * g, [(k[bi, hk, r0:r0 + n], v[bi, hk, r0:r0 + n])
                           for _, r0, n in tpg.live_tiles(lengths[bi], s, 1)])
             for bi in range(b) for hk in range(hkv)]
    return _emulate(q, cells, g)


def _emulate_paged(q, kp, vp, table, lengths, fold):
    """paged_decode_fused (fold: a cell per (slot, KV head), its G rows)
    or paged_attention (a cell per (slot, query head)): the tiles of rows
    of the table's pages."""
    b, h = q.shape[:2]
    hkv, ps, pmax = kp.shape[1], kp.shape[2], table.shape[1]
    g = h // hkv
    rows = g if fold else 1
    cells = []
    for bi in range(b):
        tiles = tpg.live_tiles(lengths[bi], ps, pmax)
        for h0 in range(0, h, rows):
            hk = h0 // g
            cells.append((bi, h0, [
                (kp[int(table[bi, i]), hk, r0:r0 + n],
                 vp[int(table[bi, i]), hk, r0:r0 + n])
                for i, r0, n in tiles]))
    return _emulate(q, cells, rows)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def _contiguous_case(rng, b, h, hkv, s, d, lengths):
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, np.asarray(lengths, np.int32)


def _paged_case(rng, b, h, hkv, d, ps, pmax, lengths):
    num_pages = b * pmax + 1
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
              for _ in range(2))
    table = _table(rng, b, pmax, ps, lengths, num_pages)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(x) for x in arrays]


def test_emulated_tiles_match_jax_xla():
    """The tiles, the split over C blocks and the rank-order merge keep o
    within 1e-5 (f32) of the JAX package (impl "xla") at G = 4: the
    contiguous cache (S = 45, three tiles, the last ragged) against
    `softmax_decode_fused` at lengths 1, ragged, full and past S (its xla
    impl averages the values at length 0, so that is held apart), and
    pages of 40 rows (three tiles a page) at lengths 0, 1, ragged, full
    and past the table, paged_attention against `paged_attention` and
    paged_decode_fused against `paged_attention_fused`."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(73)
    s = 45
    q, k, v, lens = _contiguous_case(rng, 4, 8, 2, s, 64,
                                     [1, 2 * DECODE_TILE_ROWS + 3, s, s + 9])
    want = jops.softmax_decode_fused(*map(jnp.asarray, (q, k, v, lens)),
                                     backend="xla")
    got = _emulate_contiguous(*_torch(q, k, v, lens))
    assert _rel(got, np.asarray(want)) <= F32_REL
    ps, pmax = 40, 3
    case = _paged_case(rng, 5, 8, 2, 64, ps, pmax,
                       [0, 1, ps + 3, pmax * ps, pmax * ps + 7])
    for fold, ref in ((False, jops.paged_attention),
                      (True, jops.paged_attention_fused)):
        got = _emulate_paged(*_torch(*case), fold=fold)
        want = ref(*map(jnp.asarray, case), backend="xla")
        assert float(got[0].abs().max()) == 0.0
        assert _rel(got, np.asarray(want)) <= F32_REL, fold


def test_emulated_tiles_match_jax_pallas():
    """At one small case each, the emulation against the JAX package's
    Pallas kernels in interpret mode, within 1e-5 in f32, zeros at
    length 0 on both: `softmax_decode_fused` (G = 2, S = 37, lengths 0,
    ragged and past S) and `paged_attention` (G = 2, page size 20, two
    tiles a page, lengths 0, ragged and full)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(74)
    q, k, v, lens = _contiguous_case(rng, 3, 4, 2, 37, 32, [0, 21, 40])
    want = np.asarray(jops.softmax_decode_fused(
        *map(jnp.asarray, (q, k, v, lens)), backend="pallas_interpret"))
    got = _emulate_contiguous(*_torch(q, k, v, lens))
    assert float(got[0].abs().max()) == 0.0 == float(np.abs(want[0]).max())
    assert _rel(got, want) <= F32_REL
    ps, pmax = 20, 3
    case = _paged_case(rng, 3, 4, 2, 32, ps, pmax, [0, ps + 7, pmax * ps])
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, case),
                                           backend="pallas_interpret"))
    got = _emulate_paged(*_torch(*case), fold=False)
    assert float(got[0].abs().max()) == 0.0 == float(np.abs(want[0]).max())
    assert _rel(got, want) <= F32_REL


def test_length_zero_gives_zeros():
    """A slot of length 0 (or a negative length) has no live tile: its
    cells' blocks read no K, V or table entry, rank 0 still writes its o
    rows, and the merge of empty spans (m = -1e30, l = 0, acc = 0) gives
    zeros, as the Pallas kernels do, for all three entries."""
    rng = np.random.default_rng(75)
    lengths = np.array([0, -3, 9], np.int32)
    q, k, v, lens = _contiguous_case(rng, 3, 4, 2, 20, 32, lengths)
    o = _emulate_contiguous(*_torch(q, k, v, lens))
    assert float(o[:2].abs().max()) == 0.0 < float(o[2].abs().max())
    p = tdf.plan_softmax_decode_fused(*_torch(q, k, v, lens))
    cells, written = _reads(p, (lens,), 3 * 2)
    assert all(rows == [] for rows, _ in cells[:4]) and (written == 1).all()

    case = _paged_case(rng, 3, 4, 2, 32, 20, 2, [0, 0, 9])
    case = case[:4] + (lengths,)
    for fold, fn in ((True, tdf.plan_paged_decode_fused),
                     (False, tpg.plan_paged_attention)):
        o = _emulate_paged(*_torch(*case), fold=fold)
        assert float(o[:2].abs().max()) == 0.0 < float(o[2].abs().max())
        p = fn(*_torch(*case))
        n_cells = 3 * (2 if fold else 4)
        cells, written = _reads(p, (case[3], lengths), n_cells)
        assert all(c == ([], []) for c in cells[:2 * n_cells // 3])
        assert (written == 1).all()


@pytest.mark.gpu
def test_cuda_decode_tiles_match_plain():
    """On the card, each entry on the tile stream against its plain
    version at the serving width (H = 16, D = 128), bf16 and f32: the
    contiguous cache at S = 544 and 537 (G = 1 and 4), paged_attention at
    G = 1 and 4 (page size 16) and both paged entries at pages of 256
    rows; lengths 1, ragged, full and past S or the table; o within one
    bf16 step (bf16) or 1e-5 (f32) of the largest |o|, zeros at length
    0, a second launch bit-equal, and the plan equal to the launcher's C
    export."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(76)

    def check(kernel, plain, plan_fn, args, dtype, zero_at):
        p = plan_fn(*args)
        assert bounds.c_plan(p)[:5] == p.grid + (p.threads, p.smem)
        o1, o2 = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)
        assert float(o1[zero_at].abs().max()) == 0.0
        want = plain(*args)
        keep = torch.ones(o1.shape[0], dtype=torch.bool)
        keep[zero_at] = False   # the contiguous plain version averages
        rel = BF16_REL if dtype == BF16 else F32_REL
        assert _rel(o1[keep].float().cpu(), want[keep].float().cpu()) \
            <= rel, (p.name, dtype)

    for dtype in (BF16, F32):
        for s, g in ((544, 1), (537, 4)):
            case = _contiguous_case(rng, 8, 16, 16 // g, s, 128,
                                    [0, 1, 17, 100, 300, s - 1, s, s + 9])
            q, k, v, lens = (torch.from_numpy(x).to(dev) for x in case)
            args = (q.to(dtype), k.to(dtype), v.to(dtype), lens)
            check(tdf.softmax_decode_fused_cuda,
                  tdf.softmax_decode_fused_torch,
                  tdf.plan_softmax_decode_fused, args, dtype, 0)
        for g, ps, pmax in ((1, 16, 34), (4, 16, 34), (1, 256, 3),
                            (4, 256, 3)):
            lengths = [0, 1, 17, 100, 300, pmax * ps - 1, pmax * ps,
                       pmax * ps + 7]
            case = _paged_case(rng, 8, 16, 16 // g, 128, ps, pmax, lengths)
            q, kp, vp, table, lens = (torch.from_numpy(x).to(dev)
                                      for x in case)
            args = (q.to(dtype), kp.to(dtype), vp.to(dtype), table, lens)
            check(tpg.paged_attention_cuda, tpg.paged_attention_torch,
                  tpg.plan_paged_attention, args, dtype, 0)
            if ps == 256:
                check(tdf.paged_decode_fused_cuda,
                      tdf.paged_decode_fused_torch,
                      tdf.plan_paged_decode_fused, args, dtype, 0)
