"""The cluster-split page stream of `paged_decode_fused`: its launch plan,
its split and merge emulated on the CPU against the JAX package, and on
the card the kernel against its plain version.

`paged_decode_fused` runs the tile stream of csrc/decode_common.cuh
(namespace `pc`); at page sizes up to DECODE_TILE_ROWS its tiles are the
pages (tests/test_torch_decode_tiles_sm90.py holds larger pages and the
other two entries): a cluster of PAGED_DECODE_CLUSTER blocks per (slot,
KV head); block r takes the span [r n, min((r + 1) n, live)) of the
slot's live pages, n = ceil(live / PAGED_DECODE_CLUSTER), and streams
each page's live K and V rows through a ring of 1-D bulk copies; per
page it takes one max and one rescale per query row (as the Pallas body
does) and accumulates P V in f32; rank 0 then merges the blocks' (m, l,
acc) in rank order and divides with the guard (a slot of length 0 gives
zeros).

  * plan tests on meta tensors, at G = 1 and 4 and page sizes 16 and 5:
    the geometry, the spans cover [0, live pages) once, one writer per o
    element, and only live rows and live table entries are read;
  * the split and the rank-order merge emulated in f32 with a per-page
    max and exp against the JAX package's `paged_attention_fused` (impl
    "xla") at lengths 0, 1, a ragged page, full and past the table, and
    at one small case against its Pallas kernel in interpret mode, within
    1e-5 of the largest |o| in f32;
  * a `gpu`-marked test (skips without a card): the kernel against its
    plain version, twice for equal bits.

~3 s on the CPU.  Where JAX is installed the reference runs on the
CPU, in f32 (JAX on a card computes an f32 dot in TF32 by default, which
alone exceeds the 1e-5 limit); the machine with the card has JAX with a
CUDA backend, so the pin matters there.
"""
import numpy as np
import pytest
import torch

try:
    import functools

    import jax

    # the reference on the CPU, where an f32 dot is an f32 dot
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    # one compile per shape
    _jax_paged_xla = jax.jit(functools.partial(jops.paged_attention_fused,
                                               backend="xla"))
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.check import bounds
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import paged_attention as tpg
from repro_torch.kernels import plan
from repro_torch.kernels.defaults import PAGED_DECODE_CLUSTER, \
    PAGED_DECODE_RING, PAGED_DECODE_WARPS

BF16, F32 = torch.bfloat16, torch.float32
C = PAGED_DECODE_CLUSTER
F32_REL = 1e-5
BF16_REL = 2.0 ** -7
NEG = -1e30          # the kernel's running max before any key


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _table(rng, b, pmax, ps, lengths, num_pages):
    """Each slot's live pages drawn from a shuffled arena, the sink page
    (the last) beyond them."""
    perm = rng.permutation(num_pages - 1)[:b * pmax].reshape(b, pmax)
    live = [-(-min(n, pmax * ps) // ps) for n in lengths]
    table = np.full((b, pmax), num_pages - 1, np.int32)
    for i, n in enumerate(live):
        table[i, :n] = perm[i, :n]
    return table


def _plan(b, h, hkv, ps, pmax, d=128, dtype=BF16):
    num_pages = b * pmax + 1
    arena = _meta(num_pages, hkv, ps, d, dtype=dtype)
    return tdf.plan_paged_decode_fused(
        _meta(b, h, 1, d, dtype=dtype), arena, arena,
        _meta(b, pmax, dtype=torch.int32), _meta(b, dtype=torch.int32))


@pytest.mark.parametrize("g", [1, 4])
def test_cluster_plan(g):
    """The serving shape (B = 8, Hkv = 16 / G, D = 128, ps = 16, Pmax = 34)
    and ps = 5 (Pmax = 109): PAGED_DECODE_CLUSTER blocks of
    PAGED_DECODE_WARPS warps per (slot, KV head), a ring of
    PAGED_DECODE_RING pages of K and V and the rows beside it.  On a
    small arena at lengths 0, 1, ragged, full and past the table: each
    (slot, KV head)'s blocks read its live pages once between them, each
    only its live rows, their table entries as disjoint spans covering
    [0, live pages), and rank 0 alone writes o, once per element."""
    d, hkv = 128, 16 // g
    for ps in (16, 5):
        pmax = -(-544 // ps)
        assert tpg.tiling(ps) == (ps, 1)   # a page is a tile
        p = _plan(8, 16, hkv, ps, pmax)
        span = -(-pmax // C)
        stages = min(PAGED_DECODE_RING, span)
        end = stages * 2 * ps * d * 2 + g * d * 4 + 2 * g * ps * 4 \
            + (PAGED_DECODE_WARPS + 4) * g * 4 + span * 4
        assert (p.grid, p.threads, p.stage) == (
            (8 * hkv * C, 1, 1), 32 * PAGED_DECODE_WARPS, stages)
        assert p.smem == -(-end // 8) * 8 + 8 * stages <= plan.MAX_SMEM
    assert _plan(8, 16, 16, 16, 34).smem == 33512

    rng = np.random.default_rng(61)
    b, h, hkv, ps, pmax = 5, 2 * g, 2, 5, 7
    lengths = np.array([0, 1, 3 * ps + 2, pmax * ps, pmax * ps + 7],
                       np.int32)
    num_pages = b * pmax + 1
    table = _table(rng, b, pmax, ps, lengths, num_pages)
    p = _plan(b, h, hkv, ps, pmax, d=32)
    acc = {a.name: a for a in p.accesses}
    written = np.zeros((b, h, 1, 32), int)
    for cell in range(b * hkv):
        bi, hk = divmod(cell, hkv)
        n = min(int(lengths[bi]), pmax * ps)
        live = -(-n // ps)
        spans, reads = [], []
        for rank in range(C):
            blk = (cell * C + rank, 0, 0)
            for t in acc["page_table"].tile(blk, table, lengths):
                spans.append(t.ranges[1])
            for name in ("k_pages", "v_pages"):
                reads += [(name,) + t.ranges
                          for t in acc[name].tile(blk, table, lengths)]
            for t in acc["o"].tile(blk, table, lengths):
                assert rank == 0
                written[tuple(slice(*r) for r in t.ranges)] += 1
        assert sorted(spans) == spans and all(
            x[1] == y[0] for x, y in zip(spans, spans[1:]))
        assert [s for s in spans if s[1] > s[0]] == spans
        assert (spans[0][0], spans[-1][1]) == (0, live) if live else \
            spans == []
        want = sorted((name, (int(table[bi, i]), int(table[bi, i]) + 1),
                       (hk, hk + 1), (0, min(ps, n - i * ps)), (0, 32))
                      for name in ("k_pages", "v_pages")
                      for i in range(live))
        assert sorted(reads) == want, (bi, hk)
    assert (written == 1).all()


def _emulate_cluster(q, k_pages, v_pages, table, lengths):
    """paged_decode_fused's cluster body in f32: per (slot, KV head), block
    r scores its span's pages one at a time (scale 1/sqrt(D) on q), takes
    the page's max, m_new = max(m, page max), corr = exp(m - m_new), p =
    exp(s - m_new), l = corr l + sum p, acc = corr acc + p V; rank 0 then
    merges the blocks in rank order, f_r = exp(m_r - max m), l = f_r l_r
    + l, a = f_r acc_r + a, and o = a / l with l <= 0 read as 1."""
    b, h, _, d = q.shape
    _, hkv, ps, _ = k_pages.shape
    pmax = table.shape[1]
    g = h // hkv
    qf = q.float().reshape(b, hkv, g, d) / d ** 0.5
    o = torch.zeros(b, hkv, g, d)
    for bi in range(b):
        n = max(0, min(int(lengths[bi]), pmax * ps))
        live = -(-n // ps)
        span = -(-live // C)
        for hk in range(hkv):
            parts = []
            for rank in range(C):
                m = torch.full((g, 1), NEG)
                l_run, acc = torch.zeros(g, 1), torch.zeros(g, d)
                first = min(rank * span, live)
                for i in range(first, min(first + span, live)):
                    rows = min(ps, n - i * ps)
                    page = int(table[bi, i])
                    kk = k_pages[page, hk, :rows].float()
                    vv = v_pages[page, hk, :rows].float()
                    s = qf[bi, hk] @ kk.T
                    m_new = torch.maximum(m, s.max(1, keepdim=True).values)
                    corr = torch.exp(m - m_new)
                    p = torch.exp(s - m_new)
                    l_run = corr * l_run + p.sum(1, keepdim=True)
                    acc = corr * acc + p @ vv
                    m = m_new
                parts.append((m, l_run, acc))
            m_all = torch.stack([x[0] for x in parts]).max(0).values
            l_all, a_all = torch.zeros(g, 1), torch.zeros(g, d)
            for m, l_run, acc in parts:
                f = torch.exp(m - m_all)
                l_all = f * l_run + l_all
                a_all = f * acc + a_all
            o[bi, hk] = a_all / torch.where(l_all <= 0, 1.0, l_all)
    return o.reshape(b, h, 1, d)


def _case(rng, b, h, hkv, d, ps, pmax, lengths):
    num_pages = b * pmax + 1
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
              for _ in range(2))
    table = _table(rng, b, pmax, ps, lengths, num_pages)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


def test_emulated_cluster_merge_matches_jax_xla():
    """The split over PAGED_DECODE_CLUSTER blocks and the rank-order merge
    keep o within 1e-5 (f32) of the JAX package's fused paged decode
    (impl "xla") at G = 1 and 4, page sizes 16 and 5, lengths 0, 1, a
    ragged page, full and past the table (fewer live pages than blocks,
    and empty spans, included); length 0 gives zeros."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(62)
    for g, ps, pmax in ((1, 16, 5), (4, 5, 9)):
        lengths = [0, 1, 2 * ps + 3, pmax * ps, pmax * ps + 7]
        q, kp, vp, table, lens = _case(rng, 5, 2 * g, 2, 64, ps, pmax,
                                       lengths)
        want = _jax_paged_xla(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table), jnp.asarray(lens))
        got = _emulate_cluster(*(torch.from_numpy(x) for x in
                                 (q, kp, vp, table, lens)))
        assert float(got[0].abs().max()) == 0.0
        assert _rel(got, np.asarray(want)) <= F32_REL, (g, ps)


def test_emulated_cluster_merge_matches_jax_pallas():
    """At one small case (G = 2, page size 5, lengths 0, ragged and full),
    the emulation against the JAX package's Pallas kernel in interpret
    mode, within 1e-5 in f32."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(63)
    ps, pmax = 5, 6
    q, kp, vp, table, lens = _case(rng, 3, 4, 2, 32, ps, pmax,
                                   [0, 2 * ps + 3, pmax * ps])
    want = jops.paged_attention_fused(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), backend="pallas_interpret")
    got = _emulate_cluster(*(torch.from_numpy(x) for x in
                             (q, kp, vp, table, lens)))
    assert _rel(got, np.asarray(want)) <= F32_REL


@pytest.mark.gpu
def test_cuda_paged_cluster_matches_plain():
    """The kernel (the cluster body, from the plan) against its plain
    version at G = 1 (ps = 16) and G = 4 (ps = 5), bf16 and f32, lengths
    0, 1, ragged, full and past the table: o within one bf16 step (bf16)
    or 1e-5 (f32) of the largest |o|, zeros at length 0, and a second
    launch bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(64)
    for g, ps, pmax in ((1, 16, 34), (4, 5, 109)):
        lengths = [0, 1, 3 * ps + 2, pmax * ps, pmax * ps + 7, 17, 100, 544]
        case = _case(rng, 8, 16, 16 // g, 128, ps, pmax, lengths)
        for dtype, rel in ((BF16, BF16_REL), (F32, F32_REL)):
            q, kp, vp, table, lens = (torch.from_numpy(x).to(dev)
                                      for x in case)
            q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
            p = tdf.plan_paged_decode_fused(q, kp, vp, table, lens)
            assert bounds.c_plan(p)[:5] == p.grid + (p.threads, p.smem)
            o1 = tdf.paged_decode_fused_cuda(q, kp, vp, table, lens)
            o2 = tdf.paged_decode_fused_cuda(q, kp, vp, table, lens)
            torch.cuda.synchronize()
            want = tdf.paged_decode_fused_torch(q, kp, vp, table, lens)
            assert torch.equal(o1, o2)
            assert float(o1[0].abs().max()) == 0.0
            assert _rel(o1.float().cpu(), want.float().cpu()) <= rel, \
                (g, dtype)
