"""The launch plans of the flash kernels' wgmma bodies, and on the card the
bf16 kernels against their plain versions.

The bf16 instances of `flash_fwd`, `flash_bwd_q` and `flash_bwd_kv` at
D = 128 run the wgmma body (two warpgroups of 64 rows, TMA-fed rings of
tiles); f32 at every head dim and bf16 at D = 32 and 64 keep the mma.sync
body.  The plan tests read shapes only (meta tensors): geometry and
shared memory within the H100's 232,448 bytes, and tiles that cover the
query rows and keys exactly, at N = 8192, 1000 and a 256-row prefill
window with q_offset, at G = 1 and 4.  The `gpu`-marked test holds the
bf16 kernels at D = 128 to their plain versions at small ragged shapes
(bf16 o within 2^-7 and grads within 2^-5 of the plain version's largest
|value|: P and dS are rounded to bf16 before their products; lse in f32
within 1e-4) and runs the backward twice for bit-equal grads.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfl
from repro_torch.kernels import plan

BF16, F32 = torch.bfloat16, torch.float32
D = 128


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _plans(dtype, b, h, hkv, n, d=D):
    q, kv = _meta(b, h, n, d, dtype=dtype), _meta(b, hkv, n, d, dtype=dtype)
    stats = _meta(b, h, n, dtype=F32)
    return {"flash_fwd": tfl.plan_flash_fwd(q, kv, kv),
            "flash_bwd_q": tfl.plan_flash_bwd_q(q, kv, kv, q, stats, stats),
            "flash_bwd_kv": tfl.plan_flash_bwd_kv(q, kv, kv, q, stats,
                                                  stats)}


def _tiles(launch, name, *gathered):
    """Every block's tile ranges of operand `name`, by block."""
    acc = next(a for a in launch.accesses if a.name == name)
    return {blk: [t.ranges for t in acc.tile(blk, *gathered)]
            for blk in launch.blocks()}


def _count_rows(spans, n, counts):
    """Count every (slot, head, token < n) of one tile's ranges."""
    (b0, b1), (h0, h1), (lo, hi) = spans[:3]
    for key in ((bi, hh, r) for bi in range(b0, b1) for hh in range(h0, h1)
                for r in range(lo, min(hi, n))):
        counts[key] = counts.get(key, 0) + 1


def test_wgmma_plans_geometry():
    """bf16 at D = 128: 256 threads (two warpgroups), the grid of 128-row
    resident tiles, shared memory of the tiles, the ring's stages (3 in
    flash_fwd, 2 in the backward) and 2 KB of barriers and alignment pad,
    within 232,448 bytes."""
    plans = _plans(BF16, 2, 16, 16, 8192)
    want = {"flash_fwd": ((64, 16, 2), 32768 + 3 * 65536 + 2048, 128, 128),
            "flash_bwd_q": ((64, 16, 2), 65536 + 2 * 32768 + 2048, 128, 64),
            "flash_bwd_kv": ((64, 16, 2), 65536 + 2 * 32768 + 1024 + 2048,
                             64, 128)}
    for entry, (grid, smem, bq, bk) in want.items():
        p = plans[entry]
        assert (p.grid, p.threads, p.smem) == (grid, 256, smem), entry
        assert p.smem <= plan.MAX_SMEM
        assert tfl.flash_tiles(entry, BF16, D) == (bq, bk)
        assert p.plan_args[-3:] == (bq, bk, 1) and p.args[-4:-2] == (bq, bk)
        assert tfl.flash_body(BF16, D) == "wgmma"


def test_mma_sync_plans_unchanged():
    """f32 at every head dim and bf16 at D = 32, 64 keep the mma.sync
    body's plans: 128 threads, 64-row tiles, padded staging."""
    for dtype, d in ((F32, 128), (F32, 32), (BF16, 64)):
        assert tfl.flash_body(dtype, d) == "mma_sync"
        plans = _plans(dtype, 2, 16, 4, 1000, d)
        for entry, p in plans.items():
            assert p.threads == 128 and p.grid[0] == 16, (entry, d)
            assert tfl.flash_tiles(entry, dtype, d) == (64, 64)
    f32 = _plans(F32, 2, 16, 16, 8192)
    assert {e: p.smem for e, p in f32.items()} == {
        "flash_fwd": 118784, "flash_bwd_q": 152576, "flash_bwd_kv": 144896}


@pytest.mark.parametrize("n,g,window", [(8192, 1, None), (1000, 4, None),
                                        (544, 1, (256, [0, 256])),
                                        (97, 4, (17, [0, 80]))])
def test_wgmma_tiles_cover_rows(n, g, window):
    """The query tiles of flash_fwd and flash_bwd_q and the key tiles of
    flash_bwd_kv cover [0, N) exactly once; each flash_fwd block walks
    the keys up to its causal frontier (with q_offset: the window's) and
    no further tile; each flash_bwd_kv block walks the query rows from
    its diagonal tile on, over its group's query heads."""
    b, hkv = 2, 2
    plans = _plans(BF16, b, hkv * g, hkv, n)
    if window is not None:
        nq, off = window
        q = _meta(b, hkv * g, nq, D)
        kv = _meta(b, hkv, n, D)
        plans["flash_fwd"] = tfl.plan_flash_fwd(
            q, kv, kv, torch.zeros(b, dtype=torch.int32, device="meta"))
        offsets = (np.asarray(off, np.int32),)
    else:
        nq, offsets = n, ()
    fwd = plans["flash_fwd"]
    for entry, rows, gathered in (("flash_fwd", nq, offsets),
                                  ("flash_bwd_q", n, ())):
        seen = {}
        for (spans,) in _tiles(plans[entry], "q", *gathered).values():
            _count_rows(spans, rows, seen)
        assert set(seen.values()) == {1} and len(seen) == b * hkv * g * rows
    bq, bk = tfl.flash_tiles("flash_fwd", BF16, D)
    qs = _tiles(fwd, "q", *offsets)
    for blk, (spans,) in _tiles(fwd, "k", *offsets).items():
        (bi, _), _, (lo, hi), _ = spans
        (q0, q1), = {t[2] for t in qs[blk]}
        pos = (int(offsets[0][bi]) if offsets else n - nq) + min(q1, nq) - 1
        assert lo == 0 and hi - bk <= pos < hi and q1 - q0 == bq
    kvp = plans["flash_bwd_kv"]
    sq, _ = tfl.flash_tiles("flash_bwd_kv", BF16, D)
    keys, qs = {}, _tiles(kvp, "q")
    for blk, (spans,) in _tiles(kvp, "k").items():
        _count_rows(spans, n, keys)
        (hk, _), (lo, _) = spans[1], spans[2]
        (qt,) = qs[blk]
        assert qt[1] == (hk * g, (hk + 1) * g)
        assert qt[2][0] == lo // sq * sq and qt[2][1] >= n
    assert set(keys.values()) == {1} and len(keys) == b * hkv * n


@pytest.mark.gpu
def test_cuda_wgmma_flash_matches_plain():
    """The bf16 D = 128 kernels (the wgmma bodies) against their plain
    versions at N = 1000 with G = 4 and on a q_offset prefill window; the
    backward twice, bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(18)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(BF16).to(dev)

    def rel(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max()) / float(want.abs().max())

    b, h, hkv, n = 2, 8, 2, 1000
    q, k, v, do = t(b, h, n, D), t(b, hkv, n, D), t(b, hkv, n, D), \
        t(b, h, n, D)
    o, lse = tfl.flash_fwd_cuda(q, k, v)
    o_t, lse_t = tfl.flash_fwd_torch(q, k, v)
    assert rel(o, o_t) <= 2.0 ** -7 and rel(lse, lse_t) <= 1e-4
    grads = [tfl.flash_bwd_cuda(q, k, v, o_t, lse_t, do) for _ in range(2)]
    torch.cuda.synchronize()
    for got, again, want in zip(*grads, tfl.flash_bwd_torch(
            q, k, v, o_t, lse_t, do)):
        assert got.dtype == BF16 and torch.equal(got, again)
        assert rel(got, want) <= 2.0 ** -5
    qw = t(b, h, 48, D)
    off = torch.tensor([0, n - 48], dtype=torch.int32, device=dev)
    ow, _ = tfl.flash_fwd_cuda(qw, k, v, off, return_lse=False)
    assert rel(ow, tfl.flash_fwd_torch(qw, k, v, off)[0]) <= 2.0 ** -7
