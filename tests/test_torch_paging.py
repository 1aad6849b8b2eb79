"""The port's paged-KV serving path held against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; every model-level run carries the reference's weights over with
`params_from_jax`.  Tolerances, each relative to the reference's largest
|value|:

  * F32_REL = 1e-5: f32 paged decode outputs (float32 rounding of sums
    taken in other orders);
  * MODEL_REL = 1e-4: f32 logits of pythia smoke (float32 rounding
    through two layers and the f32 unembedding);
  * GPU_BF16_REL = 2^-7, GPU_F32_REL = 1e-5: the CUDA kernels against
    their plain versions on the card (one bf16 rounding step; f32 sums
    in other orders).

Covered: `PagePool` (allocate, extend, free, fork, exhaustion) and the
byte accounting (`page_bytes`, `cache_bytes`, `per_slot_bytes`,
`PagedAdmission`, `ByteBudget`) against `repro.serve`; the `paged` and
`paged_decode_fused` families' `torch` and `ref` impls against
`paged_attention_xla` (and once against the Pallas kernels in interpret
mode) with lengths 0 and past the table, stale arena rows beyond every
length; `_write_pages` with the retired-slot clamp; paged prefill and
decode logits against the JAX package and against the port's contiguous
path; greedy tokens of the paged `Engine` against the JAX paged
`Engine`, one-shot and chunked, with freed pages reused and every page
returned; page-bound FIFO admission; the misconfiguration errors; the
launcher's paging flags.  `gpu`-marked tests hold the CUDA kernels to
their plain versions and skip without a card.

The cases are grouped into 7 tests on purpose: pytest-xdist's loadfile
distribution queues files by their number of tests, most first, so a
file of at most 7 tests is queued after `test_property.py` (7 tests,
most of the suite's longest path) and never delays its start.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from helpers import run_engine_greedy
    from repro.configs.base import PagingCfg as JPagingCfg
    from repro.configs.registry import get_config as jget_config
    from repro.kernels import ops as jops
    from repro.kernels import paged_attention as jpg
    from repro.mixers import softmax as jsoftmax
    from repro.models import model as jmdl
    from repro.serve import cache as jcache
    from repro.serve import paging as jpaging
    from repro.serve import scheduler as jsched
except ImportError:  # the port alone, on the machine with the card
    jax = None
from repro_torch.configs.base import PagingCfg
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpg
from repro_torch.launch import serve as tlaunch
from repro_torch.mixers import get_backend
from repro_torch.mixers import softmax as tsoftmax
from repro_torch.models import model as tmdl
from repro_torch.serve import cache as tcache
from repro_torch.serve import paging as tpaging
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import Engine, Request

F32_REL = 1e-5
MODEL_REL = 1e-4
GPU_BF16_REL = 2.0 ** -7
GPU_F32_REL = 1e-5


def _assert_rel(got, want, rel, label=""):
    got = got.detach().float().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max err {err} > {rel} * {scale}"


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference is not installed here")


# ---------------------------------------------------------------------------
# PagePool and byte accounting
# ---------------------------------------------------------------------------

# (num_pages, page_size, ops): each op is a PagePool method and its args
SCRIPTS = {
    "alloc_free_lifo": (8, 16, [("allocate", 0, 40), ("allocate", 1, 16),
                                ("free", 0), ("allocate", 2, 1),
                                ("can_allocate", 113), ("pages_needed", 33),
                                ("free", 2), ("free", 1)]),
    "extend": (4, 8, [("allocate", 0, 8), ("extend", 0, 8),
                      ("extend", 0, 17), ("allocate", 0, 8),
                      ("extend", 0, 40), ("free", 0)]),
    "fork": (8, 4, [("allocate", 0, 10), ("fork", 0, 1, 8),
                    ("fork", 0, 2, 10), ("fork", 0, 3, 13), ("free", 0),
                    ("allocate_pages", 4, 2), ("fork", 2, 5, 4),
                    ("free", 1), ("free", 2), ("free", 5), ("free", 4)]),
    "exhaustion": (4, 16, [("allocate", 0, 33), ("can_allocate", 17),
                           ("allocate", 1, 17), ("allocate", 1, 16),
                           ("allocate_pages", 2, 1), ("fork", 0, 3, 49),
                           ("free", 1), ("allocate", 2, 16)]),
}


def _play(pool, ops):
    """Each op's result (or its error's class name and message) and the
    pool's tables, refcounts and free list after it."""
    trace = []
    for name, *args in ops:
        try:
            out = getattr(pool, name)(*args)
        except (ValueError, RuntimeError) as e:
            out = (type(e).__name__, str(e))
        trace.append((name, out, {r: pool.table(r) for r in sorted(
            pool._tables)}, [pool.refcount(p) for p in range(
                pool.num_pages)], list(pool._free), pool.free_pages,
            pool.pages_in_use))
    return trace


def _pool_case(script):
    num_pages, page_size, ops = SCRIPTS[script]
    want = _play(jpaging.PagePool(num_pages, page_size), ops)
    got = _play(tpaging.PagePool(num_pages, page_size), ops)
    assert got == want, script


def _pair(backend, smoke=True, paging=None):
    """The same config in both packages, optionally paged."""
    jcfg = jget_config("pythia-1.4b", smoke=smoke, attention_backend=backend)
    cfg = get_config("pythia-1.4b", smoke=smoke, attention_backend=backend)
    if paging is not None:
        jcfg = dataclasses.replace(jcfg, paging=JPagingCfg(*paging))
        cfg = dataclasses.replace(cfg, paging=PagingCfg(*paging))
    return jcfg, cfg


def _resolve(policy, cfg):
    """(slots, arena pages) a policy resolves to, or its error."""
    try:
        return (policy.resolve_slots(cfg, 20),
                getattr(policy, "resolve_num_pages", lambda _: None)(cfg))
    except ValueError as e:
        return str(e)


def _accounting_case(backend):
    for smoke in (True, False):
        jcfg, cfg = _pair(backend, smoke)
        for ps in (1, 5, 16):
            assert tcache.page_bytes(cfg, ps) == jcache.page_bytes(jcfg, ps)
    # exact cache bytes from the model's own init_cache (meta device
    # against eval_shape), contiguous and, for softmax, paged
    for paging in [None] + ([(4, 9)] if backend == "softmax" else []):
        jcfg, cfg = _pair(backend, paging=paging)
        assert tcache.cache_bytes(cfg, 3, 20) \
            == jcache.cache_bytes(jcfg, 3, 20)
        assert tcache.per_slot_bytes(cfg, 20) \
            == jcache.per_slot_bytes(jcfg, 20)
    jcfg, cfg = _pair(backend)
    for budget in (10 * tcache.page_bytes(cfg, 4) + 7, 100):
        assert _resolve(tpaging.PagedAdmission(budget, 4, 3), cfg) \
            == _resolve(jpaging.PagedAdmission(budget, 4, 3), jcfg)
        assert _resolve(tsched.ByteBudget(budget), cfg) \
            == _resolve(jsched.ByteBudget(budget), jcfg)


def test_page_pool_and_byte_accounting_match_jax():
    """Every script of pool operations, and the byte accounting of both
    backends."""
    for script in sorted(SCRIPTS):
        _pool_case(script)
    assert tpaging.pages_for(33, 16) == jpaging.pages_for(33, 16) == 3
    for backend in ("softmax", "linear"):
        _accounting_case(backend)


# ---------------------------------------------------------------------------
# The paged decode families and the page writes
# ---------------------------------------------------------------------------

def _paged_case(rng, b, h, hkv, d, ps, pmax, lengths):
    """q, random arenas (every row filled, so stale rows beyond a length
    are live garbage), a shuffled table with each slot's unallocated
    entries at the sink page (the last), and lengths."""
    num_pages = b * pmax + 1
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((num_pages, hkv, ps, d)).astype(
        np.float32) for _ in range(2))
    table = np.full((b, pmax), num_pages - 1, np.int32)
    perm = rng.permutation(num_pages - 1).astype(np.int32)
    for i, n in enumerate(lengths):
        live = min(-(-n // ps), pmax)
        table[i, :live] = perm[i * pmax:i * pmax + live]
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


def _family_case(family, g, ps):
    rng = np.random.default_rng(20 + g + ps)
    pmax = 4
    # length 0, a single key, a ragged last page, and one past the table
    lengths = [0, 1, 2 * ps + 1, pmax * ps + 1]
    case = _paged_case(rng, 4, 2 * g, 2, 16, ps, pmax, lengths)
    jfn = jops.paged_attention if family == "paged" \
        else jops.paged_attention_fused
    tfn = tops.paged_attention if family == "paged" \
        else tops.paged_attention_fused
    want = np.asarray(jfn(*(jnp.asarray(x) for x in case), backend="xla"))
    assert np.abs(want[0]).max() == 0.0
    for impl in ("torch", "ref", "auto"):
        got = tfn(*_torch(*case), backend=impl)
        _assert_rel(got, want, F32_REL, f"{family} {impl} G={g} ps={ps}")
        assert float(got[0].abs().max()) == 0.0     # length 0: zeros
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfn(*_torch(*case), backend="cuda")
    if (g, ps) == (2, 3):
        # the Pallas kernels in interpret mode; the unfused one with its
        # optional scale
        if family == "paged":
            pal = jpg.paged_attention_pallas(
                *(jnp.asarray(x) for x in case), scale=0.3, interpret=True)
            got = tpg.paged_attention_torch(*_torch(*case), scale=0.3)
        else:
            pal = jfn(*(jnp.asarray(x) for x in case),
                      backend="pallas_interpret")
            got = tdf.paged_decode_fused_torch(*_torch(*case))
        _assert_rel(got, np.asarray(pal), F32_REL, f"{family} vs pallas")


def test_paged_families_match_jax():
    """Both families, query groups 1 and 2, page sizes 3 and 8."""
    for family in ("paged", "paged_decode_fused"):
        for g in (1, 2):
            for ps in (3, 8):
                _family_case(family, g, ps)


def test_write_pages_matches_jax():
    rng = np.random.default_rng(21)
    pages = rng.standard_normal((9, 2, 3, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 2, 4)).astype(np.float32)
    table = np.array([[4, 0, 7], [2, 5, 1], [8, 8, 8]], np.int32)
    # slot 1 writes across a page boundary; slot 2 is retired: its
    # positions ran past its table (clamped to the last entry, the sink)
    positions = np.array([[0, 1], [2, 3], [11, 12]], np.int32)
    want = jsoftmax._write_pages(jnp.asarray(pages), jnp.asarray(new),
                                 jnp.asarray(table), jnp.asarray(positions))
    got = torch.from_numpy(pages.copy())
    tsoftmax._write_pages(got, *_torch(new, table, positions))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy()[8], pages[8])   # the sink took it


# ---------------------------------------------------------------------------
# Model and engine
# ---------------------------------------------------------------------------

B, N, STEPS, PS = 2, 11, 4, 4
PMAX = -(-(N + STEPS) // PS)
NUM_PAGES = B * PMAX + 1


def _configs(paging=True, **la):
    jcfg = jget_config("pythia-1.4b", smoke=True,
                       attention_backend="softmax")
    cfg = get_config("pythia-1.4b", smoke=True, attention_backend="softmax")
    if paging:
        jcfg = dataclasses.replace(jcfg, paging=JPagingCfg(PS, NUM_PAGES))
        cfg = dataclasses.replace(cfg, paging=PagingCfg(PS, NUM_PAGES))
    if la:
        cfg = dataclasses.replace(cfg, la=dataclasses.replace(cfg.la, **la))
    return jcfg, cfg


@pytest.fixture(scope="module")
def ref():
    """The JAX reference on pythia smoke with a paged softmax cache, built
    once: params, tokens, a shuffled page table, prefill and decode
    logits."""
    jcfg, _ = _configs()
    params = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(22)
    tokens = rng.integers(3, jcfg.vocab_size,
                          size=(B, N + STEPS)).astype(np.int32)
    table = rng.permutation(NUM_PAGES - 1)[:B * PMAX].reshape(
        B, PMAX).astype(np.int32)
    cache = jmdl.init_cache(jcfg, B, N + STEPS)
    blocks = cache["blocks"]
    cache["blocks"] = blocks._replace(page_table=jnp.broadcast_to(
        jnp.asarray(table), blocks.page_table.shape))
    prefill = jax.jit(jmdl.prefill, static_argnums=1)
    decode = jax.jit(jmdl.decode_step, static_argnums=1)
    logits, cache = prefill(params, jcfg,
                            {"tokens": jnp.asarray(tokens[:, :N])}, cache)
    steps = [np.asarray(logits)]
    for i in range(STEPS):
        lg, cache = decode(params, jcfg, cache, jnp.asarray(tokens[:, N + i]))
        steps.append(np.asarray(lg))
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "table": table, "logits": steps}


def _port_logits(cfg, params, tokens, table=None):
    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    if table is not None:
        for layer in cache["blocks"]:
            layer.page_table.copy_(torch.from_numpy(table))
    tokens = torch.from_numpy(tokens)
    logits, cache = tmdl.prefill(params, cfg, {"tokens": tokens[:, :N]},
                                 cache)
    out = [logits]
    for i in range(STEPS):
        logits, cache = tmdl.decode_step(params, cfg, cache,
                                         tokens[:, N + i])
        out.append(logits)
    return out


def test_paged_logits_match_jax_and_contiguous(ref):
    """Prefill and decode logits, fused and unfused decode."""
    _, contiguous = _configs(paging=False)
    params = params_from_jax(contiguous, ref["params"], device="cpu")
    flat = _port_logits(contiguous, params, ref["tokens"])
    for fused in (True, False):
        _, cfg = _configs(fused_decode=fused)
        paged = _port_logits(cfg, params, ref["tokens"], ref["table"])
        for i, (p, c, want) in enumerate(zip(paged, flat, ref["logits"])):
            _assert_rel(p, want, MODEL_REL, f"fused={fused} step {i} vs jax")
            _assert_rel(p, c.numpy(), MODEL_REL,
                        f"fused={fused} step {i} vs contiguous")


# slots finish at different steps; with 2 slots for 3 requests the pages
# request 0 frees go to request 2 (LIFO) while request 1 still decodes
_REQS = [(0, list(range(3, 12)), 2), (1, list(range(20, 29)), 5),
         (2, list(range(7, 16)), 3)]
_CHUNKS = [None, 5]


@pytest.fixture(scope="module")
def engine_ref(ref):
    jcfg, _ = _configs(paging=False)
    params = jax.tree.map(jnp.asarray, ref["params"])
    return {chunk: run_engine_greedy(jcfg, params, reqs=_REQS, max_slots=2,
                                     page_size=PS, prefill_chunk=chunk)[0]
            for chunk in _CHUNKS}


def _engine_case(ref, engine_ref, chunk):
    _, cfg = _configs(paging=False)
    params = params_from_jax(cfg, ref["params"], device="cpu")
    eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                 page_size=PS, prefill_chunk=chunk, device="cpu")
    for rid, prompt, mn in _REQS:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mn))
    tables, got = {}, {}
    for out in eng.stream():
        for rid, _, _ in _REQS:
            if eng.pool.holds(rid):
                tables[rid] = eng.pool.table(rid)
        if out.finished:
            got[out.rid] = eng.request(out.rid).generated
    assert got == engine_ref[chunk], chunk
    assert set(tables[2]) & set(tables[0]), "request 2 reuses freed pages"
    stats = eng.page_stats()
    assert stats["pages_in_use"] == 0
    assert stats["free_pages"] == stats["num_pages"] == 2 * 16
    # the sink is the arena's last page, after the allocatable ones
    sink = torch.full((2, 16), stats["num_pages"], dtype=torch.int32)
    for layer in eng.cache["blocks"]:
        assert torch.equal(layer.page_table, sink)   # rows back at the sink


def test_paged_engine_greedy_tokens_identical_to_jax(ref, engine_ref):
    """One-shot and chunked prefill."""
    for chunk in _CHUNKS:
        _engine_case(ref, engine_ref, chunk)


def _admission_case(ref):
    """Two free slots but pages for only one request: admission waits
    (strict FIFO) and admits the queued request once the first one's
    pages free."""
    _, cfg = _configs(paging=False)
    params = params_from_jax(cfg, ref["params"], device="cpu")
    # 2 usable pages (+1 sink); each request needs 7+6-1=12 tokens = 2
    eng = Engine(cfg, params, max_slots=2, max_len=32, eos_id=-1,
                 page_size=8, num_pages=3, device="cpu")
    p = list(range(3, 10))
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=6))
    eng.submit(Request(rid=1, prompt=p, max_new_tokens=6))
    events, blocked = [], set()
    while eng.scheduler.has_work():
        events += [(o.rid, o.finished) for o in eng.step()]
        blocked.add(eng.scheduler.blocked)
    assert "resources" in blocked
    finish_0 = events.index((0, True))
    first_1 = next(i for i, (rid, _) in enumerate(events) if rid == 1)
    assert first_1 > finish_0, "rid 1 must wait for rid 0's pages"
    assert eng.request(0).generated == eng.request(1).generated
    assert eng.pool.free_pages == 2
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(Request(rid=2, prompt=list(range(3, 25)),
                           max_new_tokens=4))   # > the whole arena


def _misconfiguration_case():
    _, cfg = _configs(paging=False)
    linear = get_config("pythia-1.4b", smoke=True)
    with pytest.raises(ValueError, match="softmax"):
        Engine(linear, None, max_len=32, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="PagedAdmission"):
        Engine(cfg, None, max_len=32, page_size=8,
               policy=tsched.ByteBudget(1 << 30), device="cpu")
    with pytest.raises(ValueError, match="page_size"):
        Engine(cfg, None, max_len=32, num_pages=8, device="cpu")
    pol = tpaging.PagedAdmission(1 << 20, page_size=8)
    with pytest.raises(ValueError, match="drop the engine kwargs"):
        Engine(cfg, None, max_len=32, policy=pol, page_size=8, device="cpu")
    with pytest.raises(ValueError, match="num_pages >= 2"):
        Engine(cfg, None, max_len=32, page_size=8, num_pages=1,
               device="cpu")
    # the gla backend pages its recurrent state: one state page per slot
    gla = dataclasses.replace(cfg, attention_backend="gla")
    eng = Engine(gla, tmdl.init_params(gla, device="cpu"), max_len=32,
                 page_size=8, device="cpu")
    assert eng.pool.num_pages == eng.num_slots
    jgla = dataclasses.replace(_configs(paging=False)[0],
                               attention_backend="gla")
    assert tcache.page_bytes(gla, 8) == tcache.state_page_bytes(gla) \
        == jcache.page_bytes(jgla, 8)
    assert get_backend(dataclasses.replace(
        cfg, paging=PagingCfg(1, 2))).name == "softmax"


def _launcher_case():
    rec = tlaunch.main(["--device", "cpu", "--backend", "softmax",
                        "--page-size", "4", "--requests", "3", "--max-new",
                        "3", "--slots", "2"])
    assert rec["generated_tokens"] == 9 and rec["policy"] == "FixedSlots"
    pg = rec["paging"]
    assert pg["page_size"] == 4 and pg["free_pages"] == pg["num_pages"]
    assert 0 < pg["peak_pages_in_use"] <= pg["num_pages"]
    rec = tlaunch.main(["--device", "cpu", "--backend", "softmax",
                        "--page-size", "4", "--budget-mb", "0.1",
                        "--requests", "3", "--max-new", "3", "--slots",
                        "2"])
    assert rec["policy"] == "PagedAdmission"
    assert rec["paging"]["num_pages"] == 0.1 * 2 ** 20 // (
        2 * 4 * 4 * 16 * 4 * 2) - 1
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--num-pages", "3"])


def test_paged_admission_errors_and_launcher(ref):
    """Page-bound FIFO admission, the misconfiguration errors, and the
    launcher's paging flags."""
    _admission_case(ref)
    _misconfiguration_case()
    _launcher_case()


# ---------------------------------------------------------------------------
# The CUDA kernels (card only)
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cuda_case(dev, dtype, g, ps):
    rng = np.random.default_rng(23)
    pmax = 9
    lengths = [0, 1, 3 * ps + 2, pmax * ps, pmax * ps + 7]
    case = [torch.from_numpy(x).to(dev) for x in _paged_case(
        rng, 5, 4 * g, 4, 64, ps, pmax, lengths)]
    case[:3] = [x.to(dtype) for x in case[:3]]
    rel = GPU_BF16_REL if dtype == torch.bfloat16 else GPU_F32_REL
    for name, kernel, plain, counts in (
            ("paged_attention", tpg.paged_attention_cuda,
             tpg.paged_attention_torch, tpg.launches),
            ("paged_decode_fused", tdf.paged_decode_fused_cuda,
             tdf.paged_decode_fused_torch, tdf.launches)):
        before = counts[name]
        o = kernel(*case)
        torch.cuda.synchronize()
        assert counts[name] == before + 1
        assert o.dtype == dtype
        _assert_rel(o, plain(*case).float().cpu().numpy(), rel,
                    f"{name} {dtype} G={g} ps={ps}")
        assert float(o[0].abs().max()) == 0.0     # length 0: zeros


@pytest.mark.gpu
def test_cuda_paged_kernels_match_plain():
    """Both kernels, f32 and bf16, at (G, page size) (1, 16) and (4, 5)."""
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        for g, ps in ((1, 16), (4, 5)):
            _cuda_case(dev, dtype, g, ps)
