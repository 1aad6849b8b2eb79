#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or /usr/local/cuda) and the repo's
`src/` beside this file; imports nothing of JAX.  Phases, each of which
fails the run by raising (no result line is printed then):

  1. device  — require CUDA; print the card and its power limit; TF32 off
  2. build   — nvcc every kernel source of the paths from
               src/repro_torch/kernels/csrc, one process each, all started
               together (with -Xptxas -v); print the build seconds
  3. kernel  — each kernel against its plain PyTorch version on CUDA
               tensors: the linear decode step at the serving shapes (plus
               GQA and a zero normalizer, state in place); la_fwd,
               la_bwd_q and la_bwd_kv at the training shapes (B=2,
               H=Hkv=16, N=8192, D=128) in bf16 and f32, at odd N=1000
               and with GQA G=4; softmax_decode_fused at the serving
               shapes (B=8, H=Hkv=16, S=544, D=128, per-slot lengths >= 1,
               one past the cache; zeros at length 0 checked apart), GQA
               G=4, bf16 and f32; flash_fwd and the three flash backward
               kernels at the training shapes, odd N=1000 and GQA G=4, bf16
               and f32, and flash_fwd on a prefill window (Nq=256,
               Nk=544, q_offset [0, 256]); paged_decode_fused and
               paged_attention at the serving shapes (B=8, H=Hkv=16, D=128,
               page size 16, 34 table entries per slot into a shuffled
               arena, unallocated entries at the sink page, lengths in
               [1, 544] and one past the table) and with GQA G=4 at page
               size 5, bf16 and f32, zeros at length 0 checked apart;
               the GLA kernels under both decay regimes (the trained
               gate's log_sigmoid(N(0,1) + 6) and a hard U[-5, 0]):
               gla_decode_fused at the serving shapes and with G=4, bf16
               and f32, state in place, a zero normalizer; gla_fwd,
               gla_bwd_q and gla_bwd_kv at the training shapes, odd
               N=1000 and G=4, bf16 and f32 (o, g, dq, dk, dv and dld);
               and at log_decay = 0 each gated kernel against its linear
               counterpart; the SSD kernels ssd_fwd, ssd_bwd_q and
               ssd_bwd_kv at mamba2-2.7b's training shapes (B=2, G=1,
               H=80, N=8192, Dk=128, Dv=64), odd N=1000 and G=4 with
               H=16, bf16 and f32, under a fresh layer's decay
               (-softplus(N(0,1))) and the hard U[-5, 0] (o, the f32 dq
               and dk partials, dv, and after the epilogue dq, dk, dv and
               dld), and at log_decay = 0 the forward against
               unnormalized causal linear attention
  4. serve   — the Engine at full width pythia-1.4b in bf16, once with the
               paper's linear attention and once with the softmax
               baseline: 8 requests, 512-token prompts, prefill_chunk 256,
               32 new tokens, greedy; every decode step must go through
               the path's decode kernel (24 launches per step) and, on the
               softmax path, every prefill window through flash_fwd (24
               per window); the decode step timed with CUDA events and
               profiled with torch.profiler; the first 4 decode steps'
               logits of the kernel path against the plain path on one
               cloned prefilled cache; the softmax baseline again from a
               paged KV cache (PagedAdmission, page size 16, an arena of
               161 pages bought by its byte budget: 16 requests of 64-512
               prompt tokens, some waiting for pages, 24 paged_decode_fused
               launches per decode step), its logits against the plain
               path and the contiguous kernel path, then a short pass with
               fused_decode=False (24 paged_attention launches per step);
               the decay-gated (GLA) backend on the same traffic as the
               linear run (gla_decode_fused 24 per step), and again from
               a paged state arena (PagedAdmission, page size 16, a budget
               of 5 state pages: 4 allocatable and the sink; 16 requests
               of 64-512 prompt tokens, some waiting for pages, 24
               gla_decode_fused launches per decode step), its logits
               against the contiguous kernel path and the plain path;
               full-width mamba2-2.7b on the linear run's traffic (no
               kernel launches: the reference serves it through the
               plain SSD scan and step); and the pythia and mamba2 smoke
               configs on the card against the same weights on the CPU
               (mamba2 also its loss and every grad, through the SSD
               kernels' smoke instantiation)
  5. train   — full width pythia-1.4b (f32 params, bf16 compute, the
               config's remat) on SyntheticLM batches of 2 x 8192 tokens
               (seed 0), once per backend (linear, softmax, gla), and
               full-width mamba2-2.7b the same way: the
               first step's loss and the grads of every layer's
               wq/wk/wv/wo (and gla's gate wg), ln_f and lm_head (mamba2:
               every grad, beside a second plain run's spread) on the
               kernel path against the plain path from one set of weights;
               then 4 steps through the Trainer, each launching the
               forward kernel 48 times (remat runs each layer's forward
               twice) and each backward kernel 24 times (la_fwd /
               la_bwd_q / la_bwd_kv, flash_fwd / flash_bwd_delta /
               flash_bwd_q / flash_bwd_kv, or gla_fwd / gla_bwd_q /
               gla_bwd_kv; mamba2's 64 layers: ssd_fwd 128 times,
               ssd_bwd_q and ssd_bwd_kv 64 times each); step time,
               tokens/s, peak memory, and one more step under
               torch.profiler
  6. timing  — each kernel and its plain version with CUDA events at the
               main paths' shapes, in turns, beside the kernel's bound and,
               where one PyTorch call computes the same function (SDPA for
               the contiguous softmax kernels; the port never calls it),
               that call; the paged decode kernels also beside the
               contiguous one on the same keys
  7. result  — a JSON line with every measurement, the card's line, a
               `kernels` JSON line, then {"ok": true, "device": {...}}
               as the last line

Every main-path run sets every kernel's launch count to 0 just before it
and reads them all just after; launches made by the comparisons with
the plain versions are not counted.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12     # bf16 on the tensor cores, dense

CSRC = "src/repro_torch/kernels/csrc"
# kernel -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "la_decode_fused": (f"{CSRC}/la_decode_fused.cu",
                        "src/repro/kernels/decode_fused.py:157"),
    "la_fwd": (f"{CSRC}/la_fwd.cu",
               "src/repro/kernels/linear_attention.py:96"),
    "la_bwd_q": (f"{CSRC}/la_bwd.cu",
                 "src/repro/kernels/linear_attention.py:208"),
    "la_bwd_kv": (f"{CSRC}/la_bwd.cu",
                  "src/repro/kernels/linear_attention.py:208"),
    "softmax_decode_fused": (f"{CSRC}/softmax_decode_fused.cu",
                             "src/repro/kernels/decode_fused.py:226"),
    "flash_fwd": (f"{CSRC}/flash_fwd.cu",
                  "src/repro/kernels/flash_attention.py:126"),
    "flash_bwd_delta": (f"{CSRC}/flash_bwd.cu",
                        "src/repro/kernels/flash_attention.py:294"),
    "flash_bwd_q": (f"{CSRC}/flash_bwd.cu",
                    "src/repro/kernels/flash_attention.py:294"),
    "flash_bwd_kv": (f"{CSRC}/flash_bwd.cu",
                     "src/repro/kernels/flash_attention.py:294"),
    "paged_decode_fused": (f"{CSRC}/paged_decode.cu",
                           "src/repro/kernels/decode_fused.py:333"),
    "paged_attention": (f"{CSRC}/paged_decode.cu",
                        "src/repro/kernels/paged_attention.py:149"),
    "gla_decode_fused": (f"{CSRC}/la_decode_fused.cu",
                         "src/repro/kernels/decode_fused.py:169"),
    "gla_fwd": (f"{CSRC}/la_fwd.cu", "src/repro/kernels/gla.py:118"),
    "gla_bwd_q": (f"{CSRC}/la_bwd.cu", "src/repro/kernels/gla.py:249"),
    "gla_bwd_kv": (f"{CSRC}/la_bwd.cu", "src/repro/kernels/gla.py:249"),
    "ssd_fwd": (f"{CSRC}/ssd.cu", "src/repro/kernels/ssd.py:65"),
    "ssd_bwd_q": (f"{CSRC}/ssd.cu", "src/repro/kernels/ssd.py:192"),
    "ssd_bwd_kv": (f"{CSRC}/ssd.cu", "src/repro/kernels/ssd.py:192"),
}
FLASH_BWD = ("flash_bwd_delta", "flash_bwd_q", "flash_bwd_kv")

# main path: pythia-1.4b at full width
SLOTS, PROMPT_LEN, PREFILL_CHUNK, MAX_NEW = 8, 512, 256, 32
MAX_LEN = PROMPT_LEN + MAX_NEW
COMPARE_STEPS = 4
# paged serve path: the softmax baseline from a paged KV arena of 161
# pages of 16 tokens (160 allocatable + the sink), ~0.51 GB at full width
# against 0.86 GB for 8 contiguous slots of MAX_LEN
PAGE_SIZE, PAGED_PAGES, PAGED_REQUESTS = 16, 161, 16
PAGED_PROMPT_LENS = (64, 512)
PMAX = -(-MAX_LEN // PAGE_SIZE)
# the unfused pass: 8 requests of 128 prompt tokens, 8 new
UNFUSED_PROMPT, UNFUSED_NEW = 128, 8
# paged GLA serve path: a byte budget of 5 state pages (a page is one
# slot's whole recurrent state, 25,560,576 B at full width) buys 4
# allocatable pages and the sink, so at most 4 of the 8 slots decode and
# the other requests wait for pages
GLA_PAGED_PAGES = 5
# train path: pythia-1.4b at full width, the paper's §5.2 length
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 4
LA_SHAPE = dict(b=2, h=16, hkv=16, n=8192, d=128)
# mamba2-2.7b's training shapes: q and k (Mamba-2's C and B) shared by
# all 80 heads (G = 1), state 128, head dim 64
SSD_SHAPE = dict(b=2, g=1, h=80, n=8192, dk=128, dv=64)

# tolerances, relative to the reference's max |value|
F32_REL = 1e-5          # f32 state / f32 outputs: float32 rounding
BF16_REL = 2.0 ** -7    # bf16 outputs: one bf16 rounding step
# full-width logits, kernel path vs plain path: both round o to bf16,
# and a last-bit difference there reaches the logits through a bf16
# residual stream over 24 layers (2^-8 per rounding, compounding)
LOGITS_REL = 2.0 ** -4
SMOKE_REL = 1e-4        # f32 smoke logits, card vs CPU
# la_fwd / la_bwd in f32 against their plain versions: the kernels sum
# token by token over up to 8192 tokens, the plain scans chunk by
# chunk, so the f32 sums round in different orders
SEQ_F32_REL = 1e-4
# the GLA log-decay gradient, dld = the reverse cumsum over up to 8192
# tokens of dcl = -[v, 1].dV', held to the magnitude of those sums: the
# plain scans form each decay as exp of a difference of a chunk's cumsum
# of log decays, which under strong decay reaches ~-1,300 within 512
# tokens, where one float32 ulp is 1.2e-4, and dld sums those errors
DLD_REL = 1e-3
# at log_decay = 0 the gated kernels run the linear kernels' arithmetic
# with every decay factor exactly 1: within a few float32 ulps
LD0_REL = 1e-6
# full-width train step, kernel path vs plain path: both round o, dq,
# dk and dv to bf16 after f32 sums in different orders, and a last-bit
# difference reaches the loss and the grads through 24 layers of bf16
# matmuls forward and back
TRAIN_LOSS_REL = 2.0 ** -8
TRAIN_GRAD_REL = 2.0 ** -4
# the GLA gate's grads (wg) at init: d log_sigmoid(z + 6)/dz ~ e^-6 scales
# a sum over 16,384 tokens that mostly cancels, so in bf16 compute they are
# at the level of the rounding noise itself: two plain runs that differ
# only in the scan chunk (512 against 256) disagree by up to 1.39x their
# largest |value| (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  The kernel path is held to that spread: all wg grads
# together differ from the plain path by at most GATE_NOISE_FACTOR times
# the norm by which the two plain runs differ
GATE_NOISE_FACTOR = 2.0
# the softmax kernels against their plain versions: bf16 o within one
# bf16 step (the kernels round P to bf16 before P V, as FlashAttention-2
# does; the plain versions keep P in f32); bf16 dq/dk/dv within 2^-5 (P
# and dS rounded to bf16 before the three products of the backward);
# f32 within 1e-4 (sums over up to 8192 terms in other orders)
SOFTMAX_BF16_O_REL = 2.0 ** -7
SOFTMAX_BF16_GRAD_REL = 2.0 ** -5
SOFTMAX_F32_REL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want):
    """(max |got - want|, max |want|) in float32."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max()),
            max(float(want.abs().max()), 1e-6))


def check_close(label, got, want, rel):
    err, scale = rel_err(got, want)
    log(f"  {label}: max_abs_err={err!r} (limit {rel * scale!r})")
    if not (err <= rel * scale):
        raise AssertionError(f"{label}: max abs err {err} > {rel} * {scale}")
    return err


def _counters():
    """Every kernel wrapper's launch count dict (one per module)."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels import paged_attention as pg
    from repro_torch.kernels import ssd
    return (df.launches, la.launches, fl.launches, pg.launches,
            gla.launches, ssd.launches)


def reset_launches() -> None:
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def expect_launches(label, got, want) -> None:
    """Every kernel of the path launched as often as `want` says, and no
    other kernel at all."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        raise AssertionError(f"{label}: kernel launches {got} != {full}")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    log(smi)
    return name, smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(build.SOURCES, ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        log(f"[build] {name}: {secs!r} s\n{text.strip()}")
    return secs


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

def _decode_case(torch, gen, b, h, hkv, d, dtype, zero_den=False):
    """Warm f32 state (3 rank-1 updates with unit k) and unit q/k rows,
    as the model hands them over after l2 normalization."""
    from repro_torch.kernels import decode_fused as df

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return x / x.norm(dim=-1, keepdim=True)

    s = torch.zeros((b, hkv, d, d + 1), device="cuda")
    p = torch.zeros((b, hkv, d + 1), device="cuda")
    for _ in range(3):
        df.la_decode_fused_torch(
            s, p, unit(b, h, d), unit(b, hkv, d),
            torch.randn((b, hkv, d), generator=gen, device="cuda"), 1.0, 1.0)
    q, k = unit(b, h, d), unit(b, hkv, d)
    v = torch.randn((b, hkv, d), generator=gen, device="cuda")
    if zero_den:
        # slot 0, KV head 0: after the update p[dv] == 0 and q == 0, so
        # the normalizer is exactly 0 while the numerators are not
        p[0, 0, d] = -1.0
        q[0, :h // hkv] = 0.0
    return s, p, q.to(dtype), k.to(dtype), v.to(dtype)


def phase_kernel(torch):
    from repro_torch.kernels import decode_fused as df
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cases = [("main_bf16", 8, 16, 16, 128, torch.bfloat16, False),
             ("main_f32", 8, 16, 16, 128, torch.float32, False),
             ("gqa_bf16", 8, 16, 4, 128, torch.bfloat16, False),
             ("zero_den_f32", 8, 16, 16, 128, torch.float32, True)]
    errs = {}
    for label, b, h, hkv, d, dtype, zero_den in cases:
        s, p, q, k, v = _decode_case(torch, gen, b, h, hkv, d, dtype,
                                     zero_den)
        s_k, p_k = s.clone(), p.clone()
        ptrs = (s_k.data_ptr(), p_k.data_ptr())
        o_k = df.la_decode_fused_cuda(s_k, p_k, q, k, v, 1.0, 1.0)
        torch.cuda.synchronize()
        o_t = df.la_decode_fused_torch(s, p, q, k, v, 1.0, 1.0)
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} D={d} {dtype}")
        if (s_k.data_ptr(), p_k.data_ptr()) != ptrs:
            raise AssertionError(f"{label}: state was reallocated")
        check_close(f"{label} s (in place)", s_k, s, F32_REL)
        check_close(f"{label} p (in place)", p_k, p, F32_REL)
        rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
        errs[label] = check_close(f"{label} o", o_k, o_t, rel)
        if o_k.dtype != dtype or not torch.isfinite(o_k).all():
            raise AssertionError(f"{label}: o dtype {o_k.dtype} or "
                                 f"non-finite values")
        if zero_den and float(o_k[0, :h // hkv].abs().max()) != 0.0:
            raise AssertionError("zero normalizer did not give 0")
    return errs


def _la_case(torch, gen, b, h, hkv, n, d, dtype):
    """Unit q/k rows (as the model hands them over after l2
    normalization), normal v and upstream grad, and the plain forward's
    o and g with the backward's Ω̂ and h prepared from them."""
    from repro_torch.core import chunked
    from repro_torch.kernels import linear_attention as la

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    q, k = unit(b, h, n, d), unit(b, hkv, n, d)
    v = torch.randn((b, hkv, n, d), generator=gen, device="cuda").to(dtype)
    omega = torch.randn((b, h, n, d), generator=gen, device="cuda")
    o, g = la.la_fwd_torch(q, k, v, 1.0, 1.0)
    om_hat, h_vec = chunked.la_bwd_prep(o, g, omega)
    return q, k, v, om_hat, h_vec


def phase_kernel_la(torch):
    """la_fwd, la_bwd_q and la_bwd_kv against their plain versions."""
    from repro_torch.kernels import linear_attention as la
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    m = LA_SHAPE
    cases = [("main_bf16", m["b"], m["h"], m["hkv"], m["n"], torch.bfloat16),
             ("main_f32", m["b"], m["h"], m["hkv"], m["n"], torch.float32),
             ("odd_n_bf16", m["b"], m["h"], m["hkv"], 1000, torch.bfloat16),
             ("gqa_f32", m["b"], m["h"], 4, 1000, torch.float32),
             ("gqa_bf16", m["b"], m["h"], 4, 1000, torch.bfloat16)]
    errs = {}
    for label, b, h, hkv, n, dtype in cases:
        q, k, v, om_hat, h_vec = _la_case(torch, gen, b, h, hkv, n,
                                          m["d"], dtype)
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} N={n} D={m['d']} "
            f"{dtype}")
        rel = BF16_REL if dtype == torch.bfloat16 else SEQ_F32_REL
        o_k, g_k = la.la_fwd_cuda(q, k, v, 1.0, 1.0)
        dq_k = la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)
        dk_k, dv_k = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
        torch.cuda.synchronize()
        o_t, g_t = la.la_fwd_torch(q, k, v, 1.0, 1.0)
        dq_t = la.la_bwd_q_torch(k, v, om_hat, h_vec, 1.0)
        dk_t, dv_t = la.la_bwd_kv_torch(q, k, v, om_hat, h_vec, 1.0, 1.0)
        e = {"la_fwd": check_close(f"{label} o", o_k, o_t, rel)}
        check_close(f"{label} g", g_k, g_t, SEQ_F32_REL)
        e["la_bwd_q"] = check_close(f"{label} dq", dq_k, dq_t, rel)
        e["la_bwd_kv"] = max(check_close(f"{label} dk", dk_k, dk_t, rel),
                             check_close(f"{label} dv", dv_k, dv_t, rel))
        for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k),
                        ("dv", dv_k)):
            if t.dtype != dtype or not torch.isfinite(t).all():
                raise AssertionError(f"{label} {name}: dtype {t.dtype} or "
                                     f"non-finite values")
        errs[label] = e
        del q, k, v, om_hat, h_vec, o_k, g_k, dq_k, dk_k, dv_k, o_t, g_t, \
            dq_t, dk_t, dv_t
    return errs


def _softmax_rel(torch, dtype, grad=False):
    if dtype == torch.float32:
        return SOFTMAX_F32_REL
    return SOFTMAX_BF16_GRAD_REL if grad else SOFTMAX_BF16_O_REL


def _decode_softmax_case(torch, gen, b, h, hkv, s_len, d, dtype):
    """Normal q/k/v (unnormalized, as the softmax mixer hands them over)
    and per-slot lengths in [1, S], slot 0 one past the cache (a retired
    slot decoding as padding)."""
    q = torch.randn((b, h, 1, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, s_len, d), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    lengths = torch.randint(1, s_len + 1, (b,), generator=gen,
                            device="cuda").to(torch.int32)
    lengths[0] = s_len + 1
    return q, k, v, lengths


def _flash_case(torch, gen, b, h, hkv, nq, d, dtype, nk=None):
    nk = nq if nk is None else nk
    q = torch.randn((b, h, nq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, hkv, nk, d), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    do = torch.randn((b, h, nq, d), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def phase_kernel_softmax(torch):
    """softmax_decode_fused, flash_fwd and the three flash backward
    kernels against their plain versions."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import flash_attention as fl
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    for label, b, h, hkv, s_len, d, dtype in (
            ("decode_main_bf16", SLOTS, 16, 16, MAX_LEN, 128, bf16),
            ("decode_main_f32", SLOTS, 16, 16, MAX_LEN, 128, f32),
            ("decode_gqa_bf16", SLOTS, 16, 4, MAX_LEN, 128, bf16)):
        q, k, v, lengths = _decode_softmax_case(torch, gen, b, h, hkv, s_len,
                                                d, dtype)
        o_k = df.softmax_decode_fused_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        o_t = df.softmax_decode_fused_torch(q, k, v, lengths)
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} S={s_len} D={d} "
            f"{dtype}, lengths {lengths.tolist()}")
        errs[label] = {"softmax_decode_fused": check_close(
            f"{label} o", o_k, o_t, _softmax_rel(torch, dtype))}
        if o_k.dtype != dtype or not torch.isfinite(o_k).all():
            raise AssertionError(f"{label}: o dtype {o_k.dtype} or "
                                 f"non-finite values")
        # length 0: the kernel writes zeros (as the Pallas kernel does)
        lengths[1] = 0
        o_0 = df.softmax_decode_fused_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        if float(o_0[1].abs().max()) != 0.0:
            raise AssertionError(f"{label}: a length-0 slot is not zeros")
        log(f"  {label}: a length-0 slot gives zeros")

    m = LA_SHAPE
    for label, b, h, hkv, nq, nk, off, dtype in (
            ("flash_main_bf16", m["b"], m["h"], m["hkv"], m["n"], None,
             None, bf16),
            ("flash_main_f32", m["b"], m["h"], m["hkv"], m["n"], None, None,
             f32),
            ("flash_odd_n_bf16", m["b"], m["h"], m["hkv"], 1000, None, None,
             bf16),
            ("flash_gqa_f32", m["b"], m["h"], 4, 1000, None, None, f32),
            ("flash_gqa_bf16", m["b"], m["h"], 4, 1000, None, None, bf16),
            ("flash_prefill_bf16", m["b"], m["h"], m["hkv"], PREFILL_CHUNK,
             MAX_LEN, [0, PREFILL_CHUNK], bf16),
            ("flash_prefill_f32", m["b"], m["h"], m["hkv"], PREFILL_CHUNK,
             MAX_LEN, [0, PREFILL_CHUNK], f32)):
        q, k, v, do = _flash_case(torch, gen, b, h, hkv, nq, m["d"], dtype,
                                  nk)
        q_off = None if off is None else torch.tensor(
            off, dtype=torch.int32, device="cuda")
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} Nq={nq} "
            f"Nk={nk or nq} D={m['d']} {dtype} q_offset={off}")
        o_k, lse_k = fl.flash_fwd_cuda(q, k, v, q_off)
        torch.cuda.synchronize()
        o_t, lse_t = fl.flash_fwd_torch(q, k, v, q_off)
        e = {"flash_fwd": check_close(f"{label} o", o_k, o_t,
                                      _softmax_rel(torch, dtype))}
        check_close(f"{label} lse", lse_k, lse_t, SOFTMAX_F32_REL)
        outs = [("o", o_k)]
        if off is None:
            # the backward from the plain forward's residuals
            delta_k = fl.flash_bwd_delta_cuda(o_t, do)
            dq_k = fl.flash_bwd_q_cuda(q, k, v, do, lse_t, delta_k)
            dk_k, dv_k = fl.flash_bwd_kv_cuda(q, k, v, do, lse_t, delta_k)
            torch.cuda.synchronize()
            delta_t = fl.flash_bwd_delta_torch(o_t, do)
            dq_t = fl.flash_bwd_q_torch(q, k, v, do, lse_t, delta_t)
            dk_t, dv_t = fl.flash_bwd_kv_torch(q, k, v, do, lse_t, delta_t)
            grel = _softmax_rel(torch, dtype, grad=True)
            e["flash_bwd_delta"] = check_close(f"{label} delta", delta_k,
                                               delta_t, SOFTMAX_F32_REL)
            e["flash_bwd_q"] = check_close(f"{label} dq", dq_k, dq_t, grel)
            e["flash_bwd_kv"] = max(
                check_close(f"{label} dk", dk_k, dk_t, grel),
                check_close(f"{label} dv", dv_k, dv_t, grel))
            outs += [("dq", dq_k), ("dk", dk_k), ("dv", dv_k)]
        for name, t in outs:
            if t.dtype != dtype or not torch.isfinite(t).all():
                raise AssertionError(f"{label} {name}: dtype {t.dtype} or "
                                     f"non-finite values")
        errs[label] = e
        del q, k, v, do, o_k, lse_k, o_t, lse_t, outs
        torch.cuda.empty_cache()
    return errs


def _paged_case(torch, gen, b, h, hkv, d, ps, pmax, lengths, dtype):
    """q and arenas of B * Pmax + 1 pages in `dtype` (every row random, so
    the rows past a slot's length are garbage its walk must not read), a
    shuffled table naming each slot's pages for its live keys and the sink
    (the last page) beyond them, and `lengths`."""
    num_pages = b * pmax + 1
    q = torch.randn((b, h, 1, d), generator=gen, device="cuda").to(dtype)
    kp, vp = (torch.randn((num_pages, hkv, ps, d), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    perm = torch.randperm(num_pages - 1, generator=gen, device="cuda").to(
        torch.int32).reshape(b, pmax)
    live = (lengths.clamp(max=pmax * ps) + ps - 1) // ps
    cols = torch.arange(pmax, device="cuda")
    table = torch.where(cols[None, :] < live[:, None], perm,
                        num_pages - 1).to(torch.int32)
    return q, kp, vp, table, lengths


def phase_kernel_paged(torch):
    """paged_decode_fused and paged_attention against their plain
    versions."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import paged_attention as pg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    kernels = (("paged_decode_fused", df.paged_decode_fused_cuda),
               ("paged_attention", pg.paged_attention_cuda))
    errs = {}
    for label, hkv, ps, dtype in (
            ("paged_main_bf16", 16, PAGE_SIZE, torch.bfloat16),
            ("paged_main_f32", 16, PAGE_SIZE, torch.float32),
            ("paged_gqa_ps5_bf16", 4, 5, torch.bfloat16),
            ("paged_gqa_ps5_f32", 4, 5, torch.float32)):
        b, h, d = SLOTS, 16, 128
        pmax = -(-MAX_LEN // ps)
        lengths = torch.randint(1, MAX_LEN + 1, (b,), generator=gen,
                                device="cuda").to(torch.int32)
        lengths[0] = pmax * ps + 1       # a retired slot past its table
        case = _paged_case(torch, gen, b, h, hkv, d, ps, pmax, lengths,
                           dtype)
        want = pg.paged_attention_torch(*case)
        rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} D={d} ps={ps} "
            f"Pmax={pmax} {dtype}, lengths {lengths.tolist()}")
        errs[label] = {}
        for name, kernel in kernels:
            o = kernel(*case)
            torch.cuda.synchronize()
            errs[label][name] = check_close(f"{label} {name} o", o, want,
                                            rel)
            if o.dtype != dtype or not torch.isfinite(o).all():
                raise AssertionError(f"{label} {name}: o dtype {o.dtype} "
                                     f"or non-finite values")
        # length 0: zeros on both kernels (and on the plain version)
        lengths[1] = 0
        for name, kernel in kernels:
            o = kernel(*case)
            torch.cuda.synchronize()
            if float(o[1].abs().max()) != 0.0:
                raise AssertionError(f"{label} {name}: a length-0 slot is "
                                     f"not zeros")
        log(f"  {label}: a length-0 slot gives zeros on both kernels")
        del case, want
    return errs


def _log_decay(torch, gen, shape, regime):
    """The trained gate's regime, log_sigmoid(N(0, 1) + 6), or a hard
    one, U[-5, 0]: an off-by-one in the decay index passes the first and
    fails the second."""
    if regime == "trained":
        return torch.nn.functional.logsigmoid(
            torch.randn(shape, generator=gen, device="cuda") + 6.0)
    return -5.0 * torch.rand(shape, generator=gen, device="cuda")


def _gla_decode_case(torch, gen, b, h, hkv, d, dtype, regime):
    """_decode_case's inputs and a log decay; slot 0, KV head 0 decays by
    exactly 1 so that its zero normalizer survives the gate."""
    s, p, q, k, v = _decode_case(torch, gen, b, h, hkv, d, dtype,
                                 zero_den=True)
    ld = _log_decay(torch, gen, (b, hkv), regime)
    ld[0, 0] = 0.0
    return s, p, q, k, v, ld


def _gla_case(torch, gen, b, h, hkv, n, d, dtype, regime):
    """_la_case's inputs with a log decay, the plain GLA forward's o and
    g, and the backward's Ω̂ and h prepared from them."""
    from repro_torch.core import chunked
    from repro_torch.kernels import gla

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    q, k = unit(b, h, n, d), unit(b, hkv, n, d)
    v = torch.randn((b, hkv, n, d), generator=gen, device="cuda").to(dtype)
    ld = _log_decay(torch, gen, (b, hkv, n), regime)
    omega = torch.randn((b, h, n, d), generator=gen, device="cuda")
    o, g = gla.gla_fwd_torch(q, k, v, ld, 1.0, 1.0)
    om_hat, h_vec = chunked.la_bwd_prep(o, g, omega)
    return q, k, v, ld, om_hat, h_vec


def phase_kernel_gla(torch):
    """gla_decode_fused, gla_fwd, gla_bwd_q and gla_bwd_kv against their
    plain versions, under both decay regimes; at log_decay = 0 against
    the linear kernels."""
    from repro_torch.core import gla as core_gla
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    for label, hkv, dtype, regime in (
            ("decode_main_bf16", 16, bf16, "trained"),
            ("decode_main_f32_strong", 16, f32, "strong"),
            ("decode_main_bf16_strong", 16, bf16, "strong"),
            ("decode_gqa_bf16_strong", 4, bf16, "strong"),
            ("decode_gqa_f32", 4, f32, "trained")):
        b, h, d = SLOTS, 16, 128
        s, p, q, k, v, ld = _gla_decode_case(torch, gen, b, h, hkv, d, dtype,
                                             regime)
        s_k, p_k = s.clone(), p.clone()
        ptrs = (s_k.data_ptr(), p_k.data_ptr())
        o_k = df.gla_decode_fused_cuda(s_k, p_k, q, k, v, ld, 1.0, 1.0)
        torch.cuda.synchronize()
        o_t = df.gla_decode_fused_torch(s, p, q, k, v, ld, 1.0, 1.0)
        log(f"[kernel] gla {label}: B={b} H={h} Hkv={hkv} D={d} {dtype}, "
            f"log decay {regime}")
        if (s_k.data_ptr(), p_k.data_ptr()) != ptrs:
            raise AssertionError(f"{label}: state was reallocated")
        check_close(f"gla {label} s (in place)", s_k, s, F32_REL)
        check_close(f"gla {label} p (in place)", p_k, p, F32_REL)
        rel = BF16_REL if dtype == bf16 else F32_REL
        errs[label] = {"gla_decode_fused": check_close(
            f"gla {label} o", o_k, o_t, rel)}
        if o_k.dtype != dtype or not torch.isfinite(o_k).all():
            raise AssertionError(f"{label}: o dtype {o_k.dtype} or "
                                 f"non-finite values")
        if float(o_k[0, :h // hkv].abs().max()) != 0.0:
            raise AssertionError(f"{label}: zero normalizer did not give 0")

    m = LA_SHAPE
    for label, n, hkv, dtype, regime in (
            ("main_bf16", m["n"], m["hkv"], bf16, "trained"),
            ("main_bf16_strong", m["n"], m["hkv"], bf16, "strong"),
            ("main_f32_strong", m["n"], m["hkv"], f32, "strong"),
            ("odd_n_bf16_strong", 1000, m["hkv"], bf16, "strong"),
            ("gqa_f32", 1000, 4, f32, "trained"),
            ("gqa_bf16_strong", 1000, 4, bf16, "strong")):
        b, h, d = m["b"], m["h"], m["d"]
        q, k, v, ld, om_hat, h_vec = _gla_case(torch, gen, b, h, hkv, n, d,
                                               dtype, regime)
        log(f"[kernel] gla {label}: B={b} H={h} Hkv={hkv} N={n} D={d} "
            f"{dtype}, log decay {regime}")
        rel = BF16_REL if dtype == bf16 else SEQ_F32_REL
        o_k, g_k = gla.gla_fwd_cuda(q, k, v, ld, 1.0, 1.0)
        dq_k = gla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, 1.0)
        dk_k, dva_k = gla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0,
                                          1.0)
        torch.cuda.synchronize()
        o_t, g_t = gla.gla_fwd_torch(q, k, v, ld, 1.0, 1.0)
        dq_t = gla.gla_bwd_q_torch(k, v, ld, om_hat, h_vec, 1.0)
        dk_t, dva_t = gla.gla_bwd_kv_torch(q, k, v, ld, om_hat, h_vec, 1.0,
                                           1.0)
        dv_k, dld_k = core_gla.gla_bwd_epilogue(v, dva_k, ld)
        dv_t, dld_t = core_gla.gla_bwd_epilogue(v, dva_t, ld)
        e = {"gla_fwd": check_close(f"gla {label} o", o_k, o_t, rel)}
        check_close(f"gla {label} g", g_k, g_t, SEQ_F32_REL)
        e["gla_bwd_q"] = check_close(f"gla {label} dq", dq_k, dq_t, rel)
        e["gla_bwd_kv"] = max(
            check_close(f"gla {label} dk", dk_k, dk_t, rel),
            check_close(f"gla {label} dv", dv_k, dv_t, rel),
            check_close(f"gla {label} dV' (f32)", dva_k, dva_t,
                        SEQ_F32_REL))
        e["dld"] = check_close(f"gla {label} dld", dld_k, dld_t, DLD_REL)
        for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k),
                        ("dv", dv_k)):
            if t.dtype != dtype or not torch.isfinite(t).all():
                raise AssertionError(f"gla {label} {name}: dtype {t.dtype} "
                                     f"or non-finite values")
        if not torch.isfinite(dld_k).all():
            raise AssertionError(f"gla {label}: non-finite dld")
        errs[label] = e
        del q, k, v, ld, om_hat, h_vec, o_k, g_k, dq_k, dk_k, dva_k, o_t, \
            g_t, dq_t, dk_t, dva_t, dv_k, dld_k, dv_t, dld_t
        torch.cuda.empty_cache()

    # log_decay = 0: each gated kernel against its linear counterpart, f32
    # at the training and serving shapes
    ld0 = {}
    b, h, hkv, n, d = m["b"], m["h"], m["hkv"], m["n"], m["d"]
    q, k, v, _, om_hat, h_vec = _gla_case(torch, gen, b, h, hkv, n, d, f32,
                                          "trained")
    zero = torch.zeros((b, hkv, n), device="cuda")
    o_g, g_g = gla.gla_fwd_cuda(q, k, v, zero, 1.0, 1.0)
    o_l, g_l = la.la_fwd_cuda(q, k, v, 1.0, 1.0)
    dk_g, dva_g = gla.gla_bwd_kv_cuda(q, k, v, zero, om_hat, h_vec, 1.0,
                                      1.0)
    dk_l, dv_l = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
    pairs = [("o", o_g, o_l), ("g", g_g, g_l),
             ("dq", gla.gla_bwd_q_cuda(k, v, zero, om_hat, h_vec, 1.0),
              la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)),
             ("dk", dk_g, dk_l), ("dv", dva_g[..., :d], dv_l)]
    s, p, qd, kd, vd, _ = _gla_decode_case(torch, gen, SLOTS, 16, 16, 128,
                                           f32, "trained")
    s2, p2 = s.clone(), p.clone()
    pairs.append(("decode o", df.gla_decode_fused_cuda(
        s, p, qd, kd, vd, torch.zeros((SLOTS, 16), device="cuda"), 1.0,
        1.0), df.la_decode_fused_cuda(s2, p2, qd, kd, vd, 1.0, 1.0)))
    pairs.append(("decode s", s, s2))
    torch.cuda.synchronize()
    for name, got, want in pairs:
        ld0[name] = check_close(f"gla at log_decay = 0 vs linear, {name}",
                                got, want, LD0_REL)
    log(f"  log_decay = 0: bit-identical to the linear kernels: "
        f"{[name for name, got, want in pairs if torch.equal(got, want)]}")
    errs["ld0_vs_linear"] = ld0
    del q, k, v, om_hat, h_vec, pairs
    torch.cuda.empty_cache()
    return errs


def _ssd_case(torch, gen, b, g, h, n, dk, dv, dtype, regime):
    """Grouped q, k (B, G, N, Dk) at the scale of a conv'd silu output,
    v and the upstream grad (B, H, N, Dv), and a log decay (B, H, N): a
    fresh layer's, -softplus(N(0, 1)) (exp(a_log) = 1), or the hard
    U[-5, 0], where an off-by-one in the decay index fails."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    if regime == "init":
        ld = -torch.nn.functional.softplus(normal(b, h, n))
    else:
        ld = -5.0 * torch.rand((b, h, n), generator=gen, device="cuda")
    return ((0.5 * normal(b, g, n, dk)).to(dtype),
            (0.5 * normal(b, g, n, dk)).to(dtype),
            normal(b, h, n, dv).to(dtype), ld, normal(b, h, n, dv).to(dtype))


def phase_kernel_ssd(torch):
    """ssd_fwd, ssd_bwd_q and ssd_bwd_kv against their plain versions at
    mamba2-2.7b's training shapes, odd N and G > 1, bf16 and f32, under
    both decay regimes: o, the f32 partials of dq and dk, dv, and after
    the PyTorch epilogue (the group sums and dld, from each path's
    partials and the same o) dq, dk, dv and dld; at log_decay = 0 the
    forward against unnormalized causal linear attention."""
    from repro_torch.core import ssd as core_ssd
    from repro_torch.kernels import ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    bf16, f32 = torch.bfloat16, torch.float32
    m = SSD_SHAPE
    dk, dv = m["dk"], m["dv"]
    errs = {}
    for label, n, g, h, dtype, regime in (
            ("main_bf16", m["n"], m["g"], m["h"], bf16, "init"),
            ("main_bf16_strong", m["n"], m["g"], m["h"], bf16, "strong"),
            ("main_f32_strong", m["n"], m["g"], m["h"], f32, "strong"),
            ("odd_n_bf16_strong", 1000, m["g"], m["h"], bf16, "strong"),
            ("groups_f32", 1000, 4, 16, f32, "init"),
            ("groups_bf16_strong", 1000, 4, 16, bf16, "strong")):
        b = m["b"]
        q, k, v, ld, om = _ssd_case(torch, gen, b, g, h, n, dk, dv, dtype,
                                    regime)
        log(f"[kernel] ssd {label}: B={b} G={g} H={h} N={n} Dk={dk} "
            f"Dv={dv} {dtype}, log decay {regime}")
        rel = BF16_REL if dtype == bf16 else SEQ_F32_REL
        o_k = ssd.ssd_fwd_cuda(q, k, v, ld)
        dq_pk = ssd.ssd_bwd_q_cuda(k, v, ld, om)
        dk_pk, dv_k = ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
        torch.cuda.synchronize()
        o_t = ssd.ssd_fwd_torch(q, k, v, ld)
        dq_pt = ssd.ssd_bwd_q_torch(k, v, ld, om)
        dk_pt, dv_t = ssd.ssd_bwd_kv_torch(q, k, v, ld, om)
        e = {"ssd_fwd": check_close(f"ssd {label} o", o_k, o_t, rel),
             "ssd_bwd_q": check_close(f"ssd {label} dq partials (f32)",
                                      dq_pk, dq_pt, SEQ_F32_REL),
             "ssd_bwd_kv": max(
                 check_close(f"ssd {label} dk partials (f32)", dk_pk, dk_pt,
                             SEQ_F32_REL),
                 check_close(f"ssd {label} dv (f32)", dv_k, dv_t,
                             SEQ_F32_REL))}
        fin_k = core_ssd.ssd_bwd_epilogue(q, k, v, ld, o_t, om, dq_pk, dk_pk,
                                          dv_k)
        fin_t = core_ssd.ssd_bwd_epilogue(q, k, v, ld, o_t, om, dq_pt, dk_pt,
                                          dv_t)
        for name, got, want in zip(("dq", "dk", "dv"), fin_k, fin_t):
            e[name] = check_close(f"ssd {label} {name}", got, want, rel)
        e["dld"] = check_close(f"ssd {label} dld", fin_k[3], fin_t[3],
                               DLD_REL)
        for name, t in (("o", o_k), ("dq", fin_k[0]), ("dk", fin_k[1]),
                        ("dv", fin_k[2])):
            if t.dtype != dtype or not torch.isfinite(t).all():
                raise AssertionError(f"ssd {label} {name}: dtype {t.dtype} "
                                     f"or non-finite values")
        if not torch.isfinite(fin_k[3]).all():
            raise AssertionError(f"ssd {label}: non-finite dld")
        errs[label] = e
        del q, k, v, ld, om, o_k, dq_pk, dk_pk, dv_k, o_t, dq_pt, dk_pt, \
            dv_t, fin_k, fin_t
        torch.cuda.empty_cache()

    # log_decay = 0: unnormalized causal linear attention (the
    # reference's tests/test_kernels_ssd.py checks its kernel so)
    b, g, h, n = m["b"], 1, m["h"], 1000
    q, k, v, _, _ = _ssd_case(torch, gen, b, g, h, n, dk, dv, f32, "init")
    o_k = ssd.ssd_fwd_cuda(q, k, v, torch.zeros((b, h, n), device="cuda"))
    scores = torch.einsum("bgid,bgjd->bgij", q, k).tril()
    o_la = torch.einsum("bgij,bghjd->bghid", scores,
                        v.reshape(b, g, h // g, n, dv)).reshape(b, h, n, dv)
    errs["ld0_vs_linear"] = check_close(
        "ssd at log_decay = 0 vs unnormalized causal linear attention", o_k,
        o_la, SEQ_F32_REL)
    del q, k, v, o_k, scores, o_la
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# 4. main path: the engine at full width
# ---------------------------------------------------------------------------

def _clone_cache(cache):
    return {"blocks": [type(st)(*(t.clone() for t in st))
                       for st in cache["blocks"]],
            "pos": cache["pos"].clone()}


def _with_impl(cfg, impl):
    return dataclasses.replace(cfg, la=dataclasses.replace(cfg.la,
                                                           backend=impl))


def _config(backend):
    """Full-width pythia-1.4b with the attention backend `backend`, or
    for "mamba2" full-width mamba2-2.7b."""
    from repro_torch.configs.registry import get_config
    if backend == "mamba2":
        return get_config("mamba2-2.7b")
    return get_config("pythia-1.4b", attention_backend=backend)


def phase_serve(torch, np, backend):
    """The engine at full width with `backend`'s mixer (pythia-1.4b, or
    mamba2-2.7b for "mamba2"); returns (record, the run's launches)."""
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine, Request

    cfg = _config(backend)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    # eos_id=-1: random weights give no meaningful eos, so every request
    # decodes exactly MAX_NEW tokens
    engine = Engine(cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
                    prefill_chunk=PREFILL_CHUNK, eos_id=-1, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, cfg.vocab_size, size=(SLOTS, PROMPT_LEN))
    for rid in range(SLOTS):
        engine.submit(Request(rid=rid, prompt=prompts[rid].tolist(),
                              max_new_tokens=MAX_NEW))

    reset_launches()
    t_start = time.perf_counter()
    first = {}
    for out in engine.stream():
        if out.token is not None and out.rid not in first:
            first[out.rid] = out.t - t_start
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_launches()
    steps = engine.decode_steps
    windows = SLOTS * -(-PROMPT_LEN // PREFILL_CHUNK)
    # mamba2: no kernel at all; the reference serves it through the plain
    # SSD scan (prefill) and step (decode), and has no SSD decode kernel
    want = {"linear": {"la_decode_fused": cfg.num_layers * steps},
            "gla": {"gla_decode_fused": cfg.num_layers * steps},
            "softmax": {"softmax_decode_fused": cfg.num_layers * steps,
                        "flash_fwd": cfg.num_layers * windows},
            "mamba2": {}}[backend]
    log(f"[serve {backend}] {cfg.name}: {SLOTS} requests x {PROMPT_LEN} "
        f"prompt tokens, {MAX_NEW} new: {steps} decode steps, {windows} "
        f"prefill windows, launches {launches}, wall {wall!r} s (init "
        f"{init_s!r} s)" + ("; no SSD kernel runs while serving, as in the "
                            "reference (plain scan and step)"
                            if backend == "mamba2" else ""))
    if steps < MAX_NEW - 1:
        raise AssertionError(f"{steps} decode steps for {MAX_NEW} tokens")
    expect_launches(f"serve {backend}", launches, want)
    for rid in range(SLOTS):
        toks = engine.request(rid).generated
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"request {rid} generated {toks}")

    # steady batched decode step on the engine's full-batch cache
    tokens = torch.from_numpy(engine.next_tokens).to("cuda")
    step_dev_ms, step_host_ms, profile = _steady_decode(
        torch, mdl, engine.params, engine.cfg, engine.cache, tokens,
        f"decode step ({backend})")
    peak = torch.cuda.max_memory_allocated()

    # the first decode steps' logits, kernel path vs plain path, from one
    # prefilled cache (cloned) and the same fed tokens
    prompt_t = torch.from_numpy(prompts).to("cuda")
    logits, cache0 = mdl.prefill(engine.params, engine.cfg,
                                 {"tokens": prompt_t},
                                 mdl.init_cache(cfg, SLOTS, MAX_LEN, "cuda"))
    tok = logits.argmax(-1)
    cache_k, cache_t = _clone_cache(cache0), _clone_cache(cache0)
    del cache0
    cfg_k, cfg_t = _with_impl(engine.cfg, "cuda"), _with_impl(engine.cfg,
                                                              "torch")
    logit_errs = []
    for i in range(COMPARE_STEPS):
        lk, cache_k = mdl.decode_step(engine.params, cfg_k, cache_k, tok)
        lt, cache_t = mdl.decode_step(engine.params, cfg_t, cache_t, tok)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        logit_errs.append(check_close(f"full-width {backend} decode step "
                                      f"{i} logits (cuda vs torch)", lk, lt,
                                      LOGITS_REL))
        tok = lk.argmax(-1)

    ttft = [first[r] for r in range(SLOTS)]
    record = {
        "arch": cfg.name, "attention_backend": backend,
        "compute_dtype": cfg.compute_dtype,
        "kernels_on_path": sorted(want),
        "slots": SLOTS, "prompt_len": PROMPT_LEN,
        "prefill_chunk": PREFILL_CHUNK, "max_new": MAX_NEW,
        "max_len": MAX_LEN, "decode_steps": steps,
        "prefill_windows": windows, "kernel_launches": launches,
        "wall_s": wall,
        "generated_tokens_per_s": SLOTS * MAX_NEW / wall,
        "ttft_s": ttft, "ttft_mean_s": sum(ttft) / len(ttft),
        "ttft_max_s": max(ttft),
        "decode_step_ms_device": step_dev_ms,
        "decode_step_ms_host": step_host_ms,
        "decode_step_profile": profile,
        "decode_tokens_per_s": SLOTS / (step_host_ms / 1e3),
        "max_memory_allocated_bytes": peak,
        "logits_max_abs_err": logit_errs,
    }
    del engine, cache_k, cache_t
    torch.cuda.empty_cache()
    return record, launches


def _steady_decode(torch, mdl, params, cfg, cache, tokens, label):
    """The batched decode step on `cache` (updated in place), after 3
    warm-up steps: (device ms and host ms per step over 20 steps, the
    profile of 5 more)."""
    for _ in range(3):
        mdl.decode_step(params, cfg, cache, tokens)
    n_timed = 20
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(n_timed):
        mdl.decode_step(params, cfg, cache, tokens)
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / n_timed
    profile = _profile(torch, label,
                       lambda: mdl.decode_step(params, cfg, cache, tokens),
                       steps=5)
    return ev0.elapsed_time(ev1) / n_timed, host_ms, profile


def _profile(torch, label, fn, steps):
    """torch.profiler over `steps` calls of `fn` (one step each): the
    device's kernel time and launches per step, its busy share of the
    wall time and the kernels that take the most device time.  None
    where the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3 / steps
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        log(f"[profile] {label}: the profiler recorded no device activity")
        return None
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    rec = {"steps": steps, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "device_kernels_per_step": sum(e.count for e in rows) / steps,
           "top_kernels_ms_per_step": {
               e.key[:80]: e.self_device_time_total / 1e3 / steps
               for e in top}}
    log(f"[profile] {label}: {rec}")
    return rec


def _serve_paged_logits(torch, np, params, cfg, table, what):
    """The first decode steps' logits of one prefilled paged batch (8
    prompts of PROMPT_LEN, every slot's pages named by `table` in an
    arena of table.numel() + 1 pages): kernel path against plain path on
    clones of the cache, and against the contiguous kernel path on the
    same prompts and fed tokens.  Returns (errors, the kernel path's
    config and cache, the last fed tokens)."""
    from repro_torch.configs.base import PagingCfg
    from repro_torch.models import model as mdl

    cfg_b = dataclasses.replace(cfg, paging=PagingCfg(PAGE_SIZE,
                                                      table.numel() + 1))
    cfg_c = dataclasses.replace(cfg, paging=None)
    cache = mdl.init_cache(cfg_b, SLOTS, MAX_LEN, "cuda")
    for layer in cache["blocks"]:
        layer.page_table.copy_(table)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        3, cfg.vocab_size, size=(SLOTS, PROMPT_LEN))).to("cuda")
    logits, cache = mdl.prefill(params, cfg_b, {"tokens": prompts}, cache)
    logits_c, cache_c = mdl.prefill(params, cfg_c, {"tokens": prompts},
                                    mdl.init_cache(cfg_c, SLOTS, MAX_LEN,
                                                   "cuda"))
    errs = {"prefill_vs_contiguous": check_close(
        f"{what} prefill logits (vs contiguous)", logits, logits_c,
        LOGITS_REL), "vs_plain": [], "vs_contiguous": []}
    tok = logits.argmax(-1)
    cache_t = _clone_cache(cache)
    cfg_k, cfg_t = _with_impl(cfg_b, "cuda"), _with_impl(cfg_b, "torch")
    for i in range(COMPARE_STEPS):
        lk, cache = mdl.decode_step(params, cfg_k, cache, tok)
        lt, cache_t = mdl.decode_step(params, cfg_t, cache_t, tok)
        lc, cache_c = mdl.decode_step(params, cfg_c, cache_c, tok)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"{what} decode step {i}: non-finite "
                                 f"logits")
        errs["vs_plain"].append(check_close(
            f"full-width {what} decode step {i} logits (cuda vs torch)", lk,
            lt, LOGITS_REL))
        errs["vs_contiguous"].append(check_close(
            f"full-width {what} decode step {i} logits (vs contiguous "
            f"cuda)", lk, lc, LOGITS_REL))
        tok = lk.argmax(-1)
    del cache_t, cache_c
    return errs, cfg_k, cache, tok


def phase_serve_paged(torch, np):
    """The softmax baseline served from a paged KV arena at full width;
    returns (record, the fused run's launches, the unfused run's)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.serve.cache import page_bytes
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paging import PagedAdmission, pages_for

    cfg = get_config("pythia-1.4b", attention_backend="softmax")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    # the byte budget that buys PAGED_PAGES pages at this config
    budget = PAGED_PAGES * page_bytes(cfg, PAGE_SIZE)
    policy = PagedAdmission(budget, page_size=PAGE_SIZE, max_slots=SLOTS)
    engine = Engine(cfg, params, max_len=MAX_LEN, policy=policy,
                    prefill_chunk=PREFILL_CHUNK, eos_id=-1, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if engine.page_stats()["num_pages"] != PAGED_PAGES - 1:
        raise AssertionError(f"arena {engine.page_stats()}")
    rng = np.random.default_rng(0)
    lens = rng.integers(PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + 1,
                        size=PAGED_REQUESTS)
    for rid, n in enumerate(lens):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            3, cfg.vocab_size, size=int(n)).tolist(),
            max_new_tokens=MAX_NEW))
    reserved = sum(pages_for(int(n) + MAX_NEW - 1, PAGE_SIZE) for n in lens)

    reset_launches()
    t_start = time.perf_counter()
    first, waited, peak_pages = {}, set(), 0
    while engine.scheduler.has_work():
        outs = engine.step()
        peak_pages = max(peak_pages, engine.pool.pages_in_use)
        if engine.scheduler.blocked == "resources":
            waited.add(engine.scheduler.peek().rid)
        for out in outs:
            if out.token is not None and out.rid not in first:
                first[out.rid] = out.t - t_start
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = engine.decode_steps
    windows = sum(-(-int(n) // PREFILL_CHUNK) for n in lens)
    stats = engine.page_stats()
    log(f"[serve paged] {PAGED_REQUESTS} requests of {lens.tolist()} prompt "
        f"tokens, {MAX_NEW} new, page size {PAGE_SIZE}, {stats['num_pages']} "
        f"allocatable pages (budget {budget} B): {steps} decode steps, "
        f"{windows} prefill windows, launches {launches}, wall {wall!r} s "
        f"(init {init_s!r} s); {len(waited)} requests waited for pages at "
        f"the queue head; {reserved} pages reserved in all, peak in use "
        f"{peak_pages}; at the end {stats}")
    expect_launches("serve paged", launches,
                    {"paged_decode_fused": cfg.num_layers * steps,
                     "flash_fwd": cfg.num_layers * windows})
    for rid in range(PAGED_REQUESTS):
        toks = engine.request(rid).generated
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"request {rid} generated {toks}")
    if stats["free_pages"] != stats["num_pages"] or stats["pages_in_use"] \
            or peak_pages > PAGED_PAGES - 1 or reserved <= peak_pages:
        raise AssertionError(f"pages: {stats}, peak {peak_pages}, "
                             f"reserved {reserved} (freed pages reused?)")
    if not waited:
        raise AssertionError("no admission waited for pages")

    params = engine.params
    del engine
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    table = torch.randperm(SLOTS * PMAX, generator=gen, device="cuda").to(
        torch.int32).reshape(SLOTS, PMAX)
    logit_errs, cfg_k, cache, tok = _serve_paged_logits(torch, np, params,
                                                        cfg, table, "paged")
    # the steady batched decode step on the prefilled paged batch (every
    # slot past 512 keys, its pages shuffled over the arena)
    step_dev_ms, step_host_ms, profile = _steady_decode(
        torch, mdl, params, cfg_k, cache, tok, "decode step (softmax, paged)")
    del cache
    torch.cuda.empty_cache()

    # the unfused pass: decode through paged_attention
    engine = Engine(cfg, params, max_len=MAX_LEN, policy=policy,
                    prefill_chunk=PREFILL_CHUNK, eos_id=-1,
                    fused_decode=False, device="cuda")
    for rid in range(SLOTS):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            3, cfg.vocab_size, size=UNFUSED_PROMPT).tolist(),
            max_new_tokens=UNFUSED_NEW))
    reset_launches()
    engine.run()
    torch.cuda.synchronize()
    launches_unfused = read_launches()
    steps_u = engine.decode_steps
    log(f"[serve paged, fused_decode=False] {SLOTS} requests x "
        f"{UNFUSED_PROMPT} prompt tokens, {UNFUSED_NEW} new: {steps_u} "
        f"decode steps, launches {launches_unfused}")
    expect_launches("serve paged unfused", launches_unfused,
                    {"paged_attention": cfg.num_layers * steps_u,
                     "flash_fwd": cfg.num_layers * SLOTS})
    for rid in range(SLOTS):
        toks = engine.request(rid).generated
        if len(toks) != UNFUSED_NEW or not all(0 <= t < cfg.vocab_size
                                               for t in toks):
            raise AssertionError(f"unfused request {rid} generated {toks}")
    if engine.page_stats()["pages_in_use"]:
        raise AssertionError(f"unfused pages {engine.page_stats()}")

    ttft = [first[r] for r in range(PAGED_REQUESTS)]
    record = {
        "arch": cfg.name, "attention_backend": "softmax",
        "compute_dtype": cfg.compute_dtype, "policy": "PagedAdmission",
        "budget_bytes": budget, "page_size": PAGE_SIZE,
        "allocatable_pages": PAGED_PAGES - 1, "slots": SLOTS,
        "requests": PAGED_REQUESTS, "prompt_lens": lens.tolist(),
        "prefill_chunk": PREFILL_CHUNK, "max_new": MAX_NEW,
        "max_len": MAX_LEN, "decode_steps": steps,
        "prefill_windows": windows, "kernel_launches": launches,
        "requests_waited_for_pages": len(waited),
        "pages_reserved_in_all": reserved, "peak_pages_in_use": peak_pages,
        "page_stats_end": stats, "wall_s": wall,
        "generated_tokens_per_s": PAGED_REQUESTS * MAX_NEW / wall,
        "ttft_s": ttft, "ttft_mean_s": sum(ttft) / len(ttft),
        "ttft_max_s": max(ttft),
        "decode_step_ms_device": step_dev_ms,
        "decode_step_ms_host": step_host_ms,
        "decode_step_profile": profile,
        "decode_tokens_per_s": SLOTS / (step_host_ms / 1e3),
        "max_memory_allocated_bytes": peak,
        "logits_max_abs_err": logit_errs,
        "unfused": {"decode_steps": steps_u,
                    "kernel_launches": launches_unfused}}
    del engine, params
    torch.cuda.empty_cache()
    return record, launches, launches_unfused


def phase_serve_gla_paged(torch, np):
    """The GLA backend served from a paged state arena at full width;
    returns (record, the run's launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.serve.cache import state_page_bytes
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.paging import PagedAdmission

    cfg = get_config("pythia-1.4b", attention_backend="gla")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    page = state_page_bytes(cfg)
    budget = GLA_PAGED_PAGES * page
    policy = PagedAdmission(budget, page_size=PAGE_SIZE, max_slots=SLOTS)
    engine = Engine(cfg, params, max_len=MAX_LEN, policy=policy,
                    prefill_chunk=PREFILL_CHUNK, eos_id=-1, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if engine.page_stats()["num_pages"] != GLA_PAGED_PAGES - 1:
        raise AssertionError(f"arena {engine.page_stats()}")
    rng = np.random.default_rng(0)
    lens = rng.integers(PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + 1,
                        size=PAGED_REQUESTS)
    for rid, n in enumerate(lens):
        engine.submit(Request(rid=rid, prompt=rng.integers(
            3, cfg.vocab_size, size=int(n)).tolist(),
            max_new_tokens=MAX_NEW))

    reset_launches()
    t_start = time.perf_counter()
    first, waited, peak_pages, pages_of = {}, set(), 0, {}
    while engine.scheduler.has_work():
        outs = engine.step()
        peak_pages = max(peak_pages, engine.pool.pages_in_use)
        for rid in range(PAGED_REQUESTS):
            if engine.pool.holds(rid):
                pages_of.setdefault(rid, engine.pool.table(rid))
        if engine.scheduler.blocked == "resources":
            waited.add(engine.scheduler.peek().rid)
        for out in outs:
            if out.token is not None and out.rid not in first:
                first[out.rid] = out.t - t_start
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = engine.decode_steps
    stats = engine.page_stats()
    reused = len({p for t in pages_of.values() for p in t})
    log(f"[serve gla paged] {PAGED_REQUESTS} requests of {lens.tolist()} "
        f"prompt tokens, {MAX_NEW} new, {stats['num_pages']} allocatable "
        f"state pages of {page} B (budget {budget} B): {steps} decode "
        f"steps, launches {launches}, wall {wall!r} s (init {init_s!r} s); "
        f"{len(waited)} requests waited for pages at the queue head; "
        f"pages per request {sorted({len(t) for t in pages_of.values()})}, "
        f"{reused} distinct pages over {len(pages_of)} requests, peak in "
        f"use {peak_pages}; at the end {stats}")
    expect_launches("serve gla paged", launches,
                    {"gla_decode_fused": cfg.num_layers * steps})
    for rid in range(PAGED_REQUESTS):
        toks = engine.request(rid).generated
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"request {rid} generated {toks}")
    if stats["free_pages"] != stats["num_pages"] or stats["pages_in_use"] \
            or peak_pages > GLA_PAGED_PAGES - 1 \
            or {len(t) for t in pages_of.values()} != {1} \
            or reused > GLA_PAGED_PAGES - 1:
        raise AssertionError(f"pages: {stats}, peak {peak_pages}, pages "
                             f"{pages_of} (one per request, reused?)")
    if not waited:
        raise AssertionError("no admission waited for state pages")

    params = engine.params
    del engine
    torch.cuda.empty_cache()
    # the slots' state pages shuffled over an arena of 8 + 1 pages; the
    # paged kernel path is the contiguous one's kernel on the same
    # gathered values, so its logits are expected to equal them
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    table = torch.randperm(SLOTS, generator=gen, device="cuda").to(
        torch.int32)[:, None]
    logit_errs, cfg_k, cache, tok = _serve_paged_logits(
        torch, np, params, cfg, table, "gla paged")
    # the steady batched decode step on the prefilled paged batch (every
    # slot's state gathered from and scattered back to its page)
    step_dev_ms, step_host_ms, profile = _steady_decode(
        torch, mdl, params, cfg_k, cache, tok,
        "decode step (gla, paged state)")
    del cache
    torch.cuda.empty_cache()
    ttft = [first[r] for r in range(PAGED_REQUESTS)]
    record = {
        "arch": cfg.name, "attention_backend": "gla",
        "compute_dtype": cfg.compute_dtype, "policy": "PagedAdmission",
        "budget_bytes": budget, "state_page_bytes": page,
        "allocatable_pages": GLA_PAGED_PAGES - 1, "slots": SLOTS,
        "requests": PAGED_REQUESTS, "prompt_lens": lens.tolist(),
        "prefill_chunk": PREFILL_CHUNK, "max_new": MAX_NEW,
        "max_len": MAX_LEN, "decode_steps": steps,
        "kernel_launches": launches,
        "requests_waited_for_pages": len(waited),
        "distinct_pages_used": reused, "peak_pages_in_use": peak_pages,
        "page_stats_end": stats, "wall_s": wall,
        "generated_tokens_per_s": PAGED_REQUESTS * MAX_NEW / wall,
        "ttft_s": ttft, "ttft_mean_s": sum(ttft) / len(ttft),
        "ttft_max_s": max(ttft),
        "decode_step_ms_device": step_dev_ms,
        "decode_step_ms_host": step_host_ms,
        "decode_step_profile": profile,
        "decode_tokens_per_s": SLOTS / (step_host_ms / 1e3),
        "max_memory_allocated_bytes": peak,
        "logits_max_abs_err": logit_errs}
    del params
    torch.cuda.empty_cache()
    return record, launches


def phase_smoke_reference(torch, arch="pythia-1.4b"):
    """The smoke config of `arch` on the card (kernel path) against the
    same weights on the CPU (plain path): prefill + 4 decode steps; for
    mamba2 also the loss and every grad (the SSD kernels at their smoke
    instantiation, Dk = 16, Dv = 32)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.tree import named_leaves

    cfg = get_config(arch, smoke=True)
    p_cpu = mdl.init_params(cfg, seed=0, device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    p_gpu = to(p_cpu, "cuda")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(3, cfg.vocab_size, (3, 17), generator=gen)
    errs = []
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = mdl.init_cache(cfg, 3, 32, dev)
        lg, cache = mdl.prefill(params, cfg,
                                {"tokens": tokens[:, :13].to(dev)}, cache)
        out = [lg]
        for i in range(13, 17):
            lg, cache = mdl.decode_step(params, cfg, cache,
                                        tokens[:, i].to(dev))
            out.append(lg)
        runs[dev] = [x.cpu() for x in out]
    for i, (g, c) in enumerate(zip(runs["cuda"], runs["cpu"])):
        errs.append(check_close(f"{arch} smoke step {i} logits (cuda vs "
                                f"cpu)", g, c, SMOKE_REL))
    if cfg.family != "ssm":
        return errs
    grads = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        named = named_leaves(params)
        for _, t in named:
            t.requires_grad_(True)
        loss, _ = mdl.loss_fn(params, cfg, {"tokens": tokens.to(dev)})
        grads[dev] = [loss.detach().cpu()] + [
            g.cpu() for g in torch.autograd.grad(loss, [t for _, t in named])]
    errs.append(max(check_close(f"{arch} smoke loss and grad {i} (cuda vs "
                                f"cpu)", g, c, SMOKE_REL)
                    for i, (g, c) in enumerate(zip(grads["cuda"],
                                                   grads["cpu"]))))
    return errs


# ---------------------------------------------------------------------------
# 5. train path: the Trainer at full width
# ---------------------------------------------------------------------------

def _compared_grad(path: str) -> bool:
    """Every layer's wq/wk/wv/wo (and gla's gate wg), ln_f and
    lm_head."""
    parts = path.split(".")
    return (parts[0] in ("ln_f", "lm_head")
            or (parts[0] == "blocks" and parts[2] == "mixer"
                and parts[3] in ("wq", "wk", "wv", "wo", "wg")))


def _train_compare(torch, mdl, cfg, params, batch):
    """The first step's loss and the compared grads, kernel path against
    plain path, from the same weights and batch."""
    from repro_torch.tree import named_leaves
    named = [(p, t) for p, t in named_leaves(params) if _compared_grad(p)]
    for _, t in named:
        t.requires_grad_(True)
    runs = {}
    for impl in ("cuda", "torch"):
        loss, _ = mdl.loss_fn(params, _with_impl(cfg, impl), batch)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        runs[impl] = (loss.detach(), grads)
        del loss
    (loss_k, grads_k), (loss_t, grads_t) = runs["cuda"], runs["torch"]
    loss_err = check_close("train step 0 loss (cuda vs torch)", loss_k,
                           loss_t, TRAIN_LOSS_REL)
    if not (torch.isfinite(loss_k) and torch.isfinite(loss_t)):
        raise AssertionError("non-finite first-step loss")
    gate = [i for i, (path, _) in enumerate(named) if ".wg." in path]
    grad_errs = {}
    for i, ((path, _), gk, gt) in enumerate(zip(named, grads_k, grads_t)):
        err, scale = rel_err(gk, gt)
        grad_errs[path] = err / scale
        if not torch.isfinite(gk).all() or (
                i not in gate and not err <= TRAIN_GRAD_REL * scale):
            raise AssertionError(f"grad {path}: max abs err {err} > "
                                 f"{TRAIN_GRAD_REL} * {scale}")
    worst = max((p for i, (p, _) in enumerate(named) if i not in gate),
                key=grad_errs.get)
    log(f"  {len(named) - len(gate)} grads within {TRAIN_GRAD_REL} of "
        f"their max |value|; worst {worst} at {grad_errs[worst]!r}")
    rec = {"loss_cuda": float(loss_k), "loss_torch": float(loss_t),
           "loss_abs_err": loss_err, "grads_compared": len(named),
           "grad_rel_err_max": grad_errs[worst], "grad_rel_err_worst":
           worst, "grad_rel_err": grad_errs}
    if gate:
        rec["gate"] = _gate_noise(torch, mdl, cfg, params, batch, named,
                                  gate, grads_k, grads_t)
    return rec


def _gate_noise(torch, mdl, cfg, params, batch, named, gate, grads_k,
                grads_t):
    """The GLA gate's grads against the plain path, held to the plain
    path's own spread (GATE_NOISE_FACTOR): a second plain run with half
    the scan chunk differs from the first only in summation order."""
    c = _with_impl(cfg, "torch")
    c = dataclasses.replace(c, la=dataclasses.replace(c.la,
                                                      chunk=c.la.chunk // 2))
    loss, _ = mdl.loss_fn(params, c, batch)
    grads_2 = torch.autograd.grad(loss, [named[i][1] for i in gate])
    del loss

    def flat(gs):
        return torch.cat([g.float().flatten() for g in gs])

    ref = flat(grads_t[i] for i in gate)
    d_kernel = float((flat(grads_k[i] for i in gate) - ref).norm())
    d_plain = float((flat(grads_2) - ref).norm())
    def rel(got, want):
        err, scale = rel_err(got, want)
        return err / scale

    per_leaf = {named[i][0]: [rel(grads_k[i], grads_t[i]),
                              rel(g2, grads_t[i])]
                for i, g2 in zip(gate, grads_2)}
    log(f"  {len(gate)} gate (wg) grads: |cuda - torch| = {d_kernel!r}, "
        f"|torch chunk {c.la.chunk} - torch| = {d_plain!r} (limit "
        f"{GATE_NOISE_FACTOR} x), |torch| = {float(ref.norm())!r}; per "
        f"leaf, max abs err over max |value| (cuda, torch chunk "
        f"{c.la.chunk}): {per_leaf}")
    if not d_kernel <= GATE_NOISE_FACTOR * d_plain:
        raise AssertionError(f"gate grads: |cuda - torch| {d_kernel} > "
                             f"{GATE_NOISE_FACTOR} x {d_plain}")
    return {"norm_cuda_vs_torch": d_kernel,
            "norm_torch_half_chunk_vs_torch": d_plain,
            "norm_torch": float(ref.norm()),
            "rel_err_cuda_and_half_chunk": per_leaf}


def _param_kind(path: str) -> str:
    """A leaf's path without its layer index ("blocks.mixer.a_log")."""
    parts = path.split(".")
    return ".".join(parts[:1] + parts[2:]) if parts[0] == "blocks" \
        else path


def _train_compare_all(torch, mdl, cfg, params, batch):
    """mamba2: the first step's loss and EVERY grad, kernel path against
    plain path, from the same weights and batch, twice.

    In the config's bf16 compute the grads at init are at the level of
    the rounding noise itself: a second plain run with half the scan
    chunk, which differs from the first only in summation order, differs
    by up to 2x the max |value| of a leaf in every kind of leaf (NVIDIA
    H100 80GB HBM3, 700 W; PERF.md).  So there the loss is held to
    TRAIN_LOSS_REL and each kind of leaf, in norm over its 64 layers, to
    GATE_NOISE_FACTOR times that plain spread, as GLA's gate.  In f32
    compute the rounding is 2^16 times finer: there the loss is held to
    SEQ_F32_REL and every grad to TRAIN_GRAD_REL of its max |value|, the
    pythia runs' limit.  At most two grad sets are alive at once."""
    from repro_torch.tree import named_leaves
    named = named_leaves(params)
    ts = [t for _, t in named]
    for t in ts:
        t.requires_grad_(True)
    kinds = {}
    for i, (path, _) in enumerate(named):
        kinds.setdefault(_param_kind(path), []).append(i)

    def run(c):
        loss, _ = mdl.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, ts)
        if not torch.isfinite(loss) or not all(
                torch.isfinite(g).all() for g in grads):
            raise AssertionError(f"non-finite loss or grads ({c.la.backend}"
                                 f", {c.compute_dtype})")
        return loss.detach(), grads

    def against(grads, ref):
        """Per leaf max abs err over max |value|; per kind of leaf the
        norm of the differences and its share of the reference's norm."""
        rel = [e / sc for e, sc in (rel_err(g, r)
                                    for g, r in zip(grads, ref))]
        norms = {}
        for kind, idx in kinds.items():
            d = math.sqrt(sum(float(((grads[i].float() - ref[i].float())
                                     ** 2).sum()) for i in idx))
            r = math.sqrt(sum(float((ref[i].float() ** 2).sum())
                              for i in idx))
            norms[kind] = {"norm_diff": d, "norm_rel": d / max(r, 1e-30),
                           "max_rel": max(rel[i] for i in idx),
                           "worst": named[max(idx, key=rel.__getitem__)][0]}
        return rel, norms

    rec = {"grads_compared": len(named)}
    # bf16 compute (the config's): held to the plain path's own spread
    loss_t, grads_t = run(_with_impl(cfg, "torch"))
    loss_k, grads_k = run(_with_impl(cfg, "cuda"))
    rec["loss_cuda"], rec["loss_torch"] = float(loss_k), float(loss_t)
    rec["loss_abs_err"] = check_close("train step 0 loss (cuda vs torch)",
                                      loss_k, loss_t, TRAIN_LOSS_REL)
    _, norm_k = against(grads_k, grads_t)
    del grads_k
    half = _with_impl(cfg, "torch")
    half = dataclasses.replace(half, la=dataclasses.replace(
        half.la, chunk=half.la.chunk // 2))
    _, grads_2 = run(half)
    _, norm_2 = against(grads_2, grads_t)
    del grads_2, grads_t
    rec["bf16"] = {kind: {"cuda_vs_torch": norm_k[kind],
                          f"torch_chunk_{half.la.chunk}_vs_torch":
                          norm_2[kind]} for kind in kinds}
    log(f"  bf16 grads by kind of leaf (cuda vs torch; torch chunk "
        f"{half.la.chunk} vs torch): {rec['bf16']}")
    bad = [kind for kind in kinds if not norm_k[kind]["norm_diff"]
           <= GATE_NOISE_FACTOR * norm_2[kind]["norm_diff"]]
    if bad:
        raise AssertionError(f"bf16 grads of {bad}: |cuda - torch| > "
                             f"{GATE_NOISE_FACTOR} x |torch chunk "
                             f"{half.la.chunk} - torch|")
    log(f"  bf16: every kind of leaf within {GATE_NOISE_FACTOR} x the "
        f"plain path's spread in norm")

    # f32 compute: every grad to the pythia runs' limit
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    loss_t, grads_t = run(_with_impl(f32, "torch"))
    loss_k, grads_k = run(_with_impl(f32, "cuda"))
    rec["f32_loss_cuda"], rec["f32_loss_torch"] = float(loss_k), \
        float(loss_t)
    rec["f32_loss_abs_err"] = check_close(
        "f32 train step 0 loss (cuda vs torch)", loss_k, loss_t, SEQ_F32_REL)
    rel_k, norm_k = against(grads_k, grads_t)
    del grads_k, grads_t
    rec["f32"] = norm_k
    log(f"  f32 grads by kind of leaf (cuda vs torch): {norm_k}")
    bad = [named[i][0] for i in range(len(named))
           if not rel_k[i] <= TRAIN_GRAD_REL]
    if bad:
        raise AssertionError(f"f32 grads not within {TRAIN_GRAD_REL} of "
                             f"their max |value|: {bad[:8]} ({len(bad)})")
    log(f"  f32: {len(named)} grads within {TRAIN_GRAD_REL} of their max "
        f"|value|; worst {max(rel_k)!r}")
    for t in ts:
        t.requires_grad_(False)
    return rec


def phase_train(torch, backend):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as mdl
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import leaves

    cfg = _config(backend)
    if not (cfg.remat and cfg.compute_dtype == "bfloat16"
            and cfg.param_dtype == "float32"):
        raise AssertionError(f"{cfg.name} is not f32 params / bf16 "
                             f"compute / remat: {cfg}")
    torch.cuda.empty_cache()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch0 = {"tokens": torch.from_numpy(data.batch_at(0)).to("cuda")}
    compare = (_train_compare_all if backend == "mamba2"
               else _train_compare)(torch, mdl, cfg, params, batch0)
    n_params = sum(t.numel() for t in leaves(params))
    del batch0
    torch.cuda.empty_cache()

    tc = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    trainer = Trainer(cfg, tc, params, data)
    del params
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    hist = trainer.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    per_step = {"linear": {"la_fwd": 2 * layers, "la_bwd_q": layers,
                           "la_bwd_kv": layers},
                "gla": {"gla_fwd": 2 * layers, "gla_bwd_q": layers,
                        "gla_bwd_kv": layers},
                "softmax": {"flash_fwd": 2 * layers,
                            "flash_bwd_delta": layers,
                            "flash_bwd_q": layers,
                            "flash_bwd_kv": layers},
                "mamba2": {"ssd_fwd": 2 * layers, "ssd_bwd_q": layers,
                           "ssd_bwd_kv": layers}}[backend]
    log(f"[train {backend}] {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens: launches {launches}, losses "
        f"{[h['loss'] for h in hist]}, step s {[h['dt'] for h in hist]}")
    expect_launches(f"train {backend}", launches,
                    {k: v * TRAIN_STEPS for k, v in per_step.items()})
    if len(hist) != TRAIN_STEPS or not all(
            math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train history {hist}")
    steady = sorted(h["dt"] for h in hist[1:])
    step_s = steady[len(steady) // 2]
    batch = {"tokens": torch.from_numpy(data.batch_at(TRAIN_STEPS)).to(
        "cuda")}
    profile = _profile(torch, f"train step ({backend})",
                       lambda: trainer.step_fn(trainer.params,
                                               trainer.opt_state, batch,
                                               TRAIN_STEPS), steps=1)
    record = {"arch": cfg.name, "attention_backend": backend,
              "params": n_params, "compute_dtype": cfg.compute_dtype,
              "param_dtype": cfg.param_dtype, "remat": cfg.remat,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
              "losses": [h["loss"] for h in hist],
              "step_s": [h["dt"] for h in hist],
              "step_s_median_after_first": step_s,
              "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
              "wall_s": wall, "kernel_launches": launches,
              "launches_per_step": per_step,
              "max_memory_allocated_bytes": peak,
              "train_step_profile": profile,
              "kernel_vs_plain": compare}
    del trainer
    torch.cuda.empty_cache()
    return record, launches


# ---------------------------------------------------------------------------
# 6. kernel timing
# ---------------------------------------------------------------------------

def _time_pair(torch, plain, kernel, reps, warm=1):
    """CUDA-event ms per call of `plain` and `kernel`, in turns (plain,
    kernel, kernel, plain); each takes no arguments."""
    def time_fn(fn):
        for _ in range(warm):
            fn()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    plain_a, kern_a = time_fn(plain), time_fn(kernel)
    kern_b, plain_b = time_fn(kernel), time_fn(plain)
    return [kern_a, kern_b], [plain_a, plain_b]


def _bound(bytes_moved, flops, flop_per_s=F32_FLOP_PER_S):
    """The least time for the work: bytes at the HBM rate or operations
    at `flop_per_s` (f32 CUDA cores for the linear-attention kernels,
    which compute in f32; bf16 tensor cores for the softmax kernels)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def phase_timing(torch):
    """Kernel and plain version at the main path's decode shapes.  The
    serving step finds each layer's state cold in L2 (24 layers of
    8.5 MB), so the timed launches rotate over enough state buffers to
    exceed the 50 MB L2."""
    from repro_torch.kernels import decode_fused as df
    b, h, hkv, d = SLOTS, 16, 16, 128
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    n_bufs = 8
    sets = [_decode_case(torch, gen, b, h, hkv, d, dtype)
            for _ in range(n_bufs)]

    def rotating(fn):
        nxt = itertools.cycle(sets).__next__
        return lambda: fn(*nxt()[:5], 1.0, 1.0)

    kern, plain = _time_pair(torch, rotating(df.la_decode_fused_torch),
                             rotating(df.la_decode_fused_cuda), reps=200,
                             warm=20)
    g = h // hkv
    cols = d + 1
    state_elems = b * hkv * d * cols
    itemsize = torch.tensor([], dtype=dtype).element_size()
    bytes_moved = (2 * state_elems * 4 + 2 * b * hkv * cols * 4
                   + (b * h * d + b * hkv * d + b * hkv * d) * itemsize
                   + b * h * d * itemsize)
    flops = (state_elems * (2 + 2 * g) + b * hkv * cols * (1 + 3 * g)
             + b * h * d)
    rec = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(plain),
           "plain_ms_runs": plain, **_bound(bytes_moved, flops)}
    log(f"[timing] la_decode_fused B={b} H={h} Hkv={hkv} D={d} {dtype}: "
        f"kernel {rec['ms_runs']} ms, plain {rec['plain_ms_runs']} ms, "
        f"bound {rec['bound_ms']!r} ms ({rec['bound_by']}: "
        f"{bytes_moved} B, {flops} flop); library_ms null: no single "
        f"PyTorch call computes this fused update + readout")
    return rec


def phase_timing_la(torch):
    """la_fwd, la_bwd_q and la_bwd_kv and their plain versions at the
    train path's shapes (bf16, as the model hands them over).  Each
    input is larger than the 50 MB L2, so every call reads it from
    device memory."""
    from repro_torch.kernels import linear_attention as la
    m = LA_SHAPE
    b, h, hkv, n, d = m["b"], m["h"], m["hkv"], m["n"], m["d"]
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    q, k, v, om_hat, h_vec = _la_case(torch, gen, b, h, hkv, n, d, dtype)
    it = q.element_size()
    q_el, kv_el = b * h * n * d, b * hkv * n * d
    tok_q, tok_kv = b * h * n, b * hkv * n
    work = {
        # q, k, v read; o written in the compute dtype, g in f32
        "la_fwd": ((q_el + 2 * kv_el) * it + q_el * it + tok_q * 4,
                   tok_q * 4 * d * (d + 1)),
        # k, v read; Ω̂ and h read in f32; dq written
        "la_bwd_q": (2 * kv_el * it + q_el * 4 + tok_q * 4 + q_el * it,
                     tok_q * 4 * d * (d + 1)),
        # q, k, v read; Ω̂ and h read in f32; dk, dv written.  The U
        # update per query token and head, the dk and dv readouts per
        # KV token and head
        "la_bwd_kv": ((q_el + 2 * kv_el) * it + q_el * 4 + tok_q * 4
                      + 2 * kv_el * it,
                      tok_q * 2 * (d + 1) ** 2 + tok_kv * 4 * d * (d + 1)),
    }
    calls = {
        "la_fwd": (lambda: la.la_fwd_torch(q, k, v, 1.0, 1.0),
                   lambda: la.la_fwd_cuda(q, k, v, 1.0, 1.0)),
        "la_bwd_q": (lambda: la.la_bwd_q_torch(k, v, om_hat, h_vec, 1.0),
                     lambda: la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)),
        "la_bwd_kv": (lambda: la.la_bwd_kv_torch(q, k, v, om_hat, h_vec,
                                                 1.0, 1.0),
                      lambda: la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec,
                                                1.0, 1.0)),
    }
    out = {}
    for name, (plain, kernel) in calls.items():
        kern, pl = _time_pair(torch, plain, kernel, reps=5)
        rec = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
               "plain_ms_runs": pl, **_bound(*work[name])}
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} N={n} D={d} {dtype}: "
            f"kernel {kern} ms, plain {pl} ms, bound {rec['bound_ms']!r} ms "
            f"({rec['bound_by']}: {rec['bytes']} B, {rec['flops']} flop); "
            f"library_ms null: no single PyTorch call computes normalized "
            f"causal linear attention or its gradient (SDPA is softmax)")
        out[name] = rec
    return out


def phase_timing_softmax(torch):
    """softmax_decode_fused at the serving shapes (rotating 8 KV caches,
    285 MB, so every call finds its cache cold in L2, as a layer's decode
    does), flash_fwd and the three backward kernels at the training
    shapes (every input larger than L2); each beside its plain version
    and one PyTorch call computing the same function (SDPA), which the
    port never calls."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import flash_attention as fl
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}

    # decode: lengths MAX_LEN in every slot, the steady serving depth
    b, h, hkv, d = SLOTS, 16, 16, 128
    sets = []
    for _ in range(8):
        q, k, v, _ = _decode_softmax_case(torch, gen, b, h, hkv, MAX_LEN, d,
                                          bf16)
        lengths = torch.full((b,), MAX_LEN, dtype=torch.int32,
                             device="cuda")
        # SDPA's (B, 1, 1, S) mask: True where a key is live
        mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
                < lengths[:, None])[:, None, None, :]
        sets.append((q, k, v, lengths, mask))

    def rotating(fn):
        nxt = itertools.cycle(sets).__next__
        return lambda: fn(*nxt())

    kern, plain = _time_pair(
        torch, rotating(lambda q, k, v, n, m: df.softmax_decode_fused_torch(
            q, k, v, n)),
        rotating(lambda q, k, v, n, m: df.softmax_decode_fused_cuda(
            q, k, v, n)), reps=200, warm=20)
    lib, _ = _time_pair(torch, rotating(
        lambda q, k, v, n, m: sdpa(q, k, v, attn_mask=m, enable_gqa=True)),
        rotating(lambda q, k, v, n, m: sdpa(q, k, v, attn_mask=m,
                                            enable_gqa=True)),
        reps=200, warm=20)
    live = int(sets[0][3].sum())
    it = 2
    bytes_moved = 2 * b * h * d * it + 2 * hkv * live * d * it + 4 * b
    flops = 4 * h * live * d
    out["softmax_decode_fused"] = {
        "ms": min(kern), "ms_runs": kern, "plain_ms": min(plain),
        "plain_ms_runs": plain, "library_ms": min(lib),
        "library_ms_runs": lib,
        "library": "scaled_dot_product_attention(attn_mask=(B,1,1,S), "
                   "enable_gqa=True)",
        **_bound(bytes_moved, flops, BF16_TC_FLOP_PER_S)}
    log(f"[timing] softmax_decode_fused B={b} H={h} Hkv={hkv} S={MAX_LEN} "
        f"D={d} bf16: {out['softmax_decode_fused']}")
    del sets

    m = LA_SHAPE
    b, h, hkv, n, d = m["b"], m["h"], m["hkv"], m["n"], m["d"]
    q, k, v, do = _flash_case(torch, gen, b, h, hkv, n, d, bf16)
    o, lse = fl.flash_fwd_cuda(q, k, v)
    delta = fl.flash_bwd_delta_cuda(o, do)
    q_el, kv_el, rows = b * h * n * d, b * hkv * n * d, b * h * n
    pairs = b * h * n * (n + 1) // 2        # causal (query, key) pairs
    work = {
        # q, k, v read; o written in bf16, lse in f32; QK^T and PV
        "flash_fwd": ((q_el + 2 * kv_el) * it + q_el * it + rows * 4,
                      4 * pairs * d),
        # o and dO read, delta written
        "flash_bwd_delta": (2 * q_el * it + rows * 4, 2 * q_el),
        # q, k, v, dO, lse, delta read; dq written; QK^T, dO V^T, dS K
        "flash_bwd_q": ((2 * q_el + 2 * kv_el) * it + 2 * rows * 4
                        + q_el * it, 6 * pairs * d),
        # q, k, v, dO, lse, delta read; dk, dv written; QK^T, dO V^T,
        # P^T dO, dS^T Q
        "flash_bwd_kv": ((2 * q_el + 2 * kv_el) * it + 2 * rows * 4
                         + 2 * kv_el * it, 8 * pairs * d),
    }
    calls = {
        "flash_fwd": (lambda: fl.flash_fwd_torch(q, k, v),
                      lambda: fl.flash_fwd_cuda(q, k, v)),
        "flash_bwd_delta": (lambda: fl.flash_bwd_delta_torch(o, do),
                            lambda: fl.flash_bwd_delta_cuda(o, do)),
        "flash_bwd_q": (lambda: fl.flash_bwd_q_torch(q, k, v, do, lse,
                                                     delta),
                        lambda: fl.flash_bwd_q_cuda(q, k, v, do, lse,
                                                    delta)),
        "flash_bwd_kv": (lambda: fl.flash_bwd_kv_torch(q, k, v, do, lse,
                                                       delta),
                         lambda: fl.flash_bwd_kv_cuda(q, k, v, do, lse,
                                                      delta)),
    }
    for name, (plain_fn, kernel_fn) in calls.items():
        kern, plain = _time_pair(torch, plain_fn, kernel_fn, reps=5)
        out[name] = {"ms": min(kern), "ms_runs": kern,
                     "plain_ms": min(plain), "plain_ms_runs": plain,
                     **_bound(*work[name], BF16_TC_FLOP_PER_S)}
    # the library calls: SDPA forward, and SDPA's backward alone (dq, dk
    # and dv together) on a retained graph
    lib_fwd, _ = _time_pair(
        torch, lambda: sdpa(q, k, v, is_causal=True),
        lambda: sdpa(q, k, v, is_causal=True), reps=5)
    out["flash_fwd"].update(
        library_ms=min(lib_fwd), library_ms_runs=lib_fwd,
        library="scaled_dot_product_attention(is_causal=True)")
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    o_lib = sdpa(*leaves, is_causal=True)
    lib_bwd, _ = _time_pair(
        torch, lambda: torch.autograd.grad(o_lib, leaves, do,
                                           retain_graph=True),
        lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True),
        reps=5)
    kernels_bwd = sum(out[name]["ms"] for name in FLASH_BWD)
    bwd_flops = 10 * pairs * d
    bwd_bytes = ((3 * q_el + 2 * kv_el) * it + rows * 4
                 + (q_el + 2 * kv_el) * it)
    out["flash_bwd"] = {
        "kernels_ms_sum": kernels_bwd, "library_ms": min(lib_bwd),
        "library_ms_runs": lib_bwd,
        "library": "scaled_dot_product_attention(is_causal=True) "
                   "backward (dq, dk, dv) on a retained graph",
        **_bound(bwd_bytes, bwd_flops, BF16_TC_FLOP_PER_S)}
    for name in FLASH_BWD:
        out[name]["library_ms"] = None
    for name in ("flash_fwd", *FLASH_BWD, "flash_bwd"):
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} N={n} D={d} bf16: "
            f"{out[name]}")
    log("[timing] flash_bwd_delta / flash_bwd_q / flash_bwd_kv: "
        "library_ms null each: no single PyTorch call computes delta, dq "
        "or (dk, dv) alone; the whole backward against SDPA's is under "
        "flash_bwd")
    return out


def phase_timing_paged(torch):
    """paged_decode_fused and paged_attention at the serving shapes (every
    slot at MAX_LEN live keys, its pages shuffled over the arena; 8
    rotating arenas, 286 MB, so every call finds its pages cold in L2),
    each beside its plain version, and paged_decode_fused beside the
    contiguous softmax_decode_fused on the same keys gathered into a
    contiguous cache: what the page indirection costs."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import paged_attention as pg
    b, h, hkv, d = SLOTS, 16, 16, 128
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    sets = []
    for _ in range(8):
        lengths = torch.full((b,), MAX_LEN, dtype=torch.int32, device="cuda")
        case = _paged_case(torch, gen, b, h, hkv, d, PAGE_SIZE, PMAX,
                           lengths, bf16)
        sets.append(case)
    contiguous = [(q, pg.gather_pages(kp, t), pg.gather_pages(vp, t), n)
                  for q, kp, vp, t, n in sets]

    def rotating(fn, over=sets):
        nxt = itertools.cycle(over).__next__
        return lambda: fn(*nxt())

    live = int(sets[0][4].sum())
    live_pages = b * -(-MAX_LEN // PAGE_SIZE)
    it = 2
    # q read, o written; the live keys' K and V rows; the live table
    # entries and the lengths
    bytes_moved = (2 * b * h * d * it + 2 * hkv * live * d * it
                   + 4 * live_pages + 4 * b)
    flops = 4 * h * live * d
    out = {}
    for name, kernel, plain in (
            ("paged_decode_fused", df.paged_decode_fused_cuda,
             df.paged_decode_fused_torch),
            ("paged_attention", pg.paged_attention_cuda,
             pg.paged_attention_torch)):
        kern, pl = _time_pair(torch, rotating(plain), rotating(kernel),
                              reps=200, warm=20)
        out[name] = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
                     "plain_ms_runs": pl, "library_ms": None,
                     **_bound(bytes_moved, flops, BF16_TC_FLOP_PER_S)}
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} D={d} ps={PAGE_SIZE} "
            f"Pmax={PMAX} bf16, {MAX_LEN} live keys per slot: {out[name]}")
    paged, contig = _time_pair(
        torch, rotating(df.softmax_decode_fused_cuda, contiguous),
        rotating(df.paged_decode_fused_cuda), reps=200, warm=20)
    out["paged_decode_fused"].update(
        contiguous_ms_runs=contig, paged_ms_runs_beside_contiguous=paged)
    log(f"[timing] paged_decode_fused {paged} ms against the contiguous "
        f"softmax_decode_fused {contig} ms on the same keys; library_ms "
        f"null for both paged kernels: no single PyTorch call attends "
        f"over a paged cache (a gather and SDPA are two calls, and the "
        f"gather alone moves the whole cache)")
    del sets, contiguous
    torch.cuda.empty_cache()
    return out


def phase_timing_gla(torch):
    """gla_decode_fused at the serving shapes (8 rotating states, cold in
    L2, as in phase_timing) and gla_fwd, gla_bwd_q and gla_bwd_kv at the
    training shapes (bf16, the trained gate's decays), each beside its
    plain version and, in turns, beside its linear counterpart on the
    same inputs: what the gate costs."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    out = {}

    b, h, hkv, d = SLOTS, 16, 16, 128
    sets = [_gla_decode_case(torch, gen, b, h, hkv, d, bf16, "trained")
            for _ in range(8)]

    def rotating(fn, gated=True):
        nxt = itertools.cycle(sets).__next__
        if gated:
            return lambda: fn(*nxt(), 1.0, 1.0)
        return lambda: fn(*nxt()[:5], 1.0, 1.0)

    kern, plain = _time_pair(torch, rotating(df.gla_decode_fused_torch),
                             rotating(df.gla_decode_fused_cuda), reps=200,
                             warm=20)
    lin, kern_b = _time_pair(torch, rotating(df.gla_decode_fused_cuda),
                             rotating(df.la_decode_fused_cuda, False),
                             reps=200, warm=20)
    g = h // hkv
    cols = d + 1
    state_elems = b * hkv * d * cols
    it = 2
    # state and normalizer read and written in f32; q, k, v, ld read; o
    # written.  The linear step's flops plus the decay of every state and
    # normalizer element
    bytes_moved = (2 * state_elems * 4 + 2 * b * hkv * cols * 4
                   + (b * h * d + 2 * b * hkv * d) * it + b * hkv * 4
                   + b * h * d * it)
    flops = (state_elems * (3 + 2 * g) + b * hkv * cols * (2 + 3 * g)
             + b * h * d)
    out["gla_decode_fused"] = {
        "ms": min(kern), "ms_runs": kern, "plain_ms": min(plain),
        "plain_ms_runs": plain, "library_ms": None,
        "in_turns_with_la_decode_fused": {"gla_ms_runs": kern_b,
                                          "la_ms_runs": lin},
        **_bound(bytes_moved, flops)}
    log(f"[timing] gla_decode_fused B={b} H={h} Hkv={hkv} D={d} bf16: "
        f"{out['gla_decode_fused']}; library_ms null: no single PyTorch "
        f"call computes this gated update + readout")
    del sets

    m = LA_SHAPE
    b, h, hkv, n, d = m["b"], m["h"], m["hkv"], m["n"], m["d"]
    q, k, v, ld, om_hat, h_vec = _gla_case(torch, gen, b, h, hkv, n, d, bf16,
                                           "trained")
    q_el, kv_el = b * h * n * d, b * hkv * n * d
    tok_q, tok_kv = b * h * n, b * hkv * n
    work = {
        # q, k, v, ld read; o written in bf16, g in f32.  Per query token
        # and head: the decay, the update and the readout of the state
        "gla_fwd": ((q_el + 2 * kv_el) * it + tok_kv * 4 + q_el * it
                    + tok_q * 4, tok_q * 5 * d * (d + 1)),
        # k, v, ld read; Ω̂ and h read in f32; dq written
        "gla_bwd_q": (2 * kv_el * it + tok_kv * 4 + q_el * 4 + tok_q * 4
                      + q_el * it, tok_q * 5 * d * (d + 1)),
        # q, k, v, ld read; Ω̂ and h read in f32; dk written in bf16 and
        # dV' in f32.  The U update per query token and head; its decay,
        # the dk and dV' readouts per KV token and head
        "gla_bwd_kv": ((q_el + 2 * kv_el) * it + tok_kv * 4 + q_el * 4
                       + tok_q * 4 + kv_el * it + tok_kv * (d + 1) * 4,
                       tok_q * 2 * (d + 1) ** 2
                       + tok_kv * (4 * d * (d + 1) + (d + 1) ** 2)),
    }
    calls = {
        "gla_fwd": (lambda: gla.gla_fwd_torch(q, k, v, ld, 1.0, 1.0),
                    lambda: gla.gla_fwd_cuda(q, k, v, ld, 1.0, 1.0),
                    lambda: la.la_fwd_cuda(q, k, v, 1.0, 1.0)),
        "gla_bwd_q": (lambda: gla.gla_bwd_q_torch(k, v, ld, om_hat, h_vec,
                                                  1.0),
                      lambda: gla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec,
                                                 1.0),
                      lambda: la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)),
        "gla_bwd_kv": (lambda: gla.gla_bwd_kv_torch(q, k, v, ld, om_hat,
                                                    h_vec, 1.0, 1.0),
                       lambda: gla.gla_bwd_kv_cuda(q, k, v, ld, om_hat,
                                                   h_vec, 1.0, 1.0),
                       lambda: la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec,
                                                 1.0, 1.0)),
    }
    for name, (plain_fn, kernel_fn, linear_fn) in calls.items():
        kern, pl = _time_pair(torch, plain_fn, kernel_fn, reps=5)
        lin, kern_b = _time_pair(torch, kernel_fn, linear_fn, reps=5)
        out[name] = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
                     "plain_ms_runs": pl, "library_ms": None,
                     "in_turns_with_linear": {"gla_ms_runs": kern_b,
                                              "la_ms_runs": lin},
                     **_bound(*work[name])}
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} N={n} D={d} bf16: "
            f"{out[name]}")
    log("[timing] gla_fwd / gla_bwd_q / gla_bwd_kv: library_ms null: no "
        "single PyTorch call computes gated linear attention or its "
        "gradient (SDPA is softmax)")
    del q, k, v, ld, om_hat, h_vec
    torch.cuda.empty_cache()
    return out


def phase_timing_ssd(torch):
    """ssd_fwd, ssd_bwd_q and ssd_bwd_kv and their plain versions at
    mamba2-2.7b's training shapes (bf16, as the model hands them over; a
    fresh layer's decays), in turns, beside their bounds.  Bytes: each
    input read once, each output written once; operations: per token and
    head, the decayed state update (3 Dk Dv: a multiply and an FMA per
    element) and each readout (2 Dk Dv), i.e. 5 Dk Dv for the forward and
    for dq, 7 Dk Dv for dk and dv (the kernel's second copy of U is its
    own choice, not counted)."""
    from repro_torch.kernels import ssd
    m = SSD_SHAPE
    b, g, h, n, dk, dv = m["b"], m["g"], m["h"], m["n"], m["dk"], m["dv"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    q, k, v, ld, om = _ssd_case(torch, gen, b, g, h, n, dk, dv,
                                torch.bfloat16, "init")
    it = 2
    qk_el, v_el, tok = b * g * n * dk, b * h * n * dv, b * h * n
    work = {
        # q, k, v, ld read; o written
        "ssd_fwd": (2 * qk_el * it + v_el * it + tok * 4 + v_el * it,
                    tok * 5 * dk * dv),
        # k, v, ld, Ω read; the f32 dq partials written
        "ssd_bwd_q": (qk_el * it + 2 * v_el * it + tok * 4 + tok * dk * 4,
                      tok * 5 * dk * dv),
        # q, k, v, ld, Ω read; the f32 dk partials and dv written
        "ssd_bwd_kv": (2 * qk_el * it + 2 * v_el * it + tok * 4
                       + tok * dk * 4 + v_el * 4, tok * 7 * dk * dv),
    }
    calls = {
        "ssd_fwd": (lambda: ssd.ssd_fwd_torch(q, k, v, ld),
                    lambda: ssd.ssd_fwd_cuda(q, k, v, ld)),
        "ssd_bwd_q": (lambda: ssd.ssd_bwd_q_torch(k, v, ld, om),
                      lambda: ssd.ssd_bwd_q_cuda(k, v, ld, om)),
        "ssd_bwd_kv": (lambda: ssd.ssd_bwd_kv_torch(q, k, v, ld, om),
                       lambda: ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)),
    }
    out = {}
    for name, (plain_fn, kernel_fn) in calls.items():
        kern, pl = _time_pair(torch, plain_fn, kernel_fn, reps=5)
        out[name] = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
                     "plain_ms_runs": pl, "library_ms": None,
                     **_bound(*work[name])}
        log(f"[timing] {name} B={b} G={g} H={h} N={n} Dk={dk} Dv={dv} "
            f"bf16: {out[name]}")
    log("[timing] ssd_fwd / ssd_bwd_q / ssd_bwd_kv: library_ms null: no "
        "single PyTorch call computes the SSD recurrence or its gradient")
    del q, k, v, ld, om
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import numpy as np
    import torch

    name, smi = phase_device(torch)
    build_s = phase_build()
    kernel_errs = phase_kernel(torch)
    la_errs = phase_kernel_la(torch)
    softmax_errs = phase_kernel_softmax(torch)
    paged_errs = phase_kernel_paged(torch)
    gla_errs = phase_kernel_gla(torch)
    ssd_errs = phase_kernel_ssd(torch)
    serve, serve_launches = phase_serve(torch, np, "linear")
    serve_sm, serve_sm_launches = phase_serve(torch, np, "softmax")
    serve_pg, serve_pg_launches, serve_pgu_launches = phase_serve_paged(
        torch, np)
    serve_gla, serve_gla_launches = phase_serve(torch, np, "gla")
    serve_glp, serve_glp_launches = phase_serve_gla_paged(torch, np)
    serve_m2, serve_m2_launches = phase_serve(torch, np, "mamba2")
    smoke_errs = {arch: phase_smoke_reference(torch, arch)
                  for arch in ("pythia-1.4b", "mamba2-2.7b")}
    torch.cuda.empty_cache()
    train, train_launches = phase_train(torch, "linear")
    train_sm, train_sm_launches = phase_train(torch, "softmax")
    train_gla, train_gla_launches = phase_train(torch, "gla")
    train_m2, train_m2_launches = phase_train(torch, "mamba2")
    timing = {"la_decode_fused": phase_timing(torch), **phase_timing_la(
        torch), **phase_timing_softmax(torch), **phase_timing_paged(torch),
        **phase_timing_gla(torch), **phase_timing_ssd(torch)}

    # each kernel's launches summed over the main-path runs (every other
    # run left it at 0, expect_launches checked)
    runs = (serve_launches, serve_sm_launches, serve_pg_launches,
            serve_pgu_launches, serve_gla_launches, serve_glp_launches,
            serve_m2_launches, train_launches, train_sm_launches,
            train_gla_launches, train_m2_launches)
    launches = {k: sum(r[k] for r in runs) for k in KERNELS}
    max_err = {"la_decode_fused": kernel_errs["main_bf16"],
               **la_errs["main_bf16"],
               **softmax_errs["decode_main_bf16"],
               **softmax_errs["flash_main_bf16"],
               **paged_errs["paged_main_bf16"],
               **gla_errs["decode_main_bf16"],
               **{k: v for k, v in gla_errs["main_bf16"].items()
                  if k in KERNELS},
               **{k: v for k, v in ssd_errs["main_bf16"].items()
                  if k in KERNELS}}
    kernels = {"kernels": [{
        "name": kname, "route": "cuda", "source": KERNELS[kname][0],
        "replaces": KERNELS[kname][1], "launches": launches[kname],
        "max_abs_err": max_err[kname], "ms": timing[kname]["ms"],
        "plain_ms": timing[kname]["plain_ms"],
        "bound_ms": timing[kname]["bound_ms"],
        "bound_by": timing[kname]["bound_by"],
        "library_ms": timing[kname].get("library_ms")} for kname in KERNELS]}
    for rec in (serve, serve_sm, serve_pg, serve_gla, serve_glp, serve_m2,
                train, train_sm, train_gla, train_m2):
        rec["card"] = smi
    print(json.dumps({"serve": serve, "serve_softmax": serve_sm,
                      "serve_softmax_paged": serve_pg,
                      "serve_gla": serve_gla, "serve_gla_paged": serve_glp,
                      "serve_mamba2": serve_m2,
                      "train": train, "train_softmax": train_sm,
                      "train_gla": train_gla, "train_mamba2": train_m2,
                      "build_s": build_s,
                      "kernel_max_abs_err": kernel_errs,
                      "la_kernel_max_abs_err": la_errs,
                      "softmax_kernel_max_abs_err": softmax_errs,
                      "paged_kernel_max_abs_err": paged_errs,
                      "gla_kernel_max_abs_err": gla_errs,
                      "ssd_kernel_max_abs_err": ssd_errs,
                      "smoke_logits_max_abs_err": smoke_errs,
                      "timing": timing}), flush=True)
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
