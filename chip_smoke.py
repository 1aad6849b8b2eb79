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
               Nk=544, q_offset [0, 256])
  4. serve   — the Engine at full width pythia-1.4b in bf16, once with the
               paper's linear attention and once with the softmax
               baseline: 8 requests, 512-token prompts, prefill_chunk 256,
               32 new tokens, greedy; every decode step must go through
               the path's decode kernel (24 launches per step) and, on the
               softmax path, every prefill window through flash_fwd (24
               per window); the decode step timed with CUDA events and
               profiled with torch.profiler; the first 4 decode steps'
               logits of the kernel path against the plain path on one
               cloned prefilled cache; and the linear smoke config on the
               card against the same weights on the CPU
  5. train   — full width pythia-1.4b (f32 params, bf16 compute, the
               config's remat) on SyntheticLM batches of 2 x 8192 tokens
               (seed 0), once per backend: the first step's loss and the
               grads of every layer's wq/wk/wv/wo, ln_f and lm_head on the
               kernel path against the plain path from one set of weights;
               then 4 steps through the Trainer, each launching the
               forward kernel 48 times (remat runs each layer's forward
               twice) and each backward kernel 24 times (la_fwd /
               la_bwd_q / la_bwd_kv, or flash_fwd / flash_bwd_delta /
               flash_bwd_q / flash_bwd_kv); step time, tokens/s, peak
               memory, and one more step under torch.profiler
  6. timing  — each kernel and its plain version with CUDA events at the
               main paths' shapes, in turns, beside the kernel's bound and,
               where one PyTorch call computes the same function (SDPA for
               the softmax kernels; the port never calls it), that call
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
}
SOURCES = ("la_decode_fused", "la_fwd", "la_bwd", "softmax_decode_fused",
           "flash_fwd", "flash_bwd")
FLASH_BWD = ("flash_bwd_delta", "flash_bwd_q", "flash_bwd_kv")

# main path: pythia-1.4b at full width
SLOTS, PROMPT_LEN, PREFILL_CHUNK, MAX_NEW = 8, 512, 256, 32
MAX_LEN = PROMPT_LEN + MAX_NEW
COMPARE_STEPS = 4
# train path: pythia-1.4b at full width, the paper's §5.2 length
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 4
LA_SHAPE = dict(b=2, h=16, hkv=16, n=8192, d=128)
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
# full-width train step, kernel path vs plain path: both round o, dq,
# dk and dv to bf16 after f32 sums in different orders, and a last-bit
# difference reaches the loss and the grads through 24 layers of bf16
# matmuls forward and back
TRAIN_LOSS_REL = 2.0 ** -8
TRAIN_GRAD_REL = 2.0 ** -4
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
    from repro_torch.kernels import linear_attention as la
    return (df.launches, la.launches, fl.launches)


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
    logs = build.build_all(SOURCES, ptxas_verbose=True)
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


def phase_serve(torch, np, backend):
    """The engine at full width with `backend`'s mixer; returns (record,
    the run's launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("pythia-1.4b", attention_backend=backend)
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
    want = ({"la_decode_fused": cfg.num_layers * steps} if backend == "linear"
            else {"softmax_decode_fused": cfg.num_layers * steps,
                  "flash_fwd": cfg.num_layers * windows})
    log(f"[serve {backend}] {SLOTS} requests x {PROMPT_LEN} prompt tokens, "
        f"{MAX_NEW} new: {steps} decode steps, {windows} prefill windows, "
        f"launches {launches}, wall {wall!r} s (init {init_s!r} s)")
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
    for _ in range(3):
        mdl.decode_step(engine.params, engine.cfg, engine.cache, tokens)
    n_timed = 20
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(n_timed):
        mdl.decode_step(engine.params, engine.cfg, engine.cache, tokens)
    ev1.record()
    torch.cuda.synchronize()
    step_host_ms = (time.perf_counter() - h0) * 1e3 / n_timed
    step_dev_ms = ev0.elapsed_time(ev1) / n_timed
    peak = torch.cuda.max_memory_allocated()
    profile = _profile(torch, f"decode step ({backend})",
                       lambda: mdl.decode_step(engine.params, engine.cfg,
                                               engine.cache, tokens),
                       steps=5)

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


def phase_smoke_reference(torch):
    """The smoke config on the card (kernel path) against the same
    weights on the CPU (plain path): prefill + 4 decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl

    cfg = get_config("pythia-1.4b", smoke=True)
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
        errs.append(check_close(f"smoke step {i} logits (cuda vs cpu)", g,
                                c, SMOKE_REL))
    return errs


# ---------------------------------------------------------------------------
# 5. train path: the Trainer at full width
# ---------------------------------------------------------------------------

def _compared_grad(path: str) -> bool:
    """Every layer's wq/wk/wv/wo, ln_f and lm_head."""
    parts = path.split(".")
    return (parts[0] in ("ln_f", "lm_head")
            or (parts[0] == "blocks" and parts[2] == "mixer"
                and parts[3] in ("wq", "wk", "wv", "wo")))


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
    grad_errs = {}
    for (path, _), gk, gt in zip(named, grads_k, grads_t):
        err, scale = rel_err(gk, gt)
        grad_errs[path] = err / scale
        if not (err <= TRAIN_GRAD_REL * scale) or not torch.isfinite(
                gk).all():
            raise AssertionError(f"grad {path}: max abs err {err} > "
                                 f"{TRAIN_GRAD_REL} * {scale}")
    worst = max(grad_errs, key=grad_errs.get)
    log(f"  {len(named)} grads within {TRAIN_GRAD_REL} of their max "
        f"|value|; worst {worst} at {grad_errs[worst]!r}")
    return {"loss_cuda": float(loss_k), "loss_torch": float(loss_t),
            "loss_abs_err": loss_err, "grads_compared": len(named),
            "grad_rel_err_max": grad_errs[worst], "grad_rel_err_worst":
            worst, "grad_rel_err": grad_errs}


def phase_train(torch, backend):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as mdl
    from repro_torch.train.loop import Trainer

    cfg = get_config("pythia-1.4b", attention_backend=backend)
    if not (cfg.remat and cfg.compute_dtype == "bfloat16"
            and cfg.param_dtype == "float32"):
        raise AssertionError(f"pythia-1.4b is not f32 params / bf16 "
                             f"compute / remat: {cfg}")
    torch.cuda.empty_cache()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch0 = {"tokens": torch.from_numpy(data.batch_at(0)).to("cuda")}
    compare = _train_compare(torch, mdl, cfg, params, batch0)
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
    per_step = ({"la_fwd": 2 * layers, "la_bwd_q": layers,
                 "la_bwd_kv": layers} if backend == "linear"
                else {"flash_fwd": 2 * layers, "flash_bwd_delta": layers,
                      "flash_bwd_q": layers, "flash_bwd_kv": layers})
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
              "compute_dtype": cfg.compute_dtype,
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


def main() -> int:
    import numpy as np
    import torch

    name, smi = phase_device(torch)
    build_s = phase_build()
    kernel_errs = phase_kernel(torch)
    la_errs = phase_kernel_la(torch)
    softmax_errs = phase_kernel_softmax(torch)
    serve, serve_launches = phase_serve(torch, np, "linear")
    serve_sm, serve_sm_launches = phase_serve(torch, np, "softmax")
    smoke_errs = phase_smoke_reference(torch)
    torch.cuda.empty_cache()
    train, train_launches = phase_train(torch, "linear")
    train_sm, train_sm_launches = phase_train(torch, "softmax")
    timing = {"la_decode_fused": phase_timing(torch), **phase_timing_la(
        torch), **phase_timing_softmax(torch)}

    # each kernel's launches summed over the main-path runs (every other
    # run left it at 0, expect_launches checked)
    runs = (serve_launches, serve_sm_launches, train_launches,
            train_sm_launches)
    launches = {k: sum(r[k] for r in runs) for k in KERNELS}
    max_err = {"la_decode_fused": kernel_errs["main_bf16"],
               **la_errs["main_bf16"],
               **softmax_errs["decode_main_bf16"],
               **softmax_errs["flash_main_bf16"]}
    kernels = {"kernels": [{
        "name": kname, "route": "cuda", "source": KERNELS[kname][0],
        "replaces": KERNELS[kname][1], "launches": launches[kname],
        "max_abs_err": max_err[kname], "ms": timing[kname]["ms"],
        "plain_ms": timing[kname]["plain_ms"],
        "bound_ms": timing[kname]["bound_ms"],
        "bound_by": timing[kname]["bound_by"],
        "library_ms": timing[kname].get("library_ms")} for kname in KERNELS]}
    for rec in (serve, serve_sm, train, train_sm):
        rec["card"] = smi
    print(json.dumps({"serve": serve, "serve_softmax": serve_sm,
                      "train": train, "train_softmax": train_sm,
                      "build_s": build_s,
                      "kernel_max_abs_err": kernel_errs,
                      "la_kernel_max_abs_err": la_errs,
                      "softmax_kernel_max_abs_err": softmax_errs,
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
