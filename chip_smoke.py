#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or /usr/local/cuda) and the repo's
`src/` beside this file; imports nothing of JAX.  Phases, each of which
fails the run by raising (no result line is printed then):

  1. device  — require CUDA; print the card and its power limit; TF32 off
  2. build   — nvcc every kernel of the path from src/repro_torch/kernels/
               csrc (with -Xptxas -v), print the build seconds
  3. kernel  — each kernel against its plain PyTorch version on CUDA
               tensors at the main path's shapes (plus GQA and a zero
               normalizer), state updated in place
  4. serve   — the Engine at full width pythia-1.4b in bf16: 8 requests,
               512-token prompts, prefill_chunk 256, 32 new tokens,
               greedy; every decode step must go through the kernel
               (24 launches per step); the decode step timed with CUDA
               events and profiled with torch.profiler; the first 4
               decode steps' logits of the kernel path against the plain
               path on one cloned prefilled cache; and the smoke config
               on the card against the same weights on the CPU
  5. timing  — the kernel and its plain version with CUDA events at the
               main path's shapes, beside the kernel's bound
  6. result  — a JSON line with every measurement, the card's line, a
               `kernels` JSON line, then {"ok": true, "device": {...}}
               as the last line
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/la_decode_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/decode_fused.py:157"

# main path: pythia-1.4b at full width
SLOTS, PROMPT_LEN, PREFILL_CHUNK, MAX_NEW = 8, 512, 256, 32
COMPARE_STEPS = 4
# tolerances, relative to the reference's max |value|
F32_REL = 1e-5          # f32 state / f32 outputs: float32 rounding
BF16_REL = 2.0 ** -7    # bf16 outputs: one bf16 rounding step
# full-width logits, kernel path vs plain path: both round o to bf16,
# and a last-bit difference there reaches the logits through a bf16
# residual stream over 24 layers (2^-8 per rounding, compounding)
LOGITS_REL = 2.0 ** -4
SMOKE_REL = 1e-4        # f32 smoke logits, card vs CPU


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
    logs = build.build_all(["la_decode_fused"], ptxas_verbose=True)
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


def phase_serve(torch, np):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import decode_fused as df
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine, Request

    cfg = get_config("pythia-1.4b")
    max_len = PROMPT_LEN + MAX_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    # eos_id=-1: random weights give no meaningful eos, so every request
    # decodes exactly MAX_NEW tokens
    engine = Engine(cfg, params, max_slots=SLOTS, max_len=max_len,
                    prefill_chunk=PREFILL_CHUNK, eos_id=-1, device="cuda")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, cfg.vocab_size, size=(SLOTS, PROMPT_LEN))
    for rid in range(SLOTS):
        engine.submit(Request(rid=rid, prompt=prompts[rid].tolist(),
                              max_new_tokens=MAX_NEW))

    df.launches = 0
    t_start = time.perf_counter()
    first = {}
    for out in engine.stream():
        if out.token is not None and out.rid not in first:
            first[out.rid] = out.t - t_start
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = df.launches
    steps = engine.decode_steps
    log(f"[serve] {SLOTS} requests x {PROMPT_LEN} prompt tokens, "
        f"{MAX_NEW} new: {steps} decode steps, {launches} kernel "
        f"launches, wall {wall!r} s (init {init_s!r} s)")
    if steps < MAX_NEW - 1 or launches != cfg.num_layers * steps:
        raise AssertionError(
            f"kernel launches {launches} != {cfg.num_layers} layers x "
            f"{steps} decode steps")
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
    profile = _profile_decode(torch, mdl, engine, tokens)

    # the first decode steps' logits, kernel path vs plain path, from one
    # prefilled cache (cloned) and the same fed tokens
    prompt_t = torch.from_numpy(prompts).to("cuda")
    logits, cache0 = mdl.prefill(engine.params, engine.cfg,
                                 {"tokens": prompt_t},
                                 mdl.init_cache(cfg, SLOTS, max_len, "cuda"))
    tok = logits.argmax(-1)
    cache_k, cache_t = _clone_cache(cache0), _clone_cache(cache0)
    cfg_k, cfg_t = _with_impl(engine.cfg, "cuda"), _with_impl(engine.cfg,
                                                              "torch")
    logit_errs = []
    for i in range(COMPARE_STEPS):
        lk, cache_k = mdl.decode_step(engine.params, cfg_k, cache_k, tok)
        lt, cache_t = mdl.decode_step(engine.params, cfg_t, cache_t, tok)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"decode step {i}: non-finite logits")
        logit_errs.append(check_close(f"full-width decode step {i} logits "
                                      f"(cuda vs torch)", lk, lt,
                                      LOGITS_REL))
        tok = lk.argmax(-1)

    ttft = [first[r] for r in range(SLOTS)]
    record = {
        "arch": cfg.name, "compute_dtype": cfg.compute_dtype,
        "slots": SLOTS, "prompt_len": PROMPT_LEN,
        "prefill_chunk": PREFILL_CHUNK, "max_new": MAX_NEW,
        "decode_steps": steps, "kernel_launches": launches,
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
    return record, launches


def _profile_decode(torch, mdl, engine, tokens, steps=5):
    """torch.profiler over `steps` full-batch decode steps: the device's
    kernel time and launches per step, its busy share of the wall time
    and the kernels that take the most device time.  None where the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for _ in range(steps):
            mdl.decode_step(engine.params, engine.cfg, engine.cache, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3 / steps
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    if not rows:
        log("[profile] the profiler recorded no device activity")
        return None
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    rec = {"steps": steps, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_busy_share": busy_ms / wall_ms,
           "device_kernels_per_step": sum(e.count for e in rows) / steps,
           "top_kernels_ms_per_step": {
               e.key[:80]: e.self_device_time_total / 1e3 / steps
               for e in top}}
    log(f"[profile] decode step: {rec}")
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
# 5. kernel timing
# ---------------------------------------------------------------------------

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

    def time_fn(fn, reps=200, warm=20):
        for i in range(warm):
            fn(*sets[i % n_bufs][:5], 1.0, 1.0)
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ev0.record()
        for i in range(reps):
            fn(*sets[i % n_bufs][:5], 1.0, 1.0)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    # plain, kernel, kernel, plain
    plain_a = time_fn(df.la_decode_fused_torch)
    kern_a = time_fn(df.la_decode_fused_cuda)
    kern_b = time_fn(df.la_decode_fused_cuda)
    plain_b = time_fn(df.la_decode_fused_torch)
    g = h // hkv
    cols = d + 1
    state_elems = b * hkv * d * cols
    itemsize = torch.tensor([], dtype=dtype).element_size()
    bytes_moved = (2 * state_elems * 4 + 2 * b * hkv * cols * 4
                   + (b * h * d + b * hkv * d + b * hkv * d) * itemsize
                   + b * h * d * itemsize)
    flops = (state_elems * (2 + 2 * g) + b * hkv * cols * (1 + 3 * g)
             + b * h * d)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    rec = {"ms": min(kern_a, kern_b), "ms_runs": [kern_a, kern_b],
           "plain_ms": min(plain_a, plain_b),
           "plain_ms_runs": [plain_a, plain_b],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": bytes_moved, "flops": flops}
    log(f"[timing] la_decode_fused B={b} H={h} Hkv={hkv} D={d} {dtype}: "
        f"kernel {rec['ms_runs']} ms, plain {rec['plain_ms_runs']} ms, "
        f"bound {rec['bound_ms']!r} ms ({rec['bound_by']}: "
        f"{bytes_moved} B, {flops} flop); library_ms null: no single "
        f"PyTorch call computes this fused update + readout")
    return rec


def main() -> int:
    import numpy as np
    import torch

    name, smi = phase_device(torch)
    build_s = phase_build()
    kernel_errs = phase_kernel(torch)
    serve, launches = phase_serve(torch, np)
    smoke_errs = phase_smoke_reference(torch)
    timing = phase_timing(torch)

    kernels = {"kernels": [{
        "name": "la_decode_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": kernel_errs["main_bf16"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}
    serve["card"] = smi
    print(json.dumps({"serve": serve, "build_s": build_s,
                      "kernel_max_abs_err": kernel_errs,
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
