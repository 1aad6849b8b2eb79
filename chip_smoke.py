#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH or /usr/local/cuda) and the repo's
`src/` beside this file; imports nothing of JAX.  Phases, each of which
fails the run by raising (no result line is printed then):

  1. device  — require CUDA; print the card and its power limit; TF32 off
  2. build   — nvcc every kernel source of the paths from
               src/repro_torch/kernels/csrc, one process each, all started
               together (with -Xptxas -v); print the build seconds, and
               keep ptxas's registers and spill bytes per instantiation
     check   — the static kernel-contract checks on the card
               (`repro_torch.check.run_all(device="cuda")`, what `python
               -m repro_torch.check` runs): registry, lint, shared memory,
               the autograd audits (cuda impls too) and the launch bounds
               of all 18 model kernel entries, each Python launch plan
               held against its launcher's C `_plan` export and each entry
               launched under guard bands at small and full widths; no
               finding allowed.  Then the launch-bounds fixture
               (csrc/check_fixture.cu, `oob_blocked_sum`) must be flagged
               exactly REPRO-B001 by its plan and by its guard band, and
               equal its plain version on the same guarded buffer (NaN
               positions included); its launches are the check path's
  3. kernel  — each kernel against its plain PyTorch version on CUDA
               tensors: the linear decode step at the serving shapes (plus
               GQA and a zero normalizer, state in place; every D = 128
               case runs the state stream, and two cases at Dk = 30,
               Dv = 32 the column walk, asserted from the C plan export;
               S and P the bits of the elementwise fmaf update, and two
               launches of the bf16 main case bit-equal); la_fwd,
               la_bwd_q and la_bwd_kv at the training shapes (B=2,
               H=Hkv=16, N=8192, D=128) in bf16 and f32, at odd N=1000
               and with GQA G=4, and in bf16 at N=8192 with q and k that
               share a direction (every bf16 case runs the chunked wgmma
               bodies of all three, every f32 case their token walks,
               asserted from the launchers' C plan exports; a second
               launch of each in the bf16 main case must give bit-equal
               o, g, dq, dk and dv);
               softmax_decode_fused at the serving shapes (B=8, H=Hkv=16,
               S=544, D=128, per-slot lengths >= 1,
               one past the cache; zeros at length 0 checked apart), GQA
               G=4, bf16 and f32 (the tile stream in every case, asserted
               from the C plan exports, and a second launch gives the
               same bits); flash_fwd and the three flash backward
               kernels at the training shapes, odd N=1000 and GQA G=4, bf16
               and f32, and flash_fwd on a prefill window (Nq=256,
               Nk=544, q_offset [0, 256]); at the training shapes
               flash_bwd_q and flash_bwd_kv run twice and must give
               bit-equal dq, dk and dv (no atomics); paged_decode_fused and
               paged_attention at the serving shapes (B=8, H=Hkv=16, D=128,
               page size 16, 34 table entries per slot into a shuffled
               arena, unallocated entries at the sink page, lengths in
               [1, 544] and one past the table), with GQA G=4 at page
               size 5 and with pages of 256 rows (16 tiles a page), bf16
               and f32, zeros at length 0 checked apart (both run the
               tile stream in every case, asserted from the C plan
               exports, and a second launch gives the same bits; at page
               size 16 softmax_decode_fused on the same keys in a
               contiguous cache gives paged_decode_fused's bits);
               the GLA kernels under both decay regimes (the trained
               gate's log_sigmoid(N(0,1) + 6) and a hard U[-5, 0]):
               gla_decode_fused at the serving shapes and with G=4, bf16
               and f32, state in place, a zero normalizer (every D = 128
               case runs the state stream, two cases at Dk = 30, Dv = 32
               the column walk, asserted from the C plan export;
               S and P must be the bits of the elementwise fmaf update,
               and two launches of the bf16 main case bit-equal);
               gla_fwd, gla_bwd_q and gla_bwd_kv at the training shapes,
               odd N=1000 and G=4, bf16 and f32 (o, g, dq, dk, dv, and
               dld against a float64 backward; every bf16 case runs the gated chunked wgmma bodies
               of all three, every f32 case their token walks, asserted
               from the C plan exports; a second launch of each in the
               bf16 main case must give bit-equal o, g, dq, dk and dV');
               and at log_decay = 0 each gated kernel against its
               linear counterpart, in f32 (the walks) and in bf16 (the
               gated wgmma bodies against the linear ones, within one
               bf16 step; dV' against its plain version); the SSD
               kernels ssd_fwd, ssd_bwd_q and
               ssd_bwd_kv at mamba2-2.7b's training shapes (B=2, G=1,
               H=80, N=8192, Dk=128, Dv=64), odd N=1000 and G=4 with
               H=16, bf16 and f32, under a fresh layer's decay
               (-softplus(N(0,1))) and the hard U[-5, 0] (o, the f32 dq
               and dk partials, dv, and after the epilogue dq, dk, dv and
               dld), and at log_decay = 0 the forward against
               unnormalized causal linear attention, in f32 (the token
               walk) and bf16; every bf16 case of the three SSD kernels
               runs its chunked wgmma body, every f32 case the token walk
               (asserted from the launchers' C plan exports), and a second
               launch of the bf16 main case must give bit-equal o, dq
               partials, dk partials and dv; and the shapes of the other
               architectures, under the same limits: la_fwd, la_bwd_q and
               la_bwd_kv at GQA G = 8, 16 and 48 (the wgmma bodies, bf16
               at D = 128; la_bwd_kv split over S = 8, 8 and 16 slices of
               the group, summed in a fixed order, the N = 8192 cases
               launched twice for bit-equal dk and dv), at D = 64 (the
               wgmma bodies in bf16) and 112 (the token walks, bf16
               and f32, GQA at 112) and at deepseek-v2-236b's MLA heads,
               (Dk, Dv) = (192, 128), H = Hkv = 128 (the token walks,
               bf16 at N = 8192 and 1000, f32 at 1000), at qwen2-vl-7b's
               G = 7 (the wgmma bodies, N = 8192 and 1000; la_bwd_kv over
               S = 4 slices of 1 or 2 heads) and at whisper's decoder
               (H = 20, D = 64, N = 448), gla_bwd_kv split at G = 8,
               la_decode_fused at G = 7, G = 48, at D = 64 (whisper), 112
               and at (192, 128) with 128 heads (the stream, bf16 and f32
               with a zero normalizer), gla_decode_fused at G = 7, the
               SSD kernels at zamba2-7b's (64, 64) (ssd_fwd's chunked
               wgmma body in bf16, launched twice for bit-equal o, the
               backward's token walks; bf16 and f32, both decay regimes,
               G = 4)
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
  4b. preempt — priority preemption at full width pythia-1.4b, one run per
               eviction policy, each traced by a ServeTracer: background
               priority-0 requests fill the slots, then (once every slot
               holder decodes and has emitted 8 tokens) 2 priority-5
               requests of 256 random prompt tokens, 16 new, arrive:
               linear and softmax contiguous (phase 4's engines and
               prompts, `snapshot` x 2: every request's tokens bit-equal
               to phase 4's run), softmax paged (phase 4's paged engine,
               its first 8 prompts, `recompute` x 2: each victim's KV rows
               after the re-prefill within RECOMPUTE_REL of a copy taken
               at eviction, per layer), gla paged with 4 slots and 7
               state pages (`page_keep` x 2: tokens bit-equal to the same
               engine without the urgent requests) and gla paged as phase
               4's with 1 urgent request (`recompute` x 1: the f32 state
               page against its eviction copy); each urgent request
               finishes before its victims, every request with its full
               budget, every page back, the path's decode kernel (and
               flash_fwd for every softmax window) launched every step;
               the linear run's tracer summary, the device time of one
               snapshot and one restore per policy, and the urgent
               requests' TTFT against a run with them at priority 0 (FIFO)
  4c. archs  — qwen2.5-3b, stablelm-1.6b, chatglm3-6b, granite-20b
               (bf16 params: 28.2 B of them), zamba2-7b and qwen2-vl-7b
               (f32 params, 7.6 B; M-RoPE) at full width and depth with
               their preset linear backend: 4 requests of 256 random
               prompt tokens, 16 new, greedy, every decode step through
               la_decode_fused (one launch per attention block: zamba2's
               shared block once per group); the decode step timed and
               profiled, and 4 decode steps' logits on the kernel path
               against the plain path; qwen2-vl-7b also `model.prefill`
               on an image of (1, 16, 16) patches then 64 text tokens and
               16 decode steps (rope_pos lags the token count by 255);
               then the smoke configs of all ten architectures on the
               card against the CPU
  4d. moe    — moonshot-v1-16b-a3b at full width and depth (bf16 params,
               28.4 B, the f32 routers kept) and deepseek-v2-236b at full
               width and 8 of 60 layers (1 dense + 7 MoE, bf16 params,
               29.2 B) the same way: la_decode_fused one launch per layer
               and step (deepseek's at (192, 128), 128 heads); their 4
               logits comparisons start each step's two paths from one
               cache (a token near a tie of router scores takes other
               experts on the two paths, and the states keep it); both
               smoke configs on the card against the CPU
  4e. encdec — whisper-large-v3 at full width and depth through
               `models/model.py` (the engine refuses the family, as the
               reference's does; f32 params, the bf16 compute copy): 4
               clips of 1500 stub frames of 1280, its 4-token
               start-of-transcript prompt, 64 new tokens greedy, one
               prefill (the encoder and each decoder layer's
               cross-attention state) and 63 decode steps, each through
               la_decode_fused once per decoder layer (D = 64); the
               decode step timed and profiled, 4 decode steps' logits on
               the kernel path against the plain path
  5. train   — full width pythia-1.4b (f32 params, bf16 compute, the
               config's remat) on SyntheticLM batches of 2 x 8192 tokens
               (seed 0), once per backend (linear, softmax, gla), and
               full-width mamba2-2.7b the same way: the first step's
               loss and grads on the kernel path against the plain path
               from one set of weights (linear and softmax: every
               layer's wq/wk/wv/wo, ln_f and lm_head within 2^-4 of
               their max |value|; gla and mamba2: every grad in two
               legs, in bf16 compute each kind of leaf beside a second
               plain run's spread, in f32 compute each grad within 2^-4);
               then 4 steps through the Trainer, each launching the
               forward kernel 48 times (remat runs each layer's forward
               twice) and each backward kernel 24 times (la_fwd /
               la_bwd_q / la_bwd_kv, flash_fwd / flash_bwd_delta /
               flash_bwd_q / flash_bwd_kv, or gla_fwd / gla_bwd_q /
               gla_bwd_kv; mamba2's 64 layers: ssd_fwd 128 times,
               ssd_bwd_q and ssd_bwd_kv 64 times each); step time,
               tokens/s, peak memory, and one more step under
               torch.profiler
  5a. resume — right after phase 5's linear run: full-width pythia-1.4b
               trained through the Trainer on a MemmapLM token file
               written by ByteTokenizer from the repo's own text (the
               paper's notes and the JAX package's sources; 2 x
               8192 tokens a step, in a temporary directory with free
               room for twice the state, else the run fails): run A 4
               steps with an async checkpoint at step 2 (the state's
               bytes, the host snapshot's and the writer's seconds);
               run B from another init seed restores step 2 (its
               seconds), fails once at step 3, rolls back to step 2 and
               replays to step 4: its params, moments and step bit-equal
               to A's by the manifest's sha256 of each leaf's host copy,
               its step 2-3 losses A's (else A runs again and B may
               differ by no more than that rerun); 48 / 24 / 24 la_fwd /
               la_bwd_q / la_bwd_kv launches a step in both; peak memory
  5b. archs  — the six other architectures 3 steps each of 2 x 8192
               tokens at full width (chatglm3-6b 8 of 28 layers,
               granite-20b 3 of 52, zamba2-7b 2 of 13 groups, qwen2-vl-7b
               6 of 28 with stub M-RoPE positions: f32 AdamW needs 16 B a
               param), launching la_fwd twice and la_bwd_q /
               la_bwd_kv once per attention block and step (zamba2 also
               the SSD kernels: 3gm + 2t forwards, gm + t backwards, remat
               per block inside remat per group); step time, tokens/s,
               peak memory, one step under torch.profiler
  5c. moe    — moonshot-v1-16b-a3b the same way at 4 of 48 layers (1
               dense + 3 MoE, 2.52 B params); its step-0 comparison and
               deepseek-v2-236b's at 2 layers (1 dense + 1 MoE, 5.36 B
               params) in `_train_legs`'s two legs, deepseek's grads held
               on the host between legs and its two kernel legs its train
               path (la_fwd, la_bwd_q and la_bwd_kv at (192, 128), counted:
               no depth of it trains with f32 AdamW on one card); an MoE
               forward at full width and 2 x 8192 tokens run twice for
               bit-equal routing, output and aux (remat recomputes it)
  5d. encdec — whisper-large-v3 at full depth, 3 steps of 16 clips of
               1500 stub frames with decoder sequences of 448 tokens (the
               decoder's self-attention: la_fwd twice, la_bwd_q and
               la_bwd_kv once per decoder layer; the encoder and the
               cross-attention are the plain non-causal form, as the
               reference keeps them on XLA), its step 0 first at 2
               encoder and 2 decoder layers in both legs
  6. timing  — each kernel and its plain version with CUDA events at the
               main paths' shapes, in turns, beside the kernel's bound and,
               where one PyTorch call computes the same function (SDPA for
               the contiguous softmax kernels, `Tensor.copy_` of the
               shifted slice for the fixture; the port never calls them),
               that call; the decode kernels by CUDA graph replays (a
               Python loop of their launches times the host's dispatch):
               la_decode_fused in turns with gla_decode_fused,
               softmax_decode_fused with SDPA, paged_decode_fused with
               paged_attention on the same inputs and with the contiguous
               kernel on the same keys, la_decode_fused and the three
               softmax decode kernels with their body records (ptxas
               registers and spills, shared memory per block, blocks an
               SM holds; the clusters the card holds); flash_fwd, flash_bwd_q
               and flash_bwd_kv also with their achieved TFLOP/s beside
               their bounds' and the ptxas report of every flash
               instantiation; la_fwd, la_bwd_q, la_bwd_kv, gla_fwd,
               gla_bwd_q, gla_bwd_kv, ssd_fwd, ssd_bwd_q and ssd_bwd_kv
               with the body that ran, its ptxas
               registers and spills, shared memory per block, the blocks
               an SM holds and the bound of that body beside the walk's;
               the three LA kernels, the three GLA training kernels and
               ssd_bwd_q also with their tensor-core and byte times and
               beside their token walks (f32 inputs) in turns;
               gla_decode_fused (the state stream) with its body record,
               in turns with la_decode_fused on the same inputs; the
               fixture at n = 2^24 f32, block 256; and the other
               architectures' shapes (`phase_timing_arch`): the LA
               training kernels at each arch's (H, Hkv, D) and at
               deepseek-v2's (128, 128, 192, 128) (whisper's at its train
               shape, B = 16, N = 448), la_decode_fused at each
               arch's serving shape by graph replays in turns with the
               pythia shape's, the SSD kernels at (64, 64); la_bwd_kv's
               records at G = 7, 8, 16 and 48 name its split (S slices),
               ssd_fwd's at (64, 64) its chunked body's registers,
               spills and blocks an SM
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
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores
BF16_TC_FLOP_PER_S = 989e12     # bf16 on the tensor cores, dense
SMS = 132                       # streaming multiprocessors
SM_SMEM = 233472                # shared memory of one SM, bytes
REGISTERS_PER_SM = 65536        # 32-bit registers of one SM

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
    "oob_blocked_sum": (f"{CSRC}/check_fixture.cu",
                        "src/repro/check/fixtures.py:35"),
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
# preemption at full width (phase_serve_preempt): 2 priority-5 requests of
# 256 random prompt tokens (seed 1), 16 new each, arrive once every slot
# holder decodes and has emitted 8 tokens; the page_keep run has 4 slots
# and a budget of 7 state pages (6 allocatable + the sink) for 4
# background requests, so slots block the urgent requests, pages do not
URGENT_PRIORITY, URGENT_PROMPT, URGENT_NEW, URGENT_AFTER = 5, 256, 16, 8
KEEP_SLOTS, KEEP_PAGES = 4, 7
# train path: pythia-1.4b at full width, the paper's §5.2 length
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 4
# phase 5a: run A's checkpoint step, run B's failure one step later; its
# token file is text of the repo that no change edits (the JAX package is
# the port's fixed reference), so every run trains on the same tokens
RESUME_AT = 2
RESUME_TEXTS = ("PAPER.md", "PAPERS.md", "SNIPPETS.md", "src/repro/**/*.py")
# the other architectures (phases 4c and 5b), each at full width with its
# preset backend (linear): served at full depth in bf16, 4 requests of 256
# random prompt tokens, 16 new, greedy (granite-20b with bf16 params: its
# 28.2 B params take 113 GB in f32, 56 GB in bf16, and the engine's
# compute copy then aliases them); trained 3 steps of TRAIN_BATCH x
# TRAIN_SEQ tokens of SyntheticLM, at full depth where f32 params, grads
# and AdamW moments (16 B a param) fit the card, else at the depth below
ARCHS = ("qwen2.5-3b", "stablelm-1.6b", "chatglm3-6b", "granite-20b",
         "zamba2-7b", "qwen2-vl-7b")
ARCH_SLOTS, ARCH_PROMPT, ARCH_NEW, ARCH_TRAIN_STEPS = 4, 256, 16, 3
ARCH_SERVE_PARAMS = {"granite-20b": "bfloat16",
                     "moonshot-v1-16b-a3b": "bfloat16",
                     "deepseek-v2-236b": "bfloat16"}
# the MoE family (phases 4d and 5c), served and trained as the archs above:
# moonshot-v1-16b-a3b at full depth in bf16 params (28.4 B, 56.8 GB, the
# compute copy aliased; the f32 routers stay f32), deepseek-v2-236b at 8
# of its 60 layers (the dense first layer and 7 MoE layers, 29.2 B params,
# 58.4 GB in bf16: the whole model does not fit one card); moonshot
# trained at 4 of 48 layers (1 dense + 3 MoE, 2.52 B params, ~40 GB of
# f32 params, grads and moments); deepseek only through the step-0
# comparison (2 of its layers are 5.36 B params, ~86 GB under f32 AdamW),
# whose grads go to the host between the legs
MOE_ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v2-236b")
# whisper-large-v3 (phases 4e and 5d; the engine refuses the
# encoder-decoder, as the reference's does): served at full width and
# depth through `models/model.py` (f32 params, the bf16 compute copy):
# ENCDEC_SLOTS clips of its 1500 stub frames of 1280, its 4-token
# start-of-transcript prompt, ENCDEC_NEW new tokens greedy; trained at
# full depth (1.53 B params, ~25 GB of params, grads and moments) on
# ENCDEC_TRAIN_BATCH clips with decoder sequences of its 448-token text
# context
ENCDEC = "whisper-large-v3"
ENCDEC_SLOTS, ENCDEC_NEW = 4, 64
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
ENCDEC_PROMPT = (50258, 50259, 50360, 50364)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 16, 448
# qwen2-vl-7b's mixed prefill (phase 4c): an image of VLM_GRID patches
# (t, h, w), then VLM_TEXT text tokens, then VLM_DECODE decode steps: its
# rope position lags the token count by the grid's patches but one
VLM_GRID, VLM_TEXT, VLM_DECODE = (1, 16, 16), 64, 16
# the archs whose attention shapes phase_timing_arch times: moonshot's is
# pythia's (H = Hkv = 16, D = 128), whose rows phase_timing_la times
TIMED_ARCHS = ARCHS + ("deepseek-v2-236b", ENCDEC)
# the LA training kernels' timing shape (B, N) where it is not LA_SHAPE's
LA_TIMING_BN = {ENCDEC: (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ)}
ARCH_SERVE_DEPTH = {"deepseek-v2-236b": dict(num_layers=8)}
COMPARE_ONLY = ("deepseek-v2-236b",)
# depth cuts of the train runs: chatglm3-6b 28 -> 8 layers, granite-20b
# 52 -> 3, zamba2-7b 13 -> 2 groups of 6 Mamba-2 blocks (the tail of 3
# and the shared block kept), qwen2-vl-7b 28 -> 6: 2.17 B, 2.20 B, 1.60 B
# and 2.49 B params, ~35, ~35, ~26 and ~40 GB of params, grads and moments
ARCH_TRAIN_DEPTH = {"chatglm3-6b": dict(num_layers=8),
                    "granite-20b": dict(num_layers=3),
                    "zamba2-7b": dict(num_layers=15, hybrid_groups=2),
                    "moonshot-v1-16b-a3b": dict(num_layers=4),
                    "qwen2-vl-7b": dict(num_layers=6)}
# depth of the step-0 comparison before each train run: kernel path
# against plain path, the loss and every grad in bf16 and in f32 compute
# (`_train_legs`), at full width: the dense stacks at 2 layers (the GQA
# group sums through autograd), zamba2-7b at 2 groups of 1 Mamba-2 block
# with the shared block after each (its grad summed over both
# applications, each under its own remat) and 1 tail block.  In bf16 the
# dense stacks' grads at init stand well above the rounding noise, and
# the wgmma bodies' bf16 products (D = 64, 128) move them by up to twice
# the plain path's own chunk spread in norm: they are held per leaf, as
# pythia's linear path is; zamba2's Mamba-2 grads sit at the noise level
# and are held to the spread, as mamba2's are, and so are the MoE
# family's: a token near a tie of router scores takes other experts on two
# paths, so the routed experts' grads move by up to 5 % of their max
# |value| between two plain runs that differ only in the scan chunk
# (moonshot, 2 layers; PERF.md, §6); whisper-large-v3 at 2 encoder and 2
# decoder layers, held per leaf as the dense stacks are
ARCH_COMPARE_DEPTH = {
    **{arch: dict(num_layers=2) for arch in ARCHS + MOE_ARCHS
       if arch != "zamba2-7b"},
    "zamba2-7b": dict(num_layers=3, hybrid_groups=2,
                      hybrid_mamba_per_group=1, hybrid_tail=1),
    ENCDEC: dict(num_layers=2, encoder_layers=2)}
# the families whose bf16 step-0 leg is held per leaf (`_train_legs`)
PER_LEAF_FAMILIES = ("dense", "vlm", "encdec")
LA_SHAPE = dict(b=2, h=16, hkv=16, n=8192, d=128)
# stablelm-1.6b's attention shape, where phase_timing_la times the D = 64
# bodies
LA_SHAPE_D64 = dict(b=2, h=32, hkv=32, n=8192, d=64)
# the new architectures' attention shapes (H, Hkv, D) and the LA kernel
# cases at them (label, arch, N, dtype): GQA through the wgmma bodies at
# G = 7 (qwen2-vl-7b), 8, 16 and 48, the wgmma bodies at D = 64 (stablelm,
# and whisper's decoder at its 448-token text context; GQA at 64 with a
# ragged chunk, no registry arch), the token walks at 112 (zamba2-7b's
# shared attention, 3584 / 32), with GQA at 112 too
LA_ARCH_SHAPES = {"qwen2.5-3b": (16, 2, 128), "stablelm-1.6b": (32, 32, 64),
                  "stablelm-1.6b-gqa": (32, 8, 64),
                  "chatglm3-6b": (32, 2, 128), "granite-20b": (48, 1, 128),
                  "zamba2-7b": (32, 32, 112), "zamba2-7b-gqa": (32, 8, 112),
                  "moonshot-v1-16b-a3b": (16, 16, 128),
                  "qwen2-vl-7b": (28, 4, 128), ENCDEC: (20, 20, 64),
                  # MLA: (H, Hkv, Dk, Dv), q and k nope 128 + rope 64
                  "deepseek-v2-236b": (128, 128, 192, 128)}
LA_ARCH_CASES = (
    ("gqa8_bf16", "qwen2.5-3b", 8192, "bfloat16"),
    ("gqa16_bf16", "chatglm3-6b", 8192, "bfloat16"),
    ("mqa48_bf16", "granite-20b", 8192, "bfloat16"),
    ("mqa48_odd_n_bf16", "granite-20b", 1000, "bfloat16"),
    ("d64_bf16", "stablelm-1.6b", 8192, "bfloat16"),
    ("d64_f32", "stablelm-1.6b", 1000, "float32"),
    ("d64_gqa_odd_n_bf16", "stablelm-1.6b-gqa", 1000, "bfloat16"),
    ("d112_bf16", "zamba2-7b", 8192, "bfloat16"),
    ("d112_f32", "zamba2-7b", 8192, "float32"),
    ("d112_gqa_odd_n_f32", "zamba2-7b-gqa", 1000, "float32"),
    ("d112_gqa_odd_n_bf16", "zamba2-7b-gqa", 1000, "bfloat16"),
    ("mla_bf16", "deepseek-v2-236b", 8192, "bfloat16"),
    ("mla_odd_n_f32", "deepseek-v2-236b", 1000, "float32"),
    ("mla_odd_n_bf16", "deepseek-v2-236b", 1000, "bfloat16"),
    ("gqa7_bf16", "qwen2-vl-7b", 8192, "bfloat16"),
    ("gqa7_odd_n_bf16", "qwen2-vl-7b", 1000, "bfloat16"),
    ("whisper_d64_bf16", ENCDEC, ENCDEC_TRAIN_SEQ, "bfloat16"))


def _la_arch_shape(arch):
    """(H, Hkv, Dk, Dv) of an LA_ARCH_SHAPES entry; Dv None where it is
    Dk."""
    h, hkv, d, *dv = LA_ARCH_SHAPES[arch]
    return h, hkv, d, (dv[0] if dv else None)
# zamba2-7b's Mamba-2 layers: state 64, head dim 64, 112 heads
SSD_ZAMBA2_SHAPE = dict(b=2, g=1, h=112, n=8192, dk=64, dv=64)
# the shared-direction case of the LA kernels: q and k rows are their
# noise (norm ~1) plus this times one common unit direction, then
# l2-normalized (cosine ~0.99 between rows)
LA_SHARED = 10.0
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
# a recompute victim's KV rows (paged softmax) or f32 state page (paged
# GLA) after its re-prefill against a copy taken at eviction, relative
# to max |value| per layer: the copy was built by prefill windows and then
# decode steps (the tile stream; the state stream), the re-prefill builds
# the same positions by windows alone (flash_fwd; the plain chunked scan),
# so each token decoded before the eviction reaches every layer through
# other bf16 roundings, compounding over the 24 layers of the bf16
# residual stream as in the logits comparisons
RECOMPUTE_REL = LOGITS_REL
# la_fwd / la_bwd in f32 against their plain versions: the kernels sum
# token by token over up to 8192 tokens, the plain scans chunk by
# chunk, so the f32 sums round in different orders
SEQ_F32_REL = 1e-4
# the GLA log-decay gradient, dld = the reverse cumsum over up to 8192
# tokens of dcl = -[v, 1].dV', held to the magnitude of those sums: the
# plain scans form each decay as exp of a difference of a chunk's cumsum
# of log decays, which under strong decay reaches ~-1,300 within 512
# tokens, where one float32 ulp is 1.2e-4, and dld sums those errors.
# The kernel's dld and the plain version's are each held against a
# float64 backward (`_gla_dld_f64`), not against each other
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
# the GLA and mamba2 grads at init in bf16 compute: the GLA gate's (wg:
# d log_sigmoid(z + 6)/dz ~ e^-6 scales a sum over 16,384 tokens that
# mostly cancels), every mamba2 leaf's and GLA's deep q projections' sit
# at the level of the rounding noise itself: two plain runs that differ
# only in the scan chunk (512 against 256) disagree by up to 1.39x (wg)
# and 2x (mamba2) their largest |value| (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md).  There the kernel path is held to that spread: each kind of
# leaf, in norm over its layers, differs from the plain path by at most
# GATE_NOISE_FACTOR times the norm by which the two plain runs differ
# (`_train_legs`, beside a strict f32-compute leg)
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
    from repro_torch.check import fixtures
    return (df.launches, la.launches, fl.launches, pg.launches,
            gla.launches, ssd.launches, fixtures.launches)


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

def _ptxas_report(logs) -> dict:
    """Registers and spill bytes of every kernel instantiation, by source,
    from ptxas's -v report in the build log."""
    fn_re = re.compile(r"Compiling entry function '([^']+)'")
    spill_re = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
    regs_re = re.compile(r"Used (\d+) registers")
    out = {}
    for name, text in logs.items():
        recs, cur = [], None
        for line in text.splitlines():
            m = fn_re.search(line)
            if m:
                cur = {"function": m.group(1)}
                recs.append(cur)
            elif cur is not None and spill_re.search(line):
                st, ss, sl = spill_re.search(line).groups()
                cur.update(stack=int(st), spill_stores=int(ss),
                           spill_loads=int(sl))
            elif cur is not None and regs_re.search(line):
                cur["registers"] = int(regs_re.search(line).group(1))
        try:
            names = subprocess.run(
                ["c++filt"], input="\n".join(r["function"] for r in recs),
                capture_output=True, text=True, timeout=60,
                check=True).stdout.splitlines()
            for rec, full in zip(recs, names):
                # "void (anonymous namespace)::name<T, D>(args)" -> name<T, D>
                full = full.replace("(anonymous namespace)::", "")
                rec["function"] = full.split("(")[0].replace("void ", "")
        except (OSError, subprocess.SubprocessError):
            pass  # keep the mangled names
        out[name] = recs
    return out


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all(build.SOURCES, ptxas_verbose=True)
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        log(f"[build] {name}: {secs!r} s\n{text.strip()}")
    return secs, _ptxas_report(logs)


# ---------------------------------------------------------------------------
# the static kernel-contract checks (this slice's path)
# ---------------------------------------------------------------------------

def phase_check(torch):
    """run_all on the card, then the fixture: the check path, its launch
    counts set to 0 just before and read just after."""
    from repro_torch.check import fixtures, run_all
    t0 = time.perf_counter()
    reset_launches()
    report = run_all(device="cuda", log=lambda s: log(f"[check] {s}"))
    static = fixtures.audit_oob_fixture()
    on_card = fixtures.audit_oob_fixture_on_card()
    launches = read_launches()
    secs = time.perf_counter() - t0
    if report["findings"]:
        raise AssertionError(f"check: findings on the model kernels: "
                             f"{report['findings']}")
    for label, found in (("plan", static), ("guard band", on_card)):
        log(f"[check] fixture by its {label}: {[str(f) for f in found]}")
        if sorted({f.rule for f in found}) != ["REPRO-B001"]:
            raise AssertionError(f"check: the fixture's {label} gave "
                                 f"{found}, not exactly REPRO-B001")
    if launches["oob_blocked_sum"] < 1:
        raise AssertionError(f"check: the fixture kernel never launched "
                             f"on the check path: {launches}")
    # the kernel against its plain version on one guarded buffer (a
    # comparison: outside the counted path)
    g = fixtures.guarded_oob_input(64, "cuda")
    got = fixtures.oob_blocked_sum_cuda(g.view, 16)
    want = fixtures.oob_blocked_sum_torch(g.buf, g.guard, 64, 16)
    torch.cuda.synchronize()
    live = ~torch.isnan(want)
    err = float((got[live] - want[live]).abs().max())
    if not torch.equal(torch.isnan(got), ~live) or err != 0.0:
        raise AssertionError(f"check: fixture kernel {got} != plain {want}")
    bounds = [c for c in report["coverage"] if c["pass"] == "bounds"]
    rec = {"check_s": secs, "findings": len(report["findings"]),
           "bounds_cases": sum(c["cases"] for c in bounds),
           "bounds_entries": sorted({k for c in bounds
                                     for k in c["kernels"]}),
           "autograd_cells": sum(c["pass"] == "autograd"
                                 for c in report["coverage"]),
           "fixture_rules": {"plan": [f.rule for f in static],
                             "guard_band": [f.rule for f in on_card]},
           "fixture_max_abs_err": err}
    log(f"[check] {rec}; launches on the check path {launches}")
    return rec, launches


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

def _decode_case(torch, gen, b, h, hkv, d, dtype, zero_den=False, dv=None):
    """Warm f32 state (3 rank-1 updates with unit k) and unit q/k rows,
    as the model hands them over after l2 normalization; Dk = d, Dv = dv
    (d where None)."""
    from repro_torch.kernels import decode_fused as df
    dv = d if dv is None else dv

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return x / x.norm(dim=-1, keepdim=True)

    s = torch.zeros((b, hkv, d, dv + 1), device="cuda")
    p = torch.zeros((b, hkv, dv + 1), device="cuda")
    for _ in range(3):
        df.la_decode_fused_torch(
            s, p, unit(b, h, d), unit(b, hkv, d),
            torch.randn((b, hkv, dv), generator=gen, device="cuda"), 1.0, 1.0)
    q, k = unit(b, h, d), unit(b, hkv, d)
    v = torch.randn((b, hkv, dv), generator=gen, device="cuda")
    if zero_den:
        # slot 0, KV head 0: after the update p[dv] == 0 and q == 0, so
        # the normalizer is exactly 0 while the numerators are not
        p[0, 0, dv] = -1.0
        q[0, :h // hkv] = 0.0
    return s, p, q.to(dtype), k.to(dtype), v.to(dtype)


def _recurrent_decode_body(s, p, q, k, v, ld=None):
    """The body la_decode_fused (ld None) or gla_decode_fused runs for
    these operands, held to its launcher's C export: "stream" or
    "walk"."""
    from repro_torch.kernels import decode_fused as df
    body = df.recurrent_decode_body(k.shape[-1], v.shape[-1],
                                    q.shape[1] // k.shape[1])
    if ld is None:
        return _c_body(body, df.plan_la_decode_fused(s, p, q, k, v, 1.0,
                                                     1.0))
    return _c_body(body, df.plan_gla_decode_fused(s, p, q, k, v, ld, 1.0,
                                                  1.0))


# The dims at which both recurrent decode entries keep the column walk
# (Dk % 4 != 0: the state's row chunks are not 16-byte aligned)
WALK_DK, WALK_DV = 30, 32


def phase_kernel(torch):
    """la_decode_fused against its plain version; every D = 128 case runs
    the state stream, and so do qwen2-vl-7b's group of 7 and granite-20b's
    of 48 query heads a KV head, zamba2-7b's head dim 112 and whisper's 64
    (at 4 slots, the serving runs'), the walk cases (Dk = 30, Dv = 32) the
    column walk (from the C plan export); S and P are the bits of the
    elementwise fmaf update, and the bf16 main case launches twice for
    bit-equal o, S and P."""
    from repro_torch.kernels import decode_fused as df
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main_bf16", 8, 16, 16, 128, None, bf16, False),
             ("main_f32", 8, 16, 16, 128, None, f32, False),
             ("gqa_bf16", 8, 16, 4, 128, None, bf16, False),
             ("zero_den_f32", 8, 16, 16, 128, None, f32, True),
             ("walk_gqa_bf16", 8, 16, 4, WALK_DK, WALK_DV, bf16, False),
             ("walk_zero_den_f32", 8, 16, 16, WALK_DK, WALK_DV, f32, True),
             ("mqa48_bf16", ARCH_SLOTS, 48, 1, 128, None, bf16, False),
             ("mqa48_zero_den_f32", ARCH_SLOTS, 48, 1, 128, None, f32,
              True),
             ("d112_bf16", ARCH_SLOTS, 32, 32, 112, None, bf16, False),
             ("d112_zero_den_f32", ARCH_SLOTS, 32, 32, 112, None, f32,
              True),
             # deepseek-v2-236b's MLA heads: a 192 x 129 f32 slab (99 KB)
             # per (slot, head), 128 heads, G = 1
             ("mla_bf16", ARCH_SLOTS, 128, 128, 192, 128, bf16, False),
             ("mla_zero_den_f32", ARCH_SLOTS, 128, 128, 192, 128, f32,
              True),
             # qwen2-vl-7b: 28 query heads on 4 KV heads, an odd group
             ("gqa7_bf16", ARCH_SLOTS, 28, 4, 128, None, bf16, False),
             ("gqa7_zero_den_f32", ARCH_SLOTS, 28, 4, 128, None, f32, True),
             # whisper-large-v3's decoder: 20 heads of 64
             ("whisper_d64_bf16", ENCDEC_SLOTS, 20, 20, 64, None, bf16,
              False)]
    errs = {}
    for label, b, h, hkv, d, dv, dtype, zero_den in cases:
        s, p, q, k, v = _decode_case(torch, gen, b, h, hkv, d, dtype,
                                     zero_den, dv)
        body = _recurrent_decode_body(s, p, q, k, v)[0]
        expect = "walk" if d == WALK_DK else "stream"
        if body != expect:
            raise AssertionError(f"{label}: decode body {body}, not "
                                 f"{expect}")
        # γ = 1: the linear update is the gated one at log_decay = 0
        want_s, want_p = _gla_decode_state(
            torch, s, p, k, v, torch.zeros((b, hkv), device="cuda"))
        s_k, p_k = s.clone(), p.clone()
        ptrs = (s_k.data_ptr(), p_k.data_ptr())
        o_k = df.la_decode_fused_cuda(s_k, p_k, q, k, v, 1.0, 1.0)
        if label == "main_bf16":
            s_2, p_2 = s.clone(), p.clone()
            o_2 = df.la_decode_fused_cuda(s_2, p_2, q, k, v, 1.0, 1.0)
        torch.cuda.synchronize()
        o_t = df.la_decode_fused_torch(s, p, q, k, v, 1.0, 1.0)
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} Dk={d} "
            f"Dv={v.shape[-1]} {dtype}, body {body} (C plan export)")
        if (s_k.data_ptr(), p_k.data_ptr()) != ptrs:
            raise AssertionError(f"{label}: state was reallocated")
        for name, got, want in (("s", s_k, want_s), ("p", p_k, want_p)):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"{label} {name}: not the elementwise update's bits "
                    f"({int((got != want).sum())} elements differ)")
        log(f"  {label} s, p: the elementwise fmaf update's bits")
        if label == "main_bf16":
            if not (torch.equal(o_k, o_2) and torch.equal(s_k, s_2)
                    and torch.equal(p_k, p_2)):
                raise AssertionError(f"{label}: two launches give "
                                     f"different o, s or p")
            log(f"  {label} o, s, p: two launches bit-equal")
            del s_2, p_2, o_2
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


def _la_case(torch, gen, b, h, hkv, n, d, dtype, shared=0.0, dv=None):
    """Unit q/k rows (as the model hands them over after l2
    normalization) of d columns, normal v and upstream grad of dv (d where
    None), and the plain forward's o and g with the backward's Ω̂ and h
    prepared from them.  With
    `shared` > 0 the rows are their noise (norm ~1) plus `shared` times
    one common unit direction before the normalization, so q and k share
    a direction as the keys of a trained model do: Σ k grows with t and
    the terms of the backward's [Ω̂, -h] cancel."""
    from repro_torch.core import chunked
    from repro_torch.kernels import linear_attention as la
    if shared:
        u = torch.randn(d, generator=gen, device="cuda")
        u = u / u.norm()

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        if shared:
            x = x / d ** 0.5 + shared * u
        return (x / x.norm(dim=-1, keepdim=True)).to(dtype)

    dv = d if dv is None else dv
    q, k = unit(b, h, n, d), unit(b, hkv, n, d)
    v = torch.randn((b, hkv, n, dv), generator=gen, device="cuda").to(dtype)
    omega = torch.randn((b, h, n, dv), generator=gen, device="cuda")
    o, g = la.la_fwd_torch(q, k, v, 1.0, 1.0)
    om_hat, h_vec = chunked.la_bwd_prep(o, g, omega)
    return q, k, v, om_hat, h_vec


def phase_kernel_la(torch):
    """la_fwd, la_bwd_q and la_bwd_kv against their plain versions.
    Every bf16 case at D in LA_WGMMA_HEAD_DIMS (128, GQA included: G = 4,
    and the new archs' 7, 8, 16 and 48; 64: stablelm-1.6b, whisper's
    decoder, G = 4 at a ragged N) runs the chunked wgmma bodies of all
    three, every f32 case and every bf16 case at D = 112 (zamba2-7b) or
    (Dk, Dv) = (192, 128) (deepseek-v2-236b's MLA) the token walks (from
    the launchers' C plan exports); la_bwd_kv at G = 7, 8, 16 and 48
    splits the group over S > 1 slices (`_kv_split`, from the C export;
    each record names S), the bf16 N = 8192 ones launched twice for
    bit-equal dk and dv; the bf16 main cases at D = 128 and 64
    launch each kernel twice for bit-equal o, g, dq, dk and dv; one bf16
    case at N = 8192 at each of the two has q and k that share a
    direction."""
    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels.defaults import LA_BWD_KV_SPLIT_GROUP, \
        LA_WGMMA_HEAD_DIMS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    m = LA_SHAPE
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("main_bf16", m["b"], m["h"], m["hkv"], m["n"], m["d"], None,
              bf16, 0.0),
             ("main_f32", m["b"], m["h"], m["hkv"], m["n"], m["d"], None,
              f32, 0.0),
             ("odd_n_bf16", m["b"], m["h"], m["hkv"], 1000, m["d"], None,
              bf16, 0.0),
             ("gqa_f32", m["b"], m["h"], 4, 1000, m["d"], None, f32, 0.0),
             ("gqa_bf16", m["b"], m["h"], 4, 1000, m["d"], None, bf16, 0.0),
             ("shared_bf16", m["b"], m["h"], m["hkv"], m["n"], m["d"], None,
              bf16, LA_SHARED),
             ("d64_shared_bf16", *(LA_SHAPE_D64[x] for x in
                                   ("b", "h", "hkv", "n", "d")), None, bf16,
              LA_SHARED),
             # the new archs' own shapes (LA_ARCH_SHAPES)
             *((label, m["b"], *_la_arch_shape(arch)[:2], n,
                *_la_arch_shape(arch)[2:], getattr(torch, dtype), 0.0)
               for label, arch, n, dtype in LA_ARCH_CASES)]
    errs = {}
    for label, b, h, hkv, n, d, dv, dtype, shared in cases:
        q, k, v, om_hat, h_vec = _la_case(torch, gen, b, h, hkv, n, d,
                                          dtype, shared, dv)
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} N={n} Dk={d} "
            f"Dv={v.shape[-1]} {dtype} shared={shared}")
        rel = BF16_REL if dtype == torch.bfloat16 else SEQ_F32_REL
        expect = "wgmma" if dtype == torch.bfloat16 \
            and d in LA_WGMMA_HEAD_DIMS and dv is None else "walk"
        bodies = {"la_fwd": _la_fwd_body(q, k, v)[0],
                  **{e: _la_bwd_body(e, q, k, v, om_hat, h_vec)[0]
                     for e in ("la_bwd_q", "la_bwd_kv")}}
        if set(bodies.values()) != {expect}:
            raise AssertionError(f"{label}: bodies {bodies}, not {expect}")
        log(f"  {label} bodies (C plan exports): {bodies}")
        split = _kv_split(q, k, v, om_hat, h_vec)
        log(f"  {label} la_bwd_kv split (C plan export): {split}")
        if (split["slices"] > 1) != (expect == "wgmma"
                                     and h // hkv >= LA_BWD_KV_SPLIT_GROUP):
            raise AssertionError(f"{label}: la_bwd_kv split {split}")
        o_k, g_k = la.la_fwd_cuda(q, k, v, 1.0, 1.0)
        dq_k = la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)
        dk_k, dv_k = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
        if split["slices"] > 1 and n == LA_SHAPE["n"]:
            again = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
            torch.cuda.synchronize()
            if not (torch.equal(dk_k, again[0])
                    and torch.equal(dv_k, again[1])):
                raise AssertionError(f"{label}: two split launches of "
                                     f"la_bwd_kv give different dk or dv")
            log(f"  {label} dk, dv: two split launches bit-equal ({split})")
            del again
        if label in ("main_bf16", "d64_bf16"):
            again = (*la.la_fwd_cuda(q, k, v, 1.0, 1.0),
                     la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0),
                     *la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0))
            torch.cuda.synchronize()
            for name, x, y in zip(("o", "g", "dq", "dk", "dv"),
                                  (o_k, g_k, dq_k, dk_k, dv_k), again):
                if not torch.equal(x, y):
                    raise AssertionError(f"{label}: two launches give "
                                         f"different {name}")
            log(f"  {label} o, g, dq, dk, dv: two launches bit-equal "
                f"({bodies})")
            del again
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
        e["la_bwd_kv_split"] = split
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
        body = _decode_stream(df.plan_softmax_decode_fused(q, k, v,
                                                           lengths))[0]
        o_k = df.softmax_decode_fused_cuda(q, k, v, lengths)
        o_2 = df.softmax_decode_fused_cuda(q, k, v, lengths)
        torch.cuda.synchronize()
        o_t = df.softmax_decode_fused_torch(q, k, v, lengths)
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} S={s_len} D={d} "
            f"{dtype}, lengths {lengths.tolist()}; body {body} (C plan "
            f"export)")
        errs[label] = {"softmax_decode_fused": check_close(
            f"{label} o", o_k, o_t, _softmax_rel(torch, dtype))}
        if o_k.dtype != dtype or not torch.isfinite(o_k).all():
            raise AssertionError(f"{label}: o dtype {o_k.dtype} or "
                                 f"non-finite values")
        if not torch.equal(o_k, o_2):
            raise AssertionError(f"{label}: two launches give different o")
        log(f"  {label} o: two launches bit-equal")
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
            if nq == m["n"]:
                # the training shape: the backward is deterministic (no
                # atomics), so a second run gives bit-equal grads
                dq_2 = fl.flash_bwd_q_cuda(q, k, v, do, lse_t, delta_k)
                dk_2, dv_2 = fl.flash_bwd_kv_cuda(q, k, v, do, lse_t,
                                                  delta_k)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in (
                    (dq_k, dq_2), (dk_k, dk_2), (dv_k, dv_2)))
                log(f"  {label} backward run twice: bit-equal {same}")
                if not same:
                    raise AssertionError(f"{label}: two backward runs "
                                         f"differ")
                e["bwd_bit_equal"] = same
                del dq_2, dk_2, dv_2
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


def _stream_clusters(launch):
    """(blocks per cluster, the most clusters the card holds at once) of a
    softmax decode launch, from its launcher's C export
    `<source>_cluster_plan`."""
    import ctypes
    from repro_torch.kernels import build
    symbol = f"{launch.lib}_cluster_plan"
    argtypes = ([ctypes.c_char_p] + [ctypes.c_int] * len(launch.plan_args)
                + [ctypes.POINTER(ctypes.c_int64)])
    lib = build.bind(launch.lib, {symbol: argtypes})
    out = (ctypes.c_int64 * 2)()
    err = getattr(lib, symbol)(launch.name.encode(), *launch.plan_args, out)
    build.raise_on(lib, launch.lib, symbol, err)
    return int(out[0]), int(out[1])


def _decode_stream(launch):
    """("stream", launch, C plan, the most clusters the card holds) for a
    softmax decode entry's plan, raising unless its launcher's C exports
    report that launch (grid, threads, shared memory) as clusters of
    PAGED_DECODE_CLUSTER blocks: the tile stream, the only body of the
    three entries."""
    from repro_torch.kernels.defaults import PAGED_DECODE_CLUSTER
    body, launch, got = _c_body("stream", launch)
    per_cluster, clusters = _stream_clusters(launch)
    if per_cluster != PAGED_DECODE_CLUSTER:
        raise AssertionError(f"{launch.name}: clusters of {per_cluster} "
                             f"blocks, not the stream's "
                             f"{PAGED_DECODE_CLUSTER}")
    return body, launch, got, clusters


def phase_kernel_paged(torch):
    """paged_decode_fused and paged_attention against their plain versions
    (the serving shape, GQA at page size 5, and pages of 256 rows: 16
    tiles each), both running the tile stream in every case (from the C
    plan exports), a second launch giving the same bits and zeros at
    length 0; at page size DECODE_TILE_ROWS softmax_decode_fused on the
    same keys gathered into a contiguous cache gives paged_decode_fused's
    bits."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import paged_attention as pg
    from repro_torch.kernels.defaults import DECODE_TILE_ROWS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    kernels = (("paged_decode_fused", df.paged_decode_fused_cuda,
                df.plan_paged_decode_fused),
               ("paged_attention", pg.paged_attention_cuda,
                pg.plan_paged_attention))
    errs = {}
    for label, hkv, ps, dtype in (
            ("paged_main_bf16", 16, PAGE_SIZE, torch.bfloat16),
            ("paged_main_f32", 16, PAGE_SIZE, torch.float32),
            ("paged_gqa_ps5_bf16", 4, 5, torch.bfloat16),
            ("paged_gqa_ps5_f32", 4, 5, torch.float32),
            ("paged_ps256_bf16", 16, 256, torch.bfloat16),
            ("paged_ps256_f32", 16, 256, torch.float32)):
        b, h, d = SLOTS, 16, 128
        pmax = -(-MAX_LEN // ps)
        lengths = torch.randint(1, MAX_LEN + 1, (b,), generator=gen,
                                device="cuda").to(torch.int32)
        lengths[0] = pmax * ps + 1       # a retired slot past its table
        case = _paged_case(torch, gen, b, h, hkv, d, ps, pmax, lengths,
                           dtype)
        want = pg.paged_attention_torch(*case)
        rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
        bodies = {name: _decode_stream(plan_fn(*case))[0]
                  for name, _, plan_fn in kernels}
        log(f"[kernel] {label}: B={b} H={h} Hkv={hkv} D={d} ps={ps} "
            f"Pmax={pmax} {dtype}, lengths {lengths.tolist()}; bodies "
            f"{bodies} (C plan exports), tiles of "
            f"{pg.tiling(ps)[0]} rows, {pg.tiling(ps)[1]} a page")
        errs[label] = {}
        for name, kernel, _ in kernels:
            o = kernel(*case)
            o_2 = kernel(*case)
            torch.cuda.synchronize()
            errs[label][name] = check_close(f"{label} {name} o", o, want,
                                            rel)
            if o.dtype != dtype or not torch.isfinite(o).all():
                raise AssertionError(f"{label} {name}: o dtype {o.dtype} "
                                     f"or non-finite values")
            if not torch.equal(o, o_2):
                raise AssertionError(f"{label} {name}: two launches give "
                                     f"different o")
            log(f"  {label} {name} o: two launches bit-equal")
            if name == "paged_decode_fused" and ps == DECODE_TILE_ROWS:
                # the same keys as a contiguous cache: the same tiles,
                # spans and arithmetic, so the same bits
                q, kp, vp, table, _ = case
                o_c = df.softmax_decode_fused_cuda(
                    q, pg.gather_pages(kp, table),
                    pg.gather_pages(vp, table), lengths)
                torch.cuda.synchronize()
                if not torch.equal(o, o_c):
                    raise AssertionError(
                        f"{label}: softmax_decode_fused on the gathered "
                        f"keys is not paged_decode_fused's bits")
                log(f"  {label}: softmax_decode_fused on the same keys "
                    f"gives paged_decode_fused's bits")
                errs[label]["contiguous_bit_equal"] = True
            del o_2
        # length 0: zeros on both kernels (and on the plain version)
        lengths[1] = 0
        for name, kernel, _ in kernels:
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


def _gla_decode_case(torch, gen, b, h, hkv, d, dtype, regime, dv=None):
    """_decode_case's inputs and a log decay; slot 0, KV head 0 decays by
    exactly 1 so that its zero normalizer survives the gate."""
    s, p, q, k, v = _decode_case(torch, gen, b, h, hkv, d, dtype,
                                 zero_den=True, dv=dv)
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


def _gla_body(entry, q, k, v, ld, om_hat, h_vec):
    """The body gla_fwd, gla_bwd_q or gla_bwd_kv runs for these operands,
    held to its launcher's C export: "wgmma" or "walk"."""
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    d = q.shape[-1]
    if entry == "gla_fwd":
        return _c_body(la.la_fwd_body(q.dtype, d, entry),
                       gla.plan_gla_fwd(q, k, v, ld, 1.0, 1.0))
    if entry == "gla_bwd_q":
        return _c_body(la.la_bwd_body(entry, q.dtype, d),
                       gla.plan_gla_bwd_q(k, v, ld, om_hat, h_vec, 1.0))
    return _c_body(la.la_bwd_body(entry, q.dtype, d),
                   gla.plan_gla_bwd_kv(q, k, v, ld, om_hat, h_vec, 1.0, 1.0))


def _fma_f32(torch, a, b, c):
    """fmaf(a, b, c) of f32 tensors, rounded once, on the card: a b + c in
    float64 (a b exact), TwoSum's error term, and the f32 rounding moved
    off a tie where that term says the exact sum lies past it."""
    x, y = c.double(), a.double() * b.double()
    s = x + y
    bb = s - x
    err = (x - (s - bb)) + (y - bb)
    r = s.float()
    inf = torch.full_like(r, math.inf)
    up, down = torch.nextafter(r, inf), torch.nextafter(r, -inf)
    r = torch.where((s == (r.double() + up.double()) / 2) & (err > 0), up,
                    r)
    return torch.where((s == (r.double() + down.double()) / 2) & (err < 0),
                       down, r)


def _gla_decode_state(torch, s, p, k, v, ld):
    """The state a gated decode step leaves, as the kernels compute it
    element by element: S = fmaf(k_i, v_j, γ S), P = fmaf(γ, P, [v, 1]),
    γ = exp(ld) (f32)."""
    b, hkv, d = k.shape
    vaug = torch.cat([v.float(), torch.ones((b, hkv, 1), device="cuda")],
                     -1)
    gam = torch.exp(ld.float())
    s_new = _fma_f32(torch, k.float()[..., :, None].expand_as(s),
                     vaug[..., None, :].expand_as(s),
                     s * gam[..., None, None])
    return s_new, _fma_f32(torch, gam[..., None].expand_as(p), p, vaug)


def _gla_dld_f64(torch, q, k, v, ld, om_hat, h_vec):
    """dlog_decay of the plain GLA backward (a = b = 1) in float64, by the
    token recurrence of its definition: U_n = γ_{n+1} U_{n+1} + Σ_g
    [q_n, 1]^T [Ω̂_n, -h_n] (Dk+1, Dv+1), dV'_n = k_n U_n[:Dk] + U_n[Dk],
    dcl_n = -[v_n, 1] . dV'_n, dld_t = Σ_{n >= t} dcl_n.  It shares
    neither the kernel's nor the chunked scan's sum order or precision."""
    f64, dev = torch.float64, q.device
    b, h, n, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    grp = h // hkv
    qa = torch.cat([q.to(f64), torch.ones((b, h, n, 1), dtype=f64,
                                          device=dev)], -1)
    qa = qa.reshape(b, hkv, grp, n, dk + 1)
    gm = torch.cat([om_hat.to(f64), -h_vec.to(f64)[..., None]], -1)
    gm = gm.reshape(b, hkv, grp, n, dv + 1)
    kk, gam = k.to(f64), torch.exp(ld.to(f64))
    u = torch.zeros((b, hkv, dk + 1, dv + 1), dtype=f64, device=dev)
    dva = torch.empty((b, hkv, n, dv + 1), dtype=f64, device=dev)
    for i in reversed(range(n)):
        if i + 1 < n:
            u = u * gam[:, :, i + 1, None, None]
        u = u + torch.einsum("bhgc,bhge->bhce", qa[:, :, :, i],
                             gm[:, :, :, i])
        dva[:, :, i] = (torch.einsum("bhd,bhde->bhe", kk[:, :, i],
                                     u[:, :, :dk]) + u[:, :, dk])
    dcl = -((v.to(f64) * dva[..., :dv]).sum(-1) + dva[..., dv])
    return torch.flip(torch.cumsum(torch.flip(dcl, [-1]), -1), [-1])


def phase_kernel_gla(torch):
    """gla_decode_fused, gla_fwd, gla_bwd_q and gla_bwd_kv against their
    plain versions, under both decay regimes; at log_decay = 0 against
    the linear kernels (f32: the walks; bf16: the gated instances of the
    chunked wgmma bodies against the linear ones).  Every D = 128 decode
    case runs gla_decode_fused's state stream, the walk cases (Dk = 30,
    Dv = 32) its column walk, S and P the bits of the elementwise fmaf
    update; every bf16 case runs gla_fwd's, gla_bwd_q's
    and gla_bwd_kv's chunked wgmma bodies, every f32 case their token
    walks (from the launchers' C plan exports); the bf16 main cases
    launch each kernel twice for bit-equal o, g, dq, dk and dV', and the
    decode step's o, S and P; at G = 8 gla_bwd_kv splits the group over
    slices (launched twice for bit-equal dk and dV')."""
    from repro_torch.core import gla as core_gla
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    errs = {}
    for label, h, hkv, d, dv, dtype, regime in (
            ("decode_main_bf16", 16, 16, 128, None, bf16, "trained"),
            ("decode_main_f32_strong", 16, 16, 128, None, f32, "strong"),
            ("decode_main_bf16_strong", 16, 16, 128, None, bf16, "strong"),
            ("decode_gqa_bf16_strong", 16, 4, 128, None, bf16, "strong"),
            ("decode_gqa_f32", 16, 4, 128, None, f32, "trained"),
            # the gated instance of qwen2-vl-7b's group of 7
            ("decode_gqa7_bf16_strong", 28, 4, 128, None, bf16, "strong"),
            ("decode_walk_gqa_bf16_strong", 16, 4, WALK_DK, WALK_DV, bf16,
             "strong"),
            ("decode_walk_f32", 16, 16, WALK_DK, WALK_DV, f32, "trained")):
        b = SLOTS
        s, p, q, k, v, ld = _gla_decode_case(
            torch, gen, b, h, hkv, d, dtype, regime, dv)
        body = _recurrent_decode_body(s, p, q, k, v, ld)[0]
        expect = "stream" if dv is None else "walk"
        if body != expect:
            raise AssertionError(f"gla {label}: decode body {body}, not "
                                 f"{expect}")
        want_s, want_p = _gla_decode_state(torch, s, p, k, v, ld)
        s_k, p_k = s.clone(), p.clone()
        ptrs = (s_k.data_ptr(), p_k.data_ptr())
        o_k = df.gla_decode_fused_cuda(s_k, p_k, q, k, v, ld, 1.0, 1.0)
        if label == "decode_main_bf16":
            s_2, p_2 = s.clone(), p.clone()
            o_2 = df.gla_decode_fused_cuda(s_2, p_2, q, k, v, ld, 1.0, 1.0)
        torch.cuda.synchronize()
        o_t = df.gla_decode_fused_torch(s, p, q, k, v, ld, 1.0, 1.0)
        log(f"[kernel] gla {label}: B={b} H={h} Hkv={hkv} Dk={d} "
            f"Dv={v.shape[-1]} {dtype}, log decay {regime}, body {body} "
            f"(C plan export)")
        if (s_k.data_ptr(), p_k.data_ptr()) != ptrs:
            raise AssertionError(f"{label}: state was reallocated")
        # the f32 state as the elementwise update leaves it, bit for bit
        # (in bf16 the plain version's own: k_i v_j is exact in f32)
        for name, got, want in (("s", s_k, want_s), ("p", p_k, want_p)):
            if not torch.equal(got, want):
                raise AssertionError(
                    f"gla {label} {name}: not the elementwise update's "
                    f"bits ({int((got != want).sum())} elements differ)")
        plain_bits = [name for name, got, want in (("s", s_k, s),
                                                   ("p", p_k, p))
                      if torch.equal(got, want)]
        log(f"  gla {label} s, p: the elementwise fmaf update's bits; "
            f"bit-equal to the plain version: {plain_bits}")
        check_close(f"gla {label} s (in place)", s_k, s, F32_REL)
        check_close(f"gla {label} p (in place)", p_k, p, F32_REL)
        if label == "decode_main_bf16":
            if not (torch.equal(o_k, o_2) and torch.equal(s_k, s_2)
                    and torch.equal(p_k, p_2)):
                raise AssertionError(f"gla {label}: two launches give "
                                     f"different o, s or p")
            log(f"  gla {label} o, s, p: two launches bit-equal")
            del s_2, p_2, o_2
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
            ("gqa_bf16_strong", 1000, 4, bf16, "strong"),
            # G = 8: gla_bwd_kv's body split over slices of the group
            ("gqa8_split_bf16_strong", 1000, 2, bf16, "strong")):
        b, h, d = m["b"], m["h"], m["d"]
        q, k, v, ld, om_hat, h_vec = _gla_case(torch, gen, b, h, hkv, n, d,
                                               dtype, regime)
        log(f"[kernel] gla {label}: B={b} H={h} Hkv={hkv} N={n} D={d} "
            f"{dtype}, log decay {regime}")
        rel = BF16_REL if dtype == bf16 else SEQ_F32_REL
        expect = "wgmma" if dtype == bf16 else "walk"
        bodies = {e: _gla_body(e, q, k, v, ld, om_hat, h_vec)[0]
                  for e in ("gla_fwd", "gla_bwd_q", "gla_bwd_kv")}
        if set(bodies.values()) != {expect}:
            raise AssertionError(f"gla {label}: bodies {bodies}, not "
                                 f"{expect}")
        log(f"  gla {label} bodies (C plan exports): {bodies}")
        o_k, g_k = gla.gla_fwd_cuda(q, k, v, ld, 1.0, 1.0)
        dq_k = gla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, 1.0)
        dk_k, dva_k = gla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0,
                                          1.0)
        split = _kv_split(q, k, v, om_hat, h_vec, ld)
        if (split["slices"] > 1) != (label == "gqa8_split_bf16_strong"):
            raise AssertionError(f"gla {label}: gla_bwd_kv split {split}")
        if split["slices"] > 1:
            again = gla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0, 1.0)
            torch.cuda.synchronize()
            if not (torch.equal(dk_k, again[0])
                    and torch.equal(dva_k, again[1])):
                raise AssertionError(f"gla {label}: two split launches of "
                                     f"gla_bwd_kv give different dk or dV'")
            log(f"  gla {label} dk, dV': two split launches bit-equal "
                f"({split})")
            del again
        if label == "main_bf16":
            again = (*gla.gla_fwd_cuda(q, k, v, ld, 1.0, 1.0),
                     gla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, 1.0),
                     *gla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0,
                                          1.0))
            torch.cuda.synchronize()
            for name, x, y in zip(("o", "g", "dq", "dk", "dV'"),
                                  (o_k, g_k, dq_k, dk_k, dva_k), again):
                if not torch.equal(x, y):
                    raise AssertionError(f"gla main_bf16: two launches give "
                                         f"different {name}")
            log(f"  gla {label} o, g, dq, dk, dV': two launches bit-equal "
                f"({bodies})")
            del again
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
        # dld against a float64 backward, the kernel's and the plain
        # version's each on its own: the two f32 paths round the long
        # sums in different orders, and their difference sums both errors
        dld_64 = _gla_dld_f64(torch, q, k, v, ld, om_hat, h_vec)
        e["dld"] = check_close(f"gla {label} dld (vs float64)", dld_k,
                               dld_64, DLD_REL)
        check_close(f"gla {label} plain dld (vs float64)", dld_t, dld_64,
                    DLD_REL)
        for name, t in (("o", o_k), ("dq", dq_k), ("dk", dk_k),
                        ("dv", dv_k)):
            if t.dtype != dtype or not torch.isfinite(t).all():
                raise AssertionError(f"gla {label} {name}: dtype {t.dtype} "
                                     f"or non-finite values")
        if not torch.isfinite(dld_k).all():
            raise AssertionError(f"gla {label}: non-finite dld")
        errs[label] = e
        del q, k, v, ld, om_hat, h_vec, o_k, g_k, dq_k, dk_k, dva_k, o_t, \
            g_t, dq_t, dk_t, dva_t, dv_k, dld_k, dv_t, dld_t, dld_64
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

    # log_decay = 0 in bf16: the gated wgmma bodies against the linear
    # ones (every decay factor is 1; the gated bodies send A, S's copy and
    # the update's operands as hi + lo pairs where the linear forward
    # rounds once), o, dq, dk and dv within one bf16 step, g within the f32
    # walk's limit, and dV' against the plain version at log_decay = 0
    q, k, v, _, om_hat, h_vec = _gla_case(torch, gen, b, h, hkv, n, d, bf16,
                                          "trained")
    bodies = {e: _gla_body(e, q, k, v, zero, om_hat, h_vec)[0]
              for e in ("gla_fwd", "gla_bwd_q", "gla_bwd_kv")}
    if set(bodies.values()) != {"wgmma"}:
        raise AssertionError(f"gla ld0 bf16: bodies {bodies}, not wgmma")
    o_g, g_g = gla.gla_fwd_cuda(q, k, v, zero, 1.0, 1.0)
    o_l, g_l = la.la_fwd_cuda(q, k, v, 1.0, 1.0)
    dq_g = gla.gla_bwd_q_cuda(k, v, zero, om_hat, h_vec, 1.0)
    dq_l = la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)
    dk_g, dva_g = gla.gla_bwd_kv_cuda(q, k, v, zero, om_hat, h_vec, 1.0,
                                      1.0)
    dk_l, dv_l = la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 1.0)
    torch.cuda.synchronize()
    _, dva_t = gla.gla_bwd_kv_torch(q, k, v, zero, om_hat, h_vec, 1.0, 1.0)
    pairs = [("o", o_g, o_l, BF16_REL), ("g", g_g, g_l, SEQ_F32_REL),
             ("dq", dq_g, dq_l, BF16_REL),
             ("dk", dk_g, dk_l, BF16_REL),
             ("dv", dva_g[..., :d], dv_l, BF16_REL),
             ("dV' (plain)", dva_g, dva_t, SEQ_F32_REL)]
    ld0_bf16 = {name: check_close(f"gla bf16 at log_decay = 0 vs linear "
                                  f"body, {name}", got, want, rel)
                for name, got, want, rel in pairs}
    same = [name for name, got, want, _ in pairs[:5]
            if torch.equal(got.to(want.dtype), want)]
    log(f"  bf16 log_decay = 0 ({bodies}): bit-identical to the linear "
        f"bodies: {same}")
    errs["ld0_bf16_vs_linear"] = ld0_bf16
    del q, k, v, om_hat, h_vec, pairs, dva_t, dq_g, dq_l
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


def _c_body(body, launch):
    """(body, launch, the launcher's C plan export) for the body the
    wrapper's module names and its plan (grid, threads and shared memory
    of the very launch), raising where the export is not that plan."""
    from repro_torch.check import bounds
    got = bounds.c_plan(launch)
    if got[:5] != launch.grid + (launch.threads, launch.smem):
        raise AssertionError(f"{launch.name}: the launcher's plan {got} is "
                             f"not the {body} body's {launch}")
    return body, launch, got


def _ssd_body(entry, q, k, v, ld, om=None):
    """The body an SSD entry runs for these operands, held to its
    launcher's C export: "wgmma" or "walk"."""
    from repro_torch.kernels import ssd
    body = ssd.ssd_body(entry, q.dtype, q.shape[-1], v.shape[-1])
    launch = {"ssd_fwd": lambda: ssd.plan_ssd_fwd(q, k, v, ld),
              "ssd_bwd_q": lambda: ssd.plan_ssd_bwd_q(k, v, ld, om),
              "ssd_bwd_kv": lambda: ssd.plan_ssd_bwd_kv(q, k, v, ld, om)
              }[entry]()
    return _c_body(body, launch)


def _la_fwd_body(q, k, v):
    """The la_fwd body these operands run, held to its launcher's C
    export: "wgmma" or "walk"."""
    from repro_torch.kernels import linear_attention as la
    return _c_body(la.la_fwd_body(q.dtype, q.shape[-1]),
                   la.plan_la_fwd(q, k, v, 1.0, 1.0))


def _kv_split(q, k, v, om_hat, h_vec, ld=None):
    """How la_bwd_kv (gla_bwd_kv with `ld`) spreads the query group over
    blocks, from its launcher's C plan export: the slices S (grid z) and
    the query heads of the largest slice; the slices' f32 partials are
    summed in a fixed order by a second kernel, so the blocks form no
    thread-block cluster (size 1)."""
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    launch = (la.plan_la_bwd_kv(q, k, v, om_hat, h_vec, 1.0, 1.0)
              if ld is None
              else gla.plan_gla_bwd_kv(q, k, v, ld, om_hat, h_vec, 1.0, 1.0))
    _, _, c_geo = _c_body("split", launch)
    slices, group = c_geo[2], q.shape[1] // k.shape[1]
    return {"slices": slices, "heads_per_slice": -(-group // slices),
            "cluster": 1, "grid": list(c_geo[:3])}


def _la_bwd_body(entry, q, k, v, om_hat, h_vec):
    """The body la_bwd_q or la_bwd_kv runs for these operands, held to
    its launcher's C export: "wgmma" or "walk"."""
    from repro_torch.kernels import linear_attention as la
    launch = (la.plan_la_bwd_q(k, v, om_hat, h_vec, 1.0)
              if entry == "la_bwd_q"
              else la.plan_la_bwd_kv(q, k, v, om_hat, h_vec, 1.0, 1.0))
    return _c_body(la.la_bwd_body(entry, q.dtype, q.shape[-1]), launch)


def phase_kernel_ssd(torch):
    """ssd_fwd, ssd_bwd_q and ssd_bwd_kv against their plain versions at
    mamba2-2.7b's training shapes, odd N and G > 1, and at zamba2-7b's
    (H = 112, (Dk, Dv) = (64, 64)), bf16 and f32, under both decay
    regimes: o, the f32 partials of dq and dk, dv, and after the PyTorch
    epilogue (the group sums and dld, from each path's partials and the
    same o) dq, dk, dv and dld; at log_decay = 0 the forward against
    unnormalized causal linear attention, in f32 and bf16.  Every bf16
    case runs the chunked wgmma bodies of all three kernels at (128, 64)
    and ssd_fwd's at (64, 64), every f32 case and the backward's bf16 at
    (64, 64) the token walk (from the launchers' C plan exports); the
    bf16 main case launches each twice for bit-equal o, dq partials, dk
    partials and dv, and zamba2's bf16 case ssd_fwd twice for bit-equal
    o."""
    from repro_torch.core import ssd as core_ssd
    from repro_torch.kernels import ssd
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    bf16, f32 = torch.bfloat16, torch.float32
    m, z = SSD_SHAPE, SSD_ZAMBA2_SHAPE
    dk, dv = m["dk"], m["dv"]
    errs = {}
    for label, n, g, h, dtype, regime, dims in (
            ("main_bf16", m["n"], m["g"], m["h"], bf16, "init", (dk, dv)),
            ("main_bf16_strong", m["n"], m["g"], m["h"], bf16, "strong",
             (dk, dv)),
            ("main_f32_strong", m["n"], m["g"], m["h"], f32, "strong",
             (dk, dv)),
            ("odd_n_bf16_strong", 1000, m["g"], m["h"], bf16, "strong",
             (dk, dv)),
            ("groups_f32", 1000, 4, 16, f32, "init", (dk, dv)),
            ("groups_bf16_strong", 1000, 4, 16, bf16, "strong", (dk, dv)),
            # zamba2-7b's Mamba-2 layers, (64, 64): ssd_fwd's chunked
            # body in bf16, the backward's token walks
            ("zamba2_bf16", z["n"], z["g"], z["h"], bf16, "init",
             (z["dk"], z["dv"])),
            ("zamba2_f32_strong", z["n"], z["g"], z["h"], f32, "strong",
             (z["dk"], z["dv"])),
            ("zamba2_groups_bf16_strong", 1000, 4, 16, bf16, "strong",
             (z["dk"], z["dv"]))):
        b = m["b"]
        q, k, v, ld, om = _ssd_case(torch, gen, b, g, h, n, *dims, dtype,
                                    regime)
        log(f"[kernel] ssd {label}: B={b} G={g} H={h} N={n} Dk={dims[0]} "
            f"Dv={dims[1]} {dtype}, log decay {regime}")
        rel = BF16_REL if dtype == bf16 else SEQ_F32_REL
        for entry in ("ssd_fwd", "ssd_bwd_q", "ssd_bwd_kv"):
            body, _, _ = _ssd_body(entry, q, k, v, ld, om)
            wgmma = dims == (dk, dv) or (entry == "ssd_fwd"
                                         and dims == (z["dk"], z["dv"]))
            if body != ("wgmma" if dtype == bf16 and wgmma else "walk"):
                raise AssertionError(f"ssd {label}: {entry} runs the {body} "
                                     f"body")
        o_k = ssd.ssd_fwd_cuda(q, k, v, ld)
        if label in ("main_bf16", "zamba2_bf16"):
            again = ssd.ssd_fwd_cuda(q, k, v, ld)
            torch.cuda.synchronize()
            if not torch.equal(o_k, again):
                raise AssertionError(f"ssd {label}: two launches of "
                                     f"ssd_fwd differ")
            log(f"  ssd {label} o: two launches bit-equal (wgmma body)")
            del again
        dq_pk = ssd.ssd_bwd_q_cuda(k, v, ld, om)
        if label == "main_bf16":
            dq_again = ssd.ssd_bwd_q_cuda(k, v, ld, om)
            torch.cuda.synchronize()
            if not torch.equal(dq_pk, dq_again):
                raise AssertionError("ssd main_bf16: two launches of "
                                     "ssd_bwd_q differ")
            log(f"  ssd {label} dq partials: two launches bit-equal "
                f"(wgmma body)")
            del dq_again
        dk_pk, dv_k = ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
        if label == "main_bf16":
            dk_again, dv_again = ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
            torch.cuda.synchronize()
            if not (torch.equal(dk_pk, dk_again)
                    and torch.equal(dv_k, dv_again)):
                raise AssertionError("ssd main_bf16: two launches of "
                                     "ssd_bwd_kv differ")
            log(f"  ssd {label} dk partials, dv: two launches bit-equal "
                f"(wgmma body)")
            del dk_again, dv_again
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
    # reference's tests/test_kernels_ssd.py checks its kernel so), through
    # the token walk (f32) and the chunked body (bf16)
    b, g, h, n = m["b"], 1, m["h"], 1000
    for label, dtype, rel in (("ld0_vs_linear", f32, SEQ_F32_REL),
                              ("ld0_vs_linear_bf16", bf16, BF16_REL)):
        q, k, v, _, _ = _ssd_case(torch, gen, b, g, h, n, dk, dv, dtype,
                                  "init")
        o_k = ssd.ssd_fwd_cuda(q, k, v,
                               torch.zeros((b, h, n), device="cuda"))
        scores = torch.einsum("bgid,bgjd->bgij", q.float(),
                              k.float()).tril()
        o_la = torch.einsum("bgij,bghjd->bghid", scores,
                            v.float().reshape(b, g, h // g, n, dv)
                            ).reshape(b, h, n, dv)
        errs[label] = check_close(
            f"ssd at log_decay = 0 vs unnormalized causal linear attention "
            f"({dtype})", o_k, o_la, rel)
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
    mamba2-2.7b for "mamba2"); returns (record, the run's launches, rid
    -> generated tokens)."""
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
    tokens_of = {rid: list(engine.request(rid).generated)
                 for rid in range(SLOTS)}
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
    return record, launches, tokens_of


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
    returns (record, the fused run's launches, the unfused run's, rid ->
    the fused run's generated tokens)."""
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
    tokens_of = {rid: list(engine.request(rid).generated)
                 for rid in range(PAGED_REQUESTS)}

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
    return record, launches, launches_unfused, tokens_of


def phase_serve_gla_paged(torch, np):
    """The GLA backend served from a paged state arena at full width;
    returns (record, the run's launches, rid -> generated tokens)."""
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
    tokens_of = {rid: list(engine.request(rid).generated)
                 for rid in range(PAGED_REQUESTS)}

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
    return record, launches, tokens_of


def _paged_prompts(np, vocab):
    """The 16 prompts of phase_serve_paged and phase_serve_gla_paged."""
    rng = np.random.default_rng(0)
    lens = rng.integers(PAGED_PROMPT_LENS[0], PAGED_PROMPT_LENS[1] + 1,
                        size=PAGED_REQUESTS)
    return [rng.integers(3, vocab, size=int(n)).tolist() for n in lens]


def _layer_rows(torch, engine, pages, pos):
    """One request's own rows of every layer's paged arena, copied: its
    first `pos` KV rows (k, v as (Hkv, pos, hd)) or its state page (s,
    p)."""
    idx = torch.tensor(pages, dtype=torch.long, device="cuda")
    out = []
    for layer in engine.cache["blocks"]:
        if hasattr(layer, "k_pages"):
            out.append(tuple(
                t[idx].transpose(0, 1).flatten(1, 2)[:, :pos].clone()
                for t in (layer.k_pages, layer.v_pages)))
        else:
            out.append((layer.s_pages[idx[0]].clone(),
                        layer.p_pages[idx[0]].clone()))
    return out


def _preempt_tracer(torch, engine_ref):
    """A ServeTracer that copies a recompute victim's rows at eviction
    (the pages it held before the step, `tables`) and, once its re-prefill
    has run, holds its new rows against that copy: per layer max |new -
    old| over max |old|, within RECOMPUTE_REL."""
    from repro_torch.obs import ServeTracer

    class Probe(ServeTracer):
        def __init__(self):
            super().__init__()
            self.tables, self.evicted, self.rebuilt = {}, {}, {}

        def request_preempted(self, rid, slot, policy):
            super().request_preempted(rid, slot, policy)
            if policy == "recompute":
                engine = engine_ref[0]
                pos = int(engine.cache["pos"][slot])
                self.evicted[rid] = (pos, _layer_rows(
                    torch, engine, self.tables[rid], pos))

        def before_step(self, engine):
            self.tables = {r.rid: engine.pool.table(r.rid)
                           for _, r in engine.scheduler.active()
                           if engine.pool.holds(r.rid)}

        def after_step(self, engine, label):
            """Compare each victim whose re-prefill just completed (its
            final window runs after the step's decode, so no decode step
            has touched its rows yet)."""
            for slot, req in engine.scheduler.active():
                rid = req.rid
                if rid not in self.evicted or rid in self.rebuilt \
                        or req.state.value != "decoding":
                    continue
                pos, old = self.evicted[rid]
                if int(engine.cache["pos"][slot]) != pos:
                    raise AssertionError(f"{label} rid {rid}: position "
                                         f"{int(engine.cache['pos'][slot])}"
                                         f" after the re-prefill, {pos} at "
                                         f"eviction")
                new = _layer_rows(torch, engine, engine.pool.table(rid), pos)
                errs = []
                for layer, (a_new, a_old) in enumerate(zip(new, old)):
                    for name, x, y in zip("ab", a_new, a_old):
                        err, scale = rel_err(x, y)
                        errs.append(err / scale)
                        if not err <= RECOMPUTE_REL * scale:
                            raise AssertionError(
                                f"{label} rid {rid} layer {layer} "
                                f"{name}: re-prefill differs from the "
                                f"eviction copy by {err} > "
                                f"{RECOMPUTE_REL} * {scale}")
                self.rebuilt[rid] = {"positions": pos,
                                     "max_rel_err_per_layer": errs}

    return Probe()


def _preempt_run(torch, label, make_engine, background, urgent, priority,
                 want):
    """Serve `background` (rid -> prompt, priority 0, MAX_NEW new each)
    on a traced engine and, once every request that holds a slot decodes
    and has emitted URGENT_AFTER tokens, submit `urgent` (rid -> prompt,
    URGENT_NEW new each) at `priority`; drain.  `want`: the kernels the
    run must launch ("decode": name, "flash": whether every prefill
    window runs flash_fwd).  Returns (engine, tracer, finish order, wall
    s, launches)."""
    from repro_torch.serve.engine import Request

    engine_ref = [None]
    tracer = _preempt_tracer(torch, engine_ref)
    engine = engine_ref[0] = make_engine(tracer)
    free0 = None if engine.pool is None else engine.pool.free_pages
    for rid, prompt in background.items():
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    reset_launches()
    t0 = time.perf_counter()
    order, arrived = [], False
    while engine.scheduler.has_work():
        held = [r for _, r in engine.scheduler.active()]
        if not arrived and held and all(
                r.state.value == "decoding"
                and len(r.generated) >= URGENT_AFTER for r in held):
            for rid, prompt in urgent.items():
                engine.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=URGENT_NEW,
                                      priority=priority))
            arrived = True
        if engine.pool is not None:
            tracer.before_step(engine)
        order += [o.rid for o in engine.step() if o.finished]
        tracer.after_step(engine, label)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if urgent and not arrived:
        raise AssertionError(f"{label}: the urgent requests never arrived")
    layers = engine.cfg.num_layers
    windows = sum(len(r.prefill_windows) for r in tracer.records())
    expect = {want["decode"]: layers * engine.decode_steps}
    if want.get("flash"):
        expect["flash_fwd"] = layers * windows
    expect_launches(label, launches, expect)
    for rid in list(background) + list(urgent):
        n = URGENT_NEW if rid in urgent else MAX_NEW
        toks = engine.request(rid).generated
        if len(toks) != n or not all(0 <= t < engine.cfg.vocab_size
                                     for t in toks):
            raise AssertionError(f"{label} request {rid} generated {toks}")
    if engine.pool is not None and engine.pool.free_pages != free0:
        raise AssertionError(f"{label}: {engine.pool.free_pages} free pages "
                             f"after the drain, {free0} before")
    if engine._suspended or engine._jobs:
        raise AssertionError(f"{label}: left suspended or mid-prefill")
    return engine, tracer, order, wall, launches


def _slot_copy_times(torch, engine):
    """Device ms of one `snapshot_slot` and one `restore_slot` of slot 0
    of the engine's cache (drained), by CUDA graph replays in turns, and
    the bytes a snapshot copies."""
    from repro_torch.serve.cache import restore_slot, slot_leaves, \
        snapshot_slot
    rows = slot_leaves(engine.cfg, engine.max_len)
    snap = snapshot_slot(engine.cache, rows, 0)
    snap_ms, restore_ms = _graph_time_pair(
        torch, lambda: snapshot_slot(engine.cache, rows, 0),
        lambda: restore_slot(engine.cache, snap, rows, 0), launches=20)
    return {"bytes": sum(t.numel() * t.element_size() for t in snap),
            "tensors": len(snap), "snapshot_ms": min(snap_ms),
            "snapshot_ms_runs": snap_ms, "restore_ms": min(restore_ms),
            "restore_ms_runs": restore_ms,
            "timed_by": "CUDA graph replays of 20, in turns"}


def phase_serve_preempt(torch, np, baselines, smi):
    """Priority preemption at full width, one run per eviction policy
    (the module docstring's phase 4b); returns (record, the launches of
    every run)."""
    from repro_torch.models import model as mdl
    from repro_torch.serve.cache import page_bytes, state_page_bytes
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.paging import PagedAdmission

    vocab = _config("linear").vocab_size
    contiguous = {rid: p.tolist() for rid, p in enumerate(
        np.random.default_rng(0).integers(3, vocab, size=(SLOTS,
                                                          PROMPT_LEN)))}
    paged = dict(enumerate(_paged_prompts(np, vocab)))
    urgent = {100 + i: p.tolist() for i, p in enumerate(
        np.random.default_rng(1).integers(3, vocab,
                                          size=(2, URGENT_PROMPT)))}
    record, all_launches = {"card": smi}, []

    def policies(tracer):
        return [p for r in tracer.records() for _, _, p in r.preempt_events]

    def victims(tracer):
        return [r.rid for r in tracer.records() if r.preempt_events]

    def check(label, engine, tracer, order, want_policies, urgent_rids):
        got = policies(tracer)
        if got != want_policies or engine.preemption_count != len(got):
            raise AssertionError(f"{label}: policies {got}, "
                                 f"preemption_count "
                                 f"{engine.preemption_count}; want "
                                 f"{want_policies}")
        for u in urgent_rids:
            for v in victims(tracer):
                if order.index(u) > order.index(v):
                    raise AssertionError(f"{label}: urgent {u} finished "
                                         f"after victim {v} ({order})")

    def same_tokens(engine, rids, baseline):
        return [rid for rid in rids
                if engine.request(rid).generated == baseline[rid]]

    def ttft(tracer, rids):
        recs = {r.rid: r for r in tracer.records()}
        return [recs[rid].ttft_s for rid in rids]

    def run(label, make_engine, background, want_policies, want, baseline,
            identical, urgent_in=urgent):
        torch.cuda.reset_peak_memory_stats()
        engine, tracer, order, wall, launches = _preempt_run(
            torch, label, make_engine, background, urgent_in, URGENT_PRIORITY,
            want)
        all_launches.append(launches)
        check(label, engine, tracer, order, want_policies, urgent_in)
        vic = victims(tracer)
        same = same_tokens(engine, background, baseline)
        if identical and same != list(background):
            raise AssertionError(
                f"{label}: tokens of {sorted(set(background) - set(same))} "
                f"differ from the uninterrupted run's (victims {vic})")
        recs = {r.rid: r for r in tracer.records()}
        rec = {"policies": policies(tracer), "victims": vic,
               "finish_order": order, "wall_s": wall,
               "decode_steps": engine.decode_steps,
               "kernel_launches": launches,
               "victims_tokens_equal_uninterrupted": len(
                   [r for r in vic if r in same]),
               "background_tokens_equal_uninterrupted": len(same),
               "urgent_ttft_s": ttft(tracer, urgent_in),
               "victim_preempted_s": {r: recs[r].preempted_s for r in vic},
               "rebuilt": tracer.rebuilt,
               "max_memory_allocated_bytes":
                   torch.cuda.max_memory_allocated()}
        if set(tracer.rebuilt) != set(tracer.evicted):
            raise AssertionError(f"{label}: re-prefills compared "
                                 f"{sorted(tracer.rebuilt)} of "
                                 f"{sorted(tracer.evicted)}")
        if "recompute" in rec["policies"]:
            # the resume's cost: the victims' re-prefill windows (host
            # clock around windows that end in a synchronize)
            rec["reprefill_s"] = {
                r: sum(w1 - w0 for w0, w1, _ in recs[r].prefill_windows
                       if w0 >= recs[r].resume_events[0][0]) for r in vic}
        else:
            rec["slot_copy"] = _slot_copy_times(torch, engine)
        log(f"[serve preempt {label}] {rec} ({smi})")
        return engine, tracer, rec

    def contiguous_engine(cfg, params):
        return lambda tracer: Engine(
            cfg, params, max_slots=SLOTS, max_len=MAX_LEN,
            prefill_chunk=PREFILL_CHUNK, eos_id=-1, tracer=tracer,
            device="cuda")

    def paged_engine(cfg, params, budget, slots):
        policy = PagedAdmission(budget, page_size=PAGE_SIZE,
                                max_slots=slots)
        return lambda tracer: Engine(
            cfg, params, max_len=MAX_LEN, policy=policy,
            prefill_chunk=PREFILL_CHUNK, eos_id=-1, tracer=tracer,
            device="cuda")

    # linear: snapshot; the same traffic with the urgent requests at
    # priority 0 (FIFO, no preemption) for their queued TTFT
    cfg = _config("linear")
    params = mdl.init_params(cfg, seed=0, device="cuda")
    engine, tracer, rec = run("linear", contiguous_engine(cfg, params),
                              contiguous, ["snapshot"] * 2,
                              {"decode": "la_decode_fused"},
                              baselines["linear"], identical=True)
    rec["summary"] = tracer.summary()
    log(f"[serve preempt linear] traced summary {rec['summary']}; "
        f"preempted_s {rec['victim_preempted_s']} ({smi})")
    del engine
    engine, fifo_tr, order, _, launches = _preempt_run(
        torch, "linear fifo", contiguous_engine(cfg, params), contiguous,
        urgent, 0, {"decode": "la_decode_fused"})
    all_launches.append(launches)
    if engine.preemption_count:
        raise AssertionError(f"fifo: {engine.preemption_count} preemptions")
    rec["urgent_ttft_fifo_s"] = ttft(fifo_tr, urgent)
    log(f"[serve preempt linear] urgent TTFT {rec['urgent_ttft_s']} s "
        f"(priority {URGENT_PRIORITY}, preempting) against "
        f"{rec['urgent_ttft_fifo_s']} s queued FIFO at priority 0 ({smi})")
    record["linear"] = rec
    del engine, params
    torch.cuda.empty_cache()

    # softmax: snapshot (contiguous), recompute (paged KV, its first 8
    # prompts)
    cfg = _config("softmax")
    params = mdl.init_params(cfg, seed=0, device="cuda")
    engine, _, record["softmax"] = run(
        "softmax", contiguous_engine(cfg, params), contiguous,
        ["snapshot"] * 2, {"decode": "softmax_decode_fused", "flash": True},
        baselines["softmax"], identical=True)
    del engine
    engine, _, record["softmax_paged"] = run(
        "softmax_paged",
        paged_engine(cfg, params, PAGED_PAGES * page_bytes(cfg, PAGE_SIZE),
                     SLOTS),
        {rid: paged[rid] for rid in range(SLOTS)}, ["recompute"] * 2,
        {"decode": "paged_decode_fused", "flash": True},
        baselines["softmax_paged"], identical=False)
    del engine, params
    torch.cuda.empty_cache()

    # gla: page_keep (slots block, pages do not; its uninterrupted run is
    # the same engine without the urgent requests), recompute (pages
    # block: phase_serve_gla_paged's engine, 1 urgent request)
    cfg = _config("gla")
    params = mdl.init_params(cfg, seed=0, device="cuda")
    keep = paged_engine(cfg, params, KEEP_PAGES * state_page_bytes(cfg),
                        KEEP_SLOTS)
    background = {rid: paged[rid] for rid in range(KEEP_SLOTS)}
    engine, _, _, _, launches = _preempt_run(
        torch, "gla_page_keep uninterrupted", keep, background, {}, 0,
        {"decode": "gla_decode_fused"})
    all_launches.append(launches)
    uninterrupted = {rid: list(engine.request(rid).generated)
                     for rid in background}
    del engine
    engine, _, record["gla_page_keep"] = run(
        "gla_page_keep", keep, background, ["page_keep"] * 2,
        {"decode": "gla_decode_fused"}, uninterrupted, identical=True)
    del engine
    engine, _, record["gla_page_blocked"] = run(
        "gla_page_blocked",
        paged_engine(cfg, params, GLA_PAGED_PAGES * state_page_bytes(cfg),
                     SLOTS),
        background, ["recompute"], {"decode": "gla_decode_fused"},
        baselines["gla_paged"], identical=False,
        urgent_in={100: urgent[100]})
    del engine, params
    torch.cuda.empty_cache()
    return record, all_launches


def phase_smoke_reference(torch, arch="pythia-1.4b"):
    """The smoke config of `arch` on the card (kernel path) against the
    same weights on the CPU (plain path): prefill + 4 decode steps (under
    M-RoPE the prompt a (1, 3, 3) image then text; the encoder-decoder's
    prefill with stub frames); for mamba2 also the loss and every grad
    (the SSD kernels at their smoke instantiation, Dk = 16, Dv = 32)."""
    from repro_torch.models.frontends import audio_frames_stub, \
        vision_positions_stub
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
    extra = {}
    if cfg.rope_kind == "mrope":
        extra["positions"] = vision_positions_stub(3, 13, (1, 3, 3))
    if cfg.family == "encdec":
        extra["frames"] = audio_frames_stub(gen, 3, cfg.encoder_seq,
                                            cfg.d_model)
    errs = []
    runs = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        cache = mdl.init_cache(cfg, 3, 32, dev)
        lg, cache = mdl.prefill(params, cfg,
                                {"tokens": tokens[:, :13].to(dev),
                                 **{k: v.to(dev) for k, v in extra.items()}},
                                cache)
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
        if not torch.isfinite(gk).all() or not err <= TRAIN_GRAD_REL * scale:
            raise AssertionError(f"grad {path}: max abs err {err} > "
                                 f"{TRAIN_GRAD_REL} * {scale}")
    worst = max(grad_errs, key=grad_errs.get)
    log(f"  {len(named)} grads within {TRAIN_GRAD_REL} of their max "
        f"|value|; worst {worst} at {grad_errs[worst]!r}")
    return {"loss_cuda": float(loss_k), "loss_torch": float(loss_t),
            "loss_abs_err": loss_err, "grads_compared": len(named),
            "grad_rel_err_max": grad_errs[worst], "grad_rel_err_worst":
            worst, "grad_rel_err": grad_errs}


def _param_kind(path: str) -> str:
    """A leaf's path without its layer and group indices
    ("blocks.mixer.a_log", "mamba_groups.mixer.a_log")."""
    return ".".join(p for p in path.split(".") if not p.isdigit())


def _within(err, limit):
    """(err <= limit, err / limit): the verdict and the share of the
    limit used (inf where the limit is 0 and err is not)."""
    ratio = err / limit if limit > 0 else (0.0 if err == 0 else math.inf)
    return err <= limit, ratio


def _train_legs(torch, mdl, cfg, params, batch, variants,
                bf16_per_leaf=False, host_grads=False):
    """The first step's loss and EVERY grad of each variant against the
    plain path, from the same weights and batch, in two legs.

    `variants` maps a name to a function of a config (the leg's compute
    dtype) that returns the config to run.  In the config's bf16 compute
    the grads at init are at the level of the rounding noise itself: a
    second plain run with half the scan chunk, which differs from the
    first only in summation order, differs by up to 2x the max |value| of
    a leaf (mamba2) and, in GLA, moves the deep q projections' grads by
    5-8 % of theirs (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  So there the
    loss is held to TRAIN_LOSS_REL and each kind of leaf, in norm over its
    layers, to GATE_NOISE_FACTOR times that plain spread.  With
    `bf16_per_leaf` (grads well above that noise, as the dense stacks'
    are) every grad is held instead to TRAIN_GRAD_REL of its max |value|,
    the pythia runs' limit, and the spread's verdict is only recorded.  In
    f32 compute the rounding is 2^16 times finer: there the loss is held
    to SEQ_F32_REL and every grad to TRAIN_GRAD_REL of its max |value|.
    At most three grad sets are alive at once; with `host_grads` each set
    goes to the host as soon as its run ends (a model whose params and
    one set of grads fill most of the card), and each pair of leaves comes
    back to the card for its comparison.

    Returns {variant: {"bf16": leg, "f32": leg}}, each leg {"ok", "worst",
    "ratio" (its share of the limit), "loss", "loss_ref", "loss_abs_err",
    "kinds": per kind of leaf the norm of the differences, its share of
    the reference's norm, the largest per-leaf max abs err over max
    |value| and that leaf}; the bf16 leg also the plain spread per kind,
    its "criterion" and, held per leaf, the spread's "spread_verdict"."""
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
        if host_grads:
            grads = [g.cpu() for g in grads]
            torch.cuda.empty_cache()
        return loss.detach(), grads

    def dev(t):
        return t.to("cuda") if host_grads else t

    def against(grads, ref):
        """Per leaf max abs err over max |value|; per kind of leaf the
        norm of the differences and its share of the reference's norm."""
        rel, sq_diff, sq_ref = [], [], []
        for g, r in zip(grads, ref):
            g, r = dev(g), dev(r)
            e, sc = rel_err(g, r)
            rel.append(e / sc)
            sq_diff.append(float(((g.float() - r.float()) ** 2).sum()))
            sq_ref.append(float((r.float() ** 2).sum()))
        norms = {}
        for kind, idx in kinds.items():
            d = math.sqrt(sum(sq_diff[i] for i in idx))
            r = math.sqrt(sum(sq_ref[i] for i in idx))
            norms[kind] = {"norm_diff": d, "norm_rel": d / max(r, 1e-30),
                           "max_rel": max(rel[i] for i in idx),
                           "worst": named[max(idx, key=rel.__getitem__)][0]}
        return rel, norms

    def leg(loss, loss_ref, loss_rel, checks, kinds_rec):
        """The verdict of one leg: the loss and every (name, err, limit)
        of `checks` within its limit."""
        err, scale = rel_err(loss, loss_ref)
        verdicts = {"loss": _within(err, loss_rel * scale)}
        verdicts.update({name: _within(e, lim) for name, e, lim in checks})
        worst = max(verdicts, key=lambda k: verdicts[k][1])
        return {"ok": all(ok for ok, _ in verdicts.values()),
                "worst": worst, "ratio": verdicts[worst][1],
                "loss": float(loss), "loss_ref": float(loss_ref),
                "loss_abs_err": err, "kinds": kinds_rec}

    out = {name: {} for name in variants}
    # bf16 compute (the config's): held to the plain path's own spread
    loss_t, grads_t = run(_with_impl(cfg, "torch"))
    half = _with_impl(cfg, "torch")
    half = dataclasses.replace(half, la=dataclasses.replace(
        half.la, chunk=half.la.chunk // 2))
    _, grads_2 = run(half)
    _, norm_2 = against(grads_2, grads_t)
    del grads_2
    for name, make in variants.items():
        loss_v, grads_v = run(make(cfg))
        rel_v, norm_v = against(grads_v, grads_t)
        del grads_v
        kinds_rec = {kind: {"vs_torch": norm_v[kind],
                            f"torch_chunk_{half.la.chunk}_vs_torch":
                            norm_2[kind]} for kind in kinds}
        spread = leg(loss_v, loss_t, TRAIN_LOSS_REL,
                     [(kind, norm_v[kind]["norm_diff"],
                       GATE_NOISE_FACTOR * norm_2[kind]["norm_diff"])
                      for kind in kinds], kinds_rec)
        if bf16_per_leaf:
            held = leg(loss_v, loss_t, TRAIN_LOSS_REL,
                       [(named[i][0], rel_v[i], TRAIN_GRAD_REL)
                        for i in range(len(named))], kinds_rec)
            held.update(criterion="per_leaf", spread_verdict={
                k: spread[k] for k in ("ok", "worst", "ratio")})
        else:
            held = dict(spread, criterion="spread")
        out[name]["bf16"] = held
    del grads_t

    # f32 compute: every grad to the pythia runs' limit
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    loss_t, grads_t = run(_with_impl(f32, "torch"))
    for name, make in variants.items():
        loss_v, grads_v = run(make(f32))
        rel_v, norm_v = against(grads_v, grads_t)
        del grads_v
        out[name]["f32"] = leg(
            loss_v, loss_t, SEQ_F32_REL,
            [(named[i][0], rel_v[i], TRAIN_GRAD_REL)
             for i in range(len(named))], norm_v)
    del grads_t
    for t in ts:
        t.requires_grad_(False)
    return out


def _train_compare_all(torch, mdl, cfg, params, batch,
                       bf16_per_leaf=False, host_grads=False):
    """GLA, mamba2 and the other architectures: the first step's loss and
    EVERY grad, kernel path against plain path, in both legs of
    `_train_legs`; raises where a leg fails."""
    from repro_torch.tree import named_leaves
    rec = {"grads_compared": len(named_leaves(params)),
           **_train_legs(torch, mdl, cfg, params, batch,
                         {"cuda": lambda c: _with_impl(c, "cuda")},
                         bf16_per_leaf, host_grads)["cuda"]}
    per_leaf = (f"{rec['grads_compared']} grads within {TRAIN_GRAD_REL} of "
                f"their max |value|")
    spread = (f"every kind of leaf within {GATE_NOISE_FACTOR} x the plain "
              f"path's spread in norm")
    for name, what in (("bf16", f"{per_leaf if bf16_per_leaf else spread}, "
                                f"the loss within {TRAIN_LOSS_REL}"),
                       ("f32", f"{per_leaf}, the loss within "
                               f"{SEQ_F32_REL}")):
        r = rec[name]
        log(f"  {name} compute (cuda vs torch): loss {r['loss']!r} vs "
            f"{r['loss_ref']!r}; by kind of leaf {r['kinds']}")
        if "spread_verdict" in r:
            log(f"  {name}: against {GATE_NOISE_FACTOR} x the plain path's "
                f"spread in norm (recorded, not held): {r['spread_verdict']}")
        if not r["ok"]:
            raise AssertionError(f"{name} train step 0: {r['worst']} at "
                                 f"{r['ratio']!r} of its limit")
        log(f"  {name}: {what}; worst {r['worst']} at {r['ratio']!r} of "
            f"its limit")
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
    compare = (_train_compare_all if backend in ("gla", "mamba2")
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
# 5a. checkpoint, resume and rollback
# ---------------------------------------------------------------------------

def _state_digests(trainer, ref=None):
    """sha256 of the host copy of every leaf of the Trainer's checkpoint
    tree, as the manifest hashes it (copies on this thread, hashes on the
    store's IO_THREADS); and the host copies, or with `ref` (run A's
    digests and host copies) each leaf's max |difference| from its ref
    where the digests differ (0.0 where they agree)."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.checkpoint import store
    from repro_torch.tree import named_leaves

    def compare(i, arr):
        d = store.digest(arr)
        if ref is None:
            return d, arr
        if d == ref[0][i]:
            return d, 0.0
        return d, float(abs(arr.astype("float64") - ref[1][i]).max())

    with ThreadPoolExecutor(store.IO_THREADS) as ex:
        futures = [ex.submit(compare, i, store.host_copy(x)[0])
                   for i, (_, x) in enumerate(named_leaves(trainer._tree()))]
        out = [f.result() for f in futures]
    return [d for d, _ in out], [e for _, e in out]


def phase_train_resume(torch, np, smi):
    """Full-width pythia-1.4b (linear, f32 params, bf16 compute, remat) on
    a MemmapLM token file of the repo's own text: run A trains 4 steps
    with an async checkpoint at step 2 (written while steps 2-3 update
    the state in place); run B, from another init seed, restores step 2,
    fails once at step 3, rolls back to step 2 and replays to step 4.
    B's params, moments and step must equal A's bit for bit (sha256 of
    each leaf's host copy), its step 2-3 losses A's; if they do not, A
    runs again and B may differ from A by no more than that rerun does."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import MemmapLM
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import model as mdl
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import named_leaves

    cfg = _config("linear")
    layers = cfg.num_layers
    per_step = {"la_fwd": 2 * layers, "la_bwd_q": layers,
                "la_bwd_kv": layers}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        tok = ByteTokenizer()
        ids = []
        for pattern in RESUME_TEXTS:
            for path in sorted(ROOT.glob(pattern)):
                ids += tok.encode(path.read_text(encoding="utf-8"),
                                  eos=True)
        np.asarray(ids, np.int32).tofile(tmp / "tokens.bin")
        data = MemmapLM(str(tmp / "tokens.bin"), TRAIN_SEQ, TRAIN_BATCH)
        tc = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1,
                         checkpoint_every=0,
                         checkpoint_dir=str(tmp / "ckpt"))
        record = {"arch": cfg.name, "tokens": len(ids),
                  "save_step": RESUME_AT, "launches_per_step": per_step}

        def trainer(seed):
            torch.cuda.empty_cache()
            return Trainer(cfg, tc, mdl.init_params(cfg, seed=seed,
                                                    device="cuda"), data)

        def run_a(save=True):
            """Run A: its trainer, launches, snapshot and writer seconds
            (None without the checkpoint)."""
            a = trainer(0)
            if "state_bytes" not in record:
                record["state_bytes"] = sum(
                    x.numel() * x.element_size()
                    if isinstance(x, torch.Tensor) else 8
                    for _, x in named_leaves(a._tree()))
                disk = shutil.disk_usage(tmp)
                record["disk_free_bytes"] = disk.free
                log(f"[train resume] {len(ids)} tokens of {RESUME_TEXTS}; "
                    f"state {record['state_bytes']} B; disk at {tmp}: free "
                    f"{disk.free} of {disk.total} B ({smi})")
                if disk.free < 2 * record["state_bytes"]:
                    raise AssertionError(
                        f"train resume: {disk.free} B free at {tmp}, fewer "
                        f"than twice the state's {record['state_bytes']} B")
            reset_launches()
            if not save:
                a.run(TRAIN_STEPS)
                return a, read_launches(), None, None
            a.run(RESUME_AT)
            t0 = time.perf_counter()
            a.save(blocking=False)
            snapshot_s = time.perf_counter() - t0
            pending = a._pending_save
            a.run(TRAIN_STEPS - RESUME_AT)    # waits for the writer
            return a, read_launches(), snapshot_s, pending.write_s

        torch.cuda.reset_peak_memory_stats()
        a, launches_a, snapshot_s, write_s = run_a()
        expect_launches("train resume A", launches_a,
                        {k: v * TRAIN_STEPS for k, v in per_step.items()})
        losses_a = [h["loss"] for h in a.history]
        digests_a, host_a = _state_digests(a)
        paths = [p for p, _ in named_leaves(a._tree())]
        log(f"[train resume A] losses {losses_a}; checkpoint at step "
            f"{RESUME_AT}: host snapshot {snapshot_s!r} s, write + hash "
            f"{write_s!r} s (a thread, beside steps {RESUME_AT}-"
            f"{TRAIN_STEPS - 1}); launches {launches_a} ({smi})")
        del a

        b = trainer(1)
        restore_s = []
        try_restore = b.try_restore

        def timed_restore():
            t0 = time.perf_counter()
            done = try_restore()
            restore_s.append(time.perf_counter() - t0)
            return done

        b.try_restore = timed_restore
        fired = []

        def inject(step):
            if step == RESUME_AT + 1 and not fired:
                fired.append(step)
                raise RuntimeError("injected failure")

        reset_launches()
        if not b.try_restore() or b.step_idx != RESUME_AT:
            raise AssertionError(f"train resume B restored step "
                                 f"{b.step_idx}, not {RESUME_AT}")
        b.run(TRAIN_STEPS - b.step_idx, fail_injector=inject)
        launches_b = read_launches()
        steps_b = [h["step"] for h in b.history]
        want = [RESUME_AT] + list(range(RESUME_AT, TRAIN_STEPS))
        if fired != [RESUME_AT + 1] or steps_b != want:
            raise AssertionError(f"train resume B: failure at {fired}, "
                                 f"steps {steps_b} != {want}")
        expect_launches("train resume B", launches_b,
                        {k: v * len(want) for k, v in per_step.items()})
        losses_b = [h["loss"] for h in b.history]
        digests_b, diff_b = _state_digests(b, (digests_a, host_a))
        step_b = b.opt_state.step
        peak = torch.cuda.max_memory_allocated()
        del b
        equal = sum(x == y for x, y in zip(digests_b, digests_a))
        # B's last run of each step against A's
        loss_diff_b = max(abs(losses_b[-(TRAIN_STEPS - s)] - losses_a[s])
                          for s in range(RESUME_AT, TRAIN_STEPS))
        record.update({
            "snapshot_s": snapshot_s, "write_hash_s": write_s,
            "restore_s": restore_s, "max_memory_allocated_bytes": peak,
            "losses_a": losses_a, "steps_b": steps_b, "losses_b": losses_b,
            "leaves": len(digests_a), "leaves_bit_equal": equal,
            "opt_step_b": step_b, "max_abs_diff_b": max(diff_b),
            "max_loss_diff_b": loss_diff_b,
            "launches_a": launches_a, "launches_b": launches_b})
        log(f"[train resume B] restored step {RESUME_AT} in "
            f"{restore_s[0]!r} s, failed at step {RESUME_AT + 1}, rolled "
            f"back in {restore_s[1]!r} s; steps {steps_b}, losses "
            f"{losses_b}; {equal} of {len(digests_a)} leaves bit-equal "
            f"to A, AdamW step {step_b}; launches {launches_b}; peak "
            f"memory {peak} B ({smi})")
        if equal != len(digests_a) or step_b != TRAIN_STEPS or \
                loss_diff_b != 0.0:
            # not bit-equal: how far does A differ from itself?
            a2 = run_a(save=False)[0]
            digests_a2, diff_a2 = _state_digests(a2, (digests_a, host_a))
            record.update({
                "leaves_bit_equal_a_rerun": sum(
                    x == y for x, y in zip(digests_a2, digests_a)),
                "max_abs_diff_a_rerun": max(diff_a2),
                "max_loss_diff_a_rerun": max(
                    abs(h["loss"] - x) for h, x in zip(a2.history,
                                                       losses_a)),
                "differing_b": [p for p, d in zip(paths, diff_b) if d][:8],
                "differing_a_rerun": [p for p, d in zip(paths, diff_a2)
                                      if d][:8]})
            del a2
            log(f"[train resume] B is not bit-equal to A; A's rerun: "
                f"{record} ({smi})")
            if not (record["leaves_bit_equal_a_rerun"] <= equal and
                    step_b == TRAIN_STEPS and
                    record["max_abs_diff_b"] <=
                    record["max_abs_diff_a_rerun"] and
                    loss_diff_b <= record["max_loss_diff_a_rerun"]):
                raise AssertionError(f"train resume: B differs from A by "
                                     f"more than A's rerun: {record}")
        record["card"] = smi
        log(f"[train resume] {json.dumps(record)}")
        return record, (launches_a, launches_b)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 4c / 5b. the other architectures at full width
# ---------------------------------------------------------------------------

def _clone_tree(tree):
    """A copy of a cache: dicts, lists and state tuples rebuilt, tensors
    cloned."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_clone_tree(v) for v in tree))
    return tree.clone()


def _attention_layers(cfg) -> int:
    """Attention blocks a decode step runs: every layer of a dense stack,
    the shared block's applications (one a group) of a hybrid."""
    return cfg.hybrid_groups if cfg.family == "hybrid" else cfg.num_layers


def _arch_train_launches(cfg) -> dict:
    """Kernel launches per train step (remat): each block's forward runs
    twice, a hybrid's grouped Mamba-2 blocks three times (remat per block
    inside remat per group), its shared block twice an application."""
    if cfg.family != "hybrid":
        n = cfg.num_layers
        return {"la_fwd": 2 * n, "la_bwd_q": n, "la_bwd_kv": n}
    g, m, t = cfg.hybrid_groups, cfg.hybrid_mamba_per_group, cfg.hybrid_tail
    return {"la_fwd": 2 * g, "la_bwd_q": g, "la_bwd_kv": g,
            "ssd_fwd": 3 * g * m + 2 * t, "ssd_bwd_q": g * m + t,
            "ssd_bwd_kv": g * m + t}


def _head_dims(cfg):
    """(Dk, Dv) of the model's attention heads: MLA's decompressed nope +
    rope and v widths, else the head dim twice."""
    if cfg.mixer == "mla":
        return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim,
                cfg.mla.v_head_dim)
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def _vlm_mixed(torch, mdl, params, cfg):
    """qwen2-vl-7b's `model.prefill` on a mixed stream, ARCH_SLOTS
    sequences of an image of VLM_GRID patches (positions from
    `vision_positions_stub`) then VLM_TEXT text tokens, and VLM_DECODE
    greedy decode steps through la_decode_fused, the first COMPARE_STEPS
    beside the plain path from a copy of the prefilled cache; rope_pos
    lags the token count by the patches but one.  Returns (record, the
    run's launches)."""
    from repro_torch.models.frontends import vision_positions_stub
    n_img = math.prod(VLM_GRID)
    n = n_img + VLM_TEXT
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    tokens = torch.randint(3, cfg.vocab_size, (ARCH_SLOTS, n), generator=gen,
                           device="cuda")
    positions = vision_positions_stub(ARCH_SLOTS, n, VLM_GRID, "cuda")
    cfg_k, cfg_t = _with_impl(cfg, "cuda"), _with_impl(cfg, "torch")
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = mdl.prefill(params, cfg_k, {"tokens": tokens,
                                                "positions": positions},
                                mdl.init_cache(cfg, ARCH_SLOTS,
                                               n + VLM_DECODE, "cuda"))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    rope0 = cache["rope_pos"].tolist()
    if rope0 != [VLM_TEXT + 1] * ARCH_SLOTS or \
            cache["pos"].tolist() != [n] * ARCH_SLOTS:
        raise AssertionError(f"mixed prefill: rope_pos {rope0}, pos "
                             f"{cache['pos'].tolist()}")
    cache_t = _clone_tree(cache)
    errs, toks = [], []
    for i in range(VLM_DECODE):
        tok = logits.argmax(-1)
        toks.append(tok.tolist())
        logits, cache = mdl.decode_step(params, cfg_k, cache, tok)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"mixed decode step {i}: non-finite logits")
        if i < COMPARE_STEPS:
            lt, cache_t = mdl.decode_step(params, cfg_t, cache_t, tok)
            errs.append(check_close(f"qwen2-vl-7b mixed decode step {i} "
                                    f"logits (cuda vs torch)", logits, lt,
                                    LOGITS_REL))
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches("qwen2-vl-7b mixed image+text stream", launches,
                    {"la_decode_fused": cfg.num_layers * VLM_DECODE})
    rope1 = cache["rope_pos"].tolist()
    if rope1 != [VLM_TEXT + 1 + VLM_DECODE] * ARCH_SLOTS:
        raise AssertionError(f"mixed decode: rope_pos {rope1}")
    log(f"[serve qwen2-vl-7b mixed] {ARCH_SLOTS} x ({n_img} image patches "
        f"{VLM_GRID} + {VLM_TEXT} text): prefill {prefill_s!r} s, rope_pos "
        f"{rope0[0]} at pos {n} -> {rope1[0]} after {VLM_DECODE} decode "
        f"steps; launches {launches}")
    del cache, cache_t
    return {"grid": list(VLM_GRID), "image_patches": n_img,
            "text_tokens": VLM_TEXT, "decode_steps": VLM_DECODE,
            "prefill_s": prefill_s, "rope_pos_after_prefill": rope0[0],
            "pos_after_prefill": n, "rope_pos_after_decode": rope1[0],
            "tokens": toks, "kernel_launches": launches,
            "logits_max_abs_err": errs}, launches


def phase_arch_serve(torch, np, arch):
    """The engine at full width and depth (deepseek-v2-236b at
    ARCH_SERVE_DEPTH's) with `arch`'s preset (linear) backend, bf16
    compute (granite-20b and the MoE family: bf16 params too, the compute
    copy the very tensors): ARCH_SLOTS requests of ARCH_PROMPT random tokens,
    ARCH_NEW new, greedy; every decode step through la_decode_fused (one
    launch per attention block); the steady decode step (events, host
    clock, profile) and the first decode steps' logits, kernel path
    against plain path, from one cloned prefilled cache (under M-RoPE text
    positions, as the engine gives); qwen2-vl-7b also its mixed
    image+text stream (`_vlm_mixed`).  Returns (record, the run's
    launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, **ARCH_SERVE_DEPTH.get(arch, {}))
    if arch in ARCH_SERVE_PARAMS:
        cfg = dataclasses.replace(cfg, param_dtype=ARCH_SERVE_PARAMS[arch])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    max_len = ARCH_PROMPT + ARCH_NEW
    engine = Engine(cfg, params, max_slots=ARCH_SLOTS, max_len=max_len,
                    prefill_chunk=ARCH_PROMPT, eos_id=-1, device="cuda")
    aliased = all(a.data_ptr() == b.data_ptr() for a, b in
                  zip(leaves(params), leaves(engine.params)))
    if cfg.param_dtype == cfg.compute_dtype and not aliased:
        raise AssertionError(f"{arch}: the engine's compute copy does not "
                             f"alias the {cfg.param_dtype} params")
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, cfg.vocab_size, size=(ARCH_SLOTS, ARCH_PROMPT))
    for rid in range(ARCH_SLOTS):
        engine.submit(Request(rid=rid, prompt=prompts[rid].tolist(),
                              max_new_tokens=ARCH_NEW))
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
    attn = _attention_layers(cfg)
    log(f"[serve {arch}] {cfg.name} ({n_params} params, {cfg.param_dtype} "
        f"params, aliased compute copy {aliased}): {ARCH_SLOTS} requests x "
        f"{ARCH_PROMPT} prompt tokens, {ARCH_NEW} new: {steps} decode "
        f"steps, launches {launches}, wall {wall!r} s (init {init_s!r} s)")
    if steps < ARCH_NEW - 1:
        raise AssertionError(f"{steps} decode steps for {ARCH_NEW} tokens")
    expect_launches(f"serve {arch}", launches,
                    {"la_decode_fused": attn * steps})
    for rid in range(ARCH_SLOTS):
        toks = engine.request(rid).generated
        if len(toks) != ARCH_NEW or not all(0 <= t < cfg.vocab_size
                                            for t in toks):
            raise AssertionError(f"{arch} request {rid} generated {toks}")
    tokens = torch.from_numpy(engine.next_tokens).to("cuda")
    step_dev_ms, step_host_ms, profile = _steady_decode(
        torch, mdl, engine.params, engine.cfg, engine.cache, tokens,
        f"decode step ({arch})")
    peak = torch.cuda.max_memory_allocated()

    prompt_t = torch.from_numpy(prompts).to("cuda")
    batch = {"tokens": prompt_t}
    if cfg.rope_kind == "mrope":
        batch["positions"] = torch.arange(
            ARCH_PROMPT, dtype=torch.int32,
            device="cuda")[None, None].expand(3, ARCH_SLOTS, ARCH_PROMPT)
    logits, cache0 = mdl.prefill(engine.params, engine.cfg, batch,
                                 mdl.init_cache(cfg, ARCH_SLOTS, max_len,
                                                "cuda"))
    tok = logits.argmax(-1)
    cache_k, cache_t = _clone_tree(cache0), _clone_tree(cache0)
    del cache0
    cfg_k, cfg_t = _with_impl(engine.cfg, "cuda"), _with_impl(engine.cfg,
                                                              "torch")
    logit_errs = []
    # the MoE family: a token whose router scores lie within rounding of a
    # tie takes other experts on the two paths, and the recurrent states
    # keep that for every later step, so each step starts both paths from
    # the kernel path's cache
    resync = cfg.moe is not None
    for i in range(COMPARE_STEPS):
        if resync and i:
            cache_t = _clone_tree(cache_k)
        lk, cache_k = mdl.decode_step(engine.params, cfg_k, cache_k, tok)
        lt, cache_t = mdl.decode_step(engine.params, cfg_t, cache_t, tok)
        if not torch.isfinite(lk).all():
            raise AssertionError(f"{arch} decode step {i}: non-finite "
                                 f"logits")
        logit_errs.append(check_close(f"full-width {arch} decode step {i} "
                                      f"logits (cuda vs torch"
                                      f"{', same cache' if resync else ''})",
                                      lk, lt, LOGITS_REL))
        tok = lk.argmax(-1)
    del cache_k, cache_t
    mixed = None
    if cfg.rope_kind == "mrope":
        mixed, mixed_l = _vlm_mixed(torch, mdl, engine.params, engine.cfg)
        launches = {k: v + mixed_l[k] for k, v in launches.items()}
    ttft = [first[r] for r in range(ARCH_SLOTS)]
    record = {
        "arch": cfg.name, "params": n_params,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "compute_copy_aliases_params": aliased,
        "layers": cfg.num_layers, "full_depth_layers": full.num_layers,
        "depth_cut": ARCH_SERVE_DEPTH.get(arch),
        "full_depth_params": full.param_count(),
        "attention_blocks_per_step": attn,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim, "head_dims_kv": _head_dims(cfg),
        "mixer": cfg.mixer, "moe": (dataclasses.asdict(cfg.moe)
                                    if cfg.moe is not None else None),
        "slots": ARCH_SLOTS, "prompt_len": ARCH_PROMPT,
        "prefill_chunk": ARCH_PROMPT, "max_new": ARCH_NEW,
        "decode_steps": steps, "kernel_launches": launches,
        "wall_s": wall, "init_s": init_s,
        "generated_tokens_per_s": ARCH_SLOTS * ARCH_NEW / wall,
        "ttft_s": ttft, "ttft_max_s": max(ttft),
        "decode_step_ms_device": step_dev_ms,
        "decode_step_ms_host": step_host_ms,
        "decode_step_profile": profile,
        "max_memory_allocated_bytes": peak,
        "logits_max_abs_err": logit_errs,
        "logits_compared_from_same_cache_each_step": resync,
        "mixed_image_text": mixed,
    }
    del engine
    torch.cuda.empty_cache()
    return record, launches


def phase_encdec_serve(torch):
    """whisper-large-v3 at full width and depth through `models/model.py`
    (the engine refuses the encoder-decoder, as the reference's does):
    f32 params and their bf16 compute copy (`compute_params`, as the
    engine makes it), ENCDEC_SLOTS clips of 1500 stub frames
    (`audio_frames_stub`), the 4-token start-of-transcript prompt; one
    prefill (the encoder, each decoder layer's cross-attention state, the
    prompt) and ENCDEC_NEW - 1 greedy decode steps, each through
    la_decode_fused once per decoder layer; the steady decode step
    (events, host clock, profile) and the first decode steps' logits,
    kernel path against plain path, from one cloned prefilled cache.
    Returns (record, the run's launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as mdl
    from repro_torch.models.frontends import audio_frames_stub
    from repro_torch.tree import leaves

    cfg = get_config(ENCDEC)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = mdl.init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    cparams = mdl.compute_params(params, cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    frames = audio_frames_stub(gen, ENCDEC_SLOTS, cfg.encoder_seq,
                               cfg.d_model)
    prompt = torch.tensor([ENCDEC_PROMPT] * ENCDEC_SLOTS, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_len = len(ENCDEC_PROMPT) + ENCDEC_NEW
    reset_launches()
    t_start = time.perf_counter()
    logits, cache = mdl.prefill(cparams, cfg, {"tokens": prompt,
                                               "frames": frames},
                                mdl.init_cache(cfg, ENCDEC_SLOTS, max_len,
                                               "cuda"))
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t_start
    prefilled = _clone_tree(cache)
    generated = [tok.tolist()]
    for _ in range(ENCDEC_NEW - 1):
        logits, cache = mdl.decode_step(cparams, cfg, cache, tok)
        tok = logits.argmax(-1)
        generated.append(tok.tolist())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = read_launches()
    steps = ENCDEC_NEW - 1
    log(f"[serve {ENCDEC}] {n_params} f32 params (bf16 compute copy): "
        f"{ENCDEC_SLOTS} clips x {cfg.encoder_seq} frames, prompt "
        f"{ENCDEC_PROMPT}, {ENCDEC_NEW} new: TTFT {ttft!r} s, wall {wall!r} "
        f"s, launches {launches}")
    expect_launches(f"serve {ENCDEC}", launches,
                    {"la_decode_fused": cfg.num_layers * steps})
    toks = list(zip(*generated))
    if not all(len(t) == ENCDEC_NEW and all(0 <= x < cfg.vocab_size
                                              for x in t) for t in toks):
        raise AssertionError(f"{ENCDEC} generated {toks}")
    if cache["pos"].tolist() != [max_len - 1] * ENCDEC_SLOTS:
        raise AssertionError(f"{ENCDEC} pos {cache['pos'].tolist()}")
    for i, cs in enumerate(prefilled["cross"]):
        hd = cfg.resolved_head_dim
        if tuple(cs.s.shape) != (ENCDEC_SLOTS, cfg.num_kv_heads, hd,
                                 hd + 1) \
                or not torch.isfinite(cs.s).all() \
                or not torch.allclose(cs.p[..., -1], torch.full_like(
                    cs.p[..., -1], float(cfg.encoder_seq))):
            raise AssertionError(f"{ENCDEC} layer {i} cross state")
    step_dev_ms, step_host_ms, profile = _steady_decode(
        torch, mdl, cparams, cfg, cache, tok, f"decode step ({ENCDEC})")
    peak = torch.cuda.max_memory_allocated()
    del cache
    tok = torch.tensor(generated[0], device="cuda")
    cache_k, cache_t = prefilled, _clone_tree(prefilled)
    cfg_k, cfg_t = _with_impl(cfg, "cuda"), _with_impl(cfg, "torch")
    logit_errs = []
    for i in range(COMPARE_STEPS):
        lk, cache_k = mdl.decode_step(cparams, cfg_k, cache_k, tok)
        lt, cache_t = mdl.decode_step(cparams, cfg_t, cache_t, tok)
        logit_errs.append(check_close(f"full-width {ENCDEC} decode step {i} "
                                      f"logits (cuda vs torch)", lk, lt,
                                      LOGITS_REL))
        tok = lk.argmax(-1)
    record = {
        "arch": cfg.name, "params": n_params, "param_dtype": cfg.param_dtype,
        "compute_dtype": cfg.compute_dtype,
        "encoder_layers": cfg.encoder_layers, "decoder_layers":
        cfg.num_layers, "full_depth_params": cfg.param_count(),
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.resolved_head_dim, "slots": ENCDEC_SLOTS,
        "frames": cfg.encoder_seq, "prompt": list(ENCDEC_PROMPT),
        "max_new": ENCDEC_NEW, "decode_steps": steps,
        "kernel_launches": launches, "wall_s": wall, "init_s": init_s,
        "ttft_s": ttft,
        "generated_tokens_per_s": ENCDEC_SLOTS * ENCDEC_NEW / wall,
        "decode_step_ms_device": step_dev_ms,
        "decode_step_ms_host": step_host_ms,
        "decode_step_profile": profile,
        "max_memory_allocated_bytes": peak,
        "logits_max_abs_err": logit_errs, "tokens": toks}
    del params, cparams, cache_k, cache_t, prefilled, frames
    torch.cuda.empty_cache()
    return record, launches


def _moe_recompute_bits(torch, cfg, params, batch):
    """An MoE FFN of the model's first MoE block run twice on the same
    full-width input (its embedded batch, bf16): remat recomputes the
    routing in the backward, so both runs must give the same top-k,
    output and aux loss, bit for bit."""
    from repro_torch.models import moe
    from repro_torch.models.common import embed_lookup
    p = params["blocks"][0]["ffn"]
    with torch.no_grad():
        x = embed_lookup(params["embed"], batch["tokens"], torch.bfloat16)
        xt = x.reshape(-1, x.shape[-1])
        runs = [(*moe.route(p, cfg, xt)[1:2], *moe.moe_apply(
            p, cfg, x, torch.bfloat16)) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    tokens = xt.shape[0]
    log(f"  MoE routing recomputed at {tokens} tokens: top-k ids, output "
        f"and aux bit-equal {same}")
    if not same:
        raise AssertionError(f"{cfg.name}: a recomputed MoE forward differs "
                             f"from the first")
    return {"tokens": tokens, "bit_equal": same,
            "capacity": moe.capacity(cfg, tokens)}


def phase_arch_train(torch, arch):
    """The first step of `arch` at full width and ARCH_COMPARE_DEPTH's
    depth, kernel path against plain path (`_train_compare_all`: the loss
    and every grad, bf16 and f32 compute; the MoE family also an MoE
    forward recomputed bit-equal, `_moe_recompute_bits`); then
    ARCH_TRAIN_STEPS Trainer steps at full width (f32 params and moments,
    bf16 compute, remat; ARCH_TRAIN_DEPTH's depth), each through the LA
    kernels (and a hybrid's SSD kernels) as often as
    `_arch_train_launches` says; step time, tokens/s, peak memory and one
    more step under torch.profiler.  Batches are TRAIN_BATCH x TRAIN_SEQ
    tokens of SyntheticLM (whisper-large-v3: ENCDEC_TRAIN_BATCH clips of
    1500 stub frames and ENCDEC_TRAIN_SEQ decoder tokens), with M-RoPE
    positions or encoder frames where the family takes them
    (`models/frontends.py::StubBatches`).  An arch of COMPARE_ONLY (deepseek-v2:
    no depth of it trains on one card) stops after the comparison, its
    grads held on the host between legs, and its kernel legs are its
    train path: counted, each leg a step's forward (twice under remat)
    and backward.  Returns (record, the run's launches)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as mdl
    from repro_torch.models.frontends import StubBatches
    from repro_torch.train.loop import Trainer
    from repro_torch.tree import leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, **ARCH_TRAIN_DEPTH.get(arch, {}))
    if not (cfg.remat and cfg.compute_dtype == "bfloat16"
            and cfg.param_dtype == "float32"):
        raise AssertionError(f"{cfg.name} is not f32 params / bf16 "
                             f"compute / remat: {cfg}")
    torch.cuda.empty_cache()
    n_batch, seq = ((ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ)
                    if cfg.family == "encdec" else (TRAIN_BATCH, TRAIN_SEQ))
    data = StubBatches(cfg, SyntheticLM(cfg.vocab_size, seq, n_batch,
                                        seed=0), VLM_GRID, "cuda")
    short = dataclasses.replace(full, **ARCH_COMPARE_DEPTH[arch])
    params = mdl.init_params(short, seed=0, device="cuda")
    batch0 = data.batch_at(0)
    log(f"[train {arch}] step 0 at {short.num_layers} layers, kernel path "
        f"vs plain path")
    compare_only = arch in COMPARE_ONLY
    reset_launches()
    t_cmp = time.perf_counter()
    compare = {"layers": short.num_layers,
               **_train_compare_all(torch, mdl, short, params, batch0,
                                    bf16_per_leaf=cfg.family
                                    in PER_LEAF_FAMILIES,
                                    host_grads=compare_only)}
    compare["compare_s"] = time.perf_counter() - t_cmp
    if compare_only:
        launches = read_launches()
        per_step = _arch_train_launches(short)
        log(f"[train {arch}] the step-0 comparison's two kernel legs: "
            f"launches {launches}")
        expect_launches(f"train {arch} (step-0 kernel legs)", launches,
                        {k: 2 * v for k, v in per_step.items()})
    if cfg.moe is not None:
        compare["moe_recompute"] = _moe_recompute_bits(torch, short, params,
                                                       batch0)
    del params, batch0
    torch.cuda.empty_cache()
    if compare_only:
        return {"arch": cfg.name, "full_depth_layers": full.num_layers,
                "full_depth_params": full.param_count(),
                "compare_only": True, "batch": n_batch, "seq": seq,
                "kernel_launches": launches,
                "launches_per_kernel_leg": per_step,
                "kernel_vs_plain": compare}, launches
    params = mdl.init_params(cfg, seed=0, device="cuda")
    n_params = sum(t.numel() for t in leaves(params))
    tc = TrainConfig(total_steps=ARCH_TRAIN_STEPS, warmup_steps=1)
    trainer = Trainer(cfg, tc, params, data)
    del params
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    hist = trainer.run(ARCH_TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    per_step = _arch_train_launches(cfg)
    log(f"[train {arch}] {cfg.name} at {cfg.num_layers} of "
        f"{full.num_layers} layers ({n_params} params): "
        f"{ARCH_TRAIN_STEPS} steps of {n_batch} x {seq} tokens: "
        f"launches {launches}, losses {[h['loss'] for h in hist]}, step s "
        f"{[h['dt'] for h in hist]}, peak {peak} B")
    expect_launches(f"train {arch}", launches,
                    {k: v * ARCH_TRAIN_STEPS for k, v in per_step.items()})
    if len(hist) != ARCH_TRAIN_STEPS or not all(
            math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"{arch} train history {hist}")
    steady = sorted(h["dt"] for h in hist[1:])
    step_s = steady[len(steady) // 2]
    batch = data.batch_at(ARCH_TRAIN_STEPS)
    profile = _profile(torch, f"train step ({arch})",
                       lambda: trainer.step_fn(trainer.params,
                                               trainer.opt_state, batch,
                                               ARCH_TRAIN_STEPS), steps=1)
    record = {"arch": cfg.name, "layers": cfg.num_layers,
              "full_depth_layers": full.num_layers,
              "depth_cut": ARCH_TRAIN_DEPTH.get(arch),
              "params": n_params, "full_depth_params": full.param_count(),
              "compute_dtype": cfg.compute_dtype,
              "param_dtype": cfg.param_dtype, "remat": cfg.remat,
              "batch": n_batch, "seq": seq,
              "encoder_frames": (cfg.encoder_seq if cfg.family == "encdec"
                                 else None),
              "steps": ARCH_TRAIN_STEPS,
              "losses": [h["loss"] for h in hist],
              "step_s": [h["dt"] for h in hist],
              "step_s_median_after_first": step_s,
              "tokens_per_s": n_batch * seq / step_s,
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

def _time_loop(torch, fn, reps, warm=1):
    """CUDA-event ms per call of `fn` (no arguments) in a Python loop."""
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


def _time_pair(torch, plain, kernel, reps, warm=1):
    """CUDA-event ms per call of `plain` and `kernel`, in turns (plain,
    kernel, kernel, plain); each takes no arguments."""
    plain_a = _time_loop(torch, plain, reps, warm)
    kern_a = _time_loop(torch, kernel, reps, warm)
    kern_b = _time_loop(torch, kernel, reps, warm)
    plain_b = _time_loop(torch, plain, reps, warm)
    return [kern_a, kern_b], [plain_a, plain_b]


def _graph_time_pair(torch, first, second, launches=200):
    """CUDA-event ms per launch of `first` and `second`, each captured
    `launches` times into a CUDA graph and the graphs replayed in turns
    (first, second, second, first): the kernels' own time, where a
    Python loop of launches would time the host's dispatch (each takes
    no arguments)."""
    graphs = []
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in (first, second):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(launches):
                    fn()
            graphs.append(graph)
    torch.cuda.current_stream().wait_stream(side)

    def time_graph(graph):
        graph.replay()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        ev0.record()
        graph.replay()
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / launches

    a1, b1 = time_graph(graphs[0]), time_graph(graphs[1])
    b2, a2 = time_graph(graphs[1]), time_graph(graphs[0])
    return [a1, a2], [b1, b2]


def _rotating(fn, sets, tail=()):
    """fn over `sets` in turn (each a tuple of its leading arguments, then
    `tail`), taking no arguments."""
    nxt = itertools.cycle(sets).__next__
    return lambda: fn(*nxt(), *tail)


def decode_state_sets(torch, n=8):
    """n gated decode steps' inputs at the serving shape (B=8, H=Hkv=16,
    D=128, bf16, the trained gate): 8.5 MB of f32 state each, so that 8
    of them exceed the 50 MB L2 and each call finds its state cold, as a
    serving step finds each of its 24 layers'."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    return [_gla_decode_case(torch, gen, SLOTS, 16, 16, 128, torch.bfloat16,
                             "trained") for _ in range(n)]


def recurrent_graph_times(torch, sets):
    """la_decode_fused and gla_decode_fused over `sets` (the linear step
    reads no log decay), each captured to a CUDA graph and the graphs
    replayed in turns: ([la ms], [gla ms]) per launch."""
    from repro_torch.kernels import decode_fused as df
    return _graph_time_pair(
        torch, _rotating(df.la_decode_fused_cuda, [x[:5] for x in sets],
                         (1.0, 1.0)),
        _rotating(df.gla_decode_fused_cuda, sets, (1.0, 1.0)))


def paged_sets(torch, n=8):
    """n paged decode inputs at the serving shape (B=8, H=Hkv=16, D=128,
    bf16, page size 16, 34 table entries a slot into a shuffled arena,
    every slot at MAX_LEN live keys): 36 MB of live keys each, 286 MB in
    all, so each call finds its pages cold in L2; and the same keys
    gathered into contiguous caches for softmax_decode_fused."""
    from repro_torch.kernels import paged_attention as pg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    sets = []
    for _ in range(n):
        lengths = torch.full((SLOTS,), MAX_LEN, dtype=torch.int32,
                             device="cuda")
        sets.append(_paged_case(torch, gen, SLOTS, 16, 16, 128, PAGE_SIZE,
                                PMAX, lengths, torch.bfloat16))
    contiguous = [(q, pg.gather_pages(kp, t), pg.gather_pages(vp, t), n)
                  for q, kp, vp, t, n in sets]
    return sets, contiguous


def paged_graph_times(torch, sets, contiguous):
    """By CUDA graph replays in turns: paged_decode_fused beside
    paged_attention on the same inputs, then beside softmax_decode_fused
    on the same keys in contiguous caches.  ms runs per launch of each."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import paged_attention as pg
    fused, unfused = _graph_time_pair(
        torch, _rotating(df.paged_decode_fused_cuda, sets),
        _rotating(pg.paged_attention_cuda, sets))
    paged, contig = _graph_time_pair(
        torch, _rotating(df.paged_decode_fused_cuda, sets),
        _rotating(df.softmax_decode_fused_cuda, contiguous))
    return {"paged_decode_fused": fused, "paged_attention": unfused,
            "paged_decode_fused_beside_contiguous": paged,
            "softmax_decode_fused_contiguous": contig}


def _bound(bytes_moved, flops, flop_per_s=F32_FLOP_PER_S):
    """The least time for the work: bytes at the HBM rate or operations
    at `flop_per_s` (f32 CUDA cores for the linear-attention kernels,
    which compute in f32; bf16 tensor cores for the softmax kernels)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def _blocks_per_sm(threads, smem, regs):
    """Blocks of one kernel an SM holds at once: by its shared memory
    (each block also takes 1 KB), by its registers (each of the four
    schedulers holds a quarter of the file, a warp's in units of 8 a
    thread) and by its threads."""
    warps = -(-threads // 32)
    by_regs = (REGISTERS_PER_SM // 4 // (-(-regs // 8) * 8 * 32)) * 4 // warps
    return min(SM_SMEM // (smem + 1024), by_regs, 2048 // threads)


def _body_record(c_body, walk_bound, ptxas_recs, wgmma_fn):
    """The body a timed kernel ran (from its launcher's C export), its
    ptxas registers and spills, shared memory per block, the blocks an SM
    holds and the blocks per SM of its grid, and the walk's bound."""
    body, launch, c_geo = c_body
    rec = {"body": body, "threads": launch.threads,
           "smem_per_block": launch.smem, "grid": list(launch.grid),
           "c_plan": list(c_geo), "walk_bound": walk_bound}
    if body == "wgmma":
        blocks = launch.grid[0] * launch.grid[1] * launch.grid[2]
        rec.update(
            ptxas=[r for r in ptxas_recs if r["function"] == wgmma_fn],
            blocks_per_sm_fit=_blocks_per_sm(launch.threads, launch.smem,
                                             c_geo[5]),
            grid_blocks_per_sm=blocks / SMS)
    return rec


def _ptxas_of(ptxas, source, prefix):
    """ptxas's records of `source`'s instantiations whose name starts with
    `prefix`."""
    return [r for r in ptxas.get(source, [])
            if r["function"].startswith(prefix)]


def _stream_record(launch, ptxas, source, paged):
    """The tile stream a bf16, D = 128 softmax decode launch with one query
    row a cell and tiles of whole pages (or of the contiguous cache) runs
    (from its launcher's C exports), its ptxas registers and spills,
    shared memory per block, the blocks an SM holds and the clusters the
    card holds."""
    from repro_torch.kernels.defaults import PAGED_DECODE_CLUSTER
    body, launch, c_geo, clusters = _decode_stream(launch)
    per_cluster = PAGED_DECODE_CLUSTER
    return dict(
        body=body, threads=launch.threads, smem_per_block=launch.smem,
        stages=launch.stage, grid=list(launch.grid), c_plan=list(c_geo),
        ptxas=_ptxas_of(ptxas, source,
                        f"pc::stream_kernel<__nv_bfloat16, 128, 1, "
                        f"{str(paged).lower()}, false>"),
        blocks_per_sm_fit=_blocks_per_sm(launch.threads, launch.smem,
                                         c_geo[5]),
        grid_blocks_per_sm=launch.grid[0] / SMS,
        blocks_per_cluster=per_cluster, max_active_clusters=clusters,
        active_blocks_per_sm=clusters * per_cluster / SMS,
        grid_clusters=launch.grid[0] // max(per_cluster, 1))


def _decode_work(b, h, hkv, d, itemsize, dv=None):
    """(bytes, flops) of one linear decode step (Dk = d, Dv = dv, default
    d): the f32 state and P read and written once, q, k, v read and o
    written in the compute dtype; the update and the G readouts."""
    dv = d if dv is None else dv
    g, cols = h // hkv, dv + 1
    state_elems = b * hkv * d * cols
    bytes_moved = (2 * state_elems * 4 + 2 * b * hkv * cols * 4
                   + (b * h * d + b * hkv * d + b * hkv * dv) * itemsize
                   + b * h * dv * itemsize)
    flops = (state_elems * (2 + 2 * g) + b * hkv * cols * (1 + 3 * g)
             + b * h * dv)
    return bytes_moved, flops


def phase_timing(torch, ptxas):
    """la_decode_fused and its plain version at the main path's decode
    shapes.  The serving step finds each layer's state cold in L2 (24
    layers of 8.5 MB), so the timed launches rotate over enough state
    buffers to exceed the 50 MB L2.  The kernel is timed by CUDA graph
    replays, in turns with gla_decode_fused on the same inputs (a Python
    loop of launches times the host's dispatch); the plain version by a
    loop.  Its record names the body (the state stream), its ptxas
    registers and spills, shared memory per block and the blocks an SM
    holds."""
    from repro_torch.kernels import decode_fused as df
    b, h, hkv, d = SLOTS, 16, 16, 128
    dtype = torch.bfloat16
    sets = decode_state_sets(torch)
    linear = [x[:5] for x in sets]
    loop, plain = _time_pair(
        torch, _rotating(df.la_decode_fused_torch, linear, (1.0, 1.0)),
        _rotating(df.la_decode_fused_cuda, linear, (1.0, 1.0)), reps=200,
        warm=20)
    kern, gla_runs = recurrent_graph_times(torch, sets)
    bytes_moved, flops = _decode_work(
        b, h, hkv, d, torch.tensor([], dtype=dtype).element_size())
    rec = {"ms": min(kern), "ms_runs": kern,
           "timed_by": "CUDA graph replays",
           "python_loop_ms_runs": loop, "plain_ms": min(plain),
           "plain_ms_runs": plain, "library_ms": None,
           "in_turns_with_gla_decode_fused": {"la_ms_runs": kern,
                                              "gla_ms_runs": gla_runs},
           **_bound(bytes_moved, flops)}
    body, launch, c_geo = _recurrent_decode_body(*sets[0][:5])
    rec.update(
        body=body, threads=launch.threads, smem_per_block=launch.smem,
        grid=list(launch.grid), c_plan=list(c_geo),
        ptxas=_ptxas_of(ptxas, "la_decode_fused",
                        "ds::decode_stream_kernel<__nv_bfloat16, 1, false>"),
        blocks_per_sm_fit=_blocks_per_sm(launch.threads, launch.smem,
                                         c_geo[5]),
        grid_blocks_per_sm=launch.grid[0] / SMS)
    log(f"[timing] la_decode_fused B={b} H={h} Hkv={hkv} D={d} {dtype}: "
        f"{rec}; bound {rec['bound_ms']!r} ms ({rec['bound_by']}: "
        f"{bytes_moved} B, {flops} flop); library_ms null: no single "
        f"PyTorch call computes this fused update + readout")
    del sets, linear
    return rec


def _la_work(b, h, hkv, n, d, it, dv=None):
    """(bytes, f32 flops of the token walk) of la_fwd, la_bwd_q and
    la_bwd_kv at these shapes (Dk = d, Dv = dv, default d), `it` the
    compute dtype's bytes."""
    dv = d if dv is None else dv
    q_el, k_el = b * h * n * d, b * hkv * n * d
    o_el, v_el = b * h * n * dv, b * hkv * n * dv
    tok_q, tok_kv = b * h * n, b * hkv * n
    return {
        # q, k, v read; o written in the compute dtype, g in f32
        "la_fwd": ((q_el + k_el + v_el) * it + o_el * it + tok_q * 4,
                   tok_q * 4 * d * (dv + 1)),
        # k, v read; Ω̂ and h read in f32; dq written
        "la_bwd_q": ((k_el + v_el) * it + o_el * 4 + tok_q * 4 + q_el * it,
                     tok_q * 4 * d * (dv + 1)),
        # q, k, v read; Ω̂ and h read in f32; dk, dv written.  The U
        # update per query token and head, the dk and dv readouts per
        # KV token and head
        "la_bwd_kv": ((q_el + k_el + v_el) * it + o_el * 4 + tok_q * 4
                      + (k_el + v_el) * it,
                      tok_q * 2 * (d + 1) * (dv + 1)
                      + tok_kv * 4 * d * (dv + 1)),
    }


def _la_chunk_flops(b, h, hkv, n, dk, dv):
    """The bf16 operations of the three LA kernels' functions in the
    reference's chunked form at (Dk, Dv) = (dk, dv), each product once (no
    hi + lo pair): per chunk of c tokens and query head, la_fwd's q k^T,
    q S, A v and the state update; la_bwd_q's Ω̂ v^T, Ω̂ A^T, P k and A's
    update; la_bwd_kv's v Ω̂^T, T q, k q^T, A Ω̂, the two readouts of U and
    its update.  The bound of a shape no chunked body runs (the walks at
    (192, 128))."""
    from repro_torch.kernels.defaults import LA_CHUNK_TOKENS
    c, tok_q = LA_CHUNK_TOKENS, b * h * n
    return {
        "la_fwd": tok_q // c * (2 * c * c * (dk + dv) + 4 * c * dk * dv),
        "la_bwd_q": tok_q // c * (2 * c * c * (dk + dv) + 4 * c * dk * dv),
        "la_bwd_kv": tok_q // c * (4 * c * c * (dk + dv)
                                   + 6 * c * dk * dv)}


def _la_tc_flops(b, h, hkv, n, d):
    """The bf16 tensor-core flops of the three LA kernels' chunked wgmma
    bodies at these shapes, D in LA_WGMMA_HEAD_DIMS (phase_timing_la's
    docstring; `parts` = D / 64 blocks per head or per KV head and role,
    each of `half` = 64 columns)."""
    from repro_torch.kernels.defaults import LA_CHUNK_TOKENS, LA_WGMMA_PART
    tok_q, tok_kv = b * h * n, b * hkv * n
    c, half, group = LA_CHUNK_TOKENS, LA_WGMMA_PART, h // hkv
    parts = d // half
    return {
        "la_fwd": tok_q // c * parts * (
            2 * c * c * d + 2 * c * d * half + 2 * c * c * half
            + 2 * c * half * d),
        "la_bwd_q": tok_q // c * parts * (
            2 * 2 * c * c * d + 3 * 2 * c * half * d + 2 * 2 * c * c * half
            + 2 * c * half * d),
        "la_bwd_kv": tok_kv // c * parts * (
            2 * 2 * 2 * c * half * d
            + group * (2 * 2 * c * c * d + 2 * 2 * c * c * half
                       + 2 * 2 * c * half * d)
            + group * (2 * c * c * d + 3 * 2 * c * c * half
                       + 2 * 2 * c * half * d))}


def phase_timing_la(torch, ptxas):
    """la_fwd, la_bwd_q and la_bwd_kv and their plain versions at the
    train path's shapes (bf16, as the model hands them over): pythia's
    (LA_SHAPE, D = 128; records by kernel name) and stablelm-1.6b's
    (LA_SHAPE_D64; records `<kernel>@d64`).  Each input is larger than
    the 50 MB L2, so every call reads it from device memory.  In bf16 all
    three run their chunked wgmma bodies, on the bf16 tensor cores, per
    chunk of c tokens, with D / 64 parts of 64 columns (`half` below; two
    parts at D = 128, one at 64):
      * la_fwd, per (batch, query head) and part of the value columns:
        q k^T (2 c^2 D), q S (2 c D half), A v (2 c^2 half) and the state
        update (2 c half D);
      * la_bwd_q, per (batch, query head) and part of dq's columns: P =
        Ω̂ v^T twice (2 c^2 D; Ω̂ hi + lo), R = Ω̂ A^T three times (2 c
        half D; both hi + lo), P k twice (2 c^2 half) and the update (2 c
        half D);
      * la_bwd_kv, per (batch, KV head): for each part of dk, U's readout
        twice (2 c half D) and per query head T = v Ω̂^T twice (2 c^2 D),
        T q twice (2 c^2 half), the update twice (2 c half D); for each
        part of dv, the readout twice and per query head S = k q^T (2 c^2
        D), A Ω̂ three times (2 c^2 half) and the update twice.
    Each record names the body, its ptxas registers and spills, shared
    memory per block and the blocks an SM holds, keeps the walk's bound
    and the tensor-core and byte times beside, and times the token walk
    (which f32 inputs still run) in turns with it."""
    out = _timing_la_at(torch, ptxas, LA_SHAPE, 4, "")
    torch.cuda.empty_cache()
    out.update(_timing_la_at(torch, ptxas, LA_SHAPE_D64, 5, "@d64"))
    torch.cuda.empty_cache()
    return out


def _timing_la_at(torch, ptxas, m, seed, suffix):
    """phase_timing_la at one shape `m`, its records keyed by kernel name
    and `suffix`."""
    from repro_torch.kernels import linear_attention as la
    b, h, hkv, n, d = m["b"], m["h"], m["hkv"], m["n"], m["d"]
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q, k, v, om_hat, h_vec = _la_case(torch, gen, b, h, hkv, n, d, dtype)
    work = _la_work(b, h, hkv, n, d, q.element_size())
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
    qf, kf, vf = q.float(), k.float(), v.float()
    walks = {
        "la_fwd": lambda: la.la_fwd_cuda(qf, kf, vf, 1.0, 1.0),
        "la_bwd_q": lambda: la.la_bwd_q_cuda(kf, vf, om_hat, h_vec, 1.0),
        "la_bwd_kv": lambda: la.la_bwd_kv_cuda(qf, kf, vf, om_hat, h_vec,
                                               1.0, 1.0)}
    tc_flops = _la_tc_flops(b, h, hkv, n, d)
    c_bodies = {"la_fwd": _la_fwd_body(q, k, v),
                **{e: _la_bwd_body(e, q, k, v, om_hat, h_vec)
                   for e in ("la_bwd_q", "la_bwd_kv")}}
    wgmma_fn = {"la_fwd": ("la_fwd", f"lc::la_fwd_wgmma_kernel<{d}, false>"),
                "la_bwd_q": ("la_bwd",
                             f"bq::la_bwd_q_wgmma_kernel<{d}, false>"),
                "la_bwd_kv": ("la_bwd",
                              f"bkv::la_bwd_kv_wgmma_kernel<{d}, false>")}
    walk_bounds = {name: _bound(*work[name]) for name in calls}
    for name, (body, _, _) in c_bodies.items():
        if body == "wgmma":
            work[name] = (work[name][0], tc_flops[name], BF16_TC_FLOP_PER_S)
    out = {}
    for name, (plain, kernel) in calls.items():
        kern, pl = _time_pair(torch, plain, kernel, reps=5)
        rec = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
               "plain_ms_runs": pl, **_bound(*work[name])}
        lib, fn = wgmma_fn[name]
        rec.update(_body_record(c_bodies[name], walk_bounds[name],
                                ptxas.get(lib, []), fn))
        rec.update(byte_ms=rec["bytes"] / HBM_BYTES_PER_S * 1e3,
                   tensor_core_ms=tc_flops[name] / BF16_TC_FLOP_PER_S * 1e3)
        walk, kern2 = _time_pair(torch, kernel, walks[name], reps=5)
        rec.update(walk_ms=min(walk), walk_ms_runs=walk,
                   ms_runs_beside_walk=kern2)
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} N={n} D={d} {dtype}: "
            f"kernel {kern} ms, plain {pl} ms, bound {rec['bound_ms']!r} ms "
            f"({rec['bound_by']}: {rec['bytes']} B, {rec['flops']} flop); "
            f"library_ms null: no single PyTorch call computes normalized "
            f"causal linear attention or its gradient (SDPA is softmax)")
        log(f"[timing] {name} body: {rec}")
        out[name + suffix] = rec
    del qf, kf, vf
    return out


def phase_timing_softmax(torch, ptxas):
    """softmax_decode_fused at the serving shapes (rotating 8 KV caches,
    285 MB, so every call finds its cache cold in L2, as a layer's decode
    does), flash_fwd and the three backward kernels at the training
    shapes (every input larger than L2); each beside its plain version
    and one PyTorch call computing the same function (SDPA), which the
    port never calls.  The product kernels also with their achieved
    TFLOP/s beside the bound's, and ptxas's registers and spill bytes of
    every flash instantiation (from the build log)."""
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

    # the kernel and SDPA by CUDA graph replays in turns (a Python loop of
    # launches times the host's dispatch); the plain version by a loop
    loop, plain = _time_pair(
        torch, rotating(lambda q, k, v, n, m: df.softmax_decode_fused_torch(
            q, k, v, n)),
        rotating(lambda q, k, v, n, m: df.softmax_decode_fused_cuda(
            q, k, v, n)), reps=200, warm=20)
    kern, lib = _graph_time_pair(
        torch, rotating(lambda q, k, v, n, m: df.softmax_decode_fused_cuda(
            q, k, v, n)),
        rotating(lambda q, k, v, n, m: sdpa(q, k, v, attn_mask=m,
                                            enable_gqa=True)))
    live = int(sets[0][3].sum())
    it = 2
    bytes_moved = 2 * b * h * d * it + 2 * hkv * live * d * it + 4 * b
    flops = 4 * h * live * d
    out["softmax_decode_fused"] = {
        "ms": min(kern), "ms_runs": kern, "timed_by": "CUDA graph replays",
        "python_loop_ms_runs": loop, "plain_ms": min(plain),
        "plain_ms_runs": plain, "library_ms": min(lib),
        "library_ms_runs": lib,
        "library": "scaled_dot_product_attention(attn_mask=(B,1,1,S), "
                   "enable_gqa=True), by CUDA graph replays in turns",
        **_bound(bytes_moved, flops, BF16_TC_FLOP_PER_S),
        **_stream_record(df.plan_softmax_decode_fused(*sets[0][:4]), ptxas,
                         "softmax_decode_fused", paged=False)}
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
    for name in ("flash_bwd_q", "flash_bwd_kv"):
        out[name]["library_ms"] = None
    # delta = rowsum(dO o O) in f32 is one PyTorch call: vecdot of the two
    # cast to f32 (casts included), in turns with the kernel, in runs of
    # 50 (each call moves >= 134 MB, so the loop keeps the card busy)
    def vecdot():
        return torch.linalg.vecdot(do.float(), o.float(), dim=-1)

    check_close("flash_bwd_delta (cuda) vs vecdot(dO, O) in f32",
                fl.flash_bwd_delta_cuda(o, do), vecdot(), SOFTMAX_F32_REL)
    kern, lib = _time_pair(torch, vecdot,
                           lambda: fl.flash_bwd_delta_cuda(o, do), reps=50,
                           warm=3)
    out["flash_bwd_delta"].update(
        library_ms=min(lib), library_ms_runs=lib,
        in_turns_with_library_ms_runs=kern,
        library="torch.linalg.vecdot(dO.float(), O.float(), dim=-1), "
                "casts included, in turns with the kernel (runs of 50)")
    for name in ("flash_fwd", "flash_bwd_q", "flash_bwd_kv"):
        rec = out[name]
        rec["tflop_per_s"] = rec["flops"] / rec["ms"] / 1e9
        rec["bound_tflop_per_s"] = rec["flops"] / rec["bound_ms"] / 1e9
        log(f"[timing] {name} bf16: {rec['tflop_per_s']!r} TFLOP/s "
            f"achieved, {rec['bound_tflop_per_s']!r} at its bound "
            f"({rec['bound_ms']!r} ms)")
    for src in ("flash_fwd", "flash_bwd"):
        for inst in ptxas.get(src, []):
            log(f"[timing] ptxas {src}: {inst}")
    out["flash_ptxas"] = {src: ptxas.get(src, [])
                          for src in ("flash_fwd", "flash_bwd")}
    for name in ("flash_fwd", *FLASH_BWD, "flash_bwd"):
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} N={n} D={d} bf16: "
            f"{out[name]}")
    log("[timing] flash_bwd_q / flash_bwd_kv: library_ms null each: no "
        "single PyTorch call computes dq or (dk, dv) alone; the whole "
        "backward against SDPA's is under flash_bwd")
    return out


def phase_timing_paged(torch, ptxas):
    """paged_decode_fused and paged_attention at the serving shapes (every
    slot at MAX_LEN live keys, its pages shuffled over the arena; 8
    rotating arenas, 286 MB, so every call finds its pages cold in L2):
    the two kernels on the same inputs by CUDA graph replays in turns,
    each plain version by a loop, and paged_decode_fused beside the
    contiguous softmax_decode_fused on the same keys gathered into a
    contiguous cache (graph replays in turns): what the page indirection
    costs.  Each record names its body (the tile stream, from the C
    exports), its ptxas registers and spills, shared memory per block,
    the blocks an SM holds and the clusters the card holds."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import paged_attention as pg
    b, h, hkv, d = SLOTS, 16, 16, 128
    sets, contiguous = paged_sets(torch)
    live = int(sets[0][4].sum())
    live_pages = b * -(-MAX_LEN // PAGE_SIZE)
    it = 2
    # q read, o written; the live keys' K and V rows; the live table
    # entries and the lengths
    bytes_moved = (2 * b * h * d * it + 2 * hkv * live * d * it
                   + 4 * live_pages + 4 * b)
    flops = 4 * h * live * d
    graphs = paged_graph_times(torch, sets, contiguous)
    out = {}
    for name, plain in (("paged_decode_fused", df.paged_decode_fused_torch),
                        ("paged_attention", pg.paged_attention_torch)):
        kern = graphs[name]
        # the plain version alone, by two loops
        pl = [_time_loop(torch, _rotating(plain, sets), 200, 20)
              for _ in range(2)]
        out[name] = {"ms": min(kern), "ms_runs": kern,
                     "timed_by": "CUDA graph replays, paged_decode_fused "
                                 "and paged_attention in turns",
                     "plain_ms": min(pl), "plain_ms_runs": pl,
                     "library_ms": None,
                     **_bound(bytes_moved, flops, BF16_TC_FLOP_PER_S)}
    for name, plan_fn in (("paged_decode_fused", df.plan_paged_decode_fused),
                          ("paged_attention", pg.plan_paged_attention)):
        out[name].update(_stream_record(plan_fn(*sets[0]), ptxas,
                                        "paged_decode", paged=True))
    for name in out:
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} D={d} ps={PAGE_SIZE} "
            f"Pmax={PMAX} bf16, {MAX_LEN} live keys per slot: {out[name]}")
    paged = graphs["paged_decode_fused_beside_contiguous"]
    contig = graphs["softmax_decode_fused_contiguous"]
    out["paged_decode_fused"].update(
        contiguous_ms_runs=contig, paged_ms_runs_beside_contiguous=paged)
    log(f"[timing] paged_decode_fused {paged} ms against the contiguous "
        f"softmax_decode_fused {contig} ms on the same keys (graph "
        f"replays); library_ms null for both paged kernels: no single "
        f"PyTorch call attends over a paged cache (a gather and SDPA are "
        f"two calls, and the gather alone moves the whole cache)")
    del sets, contiguous
    torch.cuda.empty_cache()
    return out


def phase_timing_gla(torch, ptxas):
    """gla_decode_fused at the serving shapes (8 rotating states, cold in
    L2, as in phase_timing; the kernel and la_decode_fused on the same
    inputs timed in turns by CUDA graph replays, since a Python loop of
    launches is host-bound there) and gla_fwd, gla_bwd_q and gla_bwd_kv at the
    training shapes (bf16, the trained gate's decays), each beside its
    plain version and, in turns, beside its linear counterpart on the
    same inputs: what the gate costs.  gla_decode_fused runs the state
    stream; its record names the body, its ptxas registers and spills,
    shared memory per block and the blocks an SM holds.  gla_fwd,
    gla_bwd_q and gla_bwd_kv in bf16 run the gated instances of the
    chunked wgmma bodies (tensor-core work per chunk of c tokens, with s
    = D/2):
      * gla_fwd, per (batch, query head) and half of the value columns:
        q k^T (2 c^2 D), and twice each (a hi + lo operand) q S (2 c D
        s), A v (2 c^2 s) and the state update (2 c s D);
      * gla_bwd_q, per (batch, query head) and half of dq's columns: P =
        Ω̂ v^T twice (2 c^2 D), R = Ω̂ A^T three times (2 c s D), P k
        twice (2 c^2 s) and the update twice (2 c s D; w o v a pair);
      * gla_bwd_kv, per (batch, KV head): for each half of dk, U's
        readout twice (2 c s D) and per query head T = v Ω̂^T twice (2 c^2
        D), T q twice (2 c^2 s), the update three times (2 c s D; the
        weighted q and Ω̂ both pairs); for each half of dv, the readout
        twice and per query head S = k q^T (2 c^2 D), A Ω̂ three times (2
        c^2 s) and the update twice.
    Their records name the body, its ptxas registers and spills, shared
    memory per block and the blocks an SM holds, keep the walk's bound
    and the tensor-core and byte times beside, and time the token walk
    (which f32 inputs still run) in turns with them."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import gla
    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels.defaults import LA_CHUNK_TOKENS, LA_WGMMA_PART
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    out = {}

    b, h, hkv, d = SLOTS, 16, 16, 128
    sets = [_gla_decode_case(torch, gen, b, h, hkv, d, bf16, "trained")
            for _ in range(8)]
    # a Python loop of stream launches times the host's dispatch (~0.044
    # ms a call, over the kernel's own ~0.012): the kernel's time comes
    # from CUDA graphs of 200 launches, in turns with la_decode_fused's
    loop, plain = _time_pair(
        torch, _rotating(df.gla_decode_fused_torch, sets, (1.0, 1.0)),
        _rotating(df.gla_decode_fused_cuda, sets, (1.0, 1.0)), reps=200,
        warm=20)
    lin, kern = recurrent_graph_times(torch, sets)
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
        "ms": min(kern), "ms_runs": kern, "timed_by": "CUDA graph replays",
        "python_loop_ms_runs": loop, "plain_ms": min(plain),
        "plain_ms_runs": plain, "library_ms": None,
        "in_turns_with_la_decode_fused": {"gla_ms_runs": kern,
                                          "la_ms_runs": lin},
        **_bound(bytes_moved, flops)}
    body, launch, c_geo = _recurrent_decode_body(*sets[0])
    out["gla_decode_fused"].update(
        body=body, threads=launch.threads, smem_per_block=launch.smem,
        grid=list(launch.grid), c_plan=list(c_geo),
        ptxas=_ptxas_of(ptxas, "la_decode_fused",
                        "ds::decode_stream_kernel<__nv_bfloat16, 1, true>"),
        blocks_per_sm_fit=_blocks_per_sm(launch.threads, launch.smem,
                                         c_geo[5]),
        grid_blocks_per_sm=launch.grid[0] / SMS)
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
    qf, kf, vf = q.float(), k.float(), v.float()
    walks = {
        "gla_fwd": lambda: gla.gla_fwd_cuda(qf, kf, vf, ld, 1.0, 1.0),
        "gla_bwd_q": lambda: gla.gla_bwd_q_cuda(kf, vf, ld, om_hat, h_vec,
                                                1.0),
        "gla_bwd_kv": lambda: gla.gla_bwd_kv_cuda(qf, kf, vf, ld, om_hat,
                                                  h_vec, 1.0, 1.0)}
    c, half, group = LA_CHUNK_TOKENS, d // 2, h // hkv
    tc_flops = {
        "gla_fwd": tok_q // c * (d // LA_WGMMA_PART) * (
            2 * c * c * d + 2 * 2 * c * d * half + 2 * 2 * c * c * half
            + 2 * 2 * c * half * d),
        "gla_bwd_q": tok_q // c * 2 * (
            2 * 2 * c * c * d + 3 * 2 * c * half * d + 2 * 2 * c * c * half
            + 2 * 2 * c * half * d),
        "gla_bwd_kv": tok_kv // c * 2 * (
            2 * 2 * 2 * c * half * d
            + group * (2 * 2 * c * c * d + 2 * 2 * c * c * half
                       + 3 * 2 * c * half * d)
            + group * (2 * c * c * d + 3 * 2 * c * c * half
                       + 2 * 2 * c * half * d))}
    c_bodies = {
        name: _gla_body(name, q, k, v, ld, om_hat, h_vec)
        for name in ("gla_fwd", "gla_bwd_q", "gla_bwd_kv")}
    wgmma_fn = {"gla_fwd": ("la_fwd", "lc::la_fwd_wgmma_kernel<true>"),
                "gla_bwd_q": ("la_bwd", "bq::la_bwd_q_wgmma_kernel<true>"),
                "gla_bwd_kv": ("la_bwd", "bkv::la_bwd_kv_wgmma_kernel<true>")}
    walk_bounds = {name: _bound(*work[name]) for name in c_bodies}
    for name, (body, _, _) in c_bodies.items():
        if body == "wgmma":
            work[name] = (work[name][0], tc_flops[name], BF16_TC_FLOP_PER_S)
    for name, (plain_fn, kernel_fn, linear_fn) in calls.items():
        kern, pl = _time_pair(torch, plain_fn, kernel_fn, reps=5)
        lin, kern_b = _time_pair(torch, kernel_fn, linear_fn, reps=5)
        out[name] = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
                     "plain_ms_runs": pl, "library_ms": None,
                     "in_turns_with_linear": {"gla_ms_runs": kern_b,
                                              "la_ms_runs": lin},
                     **_bound(*work[name])}
        if name in c_bodies:
            rec = out[name]
            lib, fn = wgmma_fn[name]
            rec.update(_body_record(c_bodies[name], walk_bounds[name],
                                    ptxas.get(lib, []), fn))
            rec.update(byte_ms=rec["bytes"] / HBM_BYTES_PER_S * 1e3,
                       tensor_core_ms=tc_flops[name] / BF16_TC_FLOP_PER_S
                       * 1e3)
            walk, kern2 = _time_pair(torch, kernel_fn, walks[name], reps=5)
            rec.update(walk_ms=min(walk), walk_ms_runs=walk,
                       ms_runs_beside_walk=kern2)
        log(f"[timing] {name} B={b} H={h} Hkv={hkv} N={n} D={d} bf16: "
            f"{out[name]}")
    del qf, kf, vf
    log("[timing] gla_fwd / gla_bwd_q / gla_bwd_kv: library_ms null: no "
        "single PyTorch call computes gated linear attention or its "
        "gradient (SDPA is softmax)")
    del q, k, v, ld, om_hat, h_vec
    torch.cuda.empty_cache()
    return out


def _ssd_work(b, g, h, n, dk, dv, it):
    """(bytes, f32 flops of the token walk) of the three SSD kernels at
    these shapes (phase_timing_ssd's docstring)."""
    qk_el, v_el, tok = b * g * n * dk, b * h * n * dv, b * h * n
    return {
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


def _ssd_tc_flops(b, h, n, dk, dv):
    """The bf16 tensor-core flops of the three SSD kernels' chunked wgmma
    bodies at these shapes (phase_timing_ssd's docstring)."""
    from repro_torch.kernels.defaults import SSD_CHUNK_TOKENS, \
        SSD_FWD_PAIR_STATE_DIMS
    c = SSD_CHUNK_TOKENS
    chunks = -(-n // c)
    # ssd_fwd's q S, A v and state update twice where they take a hi + lo
    # operand
    x = 2 if (dk, dv) in SSD_FWD_PAIR_STATE_DIMS else 1
    return {
        "ssd_fwd": b * h * chunks * (2 * c * c * dk
                                     + x * (2 * c * dk * dv + 2 * c * c * dv
                                            + 2 * c * dv * dk)),
        "ssd_bwd_q": b * h * chunks * (2 * c * c * dv
                                       + 2 * (2 * c * dv * dk
                                              + 2 * c * c * dk
                                              + 2 * c * dv * dk)),
        "ssd_bwd_kv": b * h * chunks * (2 * c * c * (dv + dk)
                                        + 2 * (2 * c * dv * dk
                                               + 2 * c * c * dk
                                               + 2 * c * dk * dv
                                               + 2 * c * c * dv
                                               + 2 * c * dv * dk))}


def phase_timing_ssd(torch, ptxas):
    """ssd_fwd, ssd_bwd_q and ssd_bwd_kv and their plain versions at
    mamba2-2.7b's training shapes (bf16, as the model hands them over; a
    fresh layer's decays), in turns, beside their bounds.  Bytes: each
    input read once, each output written once.  Operations of the token
    walk (f32 on the CUDA cores): per token and head, the decayed state
    update (3 Dk Dv: a multiply and an FMA per element) and each readout
    (2 Dk Dv), i.e. 5 Dk Dv for the forward and for dq, 7 Dk Dv for dk
    and dv (the kernel's second copy of U is its own choice, not
    counted).  ssd_fwd in bf16 runs the chunked wgmma body: per chunk of
    c tokens and head its four products, q k^T, q S, A v and the state
    update, 2 c Dk (c + Dv) + 2 c Dv (c + Dk) flops on the bf16 tensor
    cores.  ssd_bwd_q in bf16 runs its chunked wgmma body: per chunk and
    head p = Ω v^T (2 c^2 Dv) and, twice each (a hi + lo operand), Ω S
    (2 c Dv Dk), W k (2 c^2 Dk) and the state update (2 c Dv Dk); it is
    also timed in turns with its token walk (f32 inputs).  ssd_bwd_kv in
    bf16 runs its chunked wgmma body: per chunk and head p = v Ω^T
    (2 c^2 Dv), s = k q^T (2 c^2 Dk), and each of the products with a
    hi + lo operand twice: e v U^T and (p o M) q (2 c Dv
    Dk and 2 c^2 Dk), e k U and (s o M) Ω (2 c Dk Dv and 2 c^2 Dv), the
    state update (2 c Dv Dk).  Each wgmma record names the body, its
    ptxas registers and spills, its shared memory per block and the
    blocks an SM holds, and keeps the walk's bound beside."""
    from repro_torch.kernels import ssd
    m = SSD_SHAPE
    b, g, h, n, dk, dv = m["b"], m["g"], m["h"], m["n"], m["dk"], m["dv"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    q, k, v, ld, om = _ssd_case(torch, gen, b, g, h, n, dk, dv,
                                torch.bfloat16, "init")
    work = _ssd_work(b, g, h, n, dk, dv, 2)
    calls = {
        "ssd_fwd": (lambda: ssd.ssd_fwd_torch(q, k, v, ld),
                    lambda: ssd.ssd_fwd_cuda(q, k, v, ld)),
        "ssd_bwd_q": (lambda: ssd.ssd_bwd_q_torch(k, v, ld, om),
                      lambda: ssd.ssd_bwd_q_cuda(k, v, ld, om)),
        "ssd_bwd_kv": (lambda: ssd.ssd_bwd_kv_torch(q, k, v, ld, om),
                       lambda: ssd.ssd_bwd_kv_cuda(q, k, v, ld, om)),
    }
    tc_flops = _ssd_tc_flops(b, h, n, dk, dv)
    wgmma_fn = {"ssd_fwd": f"sc::ssd_fwd_wgmma_kernel<{dk}, false>",
                "ssd_bwd_q": "sq::ssd_bwd_q_wgmma_kernel",
                "ssd_bwd_kv": "sk::ssd_bwd_kv_wgmma_kernel"}
    bodies = {name: _ssd_body(name, q, k, v, ld, om) for name in wgmma_fn}
    walk_bounds = {name: _bound(*work[name]) for name in wgmma_fn}
    for name, (body, _, _) in bodies.items():
        if body == "wgmma":
            work[name] = (work[name][0], tc_flops[name], BF16_TC_FLOP_PER_S)
    out = {}
    for name, (plain_fn, kernel_fn) in calls.items():
        kern, pl = _time_pair(torch, plain_fn, kernel_fn, reps=5)
        out[name] = {"ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
                     "plain_ms_runs": pl, "library_ms": None,
                     **_bound(*work[name])}
        if name in bodies:
            out[name].update(_body_record(
                bodies[name], walk_bounds[name], ptxas.get("ssd", []),
                wgmma_fn[name]))
        if name == "ssd_bwd_q":
            rec = out[name]
            rec.update(byte_ms=rec["bytes"] / HBM_BYTES_PER_S * 1e3,
                       tensor_core_ms=tc_flops[name] / BF16_TC_FLOP_PER_S
                       * 1e3)
            kf, vf, omf = k.float(), v.float(), om.float()
            walk, kern2 = _time_pair(
                torch, kernel_fn, lambda: ssd.ssd_bwd_q_cuda(kf, vf, ld, omf),
                reps=5)
            rec.update(walk_ms=min(walk), walk_ms_runs=walk,
                       ms_runs_beside_walk=kern2)
            del kf, vf, omf
        log(f"[timing] {name} B={b} G={g} H={h} N={n} Dk={dk} Dv={dv} "
            f"bf16: {out[name]}")
    log("[timing] ssd_fwd / ssd_bwd_q / ssd_bwd_kv: library_ms null: no "
        "single PyTorch call computes the SSD recurrence or its gradient")
    del q, k, v, ld, om
    torch.cuda.empty_cache()
    return out


def phase_timing_arch(torch, ptxas, arch_launches):
    """The new architectures' instantiations, each beside its plain
    version and its bound, with its launches on the main path (the arch's
    serve and train runs): la_fwd, la_bwd_q and la_bwd_kv at each arch's
    (H, Hkv, D) in bf16 (B=2, N=8192, whisper-large-v3 its train shape
    B=16, N=448; the wgmma bodies at D = 128 with G = 7, 8, 16, 48 and at
    D = 64, each with its ptxas registers and spills and the blocks an SM
    holds, the token walks at D = 112 and (192, 128)) by loops in turns
    with the plain versions; la_decode_fused at each arch's serving shape
    (ARCH_SLOTS slots, bf16) by CUDA graph replays in turns with the
    pythia serving shape's (row 3), rotating over enough states to exceed
    the 50 MB L2; the SSD kernels at zamba2-7b's (64, 64) (ssd_fwd's
    chunked body, the backward's token walks).  la_bwd_kv's records name
    the split of the query group (S slices, the heads of the largest, no
    cluster); ssd_fwd's its registers, spills and the blocks an SM
    holds.
    Each bf16 case is bounded by the function, whatever body
    runs it: bytes at 3.35 TB/s against the chunked bodies' bf16
    operations (`_la_tc_flops`, `_ssd_tc_flops`; where no chunked body
    runs, the chunked form's, `_la_chunk_flops`) at 989 TFLOP/s; the
    token walk's own f32 operations at 67 TFLOP/s are kept beside as
    `walk_bound`, a bound of that algorithm, not of the function."""
    from repro_torch.kernels import decode_fused as df
    from repro_torch.kernels import linear_attention as la
    from repro_torch.kernels import ssd
    from repro_torch.kernels.defaults import LA_WGMMA_HEAD_DIMS
    gen = torch.Generator(device="cuda")
    gen.manual_seed(23)
    # the wgmma bodies' instantiations, by kernel: (library, name prefix)
    wgmma_fn = {"la_fwd": ("la_fwd", "lc::la_fwd_wgmma_kernel<{}, false>"),
                "la_bwd_q": ("la_bwd", "bq::la_bwd_q_wgmma_kernel<{}, false>"),
                "la_bwd_kv": ("la_bwd",
                              "bkv::la_bwd_kv_wgmma_kernel<{}, false>")}
    bf16 = torch.bfloat16
    out = {}
    for arch in TIMED_ARCHS:
        b, n = LA_TIMING_BN.get(arch, (LA_SHAPE["b"], LA_SHAPE["n"]))
        h, hkv, d, dv = _la_arch_shape(arch)
        serve_l, train_l = arch_launches[arch]
        q, k, v, om_hat, h_vec = _la_case(torch, gen, b, h, hkv, n, d, bf16,
                                          dv=dv)
        work = _la_work(b, h, hkv, n, d, q.element_size(), dv)
        tc = (_la_tc_flops(b, h, hkv, n, d)
              if dv is None and d in LA_WGMMA_HEAD_DIMS
              else _la_chunk_flops(b, h, hkv, n, d, dv or d))
        bodies = {"la_fwd": _la_fwd_body(q, k, v),
                  **{e: _la_bwd_body(e, q, k, v, om_hat, h_vec)
                     for e in ("la_bwd_q", "la_bwd_kv")}}
        calls = {
            "la_fwd": (lambda: la.la_fwd_torch(q, k, v, 1.0, 1.0),
                       lambda: la.la_fwd_cuda(q, k, v, 1.0, 1.0)),
            "la_bwd_q": (lambda: la.la_bwd_q_torch(k, v, om_hat, h_vec, 1.0),
                         lambda: la.la_bwd_q_cuda(k, v, om_hat, h_vec, 1.0)),
            "la_bwd_kv": (lambda: la.la_bwd_kv_torch(q, k, v, om_hat, h_vec,
                                                     1.0, 1.0),
                          lambda: la.la_bwd_kv_cuda(q, k, v, om_hat, h_vec,
                                                    1.0, 1.0))}
        for name, (plain, kernel) in calls.items():
            body, launch, c_geo = bodies[name]
            kern, pl = _time_pair(torch, plain, kernel, reps=3)
            rec = {"arch": arch, "shape": dict(b=b, h=h, hkv=hkv, n=n, d=d,
                                               dv=dv or d,
                                               dtype="bfloat16"),
                   "ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
                   "plain_ms_runs": pl, "library_ms": None,
                   **_bound(work[name][0], tc[name], BF16_TC_FLOP_PER_S),
                   "walk_bound": _bound(*work[name]),
                   "body": body, "threads": launch.threads,
                   "smem_per_block": launch.smem, "grid": list(launch.grid),
                   "c_plan": list(c_geo), "launches": train_l.get(name, 0)}
            if body == "wgmma":
                lib, fn = wgmma_fn[name]
                rec.update(ptxas=_ptxas_of(ptxas, lib, fn.format(d)),
                           blocks_per_sm_fit=_blocks_per_sm(
                               launch.threads, launch.smem, c_geo[5]))
            if name == "la_bwd_kv":
                rec["split"] = _kv_split(q, k, v, om_hat, h_vec)
            log(f"[timing arch] {name} {arch} (B={b} H={h} Hkv={hkv} N={n} "
                f"Dk={d} Dv={dv or d} bf16, {body}): {rec}")
            out[f"{name}@{arch}"] = rec
        del q, k, v, om_hat, h_vec
        torch.cuda.empty_cache()

    main_sets = [x[:5] for x in decode_state_sets(torch)]
    main_fn = _rotating(df.la_decode_fused_cuda, main_sets, (1.0, 1.0))
    for arch in TIMED_ARCHS:
        h, hkv, d, dv = _la_arch_shape(arch)
        serve_l = arch_launches[arch][0]
        state_bytes = ARCH_SLOTS * hkv * d * ((dv or d) + 1) * 4
        n_sets = max(8, -(-64 * 2 ** 20 // state_bytes))
        sets = [_decode_case(torch, gen, ARCH_SLOTS, h, hkv, d, bf16, dv=dv)
                for _ in range(n_sets)]
        kern, main = _graph_time_pair(
            torch, _rotating(df.la_decode_fused_cuda, sets, (1.0, 1.0)),
            main_fn)
        plain = [_time_loop(torch, _rotating(df.la_decode_fused_torch, sets,
                                             (1.0, 1.0)), 50, 5)
                 for _ in range(2)]
        body, launch, c_geo = _recurrent_decode_body(*sets[0])
        rec = {"arch": arch, "shape": dict(b=ARCH_SLOTS, h=h, hkv=hkv, d=d,
                                           dv=dv or d, dtype="bfloat16"),
               "ms": min(kern), "ms_runs": kern,
               "timed_by": "CUDA graph replays",
               "row3_shape_ms_runs_in_turns": main,
               "rotating_states": n_sets, "plain_ms": min(plain),
               "plain_ms_runs": plain, "library_ms": None,
               **_bound(*_decode_work(ARCH_SLOTS, h, hkv, d, 2, dv)),
               "body": body, "threads": launch.threads,
               "smem_per_block": launch.smem, "grid": list(launch.grid),
               "c_plan": list(c_geo),
               "ptxas": _ptxas_of(ptxas, "la_decode_fused",
                                  f"ds::decode_stream_kernel<__nv_bfloat16, "
                                  f"{h // hkv}, false>"),
               "launches": serve_l.get("la_decode_fused", 0)}
        log(f"[timing arch] la_decode_fused {arch}: {rec}")
        out[f"la_decode_fused@{arch}"] = rec
        del sets
    del main_sets

    z = SSD_ZAMBA2_SHAPE
    b, g, h, n, dk, dv = z["b"], z["g"], z["h"], z["n"], z["dk"], z["dv"]
    q, k, v, ld, om = _ssd_case(torch, gen, b, g, h, n, dk, dv, bf16,
                                "init")
    work = _ssd_work(b, g, h, n, dk, dv, 2)
    tc = _ssd_tc_flops(b, h, n, dk, dv)
    train_l = arch_launches["zamba2-7b"][1]
    calls = {
        "ssd_fwd": (lambda: ssd.ssd_fwd_torch(q, k, v, ld),
                    lambda: ssd.ssd_fwd_cuda(q, k, v, ld)),
        "ssd_bwd_q": (lambda: ssd.ssd_bwd_q_torch(k, v, ld, om),
                      lambda: ssd.ssd_bwd_q_cuda(k, v, ld, om)),
        "ssd_bwd_kv": (lambda: ssd.ssd_bwd_kv_torch(q, k, v, ld, om),
                       lambda: ssd.ssd_bwd_kv_cuda(q, k, v, ld, om))}
    for name, (plain, kernel) in calls.items():
        body, launch, c_geo = _ssd_body(name, q, k, v, ld, om)
        kern, pl = _time_pair(torch, plain, kernel, reps=3)
        rec = {"arch": "zamba2-7b", "shape": dict(z, dtype="bfloat16"),
               "ms": min(kern), "ms_runs": kern, "plain_ms": min(pl),
               "plain_ms_runs": pl, "library_ms": None,
               **_bound(work[name][0], tc[name], BF16_TC_FLOP_PER_S),
               "walk_bound": _bound(*work[name]),
               "body": body, "threads": launch.threads,
               "smem_per_block": launch.smem, "grid": list(launch.grid),
               "c_plan": list(c_geo), "launches": train_l.get(name, 0)}
        if body == "wgmma":
            rec.update(ptxas=_ptxas_of(ptxas, "ssd",
                                       f"sc::ssd_fwd_wgmma_kernel<{dk}, "),
                       blocks_per_sm_fit=_blocks_per_sm(
                           launch.threads, launch.smem, c_geo[5]),
                       grid_blocks_per_sm=launch.grid[0] / SMS)
        log(f"[timing arch] {name} zamba2-7b ({body}): {rec}")
        out[f"{name}@zamba2-7b"] = rec
    del q, k, v, ld, om
    torch.cuda.empty_cache()
    return out


def phase_timing_fixture(torch):
    """The fixture kernel at n = 2^24 f32, block 256, its last block
    reading the block after x in one allocation, beside its plain version
    and `Tensor.copy_` of the shifted slice (the one PyTorch call for the
    same function), in turns; bound: 64 MiB read and 64 MiB written.
    Runs of 200 launches, as the decode kernels' (the first launch of a
    run waits on the host, which is ~0.5 % of a run of 50 of these
    0.048 ms calls)."""
    from repro_torch.check import fixtures
    n, block = 1 << 24, 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    buf = torch.randn(n + block, device="cuda", generator=gen)
    x, out = buf[:n], torch.empty(n, device="cuda")
    kern, plain = _time_pair(
        torch, lambda: fixtures.oob_blocked_sum_torch(buf, 0, n, block),
        lambda: fixtures.oob_blocked_sum_cuda(x, block), reps=200, warm=3)
    kern2, lib = _time_pair(torch,
                            lambda: out.copy_(buf[block:n + block]),
                            lambda: fixtures.oob_blocked_sum_cuda(x, block),
                            reps=200, warm=3)
    rec = {"ms": min(kern + kern2), "ms_runs": kern + kern2,
           "plain_ms": min(plain), "plain_ms_runs": plain,
           "library_ms": min(lib), "library_ms_runs": lib,
           **_bound(2 * n * 4, 0)}
    log(f"[timing] oob_blocked_sum n={n} block={block} f32: {rec}")
    del buf, x, out
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import numpy as np
    import torch

    start = time.perf_counter()

    def mark(label):
        """Seconds since the start, to find what to cut when the script
        nears its time limit."""
        log(f"[time] {label}: {time.perf_counter() - start!r} s")

    name, smi = phase_device(torch)
    build_s, ptxas = phase_build()
    mark("build")
    check, check_launches = phase_check(torch)
    kernel_errs = phase_kernel(torch)
    la_errs = phase_kernel_la(torch)
    softmax_errs = phase_kernel_softmax(torch)
    paged_errs = phase_kernel_paged(torch)
    gla_errs = phase_kernel_gla(torch)
    ssd_errs = phase_kernel_ssd(torch)
    mark("check and kernel")
    serve, serve_launches, tokens = phase_serve(torch, np, "linear")
    serve_sm, serve_sm_launches, tokens_sm = phase_serve(torch, np,
                                                         "softmax")
    serve_pg, serve_pg_launches, serve_pgu_launches, tokens_pg = \
        phase_serve_paged(torch, np)
    serve_gla, serve_gla_launches, _ = phase_serve(torch, np, "gla")
    serve_glp, serve_glp_launches, tokens_glp = phase_serve_gla_paged(
        torch, np)
    serve_pre, serve_pre_launches = phase_serve_preempt(
        torch, np, {"linear": tokens, "softmax": tokens_sm,
                    "softmax_paged": tokens_pg, "gla_paged": tokens_glp},
        smi)
    serve_m2, serve_m2_launches, _ = phase_serve(torch, np, "mamba2")
    mark("serve")
    serve_archs = {arch: phase_arch_serve(torch, np, arch)
                   for arch in ARCHS + MOE_ARCHS}
    serve_archs[ENCDEC] = phase_encdec_serve(torch)
    mark("serve archs")
    smoke_errs = {arch: phase_smoke_reference(torch, arch)
                  for arch in ("pythia-1.4b", "mamba2-2.7b", *ARCHS,
                               *MOE_ARCHS, ENCDEC)}
    torch.cuda.empty_cache()
    mark("smoke")
    train, train_launches = phase_train(torch, "linear")
    mark("train linear")
    resume, resume_launches = phase_train_resume(torch, np, smi)
    mark("train resume")
    train_sm, train_sm_launches = phase_train(torch, "softmax")
    train_gla, train_gla_launches = phase_train(torch, "gla")
    train_m2, train_m2_launches = phase_train(torch, "mamba2")
    mark("train")
    every_arch = ARCHS + MOE_ARCHS + (ENCDEC,)
    train_archs = {arch: phase_arch_train(torch, arch)
                   for arch in every_arch}
    arch_launches = {arch: (serve_archs[arch][1], train_archs[arch][1])
                     for arch in every_arch}
    mark("train archs")
    timing = {"la_decode_fused": phase_timing(torch, ptxas),
              **phase_timing_la(torch, ptxas),
              **phase_timing_softmax(torch, ptxas),
              **phase_timing_paged(torch, ptxas),
              **phase_timing_gla(torch, ptxas),
              **phase_timing_ssd(torch, ptxas),
              "oob_blocked_sum": phase_timing_fixture(torch)}
    timing_arch = phase_timing_arch(torch, ptxas, arch_launches)
    mark("timing")

    # each kernel's launches summed over the main-path runs (every other
    # run left it at 0, expect_launches checked)
    runs = (serve_launches, serve_sm_launches, serve_pg_launches,
            serve_pgu_launches, serve_gla_launches, serve_glp_launches,
            *serve_pre_launches, serve_m2_launches, train_launches,
            *resume_launches,
            train_sm_launches, train_gla_launches, train_m2_launches,
            *(x for pair in arch_launches.values() for x in pair))
    launches = {k: sum(r[k] for r in runs) for k in KERNELS}
    # the fixture's: those of the check path
    launches["oob_blocked_sum"] = check_launches["oob_blocked_sum"]
    max_err = {"la_decode_fused": kernel_errs["main_bf16"],
               **la_errs["main_bf16"],
               **softmax_errs["decode_main_bf16"],
               **softmax_errs["flash_main_bf16"],
               **paged_errs["paged_main_bf16"],
               **gla_errs["decode_main_bf16"],
               **{k: v for k, v in gla_errs["main_bf16"].items()
                  if k in KERNELS},
               **{k: v for k, v in ssd_errs["main_bf16"].items()
                  if k in KERNELS},
               "oob_blocked_sum": check["fixture_max_abs_err"]}
    kernels = {"kernels": [{
        "name": kname, "route": "cuda", "source": KERNELS[kname][0],
        "replaces": KERNELS[kname][1], "launches": launches[kname],
        "max_abs_err": max_err[kname], "ms": timing[kname]["ms"],
        "plain_ms": timing[kname]["plain_ms"],
        "bound_ms": timing[kname]["bound_ms"],
        "bound_by": timing[kname]["bound_by"],
        "library_ms": timing[kname].get("library_ms")} for kname in KERNELS]}
    for rec in (serve, serve_sm, serve_pg, serve_gla, serve_glp, serve_m2,
                train, train_sm, train_gla, train_m2,
                *(serve_archs[a][0] for a in every_arch),
                *(train_archs[a][0] for a in every_arch)):
        rec["card"] = smi
    print(json.dumps({"serve": serve, "serve_softmax": serve_sm,
                      "serve_softmax_paged": serve_pg,
                      "serve_gla": serve_gla, "serve_gla_paged": serve_glp,
                      "serve_preempt": serve_pre,
                      "serve_mamba2": serve_m2,
                      "train": train, "train_resume": resume,
                      "train_softmax": train_sm,
                      "train_gla": train_gla, "train_mamba2": train_m2,
                      "serve_archs": {a: serve_archs[a][0]
                                      for a in every_arch},
                      "train_archs": {a: train_archs[a][0]
                                      for a in every_arch},
                      "timing_arch": timing_arch,
                      "build_s": build_s, "ptxas": ptxas, "check": check,
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
