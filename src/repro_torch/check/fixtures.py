"""Seeded-defect fixtures: one deliberately broken kernel per analyzer
(port of `repro/check/fixtures.py`).

These are the analyzer's own regression tests (tests/test_torch_check.py,
and `chip_smoke.py` on the card): each fixture violates exactly one
contract and the corresponding audit must report exactly that rule ID,
as the reference's fixtures do.  They are NOT registered in
`kernels/ops.py`.

  oob_blocked_sum        a hand-written CUDA kernel
                         (kernels/csrc/check_fixture.cu) whose grid steps
                         copy x[(i+1) block + e] into o[i block + e], so the
                         last step reads one block past x -> REPRO-B001,
                         from its launch plan and, on the card, from a
                         guard band
  quadratic_residual     an autograd Function saving the (N, N) attention
                         matrix -> REPRO-J001
  unguarded_bf16_matmul  a bf16 x bf16 -> bf16 matmul -> REPRO-J002

The fixture kernel's wrapper is `oob_blocked_sum_cuda(x, block)` (CUDA
tensors only; it counts its launches in `launches`), its plain version
`oob_blocked_sum_torch(buf, offset, n, block)`, which reads the same
elements of the same allocation, and its plan `plan_oob_blocked_sum`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.check import autograd_audit, bounds
from repro_torch.check.findings import Finding
from repro_torch.kernels import build, plan

F32 = torch.float32
LIB = "check_fixture"
KERNEL = "oob_blocked_sum"

# kernel launches made by `oob_blocked_sum_cuda` (a run sets it to 0 and
# reads it back to show that its check went through the kernel)
launches = {KERNEL: 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {KERNEL: [_P, _P, _I, _I, _P]}
# the kernel's block, as csrc/check_fixture.cu: threads a CUDA block,
# float4 loads in flight per thread, and the floats of a run of grid steps
_THREADS = 256
_LOADS = 4
_RUN_FLOATS = _THREADS * _LOADS * 4


# ---------------------------------------------------------------------------
# REPRO-B001: a block that reads one block too far
# ---------------------------------------------------------------------------

def oob_blocked_sum_torch(buf, offset: int, n: int, block: int):
    """Plain version: o (n,) with o[i block + t] = buf[offset + (i+1) block
    + t] for the n // block blocks (the rest 0), reading the same elements
    of the same 1-D allocation `buf` as the kernel reads from the view of
    n elements at `offset`; raises IndexError where they lie past buf."""
    steps = n // block
    start, stop = offset + block, offset + (steps + 1) * block
    if offset < 0 or stop > buf.numel():
        raise IndexError(f"{KERNEL} reads buf[{start}:{stop}] of an "
                         f"allocation of {buf.numel()} elements")
    o = torch.empty(n, dtype=buf.dtype, device=buf.device)
    o[:steps * block] = buf[start:stop]
    o[steps * block:] = 0
    return o


def oob_blocked_sum_cuda(x, block: int):
    """Launch the fixture kernel on a 1-D float32 CUDA tensor x (block a
    multiple of 4, at most n): o (n,), zero where no grid step writes.
    The last step reads x[n : n + block], past x: x should be a view
    inside a larger allocation."""
    build.check_tensors(KERNEL, {"x": x}, ("x",))
    if x.dim() != 1 or x.dtype != F32:
        raise ValueError(f"x must be 1-D float32; got {tuple(x.shape)} "
                         f"{x.dtype}")
    _check_block(x, block)
    lib = build.bind(LIB, _SYMBOLS)
    o = torch.empty_like(x)
    tail = x.numel() % block
    if tail:
        o[-tail:] = 0   # the tail no block writes
    with torch.cuda.device(x.device):
        err = lib.oob_blocked_sum(x.data_ptr(), o.data_ptr(), x.numel(),
                                  block, build.current_stream(x.device))
    build.raise_on(lib, LIB, KERNEL, err)
    launches[KERNEL] += 1
    return o


def oob_blocked_sum(x, block: int = 16):
    """The fixture on x's device: the kernel on a CUDA tensor; on a CPU
    tensor the plain version over x's whole storage, so that it reads past
    x as the kernel does (and raises where that is past the storage)."""
    if x.device.type == "cuda":
        return oob_blocked_sum_cuda(x, block)
    storage = torch.tensor([], dtype=x.dtype).set_(x.untyped_storage())
    return oob_blocked_sum_torch(storage, x.storage_offset(), x.numel(),
                                 block)


def _check_block(x, block: int) -> None:
    if block <= 0 or block % 4:
        raise ValueError(f"{KERNEL}: block {block} is not a positive "
                         f"multiple of 4 (the kernel copies float4s)")
    if x.numel() < block:
        raise ValueError(f"{KERNEL}: n = {x.numel()} < block {block}: no "
                         f"grid step")


def _steps_of(blk, steps: int, run: int):
    """Grid steps [first, last) of CUDA block blk (x, y, z): runs of `run`
    steps over the first steps - 1, then the last step alone."""
    if blk[0] == -(-(steps - 1) // run):
        return steps - 1, steps
    return blk[0] * run, min((blk[0] + 1) * run, steps - 1)


def plan_oob_blocked_sum(x, block: int = 16) -> plan.Launch:
    """n // block grid steps in runs of _RUN_FLOATS // block (at least 1),
    one CUDA block of 256 threads each, the last step alone in the last
    block; a block taking steps [first, last) reads x[(first+1) block :
    (last+1) block] and writes o[first block : last block]."""
    _check_block(x, block)
    n = x.numel()
    steps, run = n // block, max(1, _RUN_FLOATS // block)

    def x_rows(blk):
        first, last = _steps_of(blk, steps, run)
        return plan.box(((first + 1) * block, (last + 1) * block))

    def o_rows(blk):
        first, last = _steps_of(blk, steps, run)
        return plan.box((first * block, last * block))

    return plan.make(KERNEL, LIB, (-(-(steps - 1) // run) + 1,), _THREADS,
                     0, [plan.Access("x", "in", (n,), F32, x_rows),
                         plan.Access("o", "out", (n,), F32, o_rows)],
                     (n, block), _SYMBOLS[KERNEL], (n, block, 0))


def audit_oob_fixture() -> list[Finding]:
    """The static half: the plan, proved as every kernel's is."""
    return bounds.check_launch(plan_oob_blocked_sum(torch.zeros(64), 16))


def guarded_oob_input(n: int = 64, device="cuda", guard=float("nan")):
    """x = 0, 1, ..., n-1 as a view inside a guard-banded allocation whose
    guards hold `guard` (NaN: the bounds pass's input guard)."""
    g = bounds.guard_band((n,), F32, "in", device,
                          torch.arange(n, dtype=F32))
    if not math.isnan(guard):   # the same layout, guards set to `guard`
        g.buf[:g.guard] = guard
        g.buf[g.guard + n:] = guard
        g.fill = guard
    return g


def audit_oob_fixture_on_card(n: int = 64, block: int = 16,
                              device="cuda") -> list[Finding]:
    """The card half: the kernel through its wrapper on x inside a NaN
    guard band, against the plain version on the same layout with finite
    guards (no NaN to read)."""
    g = guarded_oob_input(n, device)
    got = oob_blocked_sum_cuda(g.view, block)
    torch.cuda.synchronize(device)
    clean = guarded_oob_input(n, device, guard=0.0)
    want = oob_blocked_sum_torch(clean.buf, clean.guard, n, block)
    findings = bounds.nan_reads(f"{KERNEL}[o] @ ({n},)", got, want)
    if not g.guards_intact():
        findings.append(Finding("REPRO-B001", f"{KERNEL}[x] @ ({n},)",
                                "the guard band changed"))
    return findings


# ---------------------------------------------------------------------------
# REPRO-J001: an O(N^2) residual
# ---------------------------------------------------------------------------

class _QuadraticResidual(torch.autograd.Function):
    """Causal q k^T v that saves the full (N, N) attention matrix as a
    residual: the memory blow-up the paper's recurrence avoids."""

    @staticmethod
    def forward(ctx, q, k, v):
        att = torch.tril(q.float() @ k.float().T)
        ctx.save_for_backward(q, k, v, att)
        return (att @ v.float()).to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, att = ctx.saved_tensors
        do = do.float()
        datt = torch.tril(do @ v.float().T)
        return ((datt @ k.float()).to(q.dtype),
                (datt.T @ q.float()).to(k.dtype),
                (att.T @ do).to(v.dtype))


def quadratic_residual(q, k, v):
    return _QuadraticResidual.apply(q, k, v)


def audit_quadratic_residual_fixture() -> list[Finding]:
    def make_args(n):
        return tuple(torch.zeros(n, 16, requires_grad=True)
                     for _ in range(3))
    return autograd_audit.residual_growth_findings(
        quadratic_residual, make_args, "fixtures.quadratic_residual")


# ---------------------------------------------------------------------------
# REPRO-J002: unguarded bf16 accumulation
# ---------------------------------------------------------------------------

def unguarded_bf16_matmul(a, b):
    """bf16 x bf16 -> bf16: the result keeps ~8 bits of mantissa."""
    return a @ b


def audit_bf16_fixture() -> list[Finding]:
    args = (torch.zeros(32, 32, dtype=torch.bfloat16),
            torch.zeros(32, 32, dtype=torch.bfloat16))
    return autograd_audit.precision_findings(
        unguarded_bf16_matmul, args, "fixtures.unguarded_bf16_matmul")
