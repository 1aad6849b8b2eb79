"""Launch-bounds proofs for every CUDA kernel entry of the port (B001-B005).

The port's counterpart of `repro/check/bounds.py`.  A CUDA kernel computes
its own offsets from its block index, so there is no BlockSpec to record:
instead each entry has a launch plan beside its wrapper (kernels/plan.py,
`plan_<entry>` in kernels/*.py), a pure function of the wrapper's shapes
giving the grid, the threads, the dynamic shared memory and, per operand,
the element ranges every block touches.  The drivers below build operands
at adversarial shapes (odd N, GQA groups, continuation `q_offset` per slot
including 0, ragged lengths including an empty slot, page tables with the
sink page), at the reference's small widths and at a registry model's full
widths, and every plan is checked exhaustively:

  REPRO-B001  every unmasked tile of every block lies inside its
              operand's extent.  Gathered operands (page tables, lengths,
              q_offset) reach the tiles as NUMPY arrays, so a walk off a
              table raises and is reported here.
  REPRO-B002  the blocks' output tiles cover every output element (and
              every element of a scratch operand: the partials a split
              launch sums).
  REPRO-B003  a tile that crosses its extent (a partial tile) is declared
              masked: the kernel guards it.
  REPRO-B004  per-block resources fit the H100: dynamic shared memory
              within the launcher's limit (else the launcher refuses the
              launch), threads <= 1024, grid y and z <= 65,535.

On the card (device "cuda") two more things happen for every driver case:

  * the plan is held against the launcher's own C export `<lib>_plan`
    (REPRO-B005 where they differ), which also gives the registers per
    thread and the static shared memory of the instantiation the launch
    runs: B004 adds registers x threads <= 65,536 (and the share of the
    SM's four schedulers: at most 16,384 on the one with the most warps)
    and static + dynamic shared memory <= 232,448 B;
  * the entry is launched through its C interface with every operand a
    view inside a guard-banded allocation: float input guards hold NaN,
    output and in-out guards a sentinel, integer operands 0 (a legal page
    and length, so a stray read cannot trap).  A guard that changes is a
    B001 write; a NaN in an output where the plain version on unguarded
    inputs has none is a B001 read; an output element left at the
    sentinel is a B002 dropped tail.
"""
from __future__ import annotations

import ctypes
import dataclasses
import inspect
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.check.findings import Finding
from repro_torch.device import resolve_device
from repro_torch.kernels import build, plan
from repro_torch.kernels import decode_fused as df
from repro_torch.kernels import flash_attention as fl
from repro_torch.kernels import gla
from repro_torch.kernels import linear_attention as la
from repro_torch.kernels import paged_attention as pg
from repro_torch.kernels import ssd

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
SENTINEL = -2.0 ** 127       # exact in f32 and bf16; no kernel writes it
GUARD_MIN = 4096             # guard elements on each side, at least


# ---------------------------------------------------------------------------
# Static proof of one plan
# ---------------------------------------------------------------------------

def _quarter_registers(regs: int, threads: int) -> int:
    """Registers one of the SM's four schedulers must hold for a block:
    its warps are spread over the four, each with a quarter of the
    register file, and a warp takes its registers in units of 8 a thread
    (so 9 warps of 216 registers do not fit though 288 x 216 < 65,536)."""
    warps = -(-threads // 32)
    return -(-warps // 4) * (-(-regs // 8) * 8) * 32


def resource_findings(launch: plan.Launch, regs=None,
                      static_smem=None) -> list[Finding]:
    """REPRO-B004 for one launch; `regs` and `static_smem` come from the C
    export on the card."""
    gx, gy, gz = launch.grid
    problems = []
    if launch.smem > launch.smem_limit:
        problems.append(f"dynamic shared memory {launch.smem} B > the "
                        f"launcher's limit {launch.smem_limit} B (stage "
                        f"{launch.stage}): the launch is refused")
    if not 1 <= launch.threads <= plan.MAX_THREADS:
        problems.append(f"{launch.threads} threads per block")
    if not (1 <= gx <= plan.MAX_GRID_X and 1 <= gy <= plan.MAX_GRID_YZ
            and 1 <= gz <= plan.MAX_GRID_YZ):
        problems.append(f"grid {launch.grid}")
    if regs is not None and regs * launch.threads > plan.REGISTERS_PER_SM:
        problems.append(f"{regs} registers x {launch.threads} threads > "
                        f"{plan.REGISTERS_PER_SM}")
    elif regs is not None and _quarter_registers(regs, launch.threads) > \
            plan.REGISTERS_PER_SM // 4:
        problems.append(f"{regs} registers x {launch.threads} threads do "
                        f"not fit the SM's four schedulers: "
                        f"{_quarter_registers(regs, launch.threads)} > "
                        f"{plan.REGISTERS_PER_SM // 4} on one")
    if static_smem is not None and \
            launch.smem + static_smem > plan.MAX_SMEM:
        problems.append(f"static {static_smem} + dynamic {launch.smem} B "
                        f"of shared memory > {plan.MAX_SMEM} B")
    return [Finding("REPRO-B004", launch.name, p) for p in problems]


def _access_findings(launch: plan.Launch, access: plan.Access,
                     gathered: list) -> list[Finding]:
    """B001/B003 for one operand, and B002 coverage where it is written."""
    where = f"{launch.name}[{access.name}] @ {access.shape}"
    written = access.role in ("out", "inout", "scratch")
    covered = np.zeros(access.shape, bool) if written else None
    for blk in launch.blocks():
        try:
            tiles = access.tile(blk, *gathered)
        except IndexError as e:
            return [Finding("REPRO-B001", where,
                            f"gather out of bounds at block {blk}: {e}")]
        for t in tiles:
            if len(t.ranges) != len(access.shape):
                return [Finding("REPRO-B001", where,
                                f"tile rank {len(t.ranges)} != operand rank "
                                f"{len(access.shape)} at block {blk}")]
            live = [(lo, hi, ext) for (lo, hi), ext
                    in zip(t.ranges, access.shape)]
            if any(hi <= lo for lo, hi, _ in live):
                continue
            outside = [d for d, (lo, hi, ext) in enumerate(live)
                       if lo < 0 or (not t.masked and hi > ext)]
            partial = [d for d, (lo, hi, ext) in enumerate(live)
                       if not t.masked and lo < ext < hi]
            found = []
            if outside:
                found.append(Finding(
                    "REPRO-B001", where,
                    f"block {blk} touches {t.ranges} outside extent "
                    f"{access.shape} in dims {outside}"))
            if partial:
                found.append(Finding(
                    "REPRO-B003", where,
                    f"block {blk}'s tile {t.ranges} crosses extent "
                    f"{access.shape} in dims {partial} and is not masked"))
            if found:
                return found
            if written:
                covered[tuple(slice(max(lo, 0), min(hi, ext))
                              for lo, hi, ext in live)] = True
    if written and not covered.all():
        return [Finding("REPRO-B002", where,
                        f"grid {launch.grid} writes {int(covered.sum())} of "
                        f"{covered.size} elements (dropped tail)")]
    return []


def check_launch(launch: plan.Launch, gathered: dict | None = None
                 ) -> list[Finding]:
    """B001-B004 for one plan; `gathered` maps the names in
    `launch.gathered` to numpy arrays."""
    values = [np.asarray(gathered[name]) for name in launch.gathered]
    findings = resource_findings(launch)
    for access in launch.accesses:
        findings += _access_findings(launch, access, values)
    return findings


# ---------------------------------------------------------------------------
# Driver cases
# ---------------------------------------------------------------------------

def _accepted(fn, args: dict) -> dict:
    params = inspect.signature(fn).parameters
    return {k: v for k, v in args.items() if k in params}


@dataclasses.dataclass
class Case:
    """One call of one entry: its plan and plain version, both called with
    the wrapper's arguments (`args`: CPU tensors and scalars)."""

    width: str          # "small" (the reference's widths) or a model's
    plan: Callable
    plain: Callable
    args: dict

    def launch(self) -> plan.Launch:
        return self.plan(**_accepted(self.plan, self.args))

    def gathered(self, launch: plan.Launch) -> dict:
        return {name: self.args[name].numpy() for name in launch.gathered}


class _Data:
    """Seeded operands (numpy, then torch)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def normal(self, *shape, dtype=F32):
        return torch.from_numpy(
            self.rng.standard_normal(shape).astype(np.float32)).to(dtype)

    def decay(self, *shape):
        return -torch.from_numpy(np.abs(
            self.rng.standard_normal(shape)).astype(np.float32)) * 0.1

    def positive(self, *shape):
        return self.normal(*shape).abs() + 1.0


def _ints(values) -> torch.Tensor:
    return torch.tensor(values, dtype=I32)


# the widths of each driver: the reference's small ones (head dims raised
# to the kernels' smallest instantiation, 32) and registry models': pythia
# and mamba2, qwen2-vl-7b's group of 7 (28 query heads on 4 KV heads),
# granite-20b's group of 48 query heads on one KV head, stablelm-1.6b's
# head dim 64 (the linear entries' chunked bodies at D = 64),
# zamba2-7b's shared attention (head dim 112) and Mamba-2 layers (64, 64)
# and deepseek-v2-236b's MLA heads (Dk = 192 for q and k, Dv = 128; `d`
# is Dk, `dv` Dv where they differ)
WIDTHS = {
    "small": dict(h=4, hkv=2, d=32, dtype=F32),
    "pythia-1.4b": dict(h=16, hkv=16, d=128, dtype=BF16),
    "qwen2-vl-7b": dict(h=28, hkv=4, d=128, dtype=BF16),
    "granite-20b": dict(h=48, hkv=1, d=128, dtype=BF16),
    "stablelm-1.6b": dict(h=32, hkv=32, d=64, dtype=BF16),
    "zamba2-7b": dict(h=32, hkv=32, d=112, dtype=BF16),
    "deepseek-v2-236b": dict(h=128, hkv=128, d=192, dv=128, dtype=BF16),
}
SSD_WIDTHS = {
    "small": dict(g=2, h=4, dk=16, dv=32, dtype=F32),
    "mamba2-2.7b": dict(g=1, h=80, dk=128, dv=64, dtype=BF16),
    "zamba2-7b": dict(g=1, h=112, dk=64, dv=64, dtype=BF16),
}
# the models' widths each family is driven at beside the small ones: the
# linear entries and the linear decode step also at qwen2-vl-7b's,
# granite-20b's, zamba2-7b's and deepseek-v2-236b's, the linear entries
# at stablelm-1.6b's, the gated decode
# step at qwen2-vl-7b's group too (their kernels take these shapes; gla,
# softmax and paging do not take zamba2's head dim, nor softmax
# qwen2-vl's or granite's group, nor any of them MLA's (192, 128))
FULL_WIDTHS = {"ssd": ("mamba2-2.7b", "zamba2-7b"),
               "linear": ("pythia-1.4b", "qwen2-vl-7b", "granite-20b",
                          "stablelm-1.6b", "zamba2-7b", "deepseek-v2-236b"),
               "linear_decode_fused": ("pythia-1.4b", "qwen2-vl-7b",
                                       "granite-20b", "zamba2-7b",
                                       "deepseek-v2-236b"),
               "gla_decode_fused": ("pythia-1.4b", "qwen2-vl-7b")}


def _linear_cases(width, gated):
    w = WIDTHS[width]
    r = _Data(1)
    b, n = 2, 50 if width == "small" else 130
    h, hkv, d, dt = w["h"], w["hkv"], w["d"], w["dtype"]
    dv = w.get("dv", d)
    args = dict(q=r.normal(b, h, n, d, dtype=dt),
                k=r.normal(b, hkv, n, d, dtype=dt),
                v=r.normal(b, hkv, n, dv, dtype=dt),
                om_hat=r.normal(b, h, n, dv), h_vec=r.normal(b, h, n),
                a=1.0, b=1.0)
    if gated:
        args["log_decay"] = r.decay(b, hkv, n)
        mod, entries = gla, ("gla_fwd", "gla_bwd_q", "gla_bwd_kv")
    else:
        mod, entries = la, ("la_fwd", "la_bwd_q", "la_bwd_kv")
    return [Case(width, getattr(mod, f"plan_{e}"),
                 getattr(mod, f"{e}_torch"), args) for e in entries]


def _ssd_cases(width):
    w = SSD_WIDTHS[width]
    r = _Data(2)
    b, n = (2, 50) if width == "small" else (1, 70)
    g, h, dk, dv, dt = w["g"], w["h"], w["dk"], w["dv"], w["dtype"]
    args = dict(q=r.normal(b, g, n, dk, dtype=dt),
                k=r.normal(b, g, n, dk, dtype=dt),
                v=r.normal(b, h, n, dv, dtype=dt),
                omega=r.normal(b, h, n, dv, dtype=dt),
                log_decay=r.decay(b, h, n))
    return [Case(width, getattr(ssd, f"plan_{e}"),
                 getattr(ssd, f"{e}_torch"), args)
            for e in ("ssd_fwd", "ssd_bwd_q", "ssd_bwd_kv")]


def _flash_cases(width):
    w = WIDTHS[width]
    r = _Data(3)
    b, h, hkv, d, dt = 2, w["h"], w["hkv"], w["d"], w["dtype"]
    # odd N: a ragged last tile in every walk
    n = 97 if width == "small" else 130
    train = dict(q=r.normal(b, h, n, d, dtype=dt),
                 k=r.normal(b, hkv, n, d, dtype=dt),
                 v=r.normal(b, hkv, n, d, dtype=dt),
                 o=r.normal(b, h, n, d, dtype=dt),
                 do=r.normal(b, h, n, d, dtype=dt),
                 lse=r.normal(b, h, n) + 4.0, delta=r.normal(b, h, n))
    # continuation prefill: a short query window deep into the KV cache,
    # per-slot offsets incl. 0 (fresh) and a frontier mid-cache
    nq = 17 if width == "small" else 40
    window = dict(train, q=r.normal(b, h, nq, d, dtype=dt),
                  q_offset=_ints([0, n - nq]), return_lse=False)
    return [Case(width, fl.plan_flash_fwd, fl.flash_fwd_torch, train),
            Case(width, fl.plan_flash_fwd, fl.flash_fwd_torch, window),
            Case(width, fl.plan_flash_bwd_delta, fl.flash_bwd_delta_torch,
                 train),
            Case(width, fl.plan_flash_bwd_q, fl.flash_bwd_q_torch, train),
            Case(width, fl.plan_flash_bwd_kv, fl.flash_bwd_kv_torch, train)]


def _recurrent_cases(width, gated):
    w = WIDTHS[width]
    r = _Data(4)
    b = 3 if width == "small" else 8
    d, dt = w["d"], w["dtype"]
    dv = w.get("dv", d)
    cases = []
    # the width's group, and MHA (a group of 1) on the same grid
    for h, hkv in dict.fromkeys([(w["h"], w["hkv"]), (w["hkv"], w["hkv"])]):
        args = dict(s=r.normal(b, hkv, d, dv + 1),
                    p=r.positive(b, hkv, dv + 1),
                    q=r.normal(b, h, d, dtype=dt),
                    k=r.normal(b, hkv, d, dtype=dt),
                    v=r.normal(b, hkv, dv, dtype=dt), a=1.0, b=1.0)
        if gated:
            args["log_decay"] = r.decay(b, hkv)
            cases.append(Case(width, df.plan_gla_decode_fused,
                              df.gla_decode_fused_torch, args))
        else:
            cases.append(Case(width, df.plan_la_decode_fused,
                              df.la_decode_fused_torch, args))
    return cases


def _softmax_decode_cases(width):
    w = WIDTHS[width]
    r = _Data(5)
    h, hkv, d, dt = w["h"], w["hkv"], w["d"], w["dtype"]
    if width == "small":
        b, s_len = 3, 50
        # ragged lengths incl. an empty slot; then one past the cache
        lengths = ([0, 12, s_len], [1, s_len - 1, s_len + 3])
    else:
        b, s_len = 8, 130
        lengths = ([0, 1, 7, 64, 65, 129, 130, 131],)
    return [Case(width, df.plan_softmax_decode_fused,
                 df.softmax_decode_fused_torch,
                 dict(q=r.normal(b, h, 1, d, dtype=dt),
                      k=r.normal(b, hkv, s_len, d, dtype=dt),
                      v=r.normal(b, hkv, s_len, d, dtype=dt),
                      lengths=_ints(lens)))
            for lens in lengths]


def _page_tables(b, pmax, ps, lengths):
    """Two tables over one arena: the engine's (each slot's live pages,
    then the sink page 0) and the reference driver's dense one
    (1 + arange: every entry a real page)."""
    engine = np.zeros((b, pmax), np.int32)
    nxt = 1
    for i, n in enumerate(lengths):
        live = -(-min(n, pmax * ps) // ps)
        engine[i, :live] = np.arange(nxt, nxt + live)
        nxt += live
    dense = 1 + np.arange(b * pmax, dtype=np.int32).reshape(b, pmax)
    return [torch.from_numpy(engine), torch.from_numpy(dense)]


def _paged_cases(width, fused):
    """Page sizes within one tile, then a page of several tiles (the last
    one ragged at the small width)."""
    w = WIDTHS[width]
    r = _Data(6)
    h, hkv, d, dt = w["h"], w["hkv"], w["d"], w["dtype"]
    if width == "small":
        b = 3
        shapes = [(8, 5, [0, 12, 5 * 8]), (40, 2, [0, 37, 2 * 40 + 3])]
    else:
        b = 8
        shapes = [(16, 9, [0, 1, 15, 16, 17, 100, 9 * 16, 9 * 16 + 5]),
                  (256, 2, [0, 1, 15, 16, 17, 300, 2 * 256, 2 * 256 + 5])]
    plan_fn = df.plan_paged_decode_fused if fused else pg.plan_paged_attention
    plain = df.paged_decode_fused_torch if fused else pg.paged_attention_torch
    cases = []
    for ps, pmax, lens in shapes:
        num_pages = b * pmax + 1  # + the engine's sink page (id 0)
        k_pages = r.normal(num_pages, hkv, ps, d, dtype=dt)
        v_pages = r.normal(num_pages, hkv, ps, d, dtype=dt)
        q = r.normal(b, h, 1, d, dtype=dt)
        cases += [Case(width, plan_fn, plain,
                       dict(q=q, k_pages=k_pages, v_pages=v_pages,
                            page_table=pt, lengths=_ints(lens)))
                  for pt in _page_tables(b, pmax, ps, lens)]
    return cases


DRIVERS = {
    "softmax": _flash_cases,
    "linear": lambda width: _linear_cases(width, gated=False),
    "gla": lambda width: _linear_cases(width, gated=True),
    "ssd": _ssd_cases,
    "paged": lambda width: _paged_cases(width, fused=False),
    "linear_decode_fused": lambda width: _recurrent_cases(width, gated=False),
    "gla_decode_fused": lambda width: _recurrent_cases(width, gated=True),
    "softmax_decode_fused": _softmax_decode_cases,
    "paged_decode_fused": lambda width: _paged_cases(width, fused=True),
}


def cases(family: str) -> list[Case]:
    """Every case of a family: at the small widths, then the models'."""
    out = DRIVERS[family]("small")
    for width in FULL_WIDTHS.get(family, ("pythia-1.4b",)):
        out += DRIVERS[family](width)
    return out


# ---------------------------------------------------------------------------
# The card half
# ---------------------------------------------------------------------------

def c_plan(launch: plan.Launch) -> tuple:
    """The launcher's own plan, from its C export `<lib>_plan`: (grid x,
    y, z, threads, dynamic smem, registers per thread, static smem)."""
    symbol = f"{launch.lib}_plan"
    argtypes = ([ctypes.c_char_p] + [ctypes.c_int] * len(launch.plan_args)
                + [ctypes.POINTER(ctypes.c_int64)])
    lib = build.bind(launch.lib, {symbol: argtypes})
    out = (ctypes.c_int64 * plan.PLAN_FIELDS)()
    err = getattr(lib, symbol)(launch.name.encode(), *launch.plan_args, out)
    build.raise_on(lib, launch.lib, symbol, err)
    return tuple(int(x) for x in out)


@dataclasses.dataclass
class Guarded:
    """A view of `shape` inside a flat allocation with a guard band of
    `guard` elements on each side, holding `fill`."""

    buf: torch.Tensor
    view: torch.Tensor
    guard: int
    fill: float

    def guards(self) -> torch.Tensor:
        n = self.view.numel()
        return torch.cat([self.buf[:self.guard], self.buf[self.guard + n:]])

    def guards_intact(self) -> bool:
        g = self.guards()
        if math.isnan(self.fill):
            return bool(torch.isnan(g).all())
        return bool((g == self.fill).all())


def guard_band(shape, dtype, role: str, device, value=None) -> Guarded:
    """Place an operand inside a guard-banded allocation: float input
    guards hold NaN, output and in-out guards SENTINEL, integer guards 0;
    the view holds `value` or, for an output, SENTINEL."""
    numel = math.prod(shape)
    guard = -(-max(GUARD_MIN, numel) // 64) * 64   # keeps 16-byte alignment
    buf = torch.empty(numel + 2 * guard, dtype=dtype, device=device)
    if not dtype.is_floating_point:
        fill = 0
    else:
        fill = float("nan") if role == "in" else SENTINEL
    buf.fill_(fill)
    view = buf[guard:guard + numel].view(shape)
    if value is not None:
        view.copy_(value.reshape(shape).to(dtype))
    elif dtype.is_floating_point:
        view.fill_(SENTINEL)
    return Guarded(buf, view, guard, fill)


def nan_reads(where: str, got, want) -> list[Finding]:
    """B001 where the kernel's output holds NaN and the plain version's
    does not: a read of a NaN guard reached it."""
    fresh = torch.isnan(got.float()) & ~torch.isnan(want.float().to(
        got.device).reshape(got.shape))
    if bool(fresh.any()):
        return [Finding("REPRO-B001", where,
                        f"{int(fresh.sum())} NaN outputs where the plain "
                        f"version has none (a read of a NaN guard band), "
                        f"first at {tuple(fresh.nonzero()[0].tolist())}")]
    return []


def _launch_raw(launch: plan.Launch, views: dict, device) -> None:
    lib = build.bind(launch.lib, {launch.name: launch.argtypes})
    ptrs = [None if n is None else views[n].data_ptr()
            for n in launch.pointers]
    with torch.cuda.device(device):
        err = getattr(lib, launch.name)(*ptrs, *launch.args,
                                        build.current_stream(device))
    build.raise_on(lib, launch.lib, launch.name, err)
    torch.cuda.synchronize(device)


def card_findings(case: Case, launch: plan.Launch, device) -> list[Finding]:
    """The card half for one case: the C export, then the guarded
    launch against the plain version."""
    where = f"{launch.name} @ {case.width}"
    got = c_plan(launch)
    mine = launch.grid + (launch.threads, launch.smem)
    if got[:5] != mine:
        return [Finding("REPRO-B005", where,
                        f"plan (grid, threads, smem) {mine} != the C "
                        f"export's {got[:5]}")]
    findings = resource_findings(launch, regs=got[5], static_smem=got[6])
    if findings:
        return findings   # the launch would be refused: nothing to run
    guarded = {a.name: guard_band(a.shape, a.dtype, a.role, device,
                                  case.args.get(a.name)
                                  if a.role != "out" else None)
               for a in launch.accesses}
    _launch_raw(launch, {n: g.view for n, g in guarded.items()}, device)
    dev_args = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                for k, v in case.args.items()}
    want = case.plain(**_accepted(case.plain, dev_args))
    want = want if isinstance(want, tuple) else (want,)
    outs = [a for a in launch.accesses if a.role == "out"]
    for access, value in zip(outs, want):
        findings += nan_reads(f"{where}[{access.name}]",
                              guarded[access.name].view, value)
    for access in launch.accesses:
        g = guarded[access.name]
        if access.role == "inout":
            findings += nan_reads(f"{where}[{access.name}]", g.view,
                                  dev_args[access.name])
        if not g.guards_intact():
            findings.append(Finding(
                "REPRO-B001", f"{where}[{access.name}]",
                "the guard band changed: a write outside the extent"))
        if access.role in ("out", "scratch") \
                and bool((g.view == SENTINEL).any()):
            findings.append(Finding(
                "REPRO-B002", f"{where}[{access.name}]",
                f"{int((g.view == SENTINEL).sum())} of {g.view.numel()} "
                f"elements left unwritten"))
    return findings


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def run(device="cuda", log=lambda s: None
        ) -> tuple[list[Finding], list[dict]]:
    dev = resolve_device(device)
    findings: list[Finding] = []
    coverage: list[dict] = []
    for family in DRIVERS:
        fam: list[Finding] = []
        entries, n_cases = set(), 0
        for case in cases(family):
            launch = case.launch()
            entries.add(launch.name)
            n_cases += 1
            fam += check_launch(launch, case.gathered(launch))
            if dev.type == "cuda":
                fam += card_findings(case, launch, dev)
        findings += fam
        coverage.append({"family": family, "pass": "bounds",
                         "kernels": sorted(entries), "cases": n_cases,
                         "card": dev.type == "cuda"})
        log(f"check,bounds,{family},{'FAIL' if fam else 'ok'} "
            f"({n_cases} cases{', on the card' if dev.type == 'cuda' else ''}"
            f")")
    return findings, coverage
