"""Autograd audits: residual growth, f32 accumulation, dtype closure (the
port's counterpart of `repro/check/jaxpr_audit.py`).

PyTorch runs eagerly, so there is no jaxpr to trace: the audits run the
registry's entry points (kernels/ops.py) on small inputs and watch them.

  REPRO-J001  autograd-Function residuals are O(ND): around the forward of
              every Function with a backward (`la_causal`,
              `la_causal_learnable`, `gla_causal`, `ssd_causal`,
              `softmax_causal`), `torch.autograd.graph.saved_tensors_hooks`
              sums the bytes it saves at N = 128 and N = 512; they must
              grow at most 1.5x faster than N (ratio <= 4 x 1.5, the
              reference's `_RES_N` and `_RES_SLACK`).
  REPRO-J002  no matmul-family op (`mm`, `bmm`, `addmm`, `baddbmm`) takes
              bf16/f16 operands and returns bf16/f16: a `TorchDispatchMode`
              watches every aten call of the `torch` impls, forward and
              backward, with bf16 inputs.  The `cuda` impls are opaque to
              it (one ctypes call each); their coverage record says so.
  REPRO-J003  the primary output dtype equals q's for every (family, impl,
              dtype) cell.

On the CPU the audits run the `torch` and `ref` impls; on the card also
the `cuda` impls for J001 and J003.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.check.findings import Finding
from repro_torch.check.registry_audit import FAMILIES
from repro_torch.core.chunked import init_state
from repro_torch.core.gla import init_gla_state
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32
LOW_PRECISION = (torch.bfloat16, torch.float16)
_MATMULS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
            torch.ops.aten.baddbmm)

# residual-growth measurement points (N2 / N1 == 4: O(ND) residuals give
# exactly 4) and the slack over perfectly-linear growth, as the reference's
_RES_N = (128, 512)
_RES_SLACK = 1.5

# audit shapes: MHA at a tile boundary, GQA, odd N below it, a ragged
# tail across it; head dim 32, the kernels' smallest instantiation
_BASE = {"b": 2, "h": 4, "hkv": 4, "n": 128, "d": 32}
AUDIT_SHAPES = [("base", {}), ("gqa", {"hkv": 2}), ("odd_n", {"n": 97}),
                ("tail_n", {"n": 257, "hkv": 2})]
AUDIT_DTYPES = (F32, BF16)
# SSD's (Dk, Dv): the smoke instantiation of its kernels
_SSD_DIMS = (16, 32)
_PAGE_SIZE = 16

# the autograd Functions with a backward, by family
TRAINERS = {
    "linear": ("la_causal", "la_causal_learnable"),
    "gla": ("gla_causal",),
    "ssd": ("ssd_causal",),
    "softmax": ("softmax_causal",),
}


def _impls(family: str, device: torch.device) -> list[str]:
    """The impls a run on `device` audits: all but "cuda" on the CPU."""
    return [n for n in ops.kernel_names(family)
            if device.type == "cuda" or n != "cuda"]


def _shape(overrides: dict, **extra) -> dict:
    return {**_BASE, **overrides, **extra}


def _inputs(family: str, shape: dict, dtype, device, grad=False) -> dict:
    """Seeded inputs of one family at one shape."""
    gen = torch.Generator().manual_seed(0)
    b, h, hkv, n, d = (shape[k] for k in ("b", "h", "hkv", "n", "d"))

    def normal(*dims, dt=dtype):
        x = torch.randn(dims, generator=gen).to(dt).to(device)
        return x.requires_grad_(grad) if dt.is_floating_point else x

    if family in ("linear", "gla", "softmax"):
        out = dict(q=normal(b, h, n, d), k=normal(b, hkv, n, d),
                   v=normal(b, hkv, n, d))
        if family == "gla":
            out["log_decay"] = -(torch.rand((b, hkv, n), generator=gen)
                                 * 0.1).to(device).requires_grad_(grad)
        return out
    if family == "ssd":
        dk, dv = _SSD_DIMS
        return dict(q=normal(b, hkv, n, dk), k=normal(b, hkv, n, dk),
                    v=normal(b, h, n, dv),
                    log_decay=-(torch.rand((b, h, n), generator=gen)
                                * 0.1).to(device).requires_grad_(grad))
    if family in ("linear_decode_fused", "gla_decode_fused"):
        init = init_state if family == "linear_decode_fused" \
            else init_gla_state
        out = dict(state=init(b, hkv, d, device=device), q=normal(b, h, d),
                   k=normal(b, hkv, d), v=normal(b, hkv, d))
        if family == "gla_decode_fused":
            out["log_decay"] = -torch.rand((b, hkv), generator=gen).to(device)
        return out
    lengths = torch.arange(1, b + 1, dtype=I32, device=device) * n // b
    if family == "softmax_decode_fused":
        return dict(q=normal(b, h, 1, d), k=normal(b, hkv, n, d),
                    v=normal(b, hkv, n, d), lengths=lengths)
    # paged / paged_decode_fused: slot i's pages follow slot i-1's; page 0
    # is the sink
    pmax = -(-n // _PAGE_SIZE)
    table = (1 + torch.arange(b * pmax, dtype=I32)).reshape(b, pmax)
    pages = b * pmax + 1
    return dict(q=normal(b, h, 1, d),
                k_pages=normal(pages, hkv, _PAGE_SIZE, d),
                v_pages=normal(pages, hkv, _PAGE_SIZE, d),
                page_table=table.to(device), lengths=lengths)


def forward(family: str, impl: str, x: dict):
    """The family's forward through the registry; returns its primary
    output (the attention output)."""
    fwd = ops.get_kernel(family, impl).fwd
    if family == "linear":
        return fwd(x["q"], x["k"], x["v"], 1.0, 1.0, 64)[0]
    if family == "gla":
        return fwd(x["q"], x["k"], x["v"], x["log_decay"], 1.0, 1.0, 64)[0]
    if family == "ssd":
        return fwd(x["q"], x["k"], x["v"], x["log_decay"], 64)
    if family == "softmax":
        return fwd(x["q"], x["k"], x["v"], True, 64)
    if family == "linear_decode_fused":
        return fwd(x["state"], x["q"], x["k"], x["v"], 1.0, 1.0)[1]
    if family == "gla_decode_fused":
        return fwd(x["state"], x["q"], x["k"], x["v"], x["log_decay"], 1.0,
                   1.0)[1]
    if family == "softmax_decode_fused":
        return fwd(x["q"], x["k"], x["v"], x["lengths"])
    return fwd(x["q"], x["k_pages"], x["v_pages"], x["page_table"],
               x["lengths"])


def trainer(name: str, impl: str, x: dict):
    """One autograd Function of TRAINERS applied to inputs x."""
    if name == "la_causal":
        return ops.la_causal(x["q"], x["k"], x["v"], 1.0, 1.0, 64, impl)
    if name == "la_causal_learnable":
        a = torch.tensor(1.0, device=x["q"].device, requires_grad=True)
        b = torch.tensor(0.5, device=x["q"].device, requires_grad=True)
        return ops.la_causal_learnable(x["q"], x["k"], x["v"], a, b, 64, impl)
    if name == "gla_causal":
        return ops.gla_causal(x["q"], x["k"], x["v"], x["log_decay"], 1.0,
                              1.0, 64, impl)
    if name == "ssd_causal":
        return ops.ssd_causal(x["q"], x["k"], x["v"], x["log_decay"], 64,
                              impl)
    return ops.softmax_causal(x["q"], x["k"], x["v"], 64, impl)


def _trains(family: str, impl: str) -> bool:
    """Does (family, impl) train through its Function?  softmax_causal
    takes only impls with a custom backward; the others fall back to the
    plain backward."""
    kernel = ops.get_kernel(family, impl)
    return family != "softmax" or (kernel.bwd is not None
                                   and kernel.fwd_res is not None)


# ---------------------------------------------------------------------------
# REPRO-J001
# ---------------------------------------------------------------------------

def saved_bytes(fn, args) -> int:
    """Bytes of the tensors autograd saves while `fn(*args)` runs."""
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return total


def residual_growth_findings(fn, make_args, where: str, ns=_RES_N,
                             slack: float = _RES_SLACK) -> list[Finding]:
    """REPRO-J001 core: the bytes `fn(*make_args(n))` saves must grow
    about linearly across the two Ns."""
    (n1, b1), (n2, b2) = [(n, saved_bytes(fn, make_args(n))) for n in ns]
    if b1 <= 0:
        return [Finding("REPRO-J001", where,
                        "nothing saved (nothing for the backward to read)")]
    ratio, linear = b2 / b1, n2 / n1
    if ratio > slack * linear:
        return [Finding(
            "REPRO-J001", where,
            f"residual bytes grew {ratio:.1f}x when N grew {linear:.0f}x "
            f"({b1} B @ N={n1} -> {b2} B @ N={n2}); O(ND) residuals must "
            f"track N")]
    return []


def audit_residuals(name: str, family: str, impl: str,
                    device) -> list[Finding]:
    def make_args(n):
        return (_inputs(family, _shape({}, n=n), F32, device, grad=True),)
    return residual_growth_findings(lambda x: trainer(name, impl, x),
                                    make_args, f"{name}.{impl}")


# ---------------------------------------------------------------------------
# REPRO-J002
# ---------------------------------------------------------------------------

class LowPrecisionMatmuls(TorchDispatchMode):
    """Records every matmul-family aten call whose operands and result
    are both low precision."""

    def __init__(self):
        super().__init__()
        self.hits: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in _MATMULS:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            if any(a.dtype in LOW_PRECISION for a in ins) \
                    and isinstance(out, torch.Tensor) \
                    and out.dtype in LOW_PRECISION:
                operands = " x ".join(str(a.dtype)[6:] for a in ins)
                self.hits.append(f"{func}({operands}) -> "
                                 f"{str(out.dtype)[6:]}")
        return out


def precision_findings(fn, args, where: str) -> list[Finding]:
    """REPRO-J002 core: run `fn(*args)` (and its backward, where its result
    requires grad) and flag the first low-precision matmul."""
    mode = LowPrecisionMatmuls()
    with mode:
        out = fn(*args)
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out.float().sum().backward()
    if mode.hits:
        return [Finding("REPRO-J002", where,
                        f"{mode.hits[0]}: low-precision operands must "
                        f"accumulate and return in f32")]
    return []


# ---------------------------------------------------------------------------
# REPRO-J003
# ---------------------------------------------------------------------------

def audit_dtype_closure(family: str, impl: str, shape: dict, dtype,
                        device) -> list[Finding]:
    out = forward(family, impl, _inputs(family, shape, dtype, device))
    if out.dtype != dtype:
        return [Finding("REPRO-J003", f"{family}.{impl}.fwd @ {_fmt(shape)}",
                        f"input dtype {dtype} -> output dtype {out.dtype}")]
    return []


def _fmt(shape: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(shape.items()))


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def audit_family(family: str, impl: str, device, log=lambda s: None
                 ) -> tuple[list[Finding], dict]:
    """All audits of one (family, impl).  Returns (findings, coverage)."""
    findings: list[Finding] = []
    trains = family in TRAINERS and _trains(family, impl)
    if trains:
        for name in TRAINERS[family]:
            findings += audit_residuals(name, family, impl, device)
    for _, overrides in AUDIT_SHAPES:
        shape = _shape(overrides)
        for dtype in AUDIT_DTYPES:
            findings += audit_dtype_closure(family, impl, shape, dtype,
                                            device)
        if impl == "torch":
            where = f"{family}.{impl} @ {_fmt(shape)}"
            findings += precision_findings(
                lambda x: forward(family, impl, x),
                (_inputs(family, shape, BF16, device),), f"{where} fwd")
            for name in TRAINERS.get(family, ()) if trains else ():
                findings += precision_findings(
                    lambda x: trainer(name, impl, x),
                    (_inputs(family, shape, BF16, device, grad=True),),
                    f"{where} {name} fwdbwd")
    log(f"check,autograd,{family}.{impl},{'FAIL' if findings else 'ok'}")
    coverage = {"family": family, "impl": impl,
                "residuals": list(TRAINERS[family]) if trains else [],
                "precision": "audited" if impl == "torch" else
                "not audited: no aten matmul to watch (the cuda impls "
                "are one ctypes call each; ref is a test oracle)",
                "shapes": [tag for tag, _ in AUDIT_SHAPES],
                "dtypes": [str(d)[6:] for d in AUDIT_DTYPES]}
    return findings, coverage


def run(device="cuda", log=lambda s: None
        ) -> tuple[list[Finding], list[dict]]:
    """Audit every registered (family, impl) of the nine families that a
    run on `device` can execute."""
    dev = resolve_device(device)
    findings: list[Finding] = []
    coverage: list[dict] = []
    for family in FAMILIES:
        for impl in _impls(family, dev):
            f, c = audit_family(family, impl, dev, log=log)
            findings += f
            coverage.append(c)
    return findings, coverage
