"""Entry points for the port's kernels + the KernelImpl registry.

Port of the linear families of `repro/kernels/ops.py`.  Each (family,
impl) pair is a registered `KernelImpl`; impls are execution backends:

  "torch"  plain PyTorch (any device) — the analogue of the reference's
           "xla" impl
  "cuda"   the hand-written Hopper kernels (CUDA tensors only; a CPU
           tensor raises)
  "ref"    the quadratic oracle (linear family; tests only)
  "auto"   picked per call by the tensors' device: CUDA tensors take
           "cuda", everything else "torch"

Families: "linear" (causal training forward + analytic backward) and
"linear_decode_fused" (one-token decode, state in place).  `get_kernel`
raises an error listing the registered impls for unknown names.

The causal linear path is a `torch.autograd.Function` (`la_causal`)
implementing the paper's analytic backward (Eqs. 19-21): its residuals
are {q, k, v, o, g}, O(N D) memory, instead of the O(N D^2)
intermediates autograd would keep.  `la_causal_learnable` adds the
closed-form gradients of the scalar coefficients a and b.  Serving
prefill runs the plain chunked scan on every impl, as the reference
does (`repro/kernels/ops.py::la_prefill`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import chunked as _chunked
from repro_torch.core.chunked import LAState
from repro_torch.core.numerics import safe_div
from repro_torch.kernels import decode_fused as _df
from repro_torch.kernels import linear_attention as _la
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

__all__ = ["KernelImpl", "register_kernel", "get_kernel", "kernel_names",
           "resolve_impl", "la_causal", "la_causal_learnable", "la_prefill",
           "la_decode_step_fused"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One execution backend of one kernel family.

    fwd: linear family: (q, k, v, a, b, chunk) -> (o, g);
         linear_decode_fused family: (state, q, k, v, a, b) ->
         (state, o), with the state updated in place.
    bwd: linear family: (q, k, v, o, g, omega, a, b, chunk) ->
         (dq, dk, dv); None falls through to the plain backward.
    """

    family: str
    name: str
    fwd: Callable
    bwd: Optional[Callable] = None


_KERNELS: dict[tuple[str, str], KernelImpl] = {}


def register_kernel(family: str, name: str, *, fwd, bwd=None) -> KernelImpl:
    impl = KernelImpl(family=family, name=name, fwd=fwd, bwd=bwd)
    _KERNELS[(family, name)] = impl
    return impl


def kernel_names(family: str) -> list[str]:
    return sorted(n for (f, n) in _KERNELS if f == family)


def resolve_impl(name: str, device: Optional[torch.device]) -> str:
    """"auto" -> "cuda" for a CUDA tensor's device, else "torch"."""
    if name != "auto":
        return name
    return "cuda" if device is not None and device.type == "cuda" \
        else "torch"


def get_kernel(family: str, name: str,
               device: Optional[torch.device] = None) -> KernelImpl:
    impl = _KERNELS.get((family, resolve_impl(name, device)))
    if impl is None:
        raise ValueError(
            f"unknown kernel impl {name!r} for the {family!r} family; "
            f"registered: {kernel_names(family)} (plus 'auto')")
    return impl


# ---------------------------------------------------------------------------
# linear: causal training forward + analytic backward
# ---------------------------------------------------------------------------

def _linear_cuda_fwd(q, k, v, a, b, chunk):
    # the CUDA kernel stages its own token block (kernels/defaults.py);
    # the model hands over strided head views, the kernel reads rows
    return _la.la_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                           a, b)


def _linear_cuda_bwd(q, k, v, o, g, omega, a, b, chunk):
    # omega from autograd may be strided or expanded
    return _la.la_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                           o, g, omega.contiguous(), a, b)


def _linear_ref_fwd(q, k, v, a, b, chunk):
    """The quadratic oracle; g recomputed from its score matrix for the
    residuals (the reference's `_linear_ref_fwd`)."""
    bq, h, n, _ = q.shape
    o = _ref.la_ref(q, k, v, a, b, causal=True)
    g = _ref.la_weights(q, k, a, b, causal=True).sum(-1)
    return o, g.reshape(bq, h, n)


register_kernel("linear", "torch", fwd=_la.la_fwd_torch,
                bwd=_la.la_bwd_torch)
register_kernel("linear", "cuda", fwd=_linear_cuda_fwd, bwd=_linear_cuda_bwd)
register_kernel("linear", "ref", fwd=_linear_ref_fwd)  # bwd: the plain one


def _fwd_dispatch(q, k, v, a, b, chunk, backend):
    impl = get_kernel("linear", backend, q.device)
    return impl, impl.fwd(q, k, v, a, b, chunk)


def _bwd_dispatch(impl, q, k, v, o, g, omega, a, b, chunk):
    bwd = impl.bwd or _chunked.la_bwd_chunked
    return bwd(q, k, v, o, g, omega, a, b, chunk)


class _LACausal(torch.autograd.Function):
    """la_causal with the analytic backward; residuals {q, k, v, o, g}."""

    @staticmethod
    def forward(ctx, q, k, v, a, b, chunk, backend):
        impl, (o, g) = _fwd_dispatch(q, k, v, a, b, chunk, backend)
        ctx.save_for_backward(q, k, v, o, g)
        ctx.impl, ctx.a, ctx.b, ctx.chunk = impl, a, b, chunk
        return o

    @staticmethod
    def backward(ctx, omega):
        q, k, v, o, g = ctx.saved_tensors
        dq, dk, dv = _bwd_dispatch(ctx.impl, q, k, v, o, g, omega, ctx.a,
                                   ctx.b, ctx.chunk)
        return dq, dk, dv, None, None, None, None


def la_causal(q, k, v, a: float = 1.0, b: float = 1.0,
              chunk: int = DEFAULT_SCAN_CHUNK, backend: str = "auto"):
    """Causal normalized linear attention (paper Eqs. 4-9), differentiable
    in q, k and v through the analytic backward.

    q: (B, H, N, D); k, v: (B, Hkv, N, D), Hkv | H.  Returns (B, H, N, D)
    in q.dtype.  a, b, chunk and backend are not differentiated.
    """
    return _LACausal.apply(q, k, v, float(a), float(b), chunk, backend)


# ---------------------------------------------------------------------------
# Learnable kernel coefficients (paper §2.2).  f and g are linear in
# (a, b): f = a F1 + b F2 and g = a G1 + b G2 with F1 = cumsum(v) and
# G1_i = i, so
#     do/da = (F1 - o G1) / g        (one O(N D) cumsum)
#     do/db = -(a / b) do/da         (o depends only on a/b)
# on top of the analytic backward (the reference's `_la_learn_bwd`).
# ---------------------------------------------------------------------------

class _LACausalLearnable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, a, b, chunk, backend):
        af, bf = float(a), float(b)
        impl, (o, g) = _fwd_dispatch(q, k, v, af, bf, chunk, backend)
        ctx.save_for_backward(q, k, v, o, g, a, b)
        ctx.impl, ctx.chunk = impl, chunk
        return o

    @staticmethod
    def backward(ctx, omega):
        q, k, v, o, g, a, b = ctx.saved_tensors
        af, bf = float(a), float(b)
        dq, dk, dv = _bwd_dispatch(ctx.impl, q, k, v, o, g, omega, af, bf,
                                   ctx.chunk)
        n = q.shape[2]
        f1 = torch.cumsum(_ref.expand_kv(v, q.shape[1]).float(), dim=2)
        g1 = torch.arange(1, n + 1, dtype=F32, device=q.device)[:, None]
        do_da = safe_div(f1 - o.float() * g1, g[..., None])
        da = (omega.float() * do_da).sum()
        db = -(a.float() / b.float()) * da
        return dq, dk, dv, da.to(a.dtype), db.to(b.dtype), None, None


def la_causal_learnable(q, k, v, a, b, chunk: int = DEFAULT_SCAN_CHUNK,
                        backend: str = "auto"):
    """Causal normalized LA with differentiable scalar coefficients.

    a, b: 0-d tensors (learnable parameters).  Same output as la_causal;
    gradients flow to q, k, v, a and b.  Reading a and b for the kernels
    waits for the device once per call.
    """
    return _LACausalLearnable.apply(q, k, v, a, b, chunk, backend)


# ---------------------------------------------------------------------------
# linear_decode_fused: one-token decode, state updated in place
# ---------------------------------------------------------------------------

def _la_decode_torch(state: LAState, q, k, v, a, b):
    return state, _df.la_decode_fused_torch(state.s, state.p, q, k, v, a, b)


def _la_decode_cuda(state: LAState, q, k, v, a, b):
    # the model hands over strided head views; the kernel reads rows
    o = _df.la_decode_fused_cuda(state.s, state.p, q.contiguous(),
                                 k.contiguous(), v.contiguous(), a, b)
    return state, o


register_kernel("linear_decode_fused", "torch", fwd=_la_decode_torch)
register_kernel("linear_decode_fused", "cuda", fwd=_la_decode_cuda)


def la_decode_step_fused(state: LAState, q, k, v, a: float = 1.0,
                         b: float = 1.0, *, backend: str = "auto"):
    """One-token LA decode through the fused registry family.

    Same contract as `core.chunked.la_decode_step`, except that the
    state tensors are updated in place (the reference donates them) and
    returned as the same LAState.
    """
    return get_kernel("linear_decode_fused", backend, q.device).fwd(
        state, q, k, v, a, b)


def la_prefill(q, k, v, a: float = 1.0, b: float = 1.0,
               chunk: int = DEFAULT_SCAN_CHUNK, state: LAState | None = None):
    """Causal LA that also returns the recurrent state for decode.

    Inference only.  Returns (o, LAState).
    """
    o, _, st = _chunked.la_fwd_chunked(q, k, v, a, b, chunk, state=state)
    return o, st
