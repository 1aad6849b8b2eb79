"""Entry points for the port's kernels + the KernelImpl registry.

Port of the linear, GLA and softmax families of `repro/kernels/ops.py`.  Each
(family, impl) pair is a registered `KernelImpl`; impls are execution
backends:

  "torch"  plain PyTorch (any device) — the analogue of the reference's
           "xla" impl
  "cuda"   the hand-written Hopper kernels (CUDA tensors only; a CPU
           tensor raises)
  "ref"    the quadratic oracles (linear, GLA and softmax families;
           tests only)
  "auto"   picked per call by the tensors' device: CUDA tensors take
           "cuda", everything else "torch"

Families: "linear" (causal training forward + analytic backward),
"linear_decode_fused" (one-token decode, state in place), "gla" and
"gla_decode_fused" (the same two, decay-gated), "ssd" (Mamba-2's
scalar-decay recurrence with grouped q/k: training forward + analytic
backward), "softmax"
(flash forward, optional per-slot q_offset, + recomputation backward),
"softmax_decode" (the unfused contiguous-cache decode),
"softmax_decode_fused" (the fused one), and "paged" and
"paged_decode_fused" (decode over a paged KV arena: one kernel block per
query head, or per KV head with its query group folded in).
`get_kernel` raises an error listing the registered impls for unknown
names.

The causal linear path is a `torch.autograd.Function` (`la_causal`)
implementing the paper's analytic backward (Eqs. 19-21): its residuals
are {q, k, v, o, g}, O(N D) memory, instead of the O(N D^2)
intermediates autograd would keep.  `la_causal_learnable` adds the
closed-form gradients of the scalar coefficients a and b.  Serving
prefill runs the plain chunked scan on every impl, as the reference
does (`repro/kernels/ops.py::la_prefill`).

The causal GLA path is `gla_causal`, an autograd Function with residuals
{q, k, v, log_decay, o, g} whose backward returns gradients to q, k, v
AND log_decay (the gate trains); the `ref` impl has no backward and
falls back to the plain one, as in the reference.

The causal SSD path is `ssd_causal`, an autograd Function with residuals
{q, k, v, log_decay, o} whose backward returns dq and dk summed over each
group of heads, dv and dlog_decay; the `ref` impl has no backward.  As
in the reference, serving prefill and decode run the plain scan and step
of core/ssd.py on every impl.

The causal softmax path is `softmax_causal`, an autograd Function whose
residuals are {q, k, v, o, lse}: both the `torch` and the `cuda` impl
register a forward that returns them and a recomputation backward, so
CPU and card training go through the same Function with O(N D)
residuals (autograd through the chunked scan would keep every chunk's
score block).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import chunked as _chunked
from repro_torch.core import gla as _gla
from repro_torch.core import softmax as _softmax
from repro_torch.core import ssd as _ssd
from repro_torch.core.chunked import LAState
from repro_torch.core.gla import GLAState
from repro_torch.core.numerics import safe_div
from repro_torch.kernels import decode_fused as _df
from repro_torch.kernels import flash_attention as _fl
from repro_torch.kernels import gla as _kgla
from repro_torch.kernels import linear_attention as _la
from repro_torch.kernels import paged_attention as _pg
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _kssd
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

__all__ = ["KernelImpl", "register_kernel", "get_kernel", "kernel_names",
           "resolve_impl", "la_causal", "la_causal_learnable", "la_prefill",
           "la_decode_step_fused", "gla_causal", "gla_prefill",
           "gla_decode_step", "gla_decode_step_fused", "ssd_causal",
           "softmax_causal",
           "softmax_attention",
           "softmax_decode", "softmax_decode_fused", "paged_attention",
           "paged_attention_fused"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One execution backend of one kernel family.

    fwd: linear family: (q, k, v, a, b, chunk) -> (o, g);
         linear_decode_fused family: (state, q, k, v, a, b) ->
         (state, o), with the state updated in place;
         gla family: (q, k, v, log_decay, a, b, chunk) -> (o, g);
         gla_decode_fused family: (state, q, k, v, log_decay, a, b) ->
         (state, o), state in place;
         ssd family: (q, k, v, log_decay, chunk) -> o;
         softmax family: (q, k, v, causal, chunk, q_offset) -> o;
         softmax_decode(_fused) families: (q, k, v, lengths) -> o;
         paged and paged_decode_fused families: (q, k_pages, v_pages,
         page_table, lengths) -> o.
    bwd: linear family: (q, k, v, o, g, omega, a, b, chunk) ->
         (dq, dk, dv); gla family: (q, k, v, log_decay, o, g, omega, a,
         b, chunk) -> (dq, dk, dv, dlog_decay); ssd family: (q, k, v,
         log_decay, o, omega, chunk) -> (dq, dk, dv, dlog_decay); None
         falls through to the plain backward.
         softmax family: (q, k, v, o, lse, do, chunk) -> (dq, dk, dv).
    fwd_res: softmax family: (q, k, v, chunk) -> (o, lse), the causal
         training forward with its residual.
    """

    family: str
    name: str
    fwd: Callable
    bwd: Optional[Callable] = None
    fwd_res: Optional[Callable] = None


_KERNELS: dict[tuple[str, str], KernelImpl] = {}


def register_kernel(family: str, name: str, *, fwd, bwd=None,
                    fwd_res=None) -> KernelImpl:
    impl = KernelImpl(family=family, name=name, fwd=fwd, bwd=bwd,
                      fwd_res=fwd_res)
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


def _la_decode_ref(state: LAState, q, k, v, a, b):
    """The functional plain step (the reference's `_la_decode_unfused`),
    its new state copied into the given one."""
    new, o = _chunked.la_decode_step(state, q, k, v, a, b)
    state.s.copy_(new.s)
    state.p.copy_(new.p)
    return state, o


register_kernel("linear_decode_fused", "torch", fwd=_la_decode_torch)
register_kernel("linear_decode_fused", "cuda", fwd=_la_decode_cuda)
register_kernel("linear_decode_fused", "ref", fwd=_la_decode_ref)


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


# ---------------------------------------------------------------------------
# gla: decay-gated causal training forward + analytic backward
# ---------------------------------------------------------------------------

def _gla_cuda_fwd(q, k, v, log_decay, a, b, chunk):
    # the model hands over strided head views and a transposed gate
    return _kgla.gla_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              log_decay.float().contiguous(), a, b)


def _gla_cuda_bwd(q, k, v, log_decay, o, g, omega, a, b, chunk):
    # omega from autograd may be strided or expanded
    return _kgla.gla_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              log_decay, o, g, omega.contiguous(), a, b)


def _gla_ref_fwd(q, k, v, log_decay, a, b, chunk):
    # the oracle computes its own normalizer: one masking convention
    return _ref.gla_ref(q, k, v, log_decay, a, b, return_g=True)


register_kernel("gla", "torch", fwd=_kgla.gla_fwd_torch,
                bwd=_kgla.gla_bwd_torch)
register_kernel("gla", "cuda", fwd=_gla_cuda_fwd, bwd=_gla_cuda_bwd)
register_kernel("gla", "ref", fwd=_gla_ref_fwd)  # bwd: the plain one


class _GLACausal(torch.autograd.Function):
    """gla_causal with the analytic backward; residuals {q, k, v,
    log_decay, o, g}."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, a, b, chunk, backend):
        impl = get_kernel("gla", backend, q.device)
        o, g = impl.fwd(q, k, v, log_decay, a, b, chunk)
        ctx.save_for_backward(q, k, v, log_decay, o, g)
        ctx.impl, ctx.a, ctx.b, ctx.chunk = impl, a, b, chunk
        return o

    @staticmethod
    def backward(ctx, omega):
        q, k, v, log_decay, o, g = ctx.saved_tensors
        bwd = ctx.impl.bwd or _gla.gla_bwd_chunked
        dq, dk, dv, dld = bwd(q, k, v, log_decay, o, g, omega, ctx.a,
                              ctx.b, ctx.chunk)
        return dq, dk, dv, dld, None, None, None, None


def gla_causal(q, k, v, log_decay, a: float = 1.0, b: float = 1.0,
               chunk: int = DEFAULT_SCAN_CHUNK, backend: str = "auto"):
    """Causal decay-gated normalized LA (the training entry),
    differentiable in q, k, v and log_decay through the analytic
    backward.

    q: (B, H, N, D); k, v: (B, Hkv, N, D), Hkv | H; log_decay:
    (B, Hkv, N) <= 0.  Returns (B, H, N, D) in q.dtype.  a, b, chunk and
    backend are not differentiated.
    """
    return _GLACausal.apply(q, k, v, log_decay, float(a), float(b), chunk,
                            backend)


def gla_prefill(q, k, v, log_decay, a: float = 1.0, b: float = 1.0,
                chunk: int = DEFAULT_SCAN_CHUNK,
                state: GLAState | None = None):
    """Causal GLA that also returns the decayed recurrent state for
    decode, through the plain chunked scan on every impl (inference
    only).  Returns (o, GLAState)."""
    o, _, st = _gla.gla_fwd_chunked(q, k, v, log_decay, a, b, chunk,
                                    state=state)
    return o, st


def gla_decode_step(state: GLAState, q, k, v, log_decay, a: float = 1.0,
                    b: float = 1.0):
    """One-token GLA decode, functional (the unfused path): O(D^2), the
    context enters only through the state."""
    return _gla.gla_decode_step(state, q, k, v, log_decay, a, b)


# ---------------------------------------------------------------------------
# gla_decode_fused: one-token decode with the gate, state updated in place
# ---------------------------------------------------------------------------

def _gla_decode_torch(state: GLAState, q, k, v, log_decay, a, b):
    return state, _df.gla_decode_fused_torch(state.s, state.p, q, k, v,
                                             log_decay, a, b)


def _gla_decode_cuda(state: GLAState, q, k, v, log_decay, a, b):
    # the model hands over strided head and gate views; the kernel reads
    # rows
    o = _df.gla_decode_fused_cuda(state.s, state.p, q.contiguous(),
                                  k.contiguous(), v.contiguous(),
                                  log_decay.float().contiguous(), a, b)
    return state, o


def _gla_decode_ref(state: GLAState, q, k, v, log_decay, a, b):
    """The functional plain step (the reference's `_gla_decode_unfused`),
    its new state copied into the given one."""
    new, o = _gla.gla_decode_step(state, q, k, v, log_decay, a, b)
    state.s.copy_(new.s)
    state.p.copy_(new.p)
    return state, o


register_kernel("gla_decode_fused", "torch", fwd=_gla_decode_torch)
register_kernel("gla_decode_fused", "cuda", fwd=_gla_decode_cuda)
register_kernel("gla_decode_fused", "ref", fwd=_gla_decode_ref)


def gla_decode_step_fused(state: GLAState, q, k, v, log_decay,
                          a: float = 1.0, b: float = 1.0, *,
                          backend: str = "auto"):
    """One-token GLA decode through the fused registry family: gate,
    state update, q.S and normalizer divide in one kernel on "cuda".
    Same contract as `gla_decode_step`, except that the state tensors are
    updated in place and returned as the same GLAState."""
    return get_kernel("gla_decode_fused", backend, q.device).fwd(
        state, q, k, v, log_decay, a, b)


# ---------------------------------------------------------------------------
# ssd: Mamba-2's scalar-decay causal forward + analytic backward
# ---------------------------------------------------------------------------

def _ssd_cuda_fwd(q, k, v, log_decay, chunk):
    # the mixer hands over slices of its conv output (q, k) and transposes
    # (v, log_decay); the kernel reads rows
    return _kssd.ssd_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              log_decay.float().contiguous())


def _ssd_cuda_bwd(q, k, v, log_decay, o, omega, chunk):
    # omega from autograd may be strided or expanded
    return _kssd.ssd_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                              log_decay, o, omega.contiguous())


def _ssd_ref_fwd(q, k, v, log_decay, chunk):
    # the oracle is grouped-native: shared q/k heads stay (B, G, N, Dk)
    return _ref.ssd_ref(q, k, v, log_decay)


register_kernel("ssd", "torch", fwd=_kssd.ssd_fwd_torch,
                bwd=_kssd.ssd_bwd_torch)
register_kernel("ssd", "cuda", fwd=_ssd_cuda_fwd, bwd=_ssd_cuda_bwd)
register_kernel("ssd", "ref", fwd=_ssd_ref_fwd)  # bwd: the plain one


class _SSDCausal(torch.autograd.Function):
    """ssd_causal with the analytic backward; residuals {q, k, v,
    log_decay, o}."""

    @staticmethod
    def forward(ctx, q, k, v, log_decay, chunk, backend):
        impl = get_kernel("ssd", backend, q.device)
        o = impl.fwd(q, k, v, log_decay, chunk)
        ctx.save_for_backward(q, k, v, log_decay, o)
        ctx.impl, ctx.chunk = impl, chunk
        return o

    @staticmethod
    def backward(ctx, omega):
        q, k, v, log_decay, o = ctx.saved_tensors
        bwd = ctx.impl.bwd or _ssd.ssd_bwd_chunked
        dq, dk, dv, dld = bwd(q, k, v, log_decay, o, omega, ctx.chunk)
        return dq, dk, dv, dld, None, None


def ssd_causal(q, k, v, log_decay, chunk: int = DEFAULT_SCAN_CHUNK,
               backend: str = "auto"):
    """SSD (Mamba-2) with the analytic O(N D) backward (the training
    entry), differentiable in q, k, v and log_decay.

    q, k: (B, G, N, Dk) with G | H, shared per group; v: (B, H, N, Dv);
    log_decay: (B, H, N) <= 0.  Returns (B, H, N, Dv) in v.dtype; dq and
    dk come back group-summed, dlog_decay in log_decay's dtype.  chunk
    and backend are not differentiated.
    """
    return _SSDCausal.apply(q, k, v, log_decay, chunk, backend)


# ---------------------------------------------------------------------------
# softmax: causal flash forward (+ q_offset) and recomputation backward
# ---------------------------------------------------------------------------

def _softmax_torch_fwd(q, k, v, causal, chunk, q_offset=None):
    return _softmax.softmax_chunked(q, k, v, causal=causal, chunk=chunk,
                                    q_offset=q_offset)


def _softmax_torch_fwd_res(q, k, v, chunk):
    return _fl.flash_fwd_torch(q, k, v, chunk=chunk)


def _softmax_cuda_fwd(q, k, v, causal, chunk, q_offset=None):
    if not causal:
        raise NotImplementedError(
            "non-causal softmax attention runs only on the encoder-decoder "
            "path and comes with that slice (ROADMAP.md queue 1 "
            "'Remaining architectures'); the flash kernel is causal")
    # the model hands over strided head views; the kernel reads rows
    o, _ = _fl.flash_fwd_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        None if q_offset is None else q_offset.to(torch.int32).contiguous(),
        return_lse=False)
    return o


def _softmax_cuda_fwd_res(q, k, v, chunk):
    return _fl.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                              v.contiguous(), return_lse=True)


def _softmax_cuda_bwd(q, k, v, o, lse, do, chunk):
    # do from autograd may be strided or expanded
    return _fl.flash_bwd_cuda(q.contiguous(), k.contiguous(),
                              v.contiguous(), o, lse, do.contiguous())


def _softmax_ref_fwd(q, k, v, causal, chunk, q_offset=None):
    if q_offset is not None:
        return _softmax.softmax_chunked(q, k, v, causal=causal, chunk=chunk,
                                        q_offset=q_offset)
    return _ref.softmax_ref(q, k, v, causal=causal)


register_kernel("softmax", "torch", fwd=_softmax_torch_fwd,
                bwd=_fl.flash_bwd_torch, fwd_res=_softmax_torch_fwd_res)
register_kernel("softmax", "cuda", fwd=_softmax_cuda_fwd,
                bwd=_softmax_cuda_bwd, fwd_res=_softmax_cuda_fwd_res)
# ref: no custom backward; softmax_attention differentiates the oracle
register_kernel("softmax", "ref", fwd=_softmax_ref_fwd)


class _SoftmaxCausal(torch.autograd.Function):
    """softmax_causal with the recomputation backward; residuals {q, k, v,
    o, lse}."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, impl_name):
        impl = get_kernel("softmax", impl_name, q.device)
        if impl.fwd_res is None or impl.bwd is None:
            raise ValueError(
                f"softmax kernel impl {impl.name!r} has no custom backward "
                f"(fwd_res/bwd); differentiate through softmax_attention or "
                f"pick one of {_with_bwd('softmax')}")
        o, lse = impl.fwd_res(q, k, v, chunk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.impl, ctx.chunk = impl, chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.impl.bwd(q, k, v, o, lse, do, ctx.chunk)
        return dq, dk, dv, None, None


def _with_bwd(family: str) -> list[str]:
    return sorted(n for (f, n), i in _KERNELS.items()
                  if f == family and i.bwd is not None)


def softmax_causal(q, k, v, chunk: int = DEFAULT_SCAN_CHUNK,
                   backend: str = "auto"):
    """Causal softmax attention with the flash recomputation backward (the
    training entry).  q: (B, H, N, D); k, v: (B, Hkv, N, D), Hkv | H.
    Only impls that registered fwd_res and bwd ("torch", "cuda")."""
    return _SoftmaxCausal.apply(q, k, v, chunk, backend)


def softmax_attention(q, k, v, *, causal: bool = True,
                      chunk: int = DEFAULT_SCAN_CHUNK, backend: str = "auto",
                      q_offset: Optional[torch.Tensor] = None):
    """Softmax-baseline attention through the registry.

    q: (B, H, Nq, D); k, v: (B, Hkv, Nk, D), Hkv | H.  Causal training
    (no q_offset) on an impl with a backward goes through
    `softmax_causal`; everything else calls the impl's forward, which
    autograd differentiates where it can (the `ref` oracle).  q_offset:
    optional (B,) global position of query 0 per sequence (serving
    continuation prefill against a populated KV cache), forward only,
    as in the reference.
    """
    impl = get_kernel("softmax", backend, q.device)
    if causal and q_offset is None and impl.bwd is not None:
        return _SoftmaxCausal.apply(q, k, v, chunk, impl.name)
    return impl.fwd(q, k, v, causal, chunk, q_offset)


# ---------------------------------------------------------------------------
# softmax_decode (unfused) and softmax_decode_fused: one token per slot
# against a contiguous KV cache
# ---------------------------------------------------------------------------

def _softmax_decode_cuda(q, k, v, lengths):
    return _df.softmax_decode_fused_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        lengths.to(torch.int32).contiguous())


register_kernel("softmax_decode", "torch", fwd=_df.softmax_decode_fused_torch)
register_kernel("softmax_decode", "ref", fwd=_df.softmax_decode_fused_torch)
register_kernel("softmax_decode_fused", "torch",
                fwd=_df.softmax_decode_fused_torch)
register_kernel("softmax_decode_fused", "ref",
                fwd=_df.softmax_decode_fused_torch)
register_kernel("softmax_decode_fused", "cuda", fwd=_softmax_decode_cuda)


def softmax_decode(q, k, v, lengths, *, backend: str = "auto"):
    """Contiguous-cache softmax decode, unfused (cfg.la.fused_decode
    False).  q: (B, H, 1, D); k, v: (B, Hkv, S, D); lengths: (B,) valid
    keys per slot, the just-written token included.  As in the
    reference, the family has only plain impls: impl names without an
    entry (the kernel's "cuda") run the plain composition; the kernel
    path is `softmax_decode_fused`.
    """
    name = resolve_impl(backend, q.device)
    impl = _KERNELS.get(("softmax_decode", name)) \
        or get_kernel("softmax_decode", "torch")
    return impl.fwd(q, k, v, lengths)


def softmax_decode_fused(q, k, v, lengths, *, backend: str = "auto"):
    """Contiguous-cache softmax decode through the fused family: on the
    "cuda" impl one kernel does the online softmax, the GQA head-fold
    and the divide.  A length-0 slot yields zeros on "cuda" (as the
    Pallas kernel) and the mean of its value rows on "torch"/"ref" (as
    the reference's xla impl); serving slots always have length >= 1.
    """
    return get_kernel("softmax_decode_fused", backend, q.device).fwd(
        q, k, v, lengths)


# ---------------------------------------------------------------------------
# paged and paged_decode_fused: one token per slot against a paged KV
# arena (the page table names each slot's pages); inference only
# ---------------------------------------------------------------------------

def _paged_args(q, k_pages, v_pages, page_table, lengths):
    # the model hands over a strided q view; the kernels read rows
    return (q.contiguous(), k_pages, v_pages,
            page_table.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous())


def _paged_cuda(*args):
    return _pg.paged_attention_cuda(*_paged_args(*args))


def _paged_fused_cuda(*args):
    return _df.paged_decode_fused_cuda(*_paged_args(*args))


register_kernel("paged", "torch", fwd=_pg.paged_attention_torch)
register_kernel("paged", "ref", fwd=_pg.paged_attention_torch)
register_kernel("paged", "cuda", fwd=_paged_cuda)
register_kernel("paged_decode_fused", "torch",
                fwd=_df.paged_decode_fused_torch)
register_kernel("paged_decode_fused", "ref",
                fwd=_df.paged_decode_fused_torch)
register_kernel("paged_decode_fused", "cuda", fwd=_paged_fused_cuda)


def paged_attention(q, k_pages, v_pages, page_table, lengths, *,
                    backend: str = "auto"):
    """Paged-KV decode through the registry (one query token per slot;
    cfg.la.fused_decode False).

    q: (B, H, 1, D); k_pages/v_pages: (P, Hkv, ps, D) shared arenas;
    page_table: (B, Pmax) int32; lengths: (B,) valid keys per slot.  A
    length-0 slot yields zeros on every impl.
    """
    return get_kernel("paged", backend, q.device).fwd(
        q, k_pages, v_pages, page_table, lengths)


def paged_attention_fused(q, k_pages, v_pages, page_table, lengths, *,
                          backend: str = "auto"):
    """Paged-KV decode through the fused family (the GQA head-fold: on
    "cuda" each arena page is read once per KV head, not once per query
    head).  Same contract as `paged_attention`."""
    return get_kernel("paged_decode_fused", backend, q.device).fwd(
        q, k_pages, v_pages, page_table, lengths)
