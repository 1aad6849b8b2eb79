"""Entry points for the port's kernels + the KernelImpl registry.

Port of the serving half of `repro/kernels/ops.py`.  Each (family, impl)
pair is a registered `KernelImpl`; impls are execution backends:

  "torch"  plain PyTorch (any device) — the analogue of the reference's
           "xla" impl
  "cuda"   the hand-written Hopper kernel (CUDA tensors only; a CPU
           tensor raises)
  "auto"   picked per call by the tensors' device: CUDA tensors take
           "cuda", everything else "torch"

`get_kernel` raises an error listing the registered impls for unknown
names.  Serving prefill runs the plain chunked scan on every impl, as
the reference does (`repro/kernels/ops.py::la_prefill`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import chunked as _chunked
from repro_torch.core.chunked import LAState
from repro_torch.kernels import decode_fused as _df
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

__all__ = ["KernelImpl", "register_kernel", "get_kernel", "kernel_names",
           "resolve_impl", "la_prefill", "la_decode_step_fused"]


@dataclasses.dataclass(frozen=True)
class KernelImpl:
    """One execution backend of one kernel family.

    fwd: linear_decode_fused family: (state, q, k, v, a, b) ->
         (state, o), with the state updated in place.
    """

    family: str
    name: str
    fwd: Callable


_KERNELS: dict[tuple[str, str], KernelImpl] = {}


def register_kernel(family: str, name: str, *, fwd) -> KernelImpl:
    impl = KernelImpl(family=family, name=name, fwd=fwd)
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
