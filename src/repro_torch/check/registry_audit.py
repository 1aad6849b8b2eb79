"""Registry coverage + consistency audits (port of
`repro/check/registry_audit.py`).

  REPRO-R001  every kernel family of the reference's list registers the
              port's full impl set {torch, cuda, ref}: the plain version
              that the CPU runs, the hand-written kernel, and the oracle
              both are held against.
  REPRO-R002  every mixer backend's capability flags match the methods
              it overrides: a backend claiming `supports_noncausal`
              without overriding `apply_noncausal` reaches the base
              class's NotImplementedError at dispatch, and one that
              implements `cross_precompute` and `cross_decode` without
              claiming `supports_cross_decode` hides a working path from
              the encoder-decoder's backend resolution.
  REPRO-R003  a softmax-family impl registering a `bwd` also registers
              the `fwd_res` that produces its residuals: `softmax_causal`
              calls fwd_res for any impl it will later call bwd on.
"""
from __future__ import annotations

from repro_torch.check.findings import Finding
from repro_torch.kernels import ops
from repro_torch.mixers import base as mixer_base

FAMILIES = ("linear", "softmax", "gla", "ssd", "paged",
            "linear_decode_fused", "gla_decode_fused",
            "softmax_decode_fused", "paged_decode_fused")
REQUIRED_IMPLS = ("torch", "cuda", "ref")

# (flag, methods that must be overridden iff the flag is set)
_CAPABILITIES = (
    ("supports_noncausal", ("apply_noncausal",)),
    ("supports_cross_decode", ("cross_precompute", "cross_decode")),
)


def check_kernel_registry() -> list[Finding]:
    findings = []
    for family in FAMILIES:
        names = set(ops.kernel_names(family))
        for impl in REQUIRED_IMPLS:
            if impl not in names:
                findings.append(Finding(
                    "REPRO-R001", f"kernels/ops.py[{family}]",
                    f"family registers {sorted(names)} but not "
                    f"{impl!r}"))
        if family == "softmax":
            for name in sorted(names):
                impl = ops.get_kernel(family, name)
                if impl.bwd is not None and impl.fwd_res is None:
                    findings.append(Finding(
                        "REPRO-R003",
                        f"kernels/ops.py[{family}.{name}]",
                        "bwd registered without fwd_res; the autograd "
                        "Function cannot produce this impl's residuals"))
    return findings


def _overrides(backend, method: str) -> bool:
    """Whether the backend's class (or a parent backend class) overrides
    the AttentionBackend stub of `method`."""
    base_fn = getattr(mixer_base.AttentionBackend, method)
    return getattr(type(backend), method, base_fn) is not base_fn


def check_mixer_flags(backends=None) -> list[Finding]:
    """REPRO-R002 over the registered backends (or `backends`, name ->
    instance)."""
    findings = []
    if backends is None:
        backends = mixer_base._BACKENDS
    for name, backend in sorted(backends.items()):
        for flag, methods in _CAPABILITIES:
            claimed = bool(getattr(backend, flag))
            # a subclass may inherit the override from its parent backend
            # class while re-declaring the flag (mixers/gla.py narrows
            # GQAProjectionBackend): "overridden" means "not the base
            # stub"
            has = all(_overrides(backend, m) for m in methods)
            if claimed and not has:
                findings.append(Finding(
                    "REPRO-R002", f"mixers[{name}]",
                    f"{flag}=True but {methods} not overridden (would "
                    f"raise NotImplementedError at dispatch)"))
            elif has and not claimed and flag == "supports_cross_decode":
                findings.append(Finding(
                    "REPRO-R002", f"mixers[{name}]",
                    f"{flag}=False but {methods} are implemented "
                    f"(working path hidden from model selection)"))
    return findings


def run(log=lambda s: None) -> tuple[list[Finding], list[dict]]:
    findings = check_kernel_registry() + check_mixer_flags()
    coverage = [{"pass": "registry", "families": list(FAMILIES),
                 "required_impls": list(REQUIRED_IMPLS),
                 "mixers": sorted(mixer_base._BACKENDS)}]
    log(f"check,registry,{'FAIL' if findings else 'ok'} "
        f"({len(FAMILIES)} families, {len(mixer_base._BACKENDS)} mixers)")
    return findings, coverage
