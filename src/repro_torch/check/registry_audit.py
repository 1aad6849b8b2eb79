"""Registry coverage + consistency audits (port of
`repro/check/registry_audit.py`).

  REPRO-R001  every kernel family of the reference's list registers the
              port's full impl set {torch, cuda, ref}: the plain version
              that the CPU runs, the hand-written kernel, and the oracle
              both are held against.
  REPRO-R002  reserved: the port's mixers declare no capability flags yet
              (ROADMAP queue 1 item 7 brings them with the
              encoder-decoder path); the coverage record says so.
  REPRO-R003  a softmax-family impl registering a `bwd` also registers
              the `fwd_res` that produces its residuals: `softmax_causal`
              calls fwd_res for any impl it will later call bwd on.
"""
from __future__ import annotations

from repro_torch.check.findings import Finding
from repro_torch.kernels import ops

FAMILIES = ("linear", "softmax", "gla", "ssd", "paged",
            "linear_decode_fused", "gla_decode_fused",
            "softmax_decode_fused", "paged_decode_fused")
REQUIRED_IMPLS = ("torch", "cuda", "ref")


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


def run(log=lambda s: None) -> tuple[list[Finding], list[dict]]:
    findings = check_kernel_registry()
    coverage = [{"pass": "registry", "families": list(FAMILIES),
                 "required_impls": list(REQUIRED_IMPLS),
                 "not_audited": {"REPRO-R002": "the port's mixers have no "
                                               "capability flags yet"}}]
    log(f"check,registry,{'FAIL' if findings else 'ok'} "
        f"({len(FAMILIES)} families)")
    return findings, coverage
