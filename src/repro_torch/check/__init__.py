"""repro_torch.check — the port's static kernel-contract analyzer
(docs/static_analysis_torch.md), the counterpart of `repro.check`.

Audits every registered kernel of the port:

  autograd_audit  J-rules: O(ND) residuals, f32 accumulation, dtype
                  closure (the registry's entry points on small inputs)
  bounds          B-rules: every CUDA entry's launch plan proved block by
                  block (extents, gathers through page tables, tails,
                  per-block resources); on the card also held against the
                  launcher's own `_plan` export and launched under guard
                  bands
  smem            V-rules: default sizes vs the shared-memory limit for
                  every configs/registry.py workload
  registry_audit  R-rules: impl-set completeness, softmax autograd wiring
  lint            L-rules: AST lint for repo invariants (one clock, no
                  stray tile literals, no hardcoded CPU device, no latency
                  math in serving)

The static part runs anywhere; the card half of the bounds pass and the
`cuda` impls of the autograd audit run on the card, which is the default
device.  CLI: `python -m repro_torch.check [--strict] [--json PATH]
[--only ...] [--device cuda|cpu]`.
"""
from __future__ import annotations

from repro_torch.check import autograd_audit, bounds, lint, \
    registry_audit, smem
from repro_torch.check.findings import RULES, Finding  # noqa: F401
from repro_torch.device import resolve_device

PASSES = {
    "registry": lambda device, log: registry_audit.run(log=log),
    "lint": lambda device, log: lint.run(log=log),
    "smem": lambda device, log: smem.run(log=log),
    "autograd": lambda device, log: autograd_audit.run(device, log=log),
    "bounds": lambda device, log: bounds.run(device, log=log),
}


def run_all(only=None, device="cuda", log=print) -> dict:
    """Run the passes (all, or those named in `only`) and return the
    report.  Without a card, device "cuda" raises (resolve_device): the
    CPU runs only when the caller asks for it."""
    dev = resolve_device(device)
    findings, coverage = [], []
    for name, runner in PASSES.items():
        if only and name not in only:
            continue
        f, c = runner(dev, log)
        findings += f
        coverage += [{**rec, "pass": rec.get("pass", name)} for rec in c]
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return {
        "version": 1,
        "device": dev.type,
        "passes": sorted(only) if only else sorted(PASSES),
        "rules": {rid: RULES[rid] for rid in sorted(RULES)},
        "coverage": coverage,
        "findings": [f.to_json() for f in findings],
        "counts": dict(sorted(counts.items())),
        "clean": not findings,
    }
