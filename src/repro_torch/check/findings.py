"""Finding records + the rule catalog for `repro_torch.check`.

The port's counterpart of `repro/check/findings.py`.  Every analyzer pass
emits `Finding`s tagged with a stable rule ID; the CLI aggregates them into
a report and exits 1 on any under `--strict`.  The IDs are the reference's,
and append-only: a retired rule keeps its ID reserved.  The wording is for
Hopper where the TPU's differs (B004: per-block resources; V001: shared
memory), and one rule is the port's own (B005).  docs/static_analysis_torch.md
is the human-readable catalog.

Prefixes group the passes:

  REPRO-J*  autograd audits        (check/autograd_audit.py)
  REPRO-B*  launch bounds          (check/bounds.py)
  REPRO-V*  shared-memory legality (check/smem.py)
  REPRO-R*  registry coverage      (check/registry_audit.py)
  REPRO-L*  AST lint               (check/lint.py)
"""
from __future__ import annotations

import dataclasses

RULES: dict[str, str] = {
    # -- autograd audits ---------------------------------------------------
    "REPRO-J001": "autograd-Function residual bytes grow superlinearly in "
                  "N (the paper's memory story requires O(ND) residuals)",
    "REPRO-J002": "low-precision matmul (mm/bmm/addmm/baddbmm) that takes "
                  "bf16/f16 operands and returns bf16/f16 (unguarded "
                  "low-precision accumulation)",
    "REPRO-J003": "kernel output dtype does not close over the input "
                  "dtype (f32 leak or silent downcast)",
    # -- launch bounds -----------------------------------------------------
    "REPRO-B001": "an unmasked access outside the operand's extent at "
                  "some block (incl. gathers through page tables, "
                  "lengths and q_offset), or a guard band read or written "
                  "on the card",
    "REPRO-B002": "the blocks do not cover the full output extent "
                  "(dropped tail)",
    "REPRO-B003": "a tile that does not divide its extent is not declared "
                  "masked (a partial tile reads or writes past the end)",
    "REPRO-B004": "per-block resources exceed the H100's: dynamic shared "
                  "memory above the launcher's limit (232,448 B opt-in), "
                  "threads above 1024, grid y or z above 65,535, or "
                  "registers x threads above 65,536",
    # -- shared-memory legality -------------------------------------------
    "REPRO-V001": "default size (kernels/defaults.py) fails the "
                  "shared-memory limit for a registry shape",
    "REPRO-V002": "tuning-cache entry is invalid or its sizes fail the "
                  "shared-memory limit for its shape bucket (reserved: the "
                  "port has no tuning cache yet)",
    # -- registry coverage -------------------------------------------------
    "REPRO-R001": "kernel family missing a required impl (torch/cuda/ref)",
    "REPRO-R002": "mixer capability flag inconsistent with the methods "
                  "the backend actually overrides",
    "REPRO-R003": "softmax-family impl registers a bwd without the "
                  "fwd_res the autograd Function needs",
    # -- AST lint ----------------------------------------------------------
    "REPRO-L001": "time.time/time.perf_counter outside tune/timer.py "
                  "(use repro_torch.tune.timer)",
    "REPRO-L002": "hardcoded tile constant in kernels/*.py outside "
                  "defaults.py (chunk/block/stage tokens/warps)",
    "REPRO-L003": "device=\"cpu\" or torch.device(\"cpu\") as a parameter "
                  "default or literal keyword in non-test code (the CPU is "
                  "the caller's validation device, never hardcoded)",
    "REPRO-L004": "ad-hoc latency math in serve/ or obs/: time.* clocks, "
                  "np/statistics percentile/quantile/median calls, or "
                  "sorted(...)[...] rank indexing",
    # -- appended by the port ----------------------------------------------
    "REPRO-B005": "a Python launch plan (kernels/*.py) differs from the "
                  "C launcher's `<source>_plan` export",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit: a stable rule ID, where it fired, and why."""

    rule: str
    where: str   # "entry[operand] @ shape" or "path/to/file.py:LINE"
    detail: str

    def __post_init__(self):
        if self.rule not in RULES:
            raise KeyError(f"unknown rule id {self.rule!r}; known: "
                           f"{sorted(RULES)}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "where": self.where,
                "detail": self.detail, "summary": RULES[self.rule]}

    def __str__(self) -> str:
        return f"{self.rule} {self.where}: {self.detail}"
