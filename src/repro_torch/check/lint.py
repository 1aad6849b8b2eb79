"""AST lint for the port's repo invariants (port of `repro/check/lint.py`).

Single-file, stdlib-`ast` based, no execution of the linted code; it walks
`src/repro_torch/`.

  REPRO-L001  `time.time` / `time.perf_counter` (call, reference, or
              from-import) anywhere but `tune/timer.py`: every clock of
              the port is `repro_torch.tune.timer.now`, which measures
              device work only around code that has synchronized.
  REPRO-L002  integer-literal tile constants in `kernels/*.py` outside
              `defaults.py`: parameter defaults or module constants named
              like chunk/block/stage tokens/warps (the reference's names
              plus the port's `*_STAGE_TOKENS`, `*_WARPS` and
              `FLASH_BLOCK_*`) must come from `kernels/defaults.py`.
  REPRO-L003  `device="cpu"` or `torch.device("cpu")` as a parameter
              default or a literal keyword argument in non-test code.  On
              the port the CPU plays the part that interpret mode plays
              in the reference: the validation device, chosen by the
              caller (tests, `--device cpu`) and never hardcoded; entry
              points default to "cuda" and raise without a card.
  REPRO-L004  ad-hoc latency math inside `serve/` or `obs/`: any `time.*`
              clock, an `np/numpy/statistics` percentile / quantile /
              median call (or from-import), or `sorted(...)[...]` rank
              indexing.  The port has no `obs/metrics.py` yet, so no file
              of the serving stack is exempt.  `time.*` in serve/ fires
              L001 AND L004 by design, as in the reference.

Suppression: a line ending in `# repro: ignore[RULE]` is exempt from
RULE (use sparingly, with a justification comment).
"""
from __future__ import annotations

import ast
import os
import re

from repro_torch.check.findings import Finding

# the repo root: this file is src/repro_torch/check/lint.py
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
LINT_ROOTS = (os.path.join("src", "repro_torch"),)
TIMER_HOME = os.path.join("tune", "timer.py")
_TIME_ATTRS = {"time", "perf_counter"}
# L004: every clock the time module offers, not just the two L001 bans
_CLOCK_ATTRS = {"time", "perf_counter", "monotonic", "process_time",
                "thread_time", "time_ns", "perf_counter_ns",
                "monotonic_ns"}
_PCT_MODULES = {"np", "numpy", "statistics"}
_PCT_ATTRS = {"percentile", "nanpercentile", "quantile", "nanquantile",
              "quantiles", "median", "nanmedian"}
_TILE_NAME = re.compile(
    r"(^|_)(chunk|block_q|block_k|blk|bq|bk|pages_per_block|ppb)($|_)"
    r"|(^|_)(chunk|block)s?$"
    r"|_stage_tokens$|(^|_)warps$|^flash_block_",
    re.IGNORECASE)
_SUPPRESS = re.compile(r"#\s*repro:\s*ignore\[([A-Z0-9-]+)\]")


def _is_test_path(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return any(p in ("tests", "conftest.py") or p.startswith("test_")
               for p in parts)


def _suppressed(source_lines: list[str], lineno: int, rule: str) -> bool:
    if 1 <= lineno <= len(source_lines):
        m = _SUPPRESS.search(source_lines[lineno - 1])
        return bool(m) and m.group(1) in (rule, rule.split("-")[-1])
    return False


def _is_cpu(node) -> bool:
    """The literal "cpu", or torch.device("cpu") / device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and len(node.args) == 1:
        func = node.func
        named = (isinstance(func, ast.Attribute) and func.attr == "device"
                 ) or (isinstance(func, ast.Name) and func.id == "device")
        return named and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value == "cpu"
    return False


class _FileLint(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: list[Finding] = []
        norm = os.path.normpath(path)
        self.in_kernels = (os.sep + "kernels" + os.sep in norm
                           and not norm.endswith("defaults.py"))
        self.is_timer = norm.endswith(TIMER_HOME)
        self.is_test = _is_test_path(path)
        self.in_serving = ((os.sep + "serve" + os.sep in norm
                            or os.sep + "obs" + os.sep in norm)
                           and not self.is_test)
        # names bound by `import time as X` in this file
        self.time_aliases: set[str] = set()

    def _emit(self, rule: str, node: ast.AST, detail: str):
        lineno = getattr(node, "lineno", 0)
        if _suppressed(self.lines, lineno, rule):
            return
        self.findings.append(
            Finding(rule, f"{self.path}:{lineno}", detail))

    # -- L001 / L004 ---------------------------------------------------------
    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            if alias.name == "time":
                self.time_aliases.add(alias.asname or "time")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module == "time" and not self.is_timer:
            for alias in node.names:
                if alias.name in _TIME_ATTRS:
                    self._emit("REPRO-L001", node,
                               f"from time import {alias.name}; use "
                               f"repro_torch.tune.timer instead")
                if self.in_serving and alias.name in _CLOCK_ATTRS:
                    self._emit("REPRO-L004", node,
                               f"from time import {alias.name} in the "
                               f"serving stack; stamp with "
                               f"repro_torch.tune.timer.now")
        if self.in_serving and node.module in ("numpy", "statistics"):
            for alias in node.names:
                if alias.name in _PCT_ATTRS:
                    self._emit("REPRO-L004", node,
                               f"from {node.module} import {alias.name}; "
                               f"no percentile math in the serving stack")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute):
        if (not self.is_timer and node.attr in _TIME_ATTRS
                and isinstance(node.value, ast.Name)
                and node.value.id in self.time_aliases):
            self._emit("REPRO-L001", node,
                       f"{node.value.id}.{node.attr}; use "
                       f"repro_torch.tune.timer.now")
        if self.in_serving and isinstance(node.value, ast.Name):
            if (node.value.id in self.time_aliases
                    and node.attr in _CLOCK_ATTRS):
                self._emit("REPRO-L004", node,
                           f"{node.value.id}.{node.attr} in the serving "
                           f"stack; stamp with repro_torch.tune.timer.now")
            elif (node.value.id in _PCT_MODULES
                    and node.attr in _PCT_ATTRS):
                self._emit("REPRO-L004", node,
                           f"{node.value.id}.{node.attr} in the serving "
                           f"stack; no percentile math there")
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript):
        # L004: sorted(...)[...] — hand-rolled rank/percentile indexing
        if (self.in_serving and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id == "sorted"):
            self._emit("REPRO-L004", node,
                       "sorted(...)[...] rank indexing in the serving "
                       "stack")
        self.generic_visit(node)

    # -- L002 / L003 ---------------------------------------------------------
    def _check_defaults(self, node):
        posargs = node.args.posonlyargs + node.args.args
        defaults = node.args.defaults
        pairs = list(zip(posargs[len(posargs) - len(defaults):], defaults))
        pairs += [(a, d) for a, d in
                  zip(node.args.kwonlyargs, node.args.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if (self.in_kernels and _TILE_NAME.search(arg.arg)
                    and isinstance(default, ast.Constant)
                    and type(default.value) is int):
                self._emit("REPRO-L002", default,
                           f"parameter {arg.arg}={default.value} "
                           f"hardcodes a tile; source it from "
                           f"kernels/defaults.py")
            if not self.is_test and _is_cpu(default):
                self._emit("REPRO-L003", default,
                           f"def {node.name}(..., {arg.arg}=cpu) in "
                           f"non-test code; the caller picks the CPU")

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef):
        self._check_defaults(node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        if (self.in_kernels and isinstance(node.value, ast.Constant)
                and type(node.value.value) is int):
            for target in node.targets:
                if (isinstance(target, ast.Name)
                        and _TILE_NAME.search(target.id)):
                    self._emit("REPRO-L002", node,
                               f"{target.id} = {node.value.value} "
                               f"hardcodes a tile constant; import it "
                               f"from kernels/defaults.py")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        if not self.is_test:
            for kw in node.keywords:
                if kw.arg == "device" and _is_cpu(kw.value):
                    self._emit("REPRO-L003", kw.value,
                               "device=cpu literal in non-test code; the "
                               "caller picks the CPU")
        self.generic_visit(node)


def lint_file(path: str, source: str | None = None) -> list[Finding]:
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("REPRO-L001", f"{path}:{e.lineno or 0}",
                        f"unparseable file: {e.msg}")]
    lint = _FileLint(path, source)
    lint.visit(tree)
    return lint.findings


def iter_source_files(root: str = ROOT) -> list[str]:
    """Every .py file under LINT_ROOTS, relative to `root`."""
    files = []
    for base in LINT_ROOTS:
        for dirpath, dirnames, filenames in os.walk(os.path.join(root, base)):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in ("__pycache__", ".git"))
            files += [os.path.relpath(os.path.join(dirpath, fn), root)
                      for fn in sorted(filenames) if fn.endswith(".py")]
    return files


def run(root: str = ROOT, log=lambda s: None
        ) -> tuple[list[Finding], list[dict]]:
    findings: list[Finding] = []
    files = [p for p in iter_source_files(root) if not _is_test_path(p)]
    for path in files:
        with open(os.path.join(root, path), encoding="utf-8") as f:
            findings += lint_file(path, f.read())
    log(f"check,lint,{'FAIL' if findings else 'ok'} ({len(files)} files)")
    return findings, [{"pass": "lint", "files": len(files),
                       "roots": list(LINT_ROOTS)}]
