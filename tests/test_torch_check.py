"""The port's static kernel-contract checks (`repro_torch.check`) against
the reference's (`repro.check`).

  * each seeded-defect fixture fires the same rule in both: B001 (the
    out-of-bounds blocked copy), J001 (an O(N^2) residual) and J002 (a
    bf16 matmul accumulating in bf16);
  * synthetic plans fire B002, B003 and B004 (tests/test_check.py's
    dropped tail and partial block, and the port's per-block resources);
  * `run_all(device="cpu")` on the port is clean, covers the nine
    families x {torch, cuda, ref}, and every `extern "C"` kernel entry of
    csrc/*.cu has a launch plan;
  * the reference's lint snippets give the same (rule, line) in both
    linters, and the port's L003 (a hardcoded CPU device) fires;
  * the fixture kernel's plain version against the JAX fixture in
    interpret mode;
  * the CLI's report, and its refusal to run without a card unless asked;
  * a `gpu`-marked test of the card half (skips without a card).

Seven tests: ROADMAP's budget for a new test file.  The machine with the
card has no JAX; there the gpu test runs alone (`--noconftest -m gpu`).
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp
    from jax.experimental import pallas

    from repro.check import fixtures as ref_fixtures
    from repro.check import lint as ref_lint
except ImportError:   # the machine with the card has no JAX
    jnp = None

from repro_torch.check import RULES, bounds, fixtures, lint, run_all
from repro_torch.check.registry_audit import FAMILIES, REQUIRED_IMPLS
from repro_torch.kernels import plan

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jnp is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference is not installed here")


def rules_of(findings):
    return sorted({f.rule for f in findings})


def test_fixtures_fire_the_reference_rules():
    pairs = [(fixtures.audit_oob_fixture, ref_fixtures.audit_oob_fixture),
             (fixtures.audit_quadratic_residual_fixture,
              ref_fixtures.audit_quadratic_residual_fixture),
             (fixtures.audit_bf16_fixture, ref_fixtures.audit_bf16_fixture)]
    got = [(rules_of(port()), rules_of(ref())) for port, ref in pairs]
    assert got == [(["REPRO-B001"], ["REPRO-B001"]),
                   (["REPRO-J001"], ["REPRO-J001"]),
                   (["REPRO-J002"], ["REPRO-J002"])]


def _copy_plan(n, block, steps, masked=False, threads=None, smem=0):
    """A blocked copy of `steps` blocks of `block` elements over (n,)."""
    def rows(blk):
        return plan.box((blk[0] * block, (blk[0] + 1) * block),
                        masked=masked)
    accesses = [plan.Access("x", "in", (n,), torch.float32, rows),
                plan.Access("o", "out", (n,), torch.float32, rows)]
    return plan.make("copy", "none", (steps,), threads or block, smem,
                     accesses, (), [], ())


def test_synthetic_plans_fire_b002_b003_b004():
    # a grid one block short of the extent drops the last output block
    assert rules_of(bounds.check_launch(_copy_plan(64, 16, 3))) \
        == ["REPRO-B002"]
    # a block that does not divide the extent: the tail tile crosses it
    assert "REPRO-B003" in rules_of(bounds.check_launch(
        _copy_plan(60, 24, 3)))
    # ... unless the kernel guards it
    assert bounds.check_launch(_copy_plan(60, 24, 3, masked=True)) == []
    # per-block resources: threads, shared memory, grid, registers
    for launch in (_copy_plan(64, 16, 4, threads=2048),
                   _copy_plan(64, 16, 4, smem=plan.MAX_SMEM + 16)):
        assert rules_of(bounds.check_launch(launch)) == ["REPRO-B004"]
    wide = _copy_plan(64, 16, 4, threads=512)
    assert rules_of(bounds.resource_findings(wide, regs=255)) \
        == ["REPRO-B004"]
    assert bounds.resource_findings(wide, regs=128) == []


def test_run_all_cpu_is_clean_and_covers_every_entry():
    report = run_all(device="cpu", log=lambda s: None)
    assert report["device"] == "cpu"
    assert report["findings"] == [], report["findings"]
    assert set(report["rules"]) == set(RULES)
    registry = next(c for c in report["coverage"] if c["pass"] == "registry")
    assert (registry["families"], registry["required_impls"]) \
        == (list(FAMILIES), ["torch", "cuda", "ref"])
    assert list(REQUIRED_IMPLS) == ["torch", "cuda", "ref"]
    audited = {(c["family"], c["impl"]) for c in report["coverage"]
               if c["pass"] == "autograd"}
    assert audited == {(f, i) for f in FAMILIES for i in ("torch", "ref")}
    planned = {k for c in report["coverage"] if c["pass"] == "bounds"
               for k in c["kernels"]} | {fixtures.KERNEL}
    entries = set()
    for src in CSRC.glob("*.cu"):
        entries |= set(re.findall(r'extern "C" int (\w+)\(',
                                  src.read_text()))
    assert {e for e in entries if not e.endswith("_plan")} == planned
    assert len(planned) == 19


# the reference's lint snippets (tests/test_check.py), (path, source)
_SNIPPETS = [
    ("fake.py", "import time\nt = time.perf_counter()  "
                "# repro: ignore[REPRO-L001]\n"),
    ("fake.py", "import time\nt = time.perf_counter()\n"),
    ("serve/fake.py", "import numpy as np\ndef p99(xs):\n"
                      "    return np.percentile(xs, 99)\n"),
    ("obs/fake.py", "import numpy as np\ndef p99(xs):\n"
                    "    return np.percentile(xs, 99)\n"),
    ("train/fake.py", "import numpy as np\ndef p99(xs):\n"
                      "    return np.percentile(xs, 99)\n"),
    ("serve/fake.py", "def p99(xs):\n"
                      "    return sorted(xs)[int(0.99 * len(xs))]\n"),
    ("serve/fake.py", "def f(xs):\n    return sorted(xs)\n"),
    ("obs/fake.py", "from statistics import median\n"),
    ("kernels/fake.py", "from statistics import median\n"),
    ("serve/fake.py", "import time\nt = time.perf_counter()\n"),
    ("serve/fake.py", "import time\nt = time.monotonic()\n"),
    ("train/fake.py", "import time\nt = time.monotonic()\n"),
    ("kernels/fake.py", "def f(x, chunk=64):\n    return x\n"),
]


def _hits(findings):
    return sorted((f.rule, int(f.where.rsplit(":", 1)[1])) for f in findings)


def test_lint_matches_the_reference():
    for path, src in _SNIPPETS:
        want = _hits(ref_lint.lint_file(f"src/repro/{path}", src))
        got = _hits(lint.lint_file(f"src/repro_torch/{path}", src))
        assert got == want, (path, src, got, want)
    # the port's L003: the CPU is the caller's validation device
    cpu_default = "def f(x, device='cpu'):\n    return x\n"
    cpu_literal = ("import torch\n"
                   "x = torch.zeros(3, device=torch.device('cpu'))\n")
    for src in (cpu_default, cpu_literal):
        assert rules_of(lint.lint_file("src/repro_torch/fake.py", src)) \
            == ["REPRO-L003"]
        assert lint.lint_file("tests/test_fake.py", src) == []
    # where the two differ by design: interpret mode is not the port's,
    # and the port has no exempt obs/metrics.py
    interp = "def f(x, interpret=True):\n    return x\n"
    assert lint.lint_file("src/repro_torch/fake.py", interp) == []
    pct = _SNIPPETS[2][1]
    assert ref_lint.lint_file("src/repro/obs/metrics.py", pct) == []
    assert rules_of(lint.lint_file("src/repro_torch/obs/metrics.py", pct)) \
        == ["REPRO-L004"]


def test_fixture_plain_version_against_jax_interpret():
    """Blocks 0 .. t-2 agree.  On the last block the JAX fixture clamps
    its read to block t-1 (48..63 again), while the port's kernel and its
    plain version read the block past x: the guard band, the defect."""
    n, block = 64, 16
    real = pallas.pallas_call
    pallas.pallas_call = lambda *a, **kw: real(*a, interpret=True, **kw)
    try:
        want = np.asarray(ref_fixtures.oob_blocked_sum(
            jnp.arange(n, dtype=jnp.float32), block))
    finally:
        pallas.pallas_call = real
    g = fixtures.guarded_oob_input(n, "cpu")
    got = fixtures.oob_blocked_sum(g.view, block).numpy()
    np.testing.assert_array_equal(got[:n - block], want[:n - block])
    np.testing.assert_array_equal(want[n - block:], np.arange(48, 64))
    assert np.isnan(got[n - block:]).all()
    with pytest.raises(IndexError):   # no allocation past x to read
        fixtures.oob_blocked_sum(torch.arange(n, dtype=torch.float32), block)


def test_cli_report_and_device(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = tmp_path / "CHECK.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--device", "cpu",
         "--strict", "--only", "registry,lint,smem", "--json", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text())
    assert set(report) == {"version", "device", "passes", "rules",
                           "coverage", "findings", "counts", "clean"}
    assert (report["device"], report["clean"]) == ("cpu", True)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--only", "registry"],
        env=env, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        assert proc.returncode == 0
    else:
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.gpu
def test_card_half_clean_and_fixture_caught():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    report = run_all(only={"bounds", "autograd"}, device="cuda",
                     log=lambda s: None)
    assert report["findings"] == [], report["findings"]
    assert all(c["card"] for c in report["coverage"]
               if c["pass"] == "bounds")
    assert rules_of(fixtures.audit_oob_fixture_on_card()) == ["REPRO-B001"]
    g = fixtures.guarded_oob_input(64, "cuda")
    got = fixtures.oob_blocked_sum_cuda(g.view, 16)
    want = fixtures.oob_blocked_sum_torch(g.buf, g.guard, 64, 16)
    torch.testing.assert_close(got, want, equal_nan=True, rtol=0, atol=0)
