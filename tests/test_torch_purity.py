"""The port imports neither jax nor the JAX package.

Every `.py` file under `src/repro_torch/`, and `chip_smoke.py`, which
drives the port on the card, is parsed with `ast`; any
`import jax...`, `from jax...`, `import repro...` or `from repro...`
(the `repro` package, not `repro_torch`) fails.  Then the whole package
is imported in a fresh interpreter and no jax or repro module may be in
`sys.modules`.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _forbidden_imports(source: str):
    """(line, module) of every absolute import of a forbidden package."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_port_sources_import_no_jax_and_no_repro():
    files = _port_files()
    assert len(files) > 20, files
    assert PORT / "kernels" / "ssd.py" in files
    bad = {str(f.relative_to(ROOT)): _forbidden_imports(f.read_text())
           for f in files + [CHIP_SMOKE]}
    assert not {f: b for f, b in bad.items() if b}


def test_purity_check_catches_forbidden_imports():
    src = ("import numpy\nfrom repro.core import chunked\n"
           "import jax.numpy as jnp\nimport repro_torch\n"
           "from jax import lax\n")
    assert _forbidden_imports(src) == [(2, "repro.core"), (3, "jax.numpy"),
                                       (5, "jax")]


@pytest.mark.parametrize("entry", ["repro_torch.launch.serve",
                                   "repro_torch.launch.train",
                                   "repro_torch.convert"])
def test_importing_the_port_loads_no_jax(entry):
    mods = []
    for f in _port_files():
        parts = f.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = ("import importlib, sys\n"
            f"importlib.import_module({entry!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
