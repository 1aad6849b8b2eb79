"""Build the hand-written CUDA kernels with nvcc; load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `build/lib<name>-<hash>.so` at the repo root (`.gitignore` lists
`build/`).  The hash covers the source and the code-generating flags, so
an edited source never loads a stale library.  Nothing is built at
import: the first call that needs a kernel builds it.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# prints each kernel's registers, shared memory and spills; changes no code
PTXAS_VERBOSE = ("-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str], ptxas_verbose: bool = False
              ) -> Dict[str, str]:
    """Compile every named source, one nvcc process each, all started
    together.  Returns name -> compiler output.  A library already built
    from the same source is kept unless `ptxas_verbose` asks for the
    compiler's report."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(NVCC_FLAGS) + (list(PTXAS_VERBOSE) if ptxas_verbose else [])
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not ptxas_verbose:
            continue
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".so",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *flags, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{logs[name]}")
        else:
            # atomic: a concurrent loader sees the old file or the new one
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for `name`, building it on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
