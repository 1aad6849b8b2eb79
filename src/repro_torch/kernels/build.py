"""Build the hand-written CUDA kernels with nvcc; load and bind them with
ctypes; check what a wrapper hands them.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own
into `build/lib<name>-<hash>.so` at the repo root (`.gitignore` lists
`build/`).  The hash covers the source, the shared headers of `csrc/`
(`*.cuh`) and the code-generating flags, so an edited source or header
never loads a stale library.  Nothing is built at
import: the first call that needs a kernel builds it.

Every source exports its kernels' launchers as plain C functions that
return a cudaError_t, `<name>_error_string`, and `<name>_plan`, which
reports the geometry its launcher would launch (csrc/plan.cuh).  `bind`
declares their signatures, `check_tensors` raises on tensors a kernel
does not take and `raise_on` turns a launcher's error code into an
exception.

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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# prints each kernel's registers, shared memory and spills; changes no code
PTXAS_VERBOSE = ("-Xptxas", "-v")

# every kernel source of csrc/ (without the .cu), in the order of the port's
# slices; the last is the static checks' launch-bounds fixture
SOURCES = ("la_decode_fused", "la_fwd", "la_bwd", "softmax_decode_fused",
           "flash_fwd", "flash_bwd", "paged_decode", "ssd", "check_fixture")

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
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


def bind(name: str, symbols: Dict[str, list]) -> ctypes.CDLL:
    """`load(name)` with the signatures of `symbols` (C function ->
    argtypes; each returns a C int) and of `<name>_error_string` declared.
    Pointers and the stream are c_void_p: undeclared, ctypes would pass
    them as 32-bit ints and cut the address."""
    lib = load(name)
    for sym, argtypes in symbols.items():
        fn = getattr(lib, sym)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, name: str, kernel: str, err: int) -> None:
    """Raise if a launcher of `name`'s library returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_ALIGN = 16          # the kernels read rows by 16-byte vector loads
# C code of each compute dtype the kernels are instantiated for
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_tensors(kernel: str, named: dict, compute: tuple,
                  f32: tuple = (), i32: tuple = ()) -> None:
    """Raise on anything `kernel` does not take: a tensor off CUDA or on
    another card than the first `compute` one, not contiguous or not
    16-byte aligned; `compute` tensors not sharing one of float32 and
    bfloat16; `f32` tensors not float32, `i32` tensors not int32."""
    first = named[compute[0]]
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(
                f"{kernel}_cuda needs CUDA tensors; {name} is on {t.device} "
                f"(the plain version is {kernel}_torch)")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, {compute[0]} on "
                             f"{first.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}_cuda needs contiguous tensors; "
                             f"{name} has strides {t.stride()}")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{kernel}_cuda needs {_ALIGN}-byte aligned "
                             f"tensors; {name} starts at {t.data_ptr():#x}")
    dtypes = [named[n].dtype for n in compute]
    if first.dtype not in DTYPE_CODE or len(set(dtypes)) != 1:
        raise ValueError(f"{', '.join(compute)} must share one dtype of "
                         f"{list(DTYPE_CODE)}; got {dtypes}")
    for names, dtype in ((f32, torch.float32), (i32, torch.int32)):
        for name in names:
            if named[name].dtype != dtype:
                raise ValueError(f"{name} must be {dtype}, got "
                                 f"{named[name].dtype}")
