"""Launch plans of the CUDA kernels, from the wrappers' shapes alone.

Beside every CUDA wrapper in kernels/*.py sits one `plan_<entry>` function
per C entry: a pure function of the wrapper's arguments (it reads their
shapes and dtypes, never their values; meta tensors will do) that returns
a `Launch`:

  * the geometry the entry launches: grid, threads per block, dynamic
    shared memory and, where the kernel stages tokens, the stage after
    the launcher's shrink to fit.  Each source's launcher computes these
    in one host function that its C export `<source>_plan` also reports
    (csrc/plan.cuh), and `repro_torch.check.bounds` holds the two equal on
    the card;
  * one `Access` per pointer the entry takes: its role ("in", "out",
    "inout", or "scratch": f32 work space that the entry's first kernel
    writes and its second reads, allocated by the wrapper), its extent and
    dtype as the kernel indexes it, and
    `tile(block, *gathered) -> [Tile]`, the element ranges per dim that
    block (x, y, z) touches, each with a `masked` flag where the kernel
    guards the tail at the extent (it reads and writes nothing past it).
    Operands whose VALUES decide what a block touches (page tables,
    lengths, q_offset) are named in `gathered` and reach `tile` as numpy
    arrays, so that a walk off a table raises IndexError;
  * how to call the entry: the pointer names in order (None for a null
    pointer), the other arguments before the stream, and their ctypes
    types, so that a check can launch it on operands of its own.

The limits below are the H100's (NVIDIA's data sheet and the CUDA
programming guide's compute capability 9.0 table).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import torch

from repro_torch.kernels import build

MAX_SMEM = 232448          # dynamic shared memory a block may opt in to
MAX_THREADS = 1024         # threads per block
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535
REGISTERS_PER_SM = 65536   # 32-bit registers of one SM
PLAN_FIELDS = 7            # int64 values of a `<source>_plan` export's out
F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Tile:
    """Element ranges [lo, hi) per dim that one block touches; `masked`:
    the kernel guards every element at the operand's extent."""

    ranges: tuple
    masked: bool = False


@dataclasses.dataclass(frozen=True)
class Access:
    """One pointer of an entry: what each block touches through it."""

    name: str
    role: str          # "in", "out", "inout" or "scratch"
    shape: tuple       # the extent as the kernel indexes it
    dtype: torch.dtype
    tile: Callable     # tile((x, y, z), *gathered) -> list[Tile]


@dataclasses.dataclass(frozen=True)
class Launch:
    name: str                  # the C entry
    lib: str                   # its source, csrc/<lib>.cu
    grid: tuple                # (x, y, z)
    threads: int
    smem: int                  # dynamic shared memory, bytes
    accesses: tuple            # Access per pointer, in the entry's order
    pointers: tuple            # access names in the entry's order; None: null
    args: tuple                # the entry's other arguments before the stream
    argtypes: list             # ctypes types of all its arguments
    plan_args: tuple           # ints after `entry` of `<lib>_plan`
    gathered: tuple = ()       # names of the operands `tile` reads
    smem_limit: int = MAX_SMEM  # the launcher refuses more
    stage: Optional[int] = None  # staged tokens per iteration, if any

    def blocks(self):
        """Every block index (x, y, z) of the grid."""
        return itertools.product(*(range(g) for g in self.grid))


def box(*ranges, masked: bool = False) -> list:
    """One tile of the given (lo, hi) ranges."""
    return [Tile(tuple((int(lo), int(hi)) for lo, hi in ranges), masked)]


def fit(stage: int, per_token: int, limit: int = MAX_SMEM):
    """(stage, smem): at most `stage` tokens of `per_token` bytes that fit
    `limit`, 0 where one token does not (smem then one token's bytes), as
    `plan::fit` (csrc/plan.cuh)."""
    fitted = min(stage, limit // per_token)
    return fitted, max(fitted, 1) * per_token


def make(name: str, lib: str, grid, threads: int, smem: int, accesses,
         args, argtypes, plan_args, *, pointers=None, gathered=(),
         smem_limit: int = MAX_SMEM, stage: Optional[int] = None) -> Launch:
    """A Launch with the grid padded to three dims and the pointers taken
    from the accesses' order unless given."""
    grid = tuple(int(g) for g in grid) + (1,) * (3 - len(grid))
    accesses = tuple(accesses)
    if pointers is None:
        pointers = tuple(a.name for a in accesses)
    return Launch(name=name, lib=lib, grid=grid, threads=int(threads),
                  smem=int(smem), accesses=accesses, pointers=tuple(pointers),
                  args=tuple(args), argtypes=list(argtypes),
                  plan_args=tuple(int(a) for a in plan_args),
                  gathered=tuple(gathered), smem_limit=int(smem_limit),
                  stage=stage)


def dtype_code(dtype: torch.dtype) -> int:
    """The C code of a compute dtype; raises on one the kernels do not
    take."""
    if dtype not in build.DTYPE_CODE:
        raise ValueError(f"compute dtype {dtype} is not one of "
                         f"{list(build.DTYPE_CODE)}")
    return build.DTYPE_CODE[dtype]


def shape_of(t) -> tuple:
    return tuple(int(e) for e in t.shape)
