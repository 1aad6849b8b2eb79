"""PyTorch + CUDA port of the `repro` package (linear attention on Hopper).

The JAX package under `src/repro/` is the reference; this package keeps
its layout (configs/, core/, kernels/, mixers/, models/, serve/,
launch/) so each module's counterpart sits at the same path.  It imports
torch and numpy only.  Every entry point takes an explicit `device`
(default "cuda"); the CPU runs the kernels' plain PyTorch versions.
"""
