"""Token data: the synthetic source (port of `repro/data/pipeline.py`'s
`SyntheticLM`; the memmap source and prefetch come with the multi-GPU
slice).

The reference asks jax for the process count and index; the port asks
`torch.distributed` when a process group is initialized, and is process
0 of 1 otherwise.  Batches are bit-identical to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class SyntheticLM:
    """Deterministic synthetic token stream (Zipf-ish marginals).

    Reproducible across restarts: batch `i` depends only on (seed, i,
    process index), which is what lets a resumed job replay the stream.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.host_batch = global_batch // process_count()

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1

    def batch_at(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, i, process_index()]))
        # Zipf-like marginal over the vocab, cheap to sample
        u = rng.random((self.host_batch, self.seq))
        toks = ((self.vocab - 1) * u ** 3).astype(np.int32) + 1
        return toks
