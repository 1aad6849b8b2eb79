"""Token data (port of `repro/data/pipeline.py`): the synthetic source,
the memmap source over a flat int32 token file, and a background
prefetcher.

Each process reads only its share of the global batch.  The reference
asks jax for the process count and index; the port asks
`torch.distributed` when a process group is initialized, and is process
0 of 1 otherwise.  Batches are bit-identical to the reference's.  The
Trainer reads `batch_at` (its replay after a restore needs the batch of
a step index), so `Prefetcher` is a plain iterator that it does not use,
as in the reference.
"""
from __future__ import annotations

import queue
import threading

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


class MemmapLM:
    """Flat binary token file (np.int32), strided across processes.

    Window w of process p starts at ((w * processes + p) * host_batch *
    seq) tokens, wrapping modulo (file length - window), the reference's
    "each host owns a disjoint stride" layout.  Batches are copies, not
    views of the read-only map.
    """

    def __init__(self, path: str, seq_len: int, global_batch: int):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq = seq_len
        self.global_batch = global_batch
        self.host_batch = global_batch // process_count()

    def batch_at(self, i: int) -> np.ndarray:
        need = self.host_batch * self.seq
        start = ((i * process_count() + process_index()) * need) \
            % max(len(self.data) - need, 1)
        return np.array(self.data[start:start + need]).reshape(
            self.host_batch, self.seq)

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator (depth-bounded)."""

    def __init__(self, it, depth: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass
