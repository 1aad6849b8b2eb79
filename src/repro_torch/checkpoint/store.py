"""Checkpoints: one .npy file per leaf and a JSON manifest with sha256
hashes, an async writer thread, restore in place (port of
`repro/checkpoint/store.py`).

The on-disk contract is the reference's:
  * `path/step_%08d/` holds `leaf_%05d.npy` per leaf and `manifest.json`,
    {"step", "treedef", "time", "leaves": [{"file", "shape", "dtype",
    "sha256"}]}, dtype numpy's name and sha256 that of the leaf's bytes
    (`arr.tobytes()`);
  * a save writes into `step_%08d.tmp/`, the manifest last, and publishes
    it with `os.replace`, so a crash mid-save leaves the previous
    checkpoint the newest restorable one: a `.tmp` directory never is;
  * restore verifies every hash (IOError on a mismatch) and the leaf
    count (ValueError).

The writer and restore move and hash leaves on IO_THREADS threads
(file I/O and hashlib release the GIL), leaves in order, restore
holding at most 2 x IO_THREADS read ahead on the host.

Where the port differs, deliberately:
  * leaves go in `repro_torch.tree.named_leaves` order, insertion order
    (JAX flattens dicts by sorted key, so the two stores agree on trees
    whose keys were inserted sorted); `treedef` is that list of paths;
  * numpy has no bf16: a bf16 tensor is written as its uint16 bits
    ("<u2") under the manifest dtype "bfloat16", hashed as those bits.
    The reference writes bf16 leaves through ml_dtypes ("<V2", the same
    bytes, dtype and hash): the port reads those files, and the
    reference reads the port's as uint16 arrays of the bits;
  * a Python int or float leaf (the optimizer's step count) is written
    as a 0-d int64 or float64 array and restored as a Python number;
  * `save` copies every leaf to the host before it returns, because the
    port's AdamW updates params and moments in place; an async save's
    `PendingSave.join()` re-raises whatever its writer raised, where the
    reference's daemon thread drops it;
  * `restore` copies each leaf into the tensor of `tree_like` in place,
    on that tensor's device, so the card never holds two states.  Every
    leaf's shape and dtype is checked against the manifest first
    (ValueError); a hash mismatch raises after the leaves before it were
    copied, so the tree is then partly restored;
  * no `shardings` argument: placing leaves on other devices comes with
    the multi-GPU slice (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.tree import named_leaves
from repro_torch.tune.timer import now, wallclock

BF16 = "bfloat16"
IO_THREADS = 8


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def digest(arr: np.ndarray) -> str:
    """sha256 of `arr.tobytes()`, without that copy."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()


def _in_order(fn, items):
    """fn(item) for each item on IO_THREADS threads, yielded in order,
    at most 2 x IO_THREADS submitted ahead of the caller; an exception
    is raised where its item's result is due."""
    ex = ThreadPoolExecutor(IO_THREADS)
    ahead = collections.deque()
    try:
        for item in items:
            ahead.append(ex.submit(fn, item))
            if len(ahead) >= 2 * IO_THREADS:
                yield ahead.popleft().result()
        while ahead:
            yield ahead.popleft().result()
    finally:
        ex.shutdown(cancel_futures=True)


def host_copy(x) -> tuple[np.ndarray, str]:
    """(a host copy of one leaf in its on-disk form, its manifest dtype)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        bf16 = t.dtype == torch.bfloat16
        if bf16:
            t = t.view(torch.int16)
        arr = t.to("cpu", copy=True).contiguous().numpy()
        return ((arr.view(np.uint16), BF16) if bf16
                else (arr, str(arr.dtype)))
    if isinstance(x, (bool, np.bool_)) or not isinstance(x, (int, float)):
        raise TypeError(f"cannot checkpoint a leaf of type {type(x)}")
    arr = np.asarray(x, np.int64 if isinstance(x, int) else np.float64)
    return arr, str(arr.dtype)


def _spec(x) -> tuple[list, str | None]:
    """(shape, manifest dtype) that a leaf like `x` restores from; None
    for a Python number, which takes any 0-d numeric leaf."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return list(x.shape), BF16
        return (list(x.shape),
                str(torch.empty(0, dtype=x.dtype).numpy().dtype))
    return [], None


class PendingSave:
    """An async save's writer thread.  `join()` waits for it and re-raises
    what it raised; `write_s` is its seconds (files and hashes)."""

    def __init__(self, write):
        self.error: Exception | None = None
        self.write_s: float | None = None
        self._thread = threading.Thread(target=self._run, args=(write,),
                                        daemon=True)
        self._thread.start()

    def _run(self, write):
        t0 = now()
        try:
            write()
        except Exception as e:  # noqa: BLE001 — kept for join() to raise
            self.error = e
        self.write_s = now() - t0

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise self.error


def save(path: str, tree, step: int, *, blocking: bool = True):
    """Write `tree` under path/step_<step>/.  Returns the checkpoint dir,
    or (dir, PendingSave) when not blocking; either way every leaf is on
    the host before it returns."""
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    tmp_dir = ckpt_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    named = named_leaves(tree)
    paths = [p for p, _ in named]
    host = [host_copy(x) for _, x in named]

    def write_leaf(i):
        arr, dtype = host[i]
        fn = _leaf_name(i)
        np.save(os.path.join(tmp_dir, fn), arr)
        return {"file": fn, "shape": list(arr.shape), "dtype": dtype,
                "sha256": digest(arr)}

    def write():
        manifest = {"step": step, "treedef": paths,
                    "time": wallclock(),
                    "leaves": list(_in_order(write_leaf, range(len(host))))}
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_dir, ckpt_dir)  # atomic publish

    if blocking:
        write()
        return ckpt_dir
    return ckpt_dir, PendingSave(write)


def latest_step(path: str):
    if not os.path.isdir(path):
        return None
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(path, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _load_into(like, arr: np.ndarray, dtype: str):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item())
    src = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
           if dtype == BF16 else torch.from_numpy(arr))
    like.copy_(src)
    return like


def _rebuild(tree, values):
    """`tree` with its leaves taken from the iterator `values`, in
    `named_leaves` order (dicts, lists, tuples and NamedTuples)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, values) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return next(values)


@torch.no_grad()
def restore(path: str, tree_like, step: int | None = None,
            verify: bool = True):
    """Restore into `tree_like`: its tensors are overwritten in place, its
    Python numbers replaced.  Returns (tree, step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    ckpt_dir = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    named = named_leaves(tree_like)
    metas = manifest["leaves"]
    if len(metas) != len(named):
        raise ValueError(f"checkpoint has {len(metas)} leaves, "
                         f"expected {len(named)}")
    for (name, like), meta in zip(named, metas):
        shape, dtype = _spec(like)
        ok = (list(meta["shape"]) == shape and
              (meta["dtype"] == dtype if dtype is not None
               else np.dtype(meta["dtype"]).kind in "iuf"))
        if not ok:
            raise ValueError(
                f"checkpoint leaf {meta['file']} is {meta['dtype']} "
                f"{meta['shape']}; {name!r} is {dtype or type(like)} {shape}")
    def load(i):
        meta = metas[i]
        arr = np.load(os.path.join(ckpt_dir, meta["file"]))
        if verify and digest(arr) != meta["sha256"]:
            raise IOError(f"checkpoint leaf {i} hash mismatch "
                          f"({meta['file']}) — corrupt checkpoint")
        return arr

    values = [_load_into(like, arr, meta["dtype"]) for (_, like), meta, arr
              in zip(named, metas, _in_order(load, range(len(metas))))]
    return _rebuild(tree_like, iter(values)), step
