"""Carry the reference's parameters over to the port.

`params_from_jax(cfg, tree)` takes the JAX parameter tree of
`repro.models.model.init_params` as numpy arrays (e.g. after
`jax.tree.map(np.asarray, params)`) and returns the port's tree: the
layer axis that the reference's `_stack_init` puts on axis 0 of every
`blocks` leaf is unstacked into a list of per-layer dicts.  Dense
weights keep their (d_in, d_out) layout, so each one is a copy; the
learnable coefficients `la_a` / `la_b` (one scalar per layer, stacked
to (L,)) become one 0-d f32 tensor per layer.  A tree with tied
embeddings (mamba2) has no `lm_head` and the port's has none either.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(cfg, tree, device="cuda"):
    if cfg.family not in ("dense", "ssm") or "prefix_blocks" in tree:
        raise NotImplementedError(
            f"params_from_jax covers the dense and ssm families; got "
            f"{cfg.family!r}")
    dev = resolve_device(device)
    out = {k: _map(lambda a: _tensor(a, dev), v)
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_map(lambda a, i=i: _tensor(np.asarray(a)[i], dev),
                          tree["blocks"])
                     for i in range(cfg.num_layers)]
    return out
