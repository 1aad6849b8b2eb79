"""Carry the reference's parameters over to the port.

`params_from_jax(cfg, tree)` takes the JAX parameter tree of
`repro.models.model.init_params` as numpy arrays (e.g. after
`jax.tree.map(np.asarray, params)`) and returns the port's tree: the
layer axis that the reference's `_stack_init` puts on axis 0 of every
`blocks` leaf (dense and ssm families) is unstacked into a list of
per-layer dicts; in the moe family (moonshot-v1-16b-a3b,
deepseek-v2-236b) `prefix_blocks`, the dense first layers, is already a
list of block dicts, and the MoE leaves of `blocks` (the router, the
routed `experts` and the `shared` ones, each stacked (L, E, ...)) lose
their layer axis and keep their expert axis; in the hybrid family
(zamba2) `mamba_groups`, stacked (g, m, ...), becomes g lists of m,
`tail`, stacked (t, ...), a list of t, and the one `shared_attn` block is
not stacked; in the encdec family (whisper) `enc_blocks` and
`dec_blocks` become lists of the encoder's and the decoder's layers, and
`ln_enc` is not stacked.  Dense weights keep
their (d_in, d_out) layout, so each one is a copy; the learnable
coefficients `la_a` / `la_b` (one scalar per layer, stacked to (L,))
become one 0-d f32 tensor per layer.  A tree with tied embeddings
(mamba2, qwen2.5, whisper) has no `lm_head` and the port's has none
either.
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


def _unstack(tree, dev, *index):
    """The layer at `index` of a stacked subtree."""
    return _map(lambda a: _tensor(np.asarray(a)[index], dev), tree)


def params_from_jax(cfg, tree, device="cuda"):
    dev = resolve_device(device)
    stacked = ("blocks", "mamba_groups", "tail", "prefix_blocks",
               "enc_blocks", "dec_blocks")
    out = {k: _map(lambda a: _tensor(a, dev), v)
           for k, v in tree.items() if k not in stacked}
    if cfg.family == "encdec":
        out["enc_blocks"] = [_unstack(tree["enc_blocks"], dev, i)
                             for i in range(cfg.encoder_layers)]
        out["dec_blocks"] = [_unstack(tree["dec_blocks"], dev, i)
                             for i in range(cfg.num_layers)]
        return out
    if "prefix_blocks" in tree:
        out["prefix_blocks"] = [_map(lambda a: _tensor(a, dev), lp)
                                for lp in tree["prefix_blocks"]]
    if cfg.family == "hybrid":
        out["mamba_groups"] = [
            [_unstack(tree["mamba_groups"], dev, i, j)
             for j in range(cfg.hybrid_mamba_per_group)]
            for i in range(cfg.hybrid_groups)]
        if "tail" in tree:
            out["tail"] = [_unstack(tree["tail"], dev, i)
                           for i in range(cfg.hybrid_tail)]
        return out
    out["blocks"] = [_unstack(tree["blocks"], dev, i)
                     for i in range(cfg.num_layers
                                    - len(tree.get("prefix_blocks", [])))]
    return out
