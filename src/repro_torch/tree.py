"""Parameter trees: nested dicts and lists of tensors, as the model keeps
them (the counterpart of the `jax.tree` calls of the reference)."""
from __future__ import annotations

import torch


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf, depth first in insertion order;
    paths join keys and list indices with dots ("blocks.0.mixer.wq.w")."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += named_leaves(sub, f"{prefix}.{key}" if prefix else str(key))
    return out


def leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]
