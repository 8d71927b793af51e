"""Trees of tensors (NamedTuples, tuples, lists; None leaves) as the
port's states and step outputs are."""
from __future__ import annotations

import torch


def tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def copy_into(dst, src) -> None:
    """dst's tensors take src's values (an asynchronous device copy)."""
    for d, s in zip(leaves(dst), leaves(src)):
        d.copy_(s)
