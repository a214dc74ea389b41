"""Nested dicts, lists and tuples of tensors, walked in ``jax.tree``'s order.

The port keeps parameters, caches and migration state as plain nested
dicts, as ``repro`` keeps its pytrees, so that a leaf list of one package
lines up with the other's: dict keys are visited in sorted order, lists and
tuples in theirs, and ``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:  # noqa: A001
    """``tree`` with ``fn`` applied to every tensor, structure kept."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, v) for v in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")
