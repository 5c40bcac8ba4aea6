"""Small helpers over parameter trees (nested dicts / lists of tensors)."""

from __future__ import annotations

from typing import Callable


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def layer_slice(stacked, i: int):
    """Layer i of parameters stacked on a leading layer axis (views)."""
    return tree_map(lambda x: x[i], stacked)
