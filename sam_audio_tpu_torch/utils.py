"""Small helpers over parameter trees (nested dicts / lists of tensors), and
the serving layer's stage timer."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict

import torch


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves_with_path(tree, prefix: str = ""):
    """[(path, leaf)] with `a/b/0/c` paths, in jax.tree_util's order (dict
    keys sorted, list items in order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_leaves_with_path(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in tree_leaves_with_path(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_map_with_path(fn: Callable, tree, prefix: str = ""):
    """tree_map whose `fn(path, leaf)` also gets the leaf's `a/b/0/c` path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def unstack_layers(stacked):
    """Every layer of parameters stacked on a leading layer axis, as a list
    of trees of views. Each leaf is unbound once: its backward stacks the
    layers' gradients in one pass, where indexing each layer would build a
    full-size zero gradient per layer and sum them."""
    leaves = tree_leaves_with_path(stacked)
    unbound = {path: x.unbind(0) for path, x in leaves}
    return [tree_map_with_path(lambda path, _: unbound[path][i], stacked)
            for i in range(leaves[0][1].shape[0])]


class StageTimer:
    """Wall time per named stage (JAX: utils/profiling.py:39-86).

    with timer.stage("separate"):
        y = run(...)
        timer.sync(y)       # wait for the card inside the stage
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def sync(self, x):
        """Wait for the CUDA device of the first tensor in `x` (a tensor or
        a tree of them); nothing to wait for on the CPU."""
        if not self.enabled:
            return
        leaves = []
        tree_map(leaves.append, x)
        dev = next((t.device for t in leaves if isinstance(t, torch.Tensor)), None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:>12}: {t * 1000:8.1f} ms ({pct:4.1f}%) over "
                         f"{self.counts[name]} calls")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
