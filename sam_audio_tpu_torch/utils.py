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


def layer_slice(stacked, i: int):
    """Layer i of parameters stacked on a leading layer axis (views)."""
    return tree_map(lambda x: x[i], stacked)


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
