"""Small helpers over parameter trees (nested dicts / lists of tensors), and
the program's spans: the serving layer's stage timer and `stage(name)`."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

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

    Stages nest: `self_times` holds each stage's duration less the time its
    child stages cover. A stage entered again inside itself (the streaming
    windows re-entering `separate`) adds its time and its call to `totals`
    and `counts` once, at its outermost entry. `install()` makes this the
    timer that the module's `stage(name)` enters on the calling thread. A
    timer is driven by one thread at a time.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.self_times: Dict[str, float] = defaultdict(float)
        self.outer_total = 0.0          # the outermost stages' summed time
        self._open: List[list] = []     # [name, seconds of its children]

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield self
            return
        outermost = all(frame[0] != name for frame in self._open)
        frame = [name, 0.0]
        self._open.append(frame)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dt = time.perf_counter() - t0
            self._open.pop()
            self.self_times[name] += dt - frame[1]
            if self._open:
                self._open[-1][1] += dt
            else:
                self.outer_total += dt
            if outermost:
                self.totals[name] += dt
                self.counts[name] += 1

    @contextlib.contextmanager
    def install(self):
        """This timer is the one `stage(name)` enters on this thread."""
        previous = getattr(_installed, "timer", None)
        _installed.timer = self
        try:
            yield self
        finally:
            _installed.timer = previous

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
        """Each stage's total and self time, its total as a share of the
        outermost stages' summed time, and its calls."""
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / self.outer_total if self.outer_total else 0.0
            lines.append(f"{name:>15}: {t * 1000:8.1f} ms ({pct:5.1f}%), self "
                         f"{self.self_times[name] * 1000:8.1f} ms, over "
                         f"{self.counts[name]} calls")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self.self_times.clear()
        self.outer_total = 0.0


_installed = threading.local()
_NO_STAGE = contextlib.nullcontext()


class _Stage:
    """A stage of the installed timer and, under a running torch.profiler,
    a `sam_audio.<name>` annotation on the profiler's clock."""

    __slots__ = ("timed", "annotation")

    def __init__(self, timer: Optional[StageTimer], name: str, profiling: bool):
        self.timed = None if timer is None else timer.stage(name)
        self.annotation = (torch.profiler.record_function("sam_audio." + name)
                           if profiling else None)

    def __enter__(self):
        if self.timed is not None:
            self.timed.__enter__()
        if self.annotation is not None:
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if self.timed is not None:
            self.timed.__exit__(*exc)
        return False


def stage(name: str):
    """A span of the program at a layer boundary: a stage of the StageTimer
    installed on this thread (StageTimer.install), and while a
    torch.profiler runs, the annotation `sam_audio.<name>`. With neither, a
    shared null context. It never waits for the device."""
    timer = getattr(_installed, "timer", None)
    profiling = torch.autograd._profiler_enabled()
    if timer is None and not profiling:
        return _NO_STAGE
    return _Stage(timer, name, profiling)
