"""Reduction of a torch.profiler trace of the traced window to what the
per-layer readers take: the device's operations (kernels, copies, fills)
with their intervals, the host's operations, the window, the union of the
device intervals, and the breakdown the result line carries.

The idle share is taken from the union of device intervals, so operations
that overlap on two streams are not counted twice. The window is the span
of the benchmark's own `portbench.window` annotation, on the profiler's
clock. Grouping of kernels by name follows profile_separate.py's `_group`.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "portbench.window"


@dataclass
class Op:
    name: str
    start: int      # ns, profiler clock
    end: int
    thread: int = 0


@dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Op] = field(default_factory=list)
    host: List[Op] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> List[Op]:
        return [o for o in self.device if not o.name.startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        spans = sorted((max(o.start, w0), min(o.end, w1)) for o in self.device
                       if o.end > w0 and o.start < w1)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps

    def device_seconds(self, patterns) -> float:
        """Summed device time of the kernels whose name holds any pattern."""
        pats = [p.lower() for p in patterns]
        return sum(o.end - o.start for o in self.kernels()
                   if any(p in o.name.lower() for p in pats)) / 1e9


def from_profiler(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    device, host, window, thread = [], [], None, None
    for e in events:
        kind = str(e.device_type())
        op = Op(e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()),
                int(e.start_thread_id()))
        if kind.endswith("CUDA"):
            # a host annotation's span mirrored on the device timeline is no
            # device operation
            if not e.is_user_annotation():
                device.append(op)
        else:
            if op.name == WINDOW:
                window, thread = (op.start, op.end), op.thread
            host.append(op)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    # the host operations of the thread that drives the device
    host = [o for o in host if o.thread == thread]
    return Trace(window=window, device=device, host=host)


def kernel_group(name: str) -> str:
    """The port's kernels, matrix products, convolutions and the rest (the
    grouping of profile_separate.py's `_group`)."""
    n = name.lower()
    if ("fused_glue_attention" in n or "flash_attention" in n or "res_unit" in n
            or "int4_" in n):
        return "port kernels"
    if ("gemm" in n or "gemv" in n or "cutlass" in n or "matmul" in n or "xmma" in n
            or "nvjet" in n):
        return "matrix products"
    if "conv" in n or "cudnn" in n or "implicit" in n or "winograd" in n:
        return "convolutions"
    return "other (elementwise, reductions, copies)"


def group_seconds(tr: Trace) -> Dict[str, float]:
    by: Dict[str, int] = defaultdict(int)
    for o in tr.device:
        by[kernel_group(o.name)] += o.end - o.start
    return {k: v / 1e9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def short(name: str, n: int = 72) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."


def top_device_ops(tr: Trace, n: int = 10) -> List[list]:
    by: Dict[str, int] = defaultdict(int)
    for o in tr.device:
        by[short(o.name)] += o.end - o.start
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


_RUNTIME = ("cuda", "cu", "Runtime")


def top_idle_gaps(tr: Trace, n: int = 10) -> List[list]:
    """The idle time between device operations, summed by the innermost host
    operation (of the thread that drives the device; the runtime's own calls
    left out) open at each gap's midpoint, largest first. One sweep: the
    operations nest, so a stack holds the open ones."""
    hosts = sorted((o for o in tr.host if o.name != WINDOW and not o.name.startswith(_RUNTIME)),
                   key=lambda o: (o.start, -o.end))
    by: Dict[str, int] = defaultdict(int)
    stack: List[Op] = []
    i = 0
    for s, e in tr.idle_gaps():
        t = (s + e) // 2
        while i < len(hosts) and hosts[i].start <= t:
            while stack and stack[-1].end <= hosts[i].start:
                stack.pop()
            stack.append(hosts[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        by[short(stack[-1].name) if stack else "host outside traced ops"] += e - s
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
