"""The program's own spans in the traced window, and what the per-layer
readers take from them.

While a torch.profiler runs, sam_audio_tpu_torch opens an annotation
`sam_audio.<stage>` at each layer boundary of a call (`utils.stage`):
`run` around `SeparationPipeline.run`, `host_decode`, `plan`, `preprocess`,
`separate`, and inside the model step `upload`, `pe_encode`,
`codec_encode`, `t5`, `ode`, `decode_target`, `decode_residual`, `rank`
and `to_host`. They are host operations on the profiler's clock, the clock
the device's operations are aligned to.

Each span gets a device interval: from the start of the first to the end of
the last device operation launched inside it. A device operation is placed
by the host op it is linked to (the innermost aten op or annotation open at
its launch, the link torch.profiler's own tables follow), which lies inside
every span open then. One with no link, as a kernel launched through ctypes
outside any aten op, was launched after the operation before it on its
stream and takes that one's place. Device-idle time (`Trace.idle_gaps`) is
put down to spans by exact interval overlap with their host intervals.

A program without these spans gives no spans, and every reader here then
returns None.
"""

from __future__ import annotations

import json
import sys
import traceback
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "sam_audio."

Interval = Tuple[int, int]


@dataclass
class Span:
    name: str                       # the stage, without the prefix
    start: int                      # ns, host, profiler clock
    end: int
    device: Optional[List[int]] = None   # [first start, last end] of the ops launched in it


@dataclass
class Spans:
    spans: List[Span] = field(default_factory=list)
    inside: List[Interval] = field(default_factory=list)   # device ops launched in a span
    placed: int = 0                 # device operations placed by their link
    device_ops: int = 0
    unplaced: List[str] = field(default_factory=list)   # a few names, for the log

    def host(self, name: str) -> List[Interval]:
        return union((s.start, s.end) for s in self.spans if s.name == name)

    def device(self, name: str) -> List[Interval]:
        return union(tuple(s.device) for s in self.spans if s.name == name and s.device)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def overlap(a: List[Interval], b: List[Interval]) -> int:
    """ns that two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    return union((max(s, c), min(e, d)) for s, e in a for c, d in b if min(e, d) > max(s, c))


def length(intervals: List[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def of_events(events, window: Optional[Interval] = None,
              thread: Optional[int] = None) -> Spans:
    """The spans (of `thread`, where given) and their device intervals from a
    profile's kineto events."""
    spans: List[Span] = []
    host_ops: Dict[int, int] = {}       # id of an aten op or annotation -> its start
    device = []
    for e in events:
        start, end = int(e.start_ns()), int(e.start_ns() + e.duration_ns())
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                device.append((e.device_resource_id(), start, end, name,
                               e.linked_correlation_id()))
            continue
        # runtime calls and the profiler's own events carry ids of another kind
        if e.is_user_annotation() or "::" in name:
            host_ops[e.correlation_id()] = start
        if name.startswith(PREFIX) and (thread is None or e.start_thread_id() == thread):
            spans.append(Span(name[len(PREFIX):], start, end))
    if window is not None:
        w0, w1 = window
        spans = [s for s in spans if s.end > w0 and s.start < w1]
        device = [d for d in device if d[2] > w0 and d[1] < w1]
    ops, unplaced, stream_t = [], [], {}
    for stream, start, end, name, linked in sorted(device):
        t = host_ops.get(linked) if linked else None
        if t is None:
            # launched after the operation before it on its stream, which ran first
            t = stream_t.get(stream)
            unplaced.append(name)
        if t is not None:
            ops.append((t, start, end))
            stream_t[stream] = t
    out = Spans(sorted(spans, key=lambda s: (s.start, -s.end)),
                placed=len(device) - len(unplaced), device_ops=len(device),
                unplaced=sorted({n[:60] for n in unplaced})[:5])
    # one sweep: spans of one thread nest, so a stack holds the open ones
    stack: List[Span] = []
    i = 0
    for t, start, end in sorted(ops):
        while i < len(out.spans) and out.spans[i].start <= t:
            while stack and stack[-1].end <= out.spans[i].start:
                stack.pop()
            stack.append(out.spans[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        for s in stack:
            if s.device is None:
                s.device = [start, end]
            else:
                s.device[0], s.device[1] = min(s.device[0], start), max(s.device[1], end)
        if stack:
            out.inside.append((start, end))
    return out


def reduce(ctx) -> Optional[Spans]:
    """The traced window's spans, worked out once a run; None when the run
    was not traced. Logs each span's time a group. A reduction that fails
    is logged with its traceback and reads as None: a reader of it must
    not end the run."""
    if "spans" not in ctx:
        run, tr = ctx.get("run"), ctx.get("trace")
        if tr is None or run is None or getattr(run, "prof", None) is None:
            return None
        thread = tr.host[0].thread if tr.host else None   # the thread that drives the device
        try:
            ctx["spans"] = of_events(run.prof.profiler.kineto_results.events(), tr.window,
                                     thread)
            _log(ctx)
        except Exception:
            traceback.print_exc()
            ctx["spans"] = None
    return ctx["spans"]


def idle_parts(ctx) -> Optional[Dict[str, float]]:
    """Device-idle ns of the window under the pipeline (`run` less
    `separate`), under the model step (`separate`), and outside `run`."""
    sp = reduce(ctx)
    if sp is None or not sp.spans:
        return None
    tr = ctx["trace"]
    gaps = tr.idle_gaps()
    run, sep = sp.host("run"), sp.host("separate")
    if not run:
        return None
    under_run, model = overlap(gaps, run), overlap(gaps, intersect(sep, run))
    return {"pipeline": under_run - model, "model": model,
            "outside": length(gaps) - under_run}


def idle_ms_per_group(ctx, part: str) -> Optional[float]:
    parts = idle_parts(ctx)
    if parts is None or not ctx["groups"]:
        return None
    return parts[part] / 1e6 / ctx["groups"]


def stage_mfu(ctx, name: str, flops: float) -> Optional[float]:
    """`flops` over the summed device intervals of the `name` spans times
    the bf16 peak, in %."""
    sp = reduce(ctx)
    if sp is None:
        return None
    device_ns = length(sp.device(name))
    if device_ns <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (device_ns / 1e9 * ctx["flops"].PEAK_BF16)


def inside_share(ctx) -> Optional[float]:
    """The share of the window's device busy time launched inside a span."""
    sp = reduce(ctx)
    tr = ctx.get("trace")
    if sp is None or tr is None or tr.busy_s() <= 0:
        return None
    w0, w1 = tr.window
    inside = union((max(s, w0), min(e, w1)) for s, e in sp.inside)
    return length(inside) / 1e9 / tr.busy_s()


def _log(ctx):
    sp, tr, groups = ctx["spans"], ctx["trace"], max(1, ctx["groups"])
    if not sp.spans:
        print("[portbench] spans: the program opened no sam_audio.* span", file=sys.stderr,
              flush=True)
        return
    gaps = tr.idle_gaps()
    table = {}
    for name in dict.fromkeys(s.name for s in sp.spans):
        host = sp.host(name)
        table[name] = {"calls": sum(s.name == name for s in sp.spans) / groups,
                       "host_ms": length(host) / 1e6 / groups,
                       "device_ms": length(sp.device(name)) / 1e6 / groups,
                       "idle_ms": overlap(gaps, host) / 1e6 / groups}
    parts = idle_parts(ctx) or {}
    print("[portbench] spans a group (host ms, device interval ms, device-idle ms): "
          + json.dumps({k: {f: round(v, 3) for f, v in row.items()}
                        for k, row in table.items()}), file=sys.stderr, flush=True)
    print(f"[portbench] idle a group: pipeline {parts.get('pipeline', 0) / 1e6 / groups:.3f} ms, "
          f"model {parts.get('model', 0) / 1e6 / groups:.3f} ms, outside sam_audio.run "
          f"{parts.get('outside', 0) / 1e6 / groups:.3f} ms of "
          f"{length(gaps) / 1e6 / groups:.3f}; device ops placed by their link {sp.placed} "
          f"of {sp.device_ops}, the rest by stream order ({sp.unplaced}); busy launched "
          "inside spans "
          f"{inside_share(ctx) or 0.0:.4f}", file=sys.stderr, flush=True)

