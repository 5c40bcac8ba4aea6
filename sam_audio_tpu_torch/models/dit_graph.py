"""CUDA graphs of one velocity-field evaluation of the ODE.

One DiT evaluation is about 1,250 kernel launches, and at small batches the
host takes longer to issue them than the card takes to run them. A
`DiTGraphs` (one a `SAMAudio`, `SAMAudio.dit_graphs`) captures the
evaluation `separate_latents` hands it once for each input signature and
replays it for every later evaluation with that signature: the same
kernels, in the same order and precision, issued by one graph launch.

  * Inputs. The graph reads the state `y`, a 0-d float32 `t` and the call's
    conditioning (and the RoPE tables) from static buffers of its own: the
    conditioning is copied in once a call, `y` and `t` before each replay,
    and the output is cloned after it (rk4 holds four velocities at once).
    The parameters are read where the model holds them; replacing
    `SAMAudio.params` clears the cache.
  * When it engages (`engages`): `y` on a CUDA device, autograd off, an
    unsharded solve. Everything else runs the evaluation eagerly.
  * Capture. The first evaluation of a signature runs eagerly on a side
    stream (the usual warm-up: kernels built, libraries loaded, its result
    is that evaluation's answer) and is then captured on the same stream
    into a memory pool that all of the cache's graphs share: they never run
    at once, and each output is cloned before the next replay.
  * Bounded. At most `MAX_GRAPHS` graphs, least recently used first out,
    so a server with many bucket shapes cannot grow it without limit.
  * Launch counters (`ops._build.COUNTERS`) keep counting device
    executions: a capture's increments are taken back, and each replay adds
    the launches recorded at its capture.
  * Spans: `dit_graph` around each replay, `dit_capture` around each
    warm-up and capture (utils.stage).

Evaluations of one cache run one at a time (a lock); another call of the
same signature in between copies its conditioning in again.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from sam_audio_tpu_torch.ops import _build
from sam_audio_tpu_torch.utils import stage

# The server's grid is batch 1, 2 and 4 x its 2 s buckets, a text width:
# 15 signatures at its default 10 s (server.py main; the 10 s streaming
# windows among them), 45 at 30 s. This holds the 30 s grid, or the default
# one at four text widths.
MAX_GRAPHS = 64


class _Graph:
    """One captured evaluation and its static buffers."""

    __slots__ = ("t", "y", "inputs", "out", "graph", "launches", "owner")

    def __init__(self, y: torch.Tensor, inputs: Dict[str, Optional[torch.Tensor]]):
        self.t = torch.zeros((), dtype=torch.float32, device=y.device)
        self.y = torch.empty_like(y)
        self.inputs = {k: None if x is None else torch.empty_like(x) for k, x in inputs.items()}
        self.out: Optional[torch.Tensor] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = []      # (counter, launches one replay executes)
        self.owner = None       # the call whose conditioning the buffers hold


def signature(y: torch.Tensor, inputs: Dict[str, Optional[torch.Tensor]]) -> tuple:
    """The cache key: device, shapes and dtypes of the state and inputs."""
    return (str(y.device), y.dtype, tuple(y.shape)) + tuple(
        (k, None) if x is None else (k, x.dtype, tuple(x.shape)) for k, x in inputs.items())


class DiTGraphs:
    """A bounded cache of CUDA graphs of one velocity-field evaluation."""

    def __init__(self):
        self._graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()
        self._pool = None
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self):
        """Drop every graph and the pool (the parameters they read changed)."""
        with self._lock:
            self._graphs.clear()
            self._pool = None

    @staticmethod
    def engages(y: torch.Tensor, sharded: bool) -> bool:
        """A graph serves `y`'s solve: on a CUDA device, with autograd off,
        and unsharded (the collectives of dp, tp and sp stay eager)."""
        return y.is_cuda and not torch.is_grad_enabled() and not sharded

    def field(self, evaluate: Callable, y: torch.Tensor,
              inputs: Dict[str, Optional[torch.Tensor]]) -> Callable:
        """`func(t, y)` for odeint: `evaluate(t, y, **inputs)` through the
        graph of this signature (captured at its first evaluation)."""
        key = signature(y, inputs)
        with self._lock, torch.inference_mode():
            g = self._graphs.pop(key, None) or _Graph(y, inputs)
            self._graphs[key] = g
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        call = object()

        def func(t, y):
            with self._lock, torch.inference_mode():
                if g.owner is not call:
                    for k, buf in g.inputs.items():
                        if buf is not None:
                            buf.copy_(inputs[k])
                    g.owner = call
                if g.graph is None:
                    return self._capture(g, evaluate, t, y)
                # the copies open the span: on the trace, the graph's kernels
                # (linked to no host op) are placed after them, inside it
                with stage("dit_graph"):
                    g.t.copy_(t)
                    g.y.copy_(y)
                    g.graph.replay()
                for counter, n in g.launches:
                    counter.launches += n
                self.replays += 1
                return g.out.clone()

        return func

    def _capture(self, g: _Graph, evaluate: Callable, t, y) -> torch.Tensor:
        """Warm up on a side stream at (t, y), capture there, and return the
        warm-up's result (the answer of this evaluation)."""
        g.t.copy_(t)
        g.y.copy_(y)
        dev = g.y.device
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with stage("dit_capture"), torch.cuda.stream(side):
            out = evaluate(g.t, g.y, **g.inputs)
            counted = [(c, c.launches) for c in _build.COUNTERS]
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                      capture_error_mode="thread_local"):
                    g.out = evaluate(g.t, g.y, **g.inputs)
            finally:
                g.launches = [(c, c.launches - n) for c, n in counted if c.launches != n]
                for c, n in counted:
                    c.launches = n
        main.wait_stream(side)
        out.record_stream(main)
        g.graph = graph
        self.captures += 1
        return out
