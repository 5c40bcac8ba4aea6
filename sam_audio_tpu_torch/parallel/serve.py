"""Serving a sharded model across ranks.

After `SAMAudio.shard()` every rank must call `separate` with the same
batch, the same noise (or random state) and in the same order: each call
crosses every rank (tensor-parallel sums, dp gathers). The JAX package
serves a sharded model from one process; here rank 0 keeps the front end
(`serving.SeparationPipeline`, `server.ContinuousBatcher`,
`server.SeparationServer`) and drives the model through `Lockstep`, while
every other rank runs `follow(model)`:

  * `Lockstep(model).separate(batch, ...)` broadcasts the call from rank 0
    (an op code, the batch's numpy arrays and strings, the keyword
    arguments, the injected noise, the state of the `generator` and of the
    global random generators that `separate` draws from without one, and
    the model's serving attributes such as `text_pad_multiple`), then
    calls the model and returns its result. A lock orders the calls:
    streaming solves a window group on a worker thread while its caller
    blends the one before, so calls arrive from two threads.
  * `follow(model)` receives each call, sets the same random state and
    attributes, and calls `separate` with the same arguments, so that it
    draws the noise rank 0 draws. `Lockstep.shutdown()` broadcasts a stop,
    on which every follower returns.
  * While no call comes, rank 0 broadcasts a no-op every KEEPALIVE_S
    seconds, so that an idle server's followers never reach the process
    group's timeout (10 minutes from parallel.init_distributed).

The carrier is `broadcast_object_list` over the default group, on the CPU
under gloo and on the rank's card under NCCL. Every rank builds the same
model (weights, rankers, towers, `shard()`, `quantize()`) before serving.
Under torchrun:

    device = parallel.init_distributed("cuda")
    model = SAMAudio.from_pretrained(snapshot, device=device).shard(tp=2)
    serve(model, lambda lockstep: run_the_front_end(lockstep))
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the model attributes that separate() reads (besides its arguments)
SERVING_ATTRS = ("text_pad_multiple", "max_direct_seconds", "streaming_window_s",
                 "streaming_batch_windows")
KEEPALIVE_S = 60.0


def _broadcast(call: Optional[dict]) -> dict:
    """`call` from rank 0 to every rank (None elsewhere)."""
    device = None
    if dist.get_backend() == dist.Backend.NCCL:
        device = torch.device("cuda", torch.cuda.current_device())
    box = [call]
    dist.broadcast_object_list(box, src=0, device=device)
    return box[0]


def _random_state(device: torch.device) -> dict:
    state = {"cpu": torch.get_rng_state()}
    if device.type == "cuda":
        state["cuda"] = torch.cuda.get_rng_state(device)
    return state


class Lockstep:
    """Rank 0's handle of a sharded model: what takes a model (the pipeline,
    the batcher, streaming) takes it. Attributes read and set through it
    are the model's. Use it as a context manager, or call `shutdown()`."""

    def __init__(self, model):
        if dist.get_rank() != 0:
            raise ValueError("Lockstep drives the model from rank 0; other ranks run "
                             "follow(model)")
        # its own attributes go to __dict__: __setattr__ sets the model's
        vars(self).update(
            model=model, calls=0, keepalives=0,   # separate() calls and idle no-ops sent
            _lock=threading.Lock(), _closed=False, _last=time.monotonic(),
            _stop=threading.Event(),
            _keeper=threading.Thread(target=self._keepalive, name="sam-audio-lockstep",
                                     daemon=True))
        self._keeper.start()

    def __getattr__(self, name):
        return getattr(self.model, name)

    def __setattr__(self, name, value):
        setattr(self.model, name, value)

    def _send(self, call: dict) -> None:
        """Broadcast under the lock (held by the caller)."""
        if self._closed:
            raise RuntimeError("Lockstep: shut down; the followers have returned")
        _broadcast(call)
        vars(self)["_last"] = time.monotonic()

    def _keepalive(self):
        while not self._stop.wait(KEEPALIVE_S / 4):
            with self._lock:
                if self._closed:
                    return
                if time.monotonic() - self._last >= KEEPALIVE_S:
                    self._send({"op": "noop"})
                    vars(self)["keepalives"] += 1

    def separate(self, batch, noise=None, **kwargs):
        model = self.model
        gen = kwargs.pop("generator", None)
        with self._lock:
            self._send({
                "op": "separate", "batch": batch, "kwargs": kwargs,
                "noise": noise.detach().cpu() if torch.is_tensor(noise) else noise,
                "generator": None if gen is None else (gen.device.type, gen.get_state()),
                "random": _random_state(model.device),
                "attrs": {a: getattr(model, a) for a in SERVING_ATTRS if hasattr(model, a)}})
            vars(self)["calls"] += 1
            return model.separate(batch, noise=noise, generator=gen, **kwargs)

    def shutdown(self) -> None:
        """Send the stop: every follower returns. Idempotent."""
        self._stop.set()
        with self._lock:
            if not self._closed:
                self._send({"op": "stop"})
                vars(self)["_closed"] = True
        self._keeper.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()


def follow(model) -> int:
    """Run rank 0's `separate` calls on this rank until it shuts down.
    Returns the number of calls. A call that raises is logged and the loop
    goes on: rank 0 gets the same exception from its own call."""
    calls = 0
    while True:
        call = _broadcast(None)
        if call["op"] == "stop":
            return calls
        if call["op"] != "separate":
            continue
        calls += 1
        for name, value in call["attrs"].items():
            setattr(model, name, value)
        state = call["random"]
        torch.set_rng_state(state["cpu"])
        if "cuda" in state:
            torch.cuda.set_rng_state(state["cuda"], model.device)
        gen = None
        if call["generator"] is not None:
            kind, gen_state = call["generator"]
            gen = torch.Generator(device=model.device if kind == "cuda" else "cpu")
            gen.set_state(gen_state)
        try:
            model.separate(call["batch"], noise=call["noise"], generator=gen, **call["kwargs"])
        except Exception:  # noqa: BLE001 — the serving loop outlives one failed call
            logger.exception("follow: call %d failed on rank %d", calls, dist.get_rank())


def serve(model, main: Callable[[Lockstep], Any]) -> Any:
    """On rank 0, `main(Lockstep(model))` (the front end: a pipeline run, a
    batcher, an HTTP server), then the stop; on every other rank,
    `follow(model)`. Returns main's result on rank 0 and the number of calls
    followed elsewhere."""
    if dist.get_rank() != 0:
        return follow(model)
    with Lockstep(model) as lockstep:
        return main(lockstep)
