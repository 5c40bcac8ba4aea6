"""Online serving: a continuous batcher and a stdlib HTTP front end.

Counterpart of sam_audio_tpu/server.py:

  ContinuousBatcher — a thread-safe admission queue and ONE device thread
    that coalesces waiting requests into length-bucketed batches
    (`runtime.plan_batches`), waiting at most `max_wait_ms` for a batch to
    fill. One thread owns every dispatch to the card; a request whose audio
    does not decode fails alone.

  SeparationServer — `http.server` (no extra dependency):
      POST /v1/separate   JSON {"description": str, "audio": [floats],
                                "sample_rate": int, ...} or "audio_wav_b64"
      GET  /healthz       liveness
      GET  /v1/stats      batching counters (requests, batches, occupancy)

Run one on the card:

    python -m sam_audio_tpu_torch.server --snapshot DIR --port 8080

Not ported: the JAX module's compile-cache guard (`map_guard` and the
re-warm after a cache clear), which exists only for XLA. One difference on
purpose: `predict_spans=True` with `long_policy="stream"` is refused, since
streamed requests would be separated without their predicted spans.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from sam_audio_tpu_torch.processor import SAMAudioProcessor
from sam_audio_tpu_torch.runtime import plan_batches
from sam_audio_tpu_torch.serving import (
    SeparationRequest,
    SeparationResponse,
    batch_grid,
    decode_request_audio,
    group_batch,
    split_by_modality,
)

logger = logging.getLogger(__name__)


class ServerOverloadedError(RuntimeError):
    """The admission queue is full: the client should retry later (HTTP 429)."""


class RequestTooLongError(ValueError):
    """The request exceeds the server's duration policy (HTTP 413)."""


class ClientRequestError(ValueError):
    """A malformed request (bad JSON fields, an undecodable audio payload),
    raised only while parsing or decoding a request. Errors from the model
    are not mapped to 400 by type: a ValueError inside model.separate (a
    server misconfiguration) is a logged 500."""


@dataclass
class BatcherStats:
    """Counters the device thread updates after every dispatch."""

    requests: int = 0
    failed_requests: int = 0
    rejected_overload: int = 0   # 429s at admission
    # 413s, counted ONLY here (not in requests / failed_requests), whether
    # caught at admission or after decoding a file
    rejected_too_long: int = 0
    streamed_requests: int = 0   # served through streaming windows
    batches: int = 0
    batched_requests: int = 0    # the sum of dispatched batch sizes
    batch_size_hist: dict = field(default_factory=dict)
    latency_ms: List[float] = field(default_factory=list)   # rolling, <= 1024

    def occupancy(self, max_batch: int) -> float:
        if not self.batches:
            return 0.0
        return self.batched_requests / (self.batches * max_batch)

    def snapshot(self, max_batch: int, queue_depth: int = 0) -> dict:
        lat = sorted(self.latency_ms)
        return {
            "requests": self.requests,
            "failed_requests": self.failed_requests,
            "rejected_overload": self.rejected_overload,
            "rejected_too_long": self.rejected_too_long,
            "streamed_requests": self.streamed_requests,
            "queue_depth": queue_depth,
            "batches": self.batches,
            "mean_batch_size": self.batched_requests / self.batches if self.batches else 0.0,
            "occupancy": self.occupancy(max_batch),
            "batch_size_hist": dict(self.batch_size_hist),
            "p50_latency_ms": lat[len(lat) // 2] if lat else None,
        }


class _ShutdownSentinel:
    """Each device-thread generation obeys only its own sentinel; one left in
    the queue by a timed-out shutdown() of an earlier generation is dropped."""


class ContinuousBatcher:
    """Admission queue + one device thread with deadline-based batching.

    submit() is safe from any thread and returns a Future of a
    `SeparationResponse`. The device thread takes the oldest waiting request,
    waits up to `max_wait_ms` for more, then dispatches length-bucketed
    batches. `max_wait_ms=0` dispatches whatever is waiting.
    """

    def __init__(self, model, processor: Optional[SAMAudioProcessor] = None,
                 max_batch: int = 4, bucket_seconds: float = 2.0,
                 max_wait_ms: float = 20.0, reranking_candidates: int = 1,
                 predict_spans: bool = False,
                 preview_nfe: Optional[int] = None, visual_stride: int = 1,
                 autostart: bool = True, max_queue: int = 256,
                 max_seconds: Optional[float] = None,
                 long_policy: str = "reject",
                 max_stream_seconds: Optional[float] = 600.0,
                 streaming_window_s: float = 10.0,
                 pad_batch_sizes: bool = True,
                 text_pad_to: Optional[int] = 64):
        """Overload and over-length policy:

        max_queue — admission bound; submit() past this depth raises
          ServerOverloadedError (429).
        max_seconds — requests longer than this (snapped UP to the bucket
          grid) meet `long_policy`: "reject" fails them with
          RequestTooLongError (413); "stream" separates them through
          streaming windows on the device thread.
        max_stream_seconds — the cap of long_policy="stream" (413 past it):
          streamed requests run serially on the one device thread.
        pad_batch_sizes — pad each dispatched group to the batch grid (1, 2,
          4, ..., max_batch) by repeating its last request; padded rows are
          dropped before the reply.
        text_pad_to — round the tokenized text width up to a multiple of
          this (`model.text_pad_multiple`; pad columns are masked).

        The knobs are per batcher, as in the JAX package.
        `predict_spans=True` with `long_policy="stream"` raises ValueError:
        a streamed request would be separated without span prediction.
        """
        if long_policy not in ("reject", "stream"):
            raise ValueError(f"long_policy must be reject|stream, got {long_policy!r}")
        if predict_spans and long_policy == "stream":
            raise ValueError(
                "predict_spans=True cannot be combined with long_policy='stream': span "
                "prediction attends over a whole clip, and streamed requests would be "
                "separated without it. Use long_policy='reject', or predict_spans=False "
                "with explicit anchors.")
        self.model = model
        if text_pad_to:
            model.text_pad_multiple = int(text_pad_to)
        self.processor = processor or SAMAudioProcessor(
            audio_hop_length=model.hop_length, audio_sampling_rate=model.sample_rate)
        self.max_batch = int(max_batch)
        self.bucket_steps = max(1, int(bucket_seconds * model.sample_rate / model.hop_length))
        self.max_wait_ms = float(max_wait_ms)
        self.reranking_candidates = reranking_candidates
        self.predict_spans = predict_spans
        self.preview_nfe = preview_nfe
        self.visual_stride = visual_stride
        self.max_queue = int(max_queue)
        self.max_seconds = max_seconds
        self.long_policy = long_policy
        self.max_stream_seconds = max_stream_seconds
        self.streaming_window_s = float(streaming_window_s)
        self.pad_batch_sizes = bool(pad_batch_sizes)
        self.stats = BatcherStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()          # guards stats
        self._admit_lock = threading.Lock()    # makes the bound check atomic
        self._thread: Optional[threading.Thread] = None
        self._sentinel: Optional[_ShutdownSentinel] = None
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is not None:
            if self._thread.is_alive():
                raise RuntimeError(
                    "ContinuousBatcher.start(): the previous device thread is still "
                    "running (a shutdown() join timed out); a second one would race it "
                    "over the queue. Retry shutdown() first.")
            self._thread = None
        self._sentinel = _ShutdownSentinel()
        self._thread = threading.Thread(target=self._device_loop, name="sam-audio-batcher",
                                        daemon=True)
        self._thread.start()

    def shutdown(self, timeout: Optional[float] = 30.0):
        """Stop the device thread after draining the requests already queued."""
        if self._thread is None:
            return
        if self._thread.is_alive():
            self._queue.put(self._sentinel)
            self._thread.join(timeout)
        if self._thread.is_alive():
            # keep the handle, so that start() refuses a second thread
            logger.warning("shutdown: device thread still running after %.0fs; leaving it "
                           "to drain", timeout or 0)
            return
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- admission ---------------------------------------------------------

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def submit(self, request: SeparationRequest) -> "Future[SeparationResponse]":
        # an in-memory request's length is known now; a file's after decoding
        if not isinstance(request.audio, str):
            err = self._too_long_error(int(np.asarray(request.audio).shape[-1]))
            if err is not None:
                with self._lock:
                    self.stats.rejected_too_long += 1
                raise err
        fut: "Future[SeparationResponse]" = Future()
        # check-then-put under one lock, or concurrent submitters overshoot
        # the bound exactly under the overload it exists for
        with self._admit_lock:
            if self.max_queue and self._queue.qsize() >= self.max_queue:
                with self._lock:
                    self.stats.rejected_overload += 1
                raise ServerOverloadedError(
                    f"admission queue full ({self._queue.qsize()} >= {self.max_queue} "
                    "waiting requests)")
            self._queue.put((request, fut, time.monotonic()))
        return fut

    def _ceil_to_bucket(self, seconds: float) -> int:
        """`seconds` in samples, rounded UP to the bucket grid (at least one
        bucket). The direct limit and warmup() share this rounding, so that
        warmup's dispatches pass the over-length check."""
        unit = self.bucket_steps * self.model.hop_length
        return max(unit, -(-int(seconds * self.model.sample_rate) // unit) * unit)

    @property
    def _direct_limit(self) -> Optional[int]:
        """`max_seconds` in samples, snapped up to the bucket grid."""
        if self.max_seconds is None:
            return None
        return self._ceil_to_bucket(self.max_seconds)

    @property
    def _stream_limit(self) -> Optional[int]:
        if self.max_stream_seconds is None:
            return None
        return int(self.max_stream_seconds * self.model.sample_rate)

    def _too_long_error(self, n_samples: int) -> Optional[RequestTooLongError]:
        """The over-length policy for an `n_samples`-long request, or None if
        it is admissible."""
        sr = self.model.sample_rate
        if self._direct_limit is None or n_samples <= self._direct_limit:
            return None
        if self.long_policy == "reject":
            return RequestTooLongError(
                f"request is {n_samples / sr:.1f}s; this server accepts at most "
                f"{self._direct_limit / sr:.1f}s (long_policy=reject)")
        if self._stream_limit is not None and n_samples > self._stream_limit:
            return RequestTooLongError(
                f"request is {n_samples / sr:.1f}s; this server streams over-length "
                f"requests only up to {self.max_stream_seconds:.0f}s (max_stream_seconds)")
        return None

    def separate(self, request: SeparationRequest,
                 timeout: Optional[float] = None) -> SeparationResponse:
        """Blocking wrapper around submit()."""
        return self.submit(request).result(timeout)

    # -- device thread -----------------------------------------------------

    def _collect(self) -> Optional[list]:
        """Block for the first request, then give the queue `max_wait_ms` to
        fill, up to 8 x max_batch requests (the planner may split them into
        several groups). Returns None on shutdown."""
        while True:
            item = self._queue.get()
            if isinstance(item, _ShutdownSentinel):
                if item is self._sentinel:
                    return None
                continue   # a stale sentinel of an earlier generation
            break
        pending = [item]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(pending) < 8 * self.max_batch:
            try:
                nxt = self._queue.get(timeout=max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                break
            if isinstance(nxt, _ShutdownSentinel):
                if nxt is self._sentinel:
                    self._queue.put(nxt)   # exit after this dispatch drains
                    break
                continue
            pending.append(nxt)
        return pending

    def _device_loop(self):
        while True:
            pending = self._collect()
            if pending is None:
                return
            self._dispatch(pending)

    def _count_failed(self, n: int, record_stats: bool):
        if record_stats:
            with self._lock:
                self.stats.requests += n
                self.stats.failed_requests += n

    def _dispatch_streaming(self, req, fut, t0, wav: np.ndarray, record_stats: bool = True):
        """One over-length request through streaming windows (device
        thread), with fresh window noise per request."""
        from sam_audio_tpu_torch.streaming import separate_streaming

        try:
            res = separate_streaming(
                self.model, req.description, wav, window_s=self.streaming_window_s,
                anchors=req.anchors, reranking_candidates=self.reranking_candidates,
                preview_nfe=self.preview_nfe, masked_video=req.masked_video,
                visual_stride=self.visual_stride)
        except Exception as e:  # noqa: BLE001 — fail the request, not the loop
            logger.exception("streamed request failed")
            fut.set_exception(e)
            self._count_failed(1, record_stats)
            return
        now = time.monotonic()
        fut.set_result(SeparationResponse(
            target=np.asarray(res.target), residual=np.asarray(res.residual),
            metadata={"streamed": True, "num_windows": res.num_windows}))
        if record_stats:
            with self._lock:
                s = self.stats
                s.requests += 1
                s.streamed_requests += 1
                s.latency_ms.append((now - t0) * 1e3)
                del s.latency_ms[:-1024]

    def _dispatch(self, pending: list, record_stats: bool = True):
        # host decode per request: an undecodable payload fails only its own
        # future, as a client fault
        live, wavs = [], []
        for req, fut, t0 in pending:
            try:
                wavs.append(decode_request_audio(req, self.model.sample_rate))
                live.append((req, fut, t0))
            except Exception as e:  # noqa: BLE001 — isolate request faults
                fut.set_exception(ClientRequestError(
                    f"audio decode failed: {type(e).__name__}: {e}"))
                self._count_failed(1, record_stats)
        # the over-length policy after decoding (a file's length is known now)
        if self._direct_limit is not None and live:
            short = []
            for (req, fut, t0), wav in zip(live, wavs):
                n = int(wav.shape[-1])
                if n <= self._direct_limit:
                    short.append(((req, fut, t0), wav))
                    continue
                err = self._too_long_error(n)
                if err is None:   # long_policy=stream, within the cap
                    self._dispatch_streaming(req, fut, t0, wav, record_stats=record_stats)
                else:
                    fut.set_exception(err)
                    if record_stats:
                        with self._lock:
                            self.stats.rejected_too_long += 1
            live = [lw[0] for lw in short]
            wavs = [lw[1] for lw in short]
        if not live:
            return
        batches, buckets = plan_batches([w.shape[-1] for w in wavs], hop=self.model.hop_length,
                                        bucket_steps=self.bucket_steps,
                                        max_batch=self.max_batch)
        reqs = [r for r, _, _ in live]
        for group, bucket in split_by_modality(batches, buckets,
                                               lambda i: reqs[i].masked_video is not None):
            n_true = len(group)
            pad_to = n_true
            if self.pad_batch_sizes:
                pad_to = next(g for g in batch_grid(self.max_batch) if g >= n_true)
            idx = list(group) + [group[-1]] * (pad_to - n_true)
            futs = [live[i][1] for i in group]
            t0s = [live[i][2] for i in group]
            try:
                result = self.model.separate(
                    group_batch(self.processor, reqs, wavs, idx, bucket),
                    reranking_candidates=self.reranking_candidates,
                    predict_spans=self.predict_spans, preview_nfe=self.preview_nfe,
                    visual_stride=self.visual_stride)
            except Exception as e:  # noqa: BLE001 — fail the batch, not the loop
                logger.exception("batch of %d failed", n_true)
                for fut in futs:
                    fut.set_exception(e)
                self._count_failed(n_true, record_stats)
                continue
            now = time.monotonic()
            for j, fut in enumerate(futs):
                fut.set_result(SeparationResponse(
                    target=np.asarray(result.target[j]), residual=np.asarray(result.residual[j]),
                    metadata={"bucket": bucket, "batch_size": n_true, "dispatch_size": pad_to}))
            if not record_stats:
                continue
            with self._lock:
                s = self.stats
                s.requests += n_true
                s.batches += 1
                s.batched_requests += n_true
                s.batch_size_hist[n_true] = s.batch_size_hist.get(n_true, 0) + 1
                s.latency_ms.extend((now - t0) * 1e3 for t0 in t0s)
                del s.latency_ms[:-1024]

    # -- warmup ------------------------------------------------------------

    def warmup(self, seconds: Sequence[float] = (10.0,),
               batch_sizes: Optional[Sequence[int]] = None,
               warm_streaming: Optional[bool] = None):
        """Dispatch one silent batch of each (bucket of `seconds`, batch
        size) shape before the device thread starts, so that the kernels are
        built and the allocator sized before the first request; with
        long_policy="stream" also one streamed clip. Warm dispatches do not
        touch the traffic counters. Returns the warmed shapes."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("warmup() must run before start(): its dispatches must not "
                               "race the device thread")
        sizes = sorted(set(batch_sizes or batch_grid(self.max_batch)))
        warmed = []
        for sec in seconds:
            n = self._ceil_to_bucket(sec)
            for b in sizes:
                self._warm_one(n, b)
                warmed.append((n, b))
        if warm_streaming is None:
            warm_streaming = self.max_seconds is not None and self.long_policy == "stream"
        if warm_streaming:
            self._warm_streaming()
            warmed.append(("streaming", 1))
        logger.info("warmup complete (%d shapes)", len(warmed))
        return warmed

    def _warm_one(self, n_samples: int, b: int):
        pending = [(SeparationRequest(description="warmup",
                                      audio=np.zeros((1, n_samples), np.float32)),
                    Future(), time.monotonic()) for _ in range(b)]
        self._dispatch(pending, record_stats=False)
        for _, fut, _ in pending:
            fut.result(timeout=0)   # a warmup failure raises here

    def _warm_streaming(self):
        from sam_audio_tpu_torch.streaming import separate_streaming

        sr, hop = self.model.sample_rate, self.model.hop_length
        win = int(self.streaming_window_s * sr) // hop * hop
        # more than one window takes the windowed path
        separate_streaming(self.model, "warmup", np.zeros(int(win * 2.5), np.float32),
                           window_s=self.streaming_window_s,
                           reranking_candidates=self.reranking_candidates,
                           preview_nfe=self.preview_nfe)

    def stats_snapshot(self) -> dict:
        with self._lock:
            return self.stats.snapshot(self.max_batch, self._queue.qsize())


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------


def _array_to_wav_b64(x: np.ndarray, sr: int) -> str:
    """A mono float waveform as base64 16-bit WAV (about 9x smaller on the
    wire than a JSON float list)."""
    import io
    import wave

    pcm = (np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def _wav_b64_to_array(b64: str) -> tuple:
    """base64 WAV (16- or 32-bit PCM) -> ((channels, T) float32, rate)."""
    import io
    import wave

    try:
        with wave.open(io.BytesIO(base64.b64decode(b64)), "rb") as w:
            sr, n, ch, width = (w.getframerate(), w.getnframes(), w.getnchannels(),
                                w.getsampwidth())
            data = w.readframes(n)
    except (wave.Error, EOFError) as e:   # a client fault (400), not a server one
        raise ValueError(f"not a WAV payload: {e}") from e
    if width == 2:
        x = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(data, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return x.reshape(-1, ch).T, sr


def _status_for(exc: BaseException) -> int:
    """Client faults are 4xx, server faults 5xx: 429 overload, 413 over
    length, 504 timed out, 400 malformed (parsing only), 500 the rest."""
    import concurrent.futures

    if isinstance(exc, ServerOverloadedError):
        return 429
    if isinstance(exc, RequestTooLongError):
        return 413
    if isinstance(exc, (concurrent.futures.TimeoutError, TimeoutError)):
        return 504
    if isinstance(exc, (ClientRequestError, json.JSONDecodeError)):
        return 400
    return 500


class SeparationServer:
    """An HTTP front end over a ContinuousBatcher, on the standard library."""

    def __init__(self, batcher: ContinuousBatcher, host: str = "127.0.0.1", port: int = 8080,
                 request_timeout: float = 600.0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.batcher = batcher
        srv = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):   # quiet by default
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload: dict, headers=()):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                if self.path == "/healthz":
                    self._reply(200, {"ok": True})
                elif self.path == "/v1/stats":
                    self._reply(200, srv.batcher.stats_snapshot())
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802 — http.server API
                if self.path != "/v1/separate":
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    resp = srv.handle(json.loads(self.rfile.read(n)))
                except Exception as e:  # noqa: BLE001 — the taxonomy below
                    code = _status_for(e)
                    payload = {"error": f"{type(e).__name__}: {e}"}
                    headers = ()
                    if code == 429:
                        payload["queue_depth"] = srv.batcher.queue_depth()
                        headers = (("Retry-After", "1"),)
                    if code >= 500:
                        logger.exception("server fault handling %s", self.path)
                    self._reply(code, payload, headers)
                    return
                self._reply(200, resp)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.request_timeout = request_timeout
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def handle(self, req: dict) -> dict:
        """One /v1/separate JSON body (also callable in-process)."""
        sr_model = self.batcher.model.sample_rate
        try:
            desc = req["description"]
            if "audio_wav_b64" in req:
                wav, sr = _wav_b64_to_array(req["audio_wav_b64"])
            else:
                wav = np.asarray(req["audio"], np.float32)
                if wav.ndim == 1:
                    wav = wav[None]
                sr = int(req.get("sample_rate", sr_model))
            if sr != sr_model:
                from sam_audio_tpu_torch.ops.resample import resample_np

                wav = resample_np(wav, sr, sr_model)
            anchors = [tuple(a) for a in req["anchors"]] if req.get("anchors") else None
        except (KeyError, ValueError, TypeError, binascii.Error) as e:
            raise ClientRequestError(f"{type(e).__name__}: {e}") from e
        out = self.batcher.separate(
            SeparationRequest(description=desc, audio=wav, anchors=anchors),
            timeout=self.request_timeout)
        if req.get("response_format", "json") == "wav_b64":
            return {"target_wav_b64": _array_to_wav_b64(out.target, sr_model),
                    "residual_wav_b64": _array_to_wav_b64(out.residual, sr_model),
                    "sample_rate": sr_model, "metadata": out.metadata}
        return {"target": np.asarray(out.target, np.float64).tolist(),
                "residual": np.asarray(out.residual, np.float64).tolist(),
                "sample_rate": sr_model, "metadata": out.metadata}

    def start(self):
        """Serve on a daemon thread."""
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever,
                                              name="sam-audio-http", daemon=True)
        self._serve_thread.start()

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(10)
            self._serve_thread = None


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    ap = argparse.ArgumentParser(description="sam_audio_tpu_torch online server")
    ap.add_argument("--snapshot", required=True, help="local snapshot dir (config.json + params)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; with no GPU it refuses to start)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--bucket-seconds", type=float, default=2.0)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--candidates", type=int, default=1)
    ap.add_argument("--warmup-seconds", type=float, nargs="*", default=[10.0],
                    help="request durations to warm before accepting traffic")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission bound; beyond it requests get HTTP 429")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="longest request separated directly; defaults to the longest "
                         "--warmup-seconds")
    ap.add_argument("--long-policy", choices=("reject", "stream"), default="stream",
                    help="over-length requests: 413, or streaming windows")
    ap.add_argument("--max-stream-seconds", type=float, default=600.0,
                    help="cap of long_policy=stream (413 past it): streamed requests run "
                         "serially on the device thread")
    ap.add_argument("--text-pad-to", type=int, default=64,
                    help="round the tokenized text width up to a multiple of this (0 = off)")
    ap.add_argument("--int8", action="store_true", help="serve model.quantize(8)")
    args = ap.parse_args(argv)

    from sam_audio_tpu_torch.models.sam_audio import SAMAudio

    model = SAMAudio.from_pretrained(args.snapshot, device=args.device)
    if args.int8:
        model.quantize(8)
    max_seconds = args.max_seconds
    if max_seconds is None and args.warmup_seconds:
        max_seconds = max(args.warmup_seconds)
    batcher = ContinuousBatcher(
        model, max_batch=args.max_batch, bucket_seconds=args.bucket_seconds,
        max_wait_ms=args.max_wait_ms, reranking_candidates=args.candidates,
        max_queue=args.max_queue, max_seconds=max_seconds, long_policy=args.long_policy,
        max_stream_seconds=args.max_stream_seconds,
        streaming_window_s=max(args.warmup_seconds) if args.warmup_seconds else 10.0,
        text_pad_to=args.text_pad_to or None, autostart=False)
    if args.warmup_seconds:
        batcher.warmup(seconds=args.warmup_seconds)
    batcher.start()
    server = SeparationServer(batcher, host=args.host, port=args.port)
    print(json.dumps({"serving": f"http://{args.host}:{server.port}",
                      "max_batch": args.max_batch}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        batcher.shutdown()


if __name__ == "__main__":
    main()
