"""Serving in the PyTorch port: plan_batches and SeparationPipeline against
the JAX package (fp32, CPU; the same noise injected into both models'
separate), the ContinuousBatcher's host logic on a stub model (no JAX, no
kernels), the HTTP front end, one batcher run of a small real model, and the
command line (--device cpu) against the in-process separate.

Every Future.result and urlopen has a timeout; servers bind port 0 and shut
down in fixture finalizers."""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave
import zlib
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.runtime import native as jax_native
from sam_audio_tpu.serving import SeparationPipeline as JaxPipeline
from sam_audio_tpu.serving import SeparationRequest as JaxRequest
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, tiny_test_config
from sam_audio_tpu_torch.audio_io import read_wav, write_wav
from sam_audio_tpu_torch.runtime import plan_batches
from sam_audio_tpu_torch.server import (
    ClientRequestError,
    ContinuousBatcher,
    RequestTooLongError,
    SeparationServer,
    ServerOverloadedError,
    _status_for,
)
from sam_audio_tpu_torch.serving import SeparationPipeline, SeparationRequest
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
from sam_audio_tpu_torch.utils import StageTimer

TOL = dict(rtol=1e-4, atol=1e-4)
WAIT = 60   # seconds any future or HTTP call may take


@pytest.mark.parametrize("hop,steps,max_batch", [(8, 10, 4), (8, 1, 2), (1920, 50, 3),
                                                  (8, 0, 4), (0, 10, 2)],
                         ids=["tiny", "per-frame", "48k", "steps0", "hop0"])
def test_plan_batches_equals_jax_fallback(monkeypatch, hop, steps, max_batch):
    monkeypatch.setattr(jax_native, "_load", lambda: None)   # the numpy path
    rng = np.random.RandomState(hop + steps)
    lengths = [int(n) for n in rng.randint(1, 2000, 23)] + [80, 80, 160]
    got = plan_batches(lengths, hop=hop, bucket_steps=steps, max_batch=max_batch)
    assert got == jax_native.plan_batches(lengths, hop=hop, bucket_steps=steps,
                                          max_batch=max_batch)
    assert sorted(i for g in got[0] for i in g) == list(range(len(lengths)))
    assert plan_batches([], 8, 10, 4) == ([], [])


def test_processor_pad_to_samples_matches_jax():
    from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor

    rng = np.random.RandomState(4)
    audios = [rng.randn(1, 50).astype(np.float32), rng.randn(70).astype(np.float32)]
    anchors = [[("+", 0.001, 0.004)], []]
    got = SAMAudioProcessor(8, 8000)(descriptions=["a", "b"], audios=audios, anchors=anchors,
                                     pad_to_samples=160)
    ref = JaxProcessor(audio_hop_length=8, audio_sampling_rate=8000)(
        descriptions=["a", "b"], audios=audios, anchors=anchors, pad_to_samples=160)
    for name in ("audios", "sizes", "wav_sizes", "audio_pad_mask", "anchor_ids",
                 "anchor_alignment"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    assert got.audios.shape == (2, 1, 160)
    with pytest.raises(ValueError, match="pad_to_samples"):
        SAMAudioProcessor(8, 8000)(descriptions=["a", "b"], audios=audios, pad_to_samples=64)


# -- SeparationPipeline against the JAX package ------------------------------


def _inject(model, noise_ch):
    """Wrap model.separate to inject noise made from the batch itself, so that
    both packages' groups draw the same numbers."""
    inner = model.separate

    def separate(batch, **kw):
        t = batch.anchor_alignment.shape[-1]
        seed = zlib.crc32(("|".join(batch.descriptions) + f"/{t}").encode())
        noise = np.random.RandomState(seed).randn(len(batch.descriptions), t,
                                                  noise_ch).astype(np.float32)
        return inner(batch, noise=noise, **kw)

    model.separate = separate


def test_pipeline_matches_jax(tmp_path):
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=JaxByteTokenizer(cfg.text_encoder.vocab_size))
    jm.save_pretrained(str(tmp_path / "snap"))
    tm = SAMAudio.from_pretrained(str(tmp_path / "snap"), device="cpu",
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    for m in (jm, tm):
        _inject(m, 2 * cfg.audio_codec.codebook_dim)
    rng = np.random.RandomState(1)
    path = str(tmp_path / "in.wav")
    write_wav(path, (0.3 * np.sin(np.arange(220) / 3)).astype(np.float32), 11025)
    specs = [("a dog barking", rng.randn(1, 64) * 0.1, None),
             ("rain", rng.randn(200) * 0.1, [("+", 0.0, 0.01)]),
             ("a bell", rng.randn(2, 60) * 0.1, None),
             ("a tone from a file", path, None),
             ("speech", rng.randn(1, 70) * 0.1, [("-", 0.002, 0.006)])]
    outs = []
    for pipe, req in ((JaxPipeline(jm, bucket_seconds=0.01), JaxRequest),
                      (SeparationPipeline(tm, bucket_seconds=0.01), SeparationRequest)):
        outs.append(pipe.run([req(description=d, audio=a if isinstance(a, str)
                                  else a.astype(np.float32), anchors=an)
                              for d, a, an in specs]))
    ref, got = outs
    for r, g in zip(ref, got):
        assert g.metadata == r.metadata
        np.testing.assert_allclose(g.target, np.asarray(r.target), **TOL)
        np.testing.assert_allclose(g.residual, np.asarray(r.residual), **TOL)
    # three 80-sample requests padded to a group of 4; the file (220 samples
    # at 11,025 Hz: 160 at 8 kHz) and the 200-sample request each alone
    assert [g.metadata["dispatch_size"] for g in got] == [4, 1, 4, 1, 4]
    assert got[3].target.shape == (160,)


# -- the batcher on a stub model ----------------------------------------------


class StubModel:
    """The batcher's view of a model without weights: separate() returns half
    of each unpadded mixture as its target and records what it was given."""

    sample_rate, hop_length = 8000, 8
    device = torch.device("cpu")
    cfg = SimpleNamespace(audio_codec=SimpleNamespace(codebook_dim=4))

    def __init__(self, fail_on=None):
        self.fail_on = fail_on
        self.calls = []

    def separate(self, batch, noise=None, **kw):
        audios = np.asarray(batch.audios)
        self.calls.append({"shape": audios.shape, "descriptions": list(batch.descriptions),
                           "noise": noise, **kw})
        if self.fail_on in batch.descriptions:
            raise ValueError("the model failed")
        sizes = np.asarray(batch.sizes) * self.hop_length
        target = [audios[i, 0, :n] * 0.5 for i, n in enumerate(sizes)]
        return SimpleNamespace(target=target,
                               residual=[audios[i, 0, :n] - target[i]
                                         for i, n in enumerate(sizes)])


def _req(n, desc="x", seed=0):
    return SeparationRequest(description=desc, audio=(
        0.1 * np.random.RandomState(seed).randn(1, n)).astype(np.float32))


def _batcher(model=None, **kw):
    kw.setdefault("bucket_seconds", 0.01)   # 80-sample buckets
    kw.setdefault("autostart", False)
    return ContinuousBatcher(model or StubModel(), **kw)


@pytest.fixture
def stopped():
    """Shuts down every batcher a test registers, even when it fails."""
    batchers = []
    yield batchers.append
    for b in batchers:
        b.shutdown(timeout=WAIT)


def test_batcher_coalesces_queued_requests(stopped):
    batcher = _batcher(max_wait_ms=50.0)
    stopped(batcher)
    futs = [batcher.submit(_req(64, f"r{i}", i)) for i in range(4)]
    batcher.start()
    outs = [f.result(timeout=WAIT) for f in futs]
    for i, out in enumerate(outs):
        assert out.target.shape == (64,)
        np.testing.assert_array_equal(out.target, _req(64, seed=i).audio[0] * 0.5)
        assert out.metadata == {"bucket": 80, "batch_size": 4, "dispatch_size": 4}
    stats = batcher.stats_snapshot()
    assert (stats["requests"], stats["batches"], stats["occupancy"]) == (4, 1, 1.0)
    assert stats["batch_size_hist"] == {4: 1} and stats["p50_latency_ms"] > 0
    assert batcher.model.calls[0]["shape"] == (4, 1, 80)


def test_batcher_buckets_and_pads_groups(stopped):
    model = StubModel()
    batcher = _batcher(model, max_batch=4, max_wait_ms=50.0)
    stopped(batcher)
    lengths = [64, 200, 60, 210, 70]
    futs = [batcher.submit(_req(n, f"r{i}", i)) for i, n in enumerate(lengths)]
    batcher.start()
    outs = [f.result(timeout=WAIT) for f in futs]
    for out, n in zip(outs, lengths):
        assert out.target.shape == (-(-n // 8) * 8,)
    assert [o.metadata["bucket"] for o in outs] == [80, 240, 80, 240, 80]
    # three requests of one bucket dispatched as 4 (the last repeated)
    assert outs[0].metadata == {"bucket": 80, "batch_size": 3, "dispatch_size": 4}
    assert outs[1].metadata == {"bucket": 240, "batch_size": 2, "dispatch_size": 2}
    assert sorted(c["shape"] for c in model.calls) == [(2, 1, 240), (4, 1, 80)]
    assert model.calls[0]["descriptions"][-2:] == ["r4", "r4"]
    assert all(c["noise"] is None and c["predict_spans"] is False for c in model.calls)


def test_batcher_isolates_a_decode_failure(stopped):
    batcher = _batcher()
    stopped(batcher)
    bad = batcher.submit(SeparationRequest(description="bad", audio="/nonexistent/file.wav"))
    good = batcher.submit(_req(64))
    batcher.start()
    assert np.isfinite(good.result(timeout=WAIT).target).all()
    with pytest.raises(ClientRequestError, match="decode"):
        bad.result(timeout=WAIT)
    stats = batcher.stats_snapshot()
    assert (stats["requests"], stats["failed_requests"]) == (2, 1)


def test_batcher_model_failure_fails_its_batch_as_500(stopped):
    batcher = _batcher(StubModel(fail_on="boom"), max_batch=1)
    stopped(batcher)
    bad, good = batcher.submit(_req(64, "boom")), batcher.submit(_req(64, "fine"))
    batcher.start()
    assert good.result(timeout=WAIT).target.shape == (64,)
    with pytest.raises(ValueError) as err:
        bad.result(timeout=WAIT)
    assert _status_for(err.value) == 500
    assert batcher.stats_snapshot()["failed_requests"] == 1


def test_batcher_admission_bound_is_429():
    batcher = _batcher(max_queue=2)
    batcher.submit(_req(8))
    batcher.submit(_req(8))
    with pytest.raises(ServerOverloadedError) as err:
        batcher.submit(_req(8))
    assert _status_for(err.value) == 429
    assert batcher.stats_snapshot()["rejected_overload"] == 1
    assert batcher.queue_depth() == 2


@pytest.mark.parametrize("policy", ["reject", "stream"])
def test_batcher_over_length_policy(stopped, tmp_path, policy):
    """max_seconds 0.02 snaps up to two 80-sample buckets (160 samples); the
    stream cap is 0.1 s (800 samples)."""
    model = StubModel()
    batcher = _batcher(model, max_seconds=0.02, long_policy=policy, max_stream_seconds=0.1,
                       streaming_window_s=0.012)
    stopped(batcher)
    assert batcher.submit(_req(160)) is not None          # inside the snapped limit
    with pytest.raises(RequestTooLongError) as err:     # past the stream cap, or rejected
        batcher.submit(_req(801 if policy == "stream" else 161))
    assert _status_for(err.value) == 413
    path = str(tmp_path / "long.wav")                     # length known after decoding
    write_wav(path, np.zeros(900, np.float32), 8000)
    from_file = batcher.submit(SeparationRequest(description="f", audio=path))
    streamed = batcher.submit(_req(400, "long")) if policy == "stream" else None
    batcher.start()
    with pytest.raises(RequestTooLongError):
        from_file.result(timeout=WAIT)
    if streamed is not None:
        out = streamed.result(timeout=WAIT)
        assert out.metadata == {"streamed": True, "num_windows": 8}
        assert out.target.shape == (400,)
        np.testing.assert_allclose(out.target, _req(400).audio[0] * 0.5, atol=1e-6)
    batcher.shutdown(timeout=WAIT)
    stats = batcher.stats_snapshot()
    # 413s count only as rejected_too_long, at admission or after decoding
    assert stats["rejected_too_long"] == 2
    assert stats["requests"] == (2 if policy == "stream" else 1)
    assert stats["streamed_requests"] == (1 if policy == "stream" else 0)
    assert stats["failed_requests"] == 0


def test_streamed_requests_get_fresh_noise(stopped):
    model = StubModel()
    batcher = _batcher(model, max_seconds=0.02, long_policy="stream",
                       streaming_window_s=0.012)
    stopped(batcher)
    futs = [batcher.submit(_req(400, "long")) for _ in range(2)]
    batcher.start()
    for f in futs:
        f.result(timeout=WAIT)
    first = [c["noise"] for c in model.calls[:8]]   # 8 windows each
    second = [c["noise"] for c in model.calls[8:]]
    assert len(first) == len(second) == 8
    assert not any(torch.equal(a, b) for a, b in zip(first, second))


def test_predict_spans_with_stream_is_refused():
    with pytest.raises(ValueError, match="predict_spans.*long_policy"):
        _batcher(predict_spans=True, long_policy="stream")
    with pytest.raises(ValueError, match="long_policy"):
        _batcher(long_policy="later")
    assert _batcher(predict_spans=True, long_policy="reject").predict_spans


def test_batcher_drains_at_shutdown():
    batcher = _batcher()
    futs = [batcher.submit(_req(64, seed=i)) for i in range(3)]
    batcher.start()
    batcher.shutdown(timeout=WAIT)
    assert batcher._thread is None
    for f in futs:
        assert f.result(timeout=0).target.shape == (64,)
    batcher.start()   # a new generation serves again
    assert batcher.separate(_req(8), timeout=WAIT).target.shape == (8,)
    batcher.shutdown(timeout=WAIT)


def test_warmup_dispatches_the_grid_and_leaves_the_counters(stopped):
    model = StubModel()
    batcher = _batcher(model, max_batch=4, max_seconds=0.02, long_policy="stream",
                       streaming_window_s=0.012)
    warmed = batcher.warmup(seconds=(0.005, 0.02))
    assert warmed == [(80, 1), (80, 2), (80, 4), (160, 1), (160, 2), (160, 4), ("streaming", 1)]
    assert [c["shape"][0] for c in model.calls[:6]] == [1, 2, 4, 1, 2, 4]
    assert len(model.calls) == 6 + 4   # 2.5 windows of 96 samples, stride 48
    assert batcher.stats_snapshot()["requests"] == 0
    batcher.start()
    stopped(batcher)
    with pytest.raises(RuntimeError, match="before start"):
        batcher.warmup()


@pytest.mark.parametrize("exc,code", [
    (ServerOverloadedError("x"), 429), (RequestTooLongError("x"), 413),
    (TimeoutError(), 504), (ClientRequestError("x"), 400),
    (json.JSONDecodeError("x", "", 0), 400), (ValueError("x"), 500), (RuntimeError("x"), 500)])
def test_status_taxonomy(exc, code):
    assert _status_for(exc) == code


def test_stage_timer():
    timer = StageTimer()
    with timer.stage("a"):
        timer.sync({"x": torch.zeros(2)})   # nothing to wait for on the CPU
    with timer.stage("a"):
        pass
    assert timer.counts["a"] == 2 and timer.summary()["a"] >= 0
    assert "a" in timer.report()
    timer.reset()
    assert timer.summary() == {}
    # nested stages: each line has the total, the share of the outermost
    # stages' sum (a child is not counted twice) and the self time
    timer.totals.update(run=2.0, separate=1.5, ode=1.0)
    timer.self_times.update(run=0.5, separate=0.5, ode=1.0)
    timer.counts.update(run=1, separate=1, ode=1)
    timer.outer_total = 2.0
    lines = dict(line.split(":", 1) for line in timer.report().splitlines())
    assert {k.strip() for k in lines} == {"run", "separate", "ode"}
    assert "2000.0 ms (100.0%), self    500.0 ms" in lines["            run"]
    assert "1500.0 ms ( 75.0%), self    500.0 ms" in lines["       separate"]
    assert "1000.0 ms ( 50.0%), self   1000.0 ms" in lines["            ode"]
    timer.reset()
    assert timer.outer_total == 0.0 and not timer.self_times
    off = StageTimer(enabled=False)
    with off.stage("b"):
        pass
    assert off.summary() == {}


# -- HTTP ----------------------------------------------------------------------


def _http(port, path, body=None, timeout=WAIT):
    data = None if body is None else (body if isinstance(body, bytes)
                                      else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wav_b64(x, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture
def server(request):
    batcher = _batcher(max_seconds=0.02, long_policy="reject", max_wait_ms=0.0)
    batcher.start()
    srv = SeparationServer(batcher, port=0)
    srv.start()

    def stop():
        srv.shutdown()
        batcher.shutdown(timeout=WAIT)

    request.addfinalizer(stop)
    return srv


def test_http_endpoints(server):
    port = server.port
    assert _http(port, "/healthz") == (200, {"ok": True})
    assert _http(port, "/nope")[0] == 404
    audio = (0.1 * np.random.RandomState(0).randn(64)).astype(np.float32)
    code, body = _http(port, "/v1/separate", {"description": "a dog", "audio": audio.tolist()})
    assert code == 200 and body["sample_rate"] == 8000
    np.testing.assert_allclose(body["target"], audio * 0.5, atol=1e-7)
    assert body["metadata"] == {"bucket": 80, "batch_size": 1, "dispatch_size": 1}
    # a 16 kHz WAV payload is resampled to the model's 8 kHz; the reply as WAV
    code, body = _http(port, "/v1/separate", {"description": "x", "response_format": "wav_b64",
                                              "audio_wav_b64": _wav_b64(audio, 16000)})
    assert code == 200
    with wave.open(io.BytesIO(base64.b64decode(body["target_wav_b64"])), "rb") as w:
        assert (w.getframerate(), w.getnframes()) == (8000, 32)
    assert _http(port, "/v1/separate", b"{not json")[0] == 400
    assert _http(port, "/v1/separate", {"audio": [0.0]})[0] == 400          # no description
    assert _http(port, "/v1/separate", {"description": "x", "audio_wav_b64": "@@"})[0] == 400
    code, body = _http(port, "/v1/separate", {"description": "x", "audio": [0.0] * 200})
    assert code == 413 and "RequestTooLongError" in body["error"]
    code, stats = _http(port, "/v1/stats")
    assert code == 200 and stats["requests"] == 2 and stats["rejected_too_long"] == 1


def test_http_timeout_is_504_and_overflow_is_429(request):
    batcher = _batcher(max_queue=1)   # no device thread yet: requests wait
    srv = SeparationServer(batcher, port=0, request_timeout=0.5)
    srv.start()

    def stop():
        srv.shutdown()
        batcher.shutdown(timeout=WAIT)

    request.addfinalizer(stop)
    body = {"description": "x", "audio": [0.0] * 8}
    assert _http(srv.port, "/v1/separate", body)[0] == 504
    code, payload = _http(srv.port, "/v1/separate", body)
    assert code == 429 and payload["queue_depth"] == 1
    batcher.start()   # the queued request is served, then the finalizer drains


# -- the small real model, and the command line --------------------------------


def test_batcher_serves_the_small_model_like_a_direct_separate(stopped):
    cfg = tiny_test_config()
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    model = SAMAudio.init_random(cfg, seed=0, device="cpu", tokenizer=tok)
    batcher = _batcher(model, max_wait_ms=50.0)
    stopped(batcher)
    reqs = [_req(64, "a dog barking", 1), _req(70, "rain", 2), _req(150, "a bell", 3)]
    futs = [batcher.submit(r) for r in reqs]
    torch.manual_seed(5)   # the device thread's noise comes from the global generator
    batcher.start()
    outs = [f.result(timeout=WAIT) for f in futs]
    assert [o.metadata["dispatch_size"] for o in outs] == [2, 2, 1]
    # the same groups, padded alike, separated directly in the same order
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    torch.manual_seed(5)
    direct = model.separate(proc(descriptions=["a dog barking", "rain"],
                                 audios=[r.audio for r in reqs[:2]], pad_to_samples=80))
    direct3 = model.separate(proc(descriptions=["a bell"], audios=[reqs[2].audio],
                                  pad_to_samples=160))
    for got, want in zip(outs, direct.target + direct3.target):
        np.testing.assert_array_equal(got.target, want)
        assert np.isfinite(got.target).all()


@pytest.fixture(scope="module")
def cli_snapshot(tmp_path_factory):
    from sam_audio_tpu_torch.checkpoint import save_span_predictor
    from sam_audio_tpu_torch.models.span_predictor import SpanPredictor, SpanPredictorConfig

    cfg = tiny_test_config()
    snap = str(tmp_path_factory.mktemp("cli") / "snap")
    model = SAMAudio.init_random(cfg, seed=0, device="cpu")
    model.params["embed_anchors"]["gate"].fill_(0.5)   # 0 at init: anchors would be inert
    model.save_pretrained(snap)
    sp_cfg = SpanPredictorConfig(audio_dim=cfg.audio_codec.codebook_dim,
                                 text_dim=cfg.text_encoder.dim, hidden=16, n_layers=1,
                                 n_heads=2, threshold=0.0, min_duration_s=0.001)
    save_span_predictor(snap, SpanPredictor.init_random(sp_cfg, seed=1, device="cpu"))
    wav = (0.3 * np.sin(np.arange(300) / 4) + 0.05 * np.random.RandomState(0).randn(300))
    write_wav(f"{snap}/../mix.wav", wav.astype(np.float32), 8000)
    return snap


@pytest.mark.parametrize("flags", [[], ["--predict-spans"], ["--window-s", "0.012"],
                                   ["--int8", "-c", "2"], ["--spans", "0.005", "0.02"]],
                         ids=["plain", "predict-spans", "window", "int8-k2", "spans"])
def test_command_line_equals_in_process_separate(cli_snapshot, tmp_path, flags):
    from sam_audio_tpu_torch.separate_cli import main
    from sam_audio_tpu_torch.streaming import separate_streaming

    mix = f"{cli_snapshot}/../mix.wav"
    out = str(tmp_path / "out")
    main(["-p", cli_snapshot, "-i", mix, "-d", "a tone", "-o", out, "--seed", "3",
          "--device", "cpu", "--allow-random-towers", *flags])
    model = SAMAudio.from_pretrained(cli_snapshot, device="cpu", allow_random_towers=True)
    assert model.span_predictor is not None
    if "--int8" in flags:
        model.quantize(8)
    gen = torch.Generator().manual_seed(3)
    if "--window-s" in flags:
        res = separate_streaming(model, "a tone", read_wav(mix)[0], window_s=0.012,
                                 generator=gen)
        target, residual = res.target, res.residual
    else:
        anchors = [[("+", 0.005, 0.02)]] if "--spans" in flags else None
        batch = SAMAudioProcessor.from_pretrained(cli_snapshot)(descriptions=["a tone"],
                                                                audios=[mix], anchors=anchors)
        res = model.separate(batch, generator=gen, predict_spans="--predict-spans" in flags,
                             reranking_candidates=2 if "-c" in flags else 1)
        if "--predict-spans" in flags:
            assert batch.anchors and batch.anchors[0]
        target, residual = res.target[0], res.residual[0]
    for name, want in (("target", target), ("residual", residual)):
        write_wav(str(tmp_path / f"want_{name}.wav"), want, 8000)
        got, sr = read_wav(f"{out}/{name}.wav")
        # a direct separate keeps whole latent frames, the stream the clip's length
        assert sr == 8000 and got.shape == (1, 300 if "--window-s" in flags else 304)
        np.testing.assert_array_equal(got, read_wav(str(tmp_path / f"want_{name}.wav"))[0])


def test_command_line_refuses_a_missing_gpu(cli_snapshot, tmp_path, monkeypatch):
    from sam_audio_tpu_torch.separate_cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-p", cli_snapshot, "-i", f"{cli_snapshot}/../mix.wav", "-d", "x",
              "-o", str(tmp_path), "--allow-random-towers"])
    from sam_audio_tpu_torch.server import main as serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve(["--snapshot", cli_snapshot, "--warmup-seconds"])


def test_submit_is_thread_safe_under_a_burst():
    """The admission bound holds exactly under concurrent submitters."""
    import sys

    batcher = _batcher(max_queue=5)
    errors, admitted = [], []
    lock = threading.Lock()

    def submit():
        try:
            f = batcher.submit(_req(8))
            with lock:
                admitted.append(f)
        except ServerOverloadedError as e:
            with lock:
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit) for _ in range(40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(admitted) == 5 and len(errors) == 35
    assert batcher.stats_snapshot()["rejected_overload"] == 35
    assert all(isinstance(f, Future) for f in admitted)
