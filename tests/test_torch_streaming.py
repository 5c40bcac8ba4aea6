"""Streaming separation of long audio in the PyTorch port against the JAX
package (fp32, CPU, tiny model from one `save_pretrained` snapshot): the
crossfade weights, separate_streaming with the same per-window noise (the
port's `_window_noise` replaced by JAX's fold_in draws), separate()'s
dispatch to the windows past the direct limit, and the port's own noise
contract (independent of batch_windows, reproducible from a seeded
generator)."""

import logging

import jax
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.streaming import _crossfade_weights as jax_crossfade
from sam_audio_tpu.streaming import separate_streaming as jax_separate_streaming
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, streaming
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
SR = 8000                       # tiny config: hop 8, 8 kHz
WINDOW = dict(window_s=0.012, overlap_s=0.002)   # 96-sample windows, 16-sample fades


def _pair(tmp_path):
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=JaxByteTokenizer(cfg.text_encoder.vocab_size))
    jm.save_pretrained(str(tmp_path))
    tm = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    return cfg, jm, tm


def _wav(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("length,fade", [(96, 16), (480000, 48000), (64, 0), (10, 5)])
def test_crossfade_weights_equal_jax(length, fade):
    ours = streaming._crossfade_weights(length, fade)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, jax_crossfade(length, fade))


@pytest.mark.parametrize("bw,k,anchors", [
    (1, 1, [("+", 0.004, 0.02), ("-", 0.03, 0.04)]),
    (3, 1, [("+", 0.004, 0.02), ("-", 0.03, 0.04)]),
    (1, 2, None),
    (3, 2, [("+", 0.01, 0.045)]),
], ids=["bw1-anchors", "bw3-ragged-anchors", "bw1-k2", "bw3-k2-anchors"])
def test_separate_streaming_matches_jax(tmp_path, monkeypatch, bw, k, anchors):
    cfg, jm, tm = _pair(tmp_path)
    rng = jax.random.PRNGKey(5)

    def jax_window_noise(seed, item, window, shape, device):
        # the JAX module's per-window draw
        return torch.as_tensor(np.array(jax.random.normal(
            jax.random.fold_in(rng, window), shape, jax.numpy.float32)), device=device)

    monkeypatch.setattr(streaming, "_window_noise", jax_window_noise)
    wav = _wav(400)   # 5 windows: with bw=3, groups of 3 and 2
    ref = jax_separate_streaming(jm, "a dog barking", wav, anchors=anchors,
                                 reranking_candidates=k, rng=rng, batch_windows=bw, **WINDOW)
    out = streaming.separate_streaming(tm, "a dog barking", wav, anchors=anchors,
                                       reranking_candidates=k, seed=0, batch_windows=bw,
                                       **WINDOW)
    assert out.num_windows == ref.num_windows == 5
    assert out.target.shape == out.residual.shape == wav.shape
    np.testing.assert_allclose(out.target, np.asarray(ref.target), **TOL)
    np.testing.assert_allclose(out.residual, np.asarray(ref.residual), **TOL)


def test_short_audio_is_one_direct_separate(tmp_path):
    cfg, _, tm = _pair(tmp_path)
    wav = _wav(88)
    out = streaming.separate_streaming(tm, "rain", wav, seed=3, **WINDOW)
    assert out.num_windows == 1
    batch = SAMAudioProcessor(8, SR)(descriptions=["rain"], audios=[wav[None]])
    noise = streaming._window_noise(3, 0, 0, (1, batch.anchor_alignment.shape[-1], 8), "cpu")
    direct = tm.separate(batch, noise=noise)
    np.testing.assert_array_equal(out.target, direct.target[0])
    np.testing.assert_array_equal(out.residual, direct.residual[0])


def _long_batch():
    return SAMAudioProcessor(8, SR)(
        descriptions=["a dog barking", "rain"], audios=[_wav(400, 1)[None], _wav(300, 2)[None]],
        anchors=[[("+", 0.004, 0.02)], []])


def test_separate_past_the_limit_streams(tmp_path):
    """separate() past max_direct_seconds equals separate_streaming, item by
    item, with the seed drawn from the same generator."""
    cfg, _, tm = _pair(tmp_path)
    tm.streaming_window_s = 0.012
    tm.streaming_batch_windows = 2
    batch = _long_batch()
    res = tm.separate(batch, generator=torch.Generator().manual_seed(9),
                      max_direct_seconds=0.012)
    assert res.noise is None
    seed = streaming.base_seed(torch.Generator().manual_seed(9))
    for i, anchors in enumerate(([("+", 0.004, 0.02)], None)):
        # the item's frame-rounded size, as a direct separate trims it
        n = int(batch.sizes[i]) * 8
        ref = streaming.separate_streaming(
            tm, batch.descriptions[i], batch.audios[i, 0, :n], window_s=0.012,
            anchors=anchors, seed=seed, item=i)
        assert res.target[i].shape == (n,)
        np.testing.assert_allclose(res.target[i], ref.target, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res.residual[i], ref.residual, rtol=1e-5, atol=1e-5)
    # the model attribute sets the limit when the argument is absent
    tm.max_direct_seconds = 0.012
    again = tm.separate(batch, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(again.target[0], res.target[0])


def test_explicit_noise_stays_direct(tmp_path, caplog):
    cfg, _, tm = _pair(tmp_path)
    batch = _long_batch()
    noise = np.random.RandomState(4).randn(2, batch.anchor_alignment.shape[-1], 8
                                           ).astype(np.float32)
    with caplog.at_level(logging.WARNING):
        forced = tm.separate(batch, noise=noise, max_direct_seconds=0.012)
    assert "forces the direct path" in caplog.text
    direct = tm.separate(batch, noise=noise)
    assert forced.noise is not None
    np.testing.assert_array_equal(forced.target[0], direct.target[0])


def test_predict_spans_past_the_limit_raises(tmp_path):
    cfg, _, tm = _pair(tmp_path)
    with pytest.raises(ValueError, match="predict_spans"):
        tm.separate(_long_batch(), predict_spans=True, max_direct_seconds=0.012)
    # a masked video streams with its clip (tests/test_torch_visual.py holds it against JAX)
    res = streaming.separate_streaming(tm, "x", _wav(200), seed=0,
                                       masked_video=np.zeros((1, 3, 4, 4), np.uint8), **WINDOW)
    assert res.num_windows == 3 and res.target.shape == (200,) and np.isfinite(res.target).all()


def test_window_noise_independent_of_grouping_and_reproducible(tmp_path):
    cfg, _, tm = _pair(tmp_path)
    wav = _wav(560)   # 7 windows
    anchors = [("+", 0.01, 0.05)]
    runs = {bw: streaming.separate_streaming(tm, "a dog", wav, anchors=anchors,
                                             generator=torch.Generator().manual_seed(1),
                                             batch_windows=bw, **WINDOW)
            for bw in (1, 3)}
    np.testing.assert_allclose(runs[3].target, runs[1].target, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(runs[3].residual, runs[1].residual, rtol=1e-5, atol=1e-5)
    again = streaming.separate_streaming(tm, "a dog", wav, anchors=anchors,
                                         generator=torch.Generator().manual_seed(1),
                                         batch_windows=3, **WINDOW)
    np.testing.assert_array_equal(again.target, runs[3].target)
    # windows of one item draw other noise, and so do other items
    a = streaming._window_noise(1, 0, 0, (2, 3), "cpu")
    assert not torch.equal(a, streaming._window_noise(1, 0, 1, (2, 3), "cpu"))
    assert not torch.equal(a, streaming._window_noise(1, 1, 0, (2, 3), "cpu"))
    assert torch.equal(a, streaming._window_noise(1, 0, 0, (2, 3), "cpu"))
