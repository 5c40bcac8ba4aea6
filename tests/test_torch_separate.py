"""The whole slice: text-prompted separate() of the PyTorch port against the
JAX package's, from one `save_pretrained` snapshot and the same injected
noise (fp32, CPU, 1e-4 — PARITY.md's bound for converted weights), plus the
golden fixture, the host processor, and the package guards."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, tiny_test_config
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "golden_tiny_separate.npz")
TOL = dict(rtol=1e-4, atol=1e-4)


def _snapshot(tmp_path, **overrides):
    cfg = jax_tiny_config(**overrides)
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=JaxByteTokenizer(cfg.text_encoder.vocab_size))
    jm.save_pretrained(str(tmp_path))
    tm = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    return cfg, jm, tm


def _batch(cfg, proc_cls, anchors=None):
    proc = proc_cls(audio_hop_length=cfg.audio_codec.hop_length,
                    audio_sampling_rate=cfg.audio_codec.sample_rate)
    rng = np.random.RandomState(7)
    audios = [rng.randn(1, 77).astype(np.float32) * 0.2,
              rng.randn(2, 50).astype(np.float32) * 0.2]   # stereo, shorter
    return proc(descriptions=["a dog barking", "rain on a roof"], audios=audios,
                anchors=anchors)


WIDE_DIT = dict(transformer=jax_tiny_config().transformer.__class__(
    dim=256, n_heads=2, n_layers=2, dropout=0.0, context_dim=256, max_positions=64,
    frequency_embedding_dim=8, out_channels=8))


@pytest.mark.parametrize("overrides,k", [({}, 1), ({}, 2), (WIDE_DIT, 1)],
                         ids=["tiny-k1", "tiny-k2-no-ranker", "head_dim128-k1"])
def test_separate_matches_jax(tmp_path, overrides, k):
    cfg, jm, tm = _snapshot(tmp_path, **overrides)
    anchors = [[("+", 0.0, 0.004)], [("-", 0.001, 0.003)]]
    jb = _batch(cfg, JaxProcessor, anchors)
    tb = _batch(cfg, SAMAudioProcessor, anchors)
    noise = np.random.RandomState(8).randn(
        2, jb.anchor_alignment.shape[-1], 2 * cfg.audio_codec.codebook_dim
    ).astype(np.float32)
    ref = jm.separate(jb, noise=noise, reranking_candidates=k)
    out = tm.separate(tb, noise=noise, reranking_candidates=k)
    for i in range(2):
        assert out.target[i].shape == np.asarray(ref.target[i]).shape
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]), **TOL)
        np.testing.assert_allclose(out.residual[i], np.asarray(ref.residual[i]), **TOL)
    # trimmed to whole latent frames (hop 8), as the JAX package does
    assert out.target[0].shape == (80,) and out.target[1].shape == (56,)


def test_golden_fixture_through_the_port():
    """tests/test_golden_regression.py::_compute, run by the port."""
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg)
    from sam_audio_tpu_torch.checkpoint import params_from_numpy

    model = SAMAudio(tiny_test_config(), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm.params)), device="cpu",
        tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    proc = SAMAudioProcessor(audio_hop_length=cfg.audio_codec.hop_length,
                             audio_sampling_rate=cfg.audio_codec.sample_rate)
    rng = np.random.RandomState(123)
    audios = [rng.randn(1, 64).astype(np.float32) * 0.1,
              rng.randn(1, 40).astype(np.float32) * 0.1]
    batch = proc(descriptions=["dog barking", "rain"], audios=audios)
    noise = rng.randn(2, batch.anchor_alignment.shape[-1],
                      2 * cfg.audio_codec.codebook_dim).astype(np.float32)
    res = model.separate(batch, noise=noise)
    with np.load(FIXTURE) as ref:
        for key, got in (("target0", res.target[0]), ("target1", res.target[1]),
                         ("residual0", res.residual[0])):
            np.testing.assert_allclose(got, ref[key], **TOL)


def test_processor_matches_jax_processor():
    cfg = jax_tiny_config()
    anchors = [[("+", 0.0, 0.004), ("-", 0.005, 0.008)], []]
    jb = _batch(cfg, JaxProcessor, anchors)
    tb = _batch(cfg, SAMAudioProcessor, anchors)
    for name in ("audios", "sizes", "wav_sizes", "audio_pad_mask", "anchor_ids",
                 "anchor_alignment"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    from sam_audio_tpu.ops.resample import resample_np as jax_resample
    from sam_audio_tpu_torch.ops.resample import resample_np

    wav = np.random.RandomState(0).randn(2, 441).astype(np.float32)
    np.testing.assert_allclose(resample_np(wav, 44100, 48000),
                               jax_resample(wav, 44100, 48000), rtol=1e-6, atol=1e-6)


def test_processor_reads_wav_files_like_jax(tmp_path):
    """A stereo 44.1 kHz PCM16 file: read, resampled to 48 kHz, downmixed."""
    from sam_audio_tpu_torch.audio_io import read_wav, write_wav

    wav = (0.5 * np.random.RandomState(3).randn(2, 441)).clip(-1, 1).astype(np.float32)
    path = str(tmp_path / "stereo.wav")
    write_wav(path, wav, 44100)
    back, sr = read_wav(path)
    assert sr == 44100 and back.shape == (2, 441)
    # PCM16 truncation, and the write scales by 32767 where the read divides by 32768
    np.testing.assert_allclose(back, wav, atol=1e-4)
    jb = JaxProcessor(audio_hop_length=1920, audio_sampling_rate=48000)(
        descriptions=["x"], audios=[path])
    tb = SAMAudioProcessor(1920, 48000)(descriptions=["x"], audios=[path])
    assert tb.audios.shape == jb.audios.shape == (1, 1, 480)
    np.testing.assert_allclose(tb.audios, jb.audios, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tb.sizes, jb.sizes)


def test_tokenizer_ids_and_text_padding(tmp_path):
    texts = ["dog", "a much longer description ü"]
    for a, b in zip(ByteFallbackTokenizer(32128)(texts, 512),
                    JaxByteTokenizer(32128)(texts, 512)):
        np.testing.assert_array_equal(a, b)
    cfg, _, tm = _snapshot(tmp_path)
    tm.text_pad_multiple = 64
    ids, mask = tm._tokenize(texts)
    assert ids.shape == mask.shape == (2, 64) and not mask[0, 4:].any()


def test_unported_options_raise(tmp_path):
    cfg, _, tm = _snapshot(tmp_path)
    batch = _batch(cfg, SAMAudioProcessor)
    # predict_spans is ported (tests/test_torch_spans.py): with no span
    # predictor attached it raises ValueError, as in JAX
    tm.allow_random_towers = False
    with pytest.raises(ValueError, match="no span predictor is attached"):
        tm.separate(batch, predict_spans=True)
    tm.allow_random_towers = True
    # visual_stride is ported: without a video it changes nothing
    noise = np.random.RandomState(0).randn(2, batch.anchor_alignment.shape[-1], 8).astype(
        np.float32)
    np.testing.assert_array_equal(tm.separate(batch, noise=noise, visual_stride=2).target[0],
                                  tm.separate(batch, noise=noise).target[0])
    # preview_nfe is ported: without a ranker it is ignored, as in JAX
    assert np.isfinite(tm.separate(batch, reranking_candidates=2, preview_nfe=8,
                                   generator=torch.Generator().manual_seed(0)).target[0]).all()
    # past the direct limit the clip streams (tests/test_torch_streaming.py)
    streamed = tm.separate(batch, max_direct_seconds=0.001,
                           generator=torch.Generator().manual_seed(0))
    assert streamed.noise is None and np.isfinite(streamed.target[0]).all()
    # masked videos are ported (tests/test_torch_visual.py): one frame a latent frame
    proc = SAMAudioProcessor(cfg.audio_codec.hop_length, cfg.audio_codec.sample_rate)
    vb = proc(descriptions=["x"], audios=[np.zeros(8, np.float32)],
              masked_videos=[np.zeros((1, 3, 4, 4), np.uint8)])
    assert vb.masked_video[0].shape == (1, 3, 4, 4)


def test_separate_draws_noise_from_generator(tmp_path):
    cfg, _, tm = _snapshot(tmp_path)
    batch = _batch(cfg, SAMAudioProcessor)
    a = tm.separate(batch, generator=torch.Generator().manual_seed(3))
    b = tm.separate(batch, generator=torch.Generator().manual_seed(3))
    assert a.noise.shape == (2, batch.anchor_alignment.shape[-1], 8)
    np.testing.assert_array_equal(a.target[0], b.target[0])


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    cfg, _, _ = _snapshot(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SAMAudio.from_pretrained(str(tmp_path), allow_random_towers=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        SAMAudio.init_random(tiny_test_config())


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, sys, sam_audio_tpu_torch\n"
        "for m in pkgutil.walk_packages(sam_audio_tpu_torch.__path__, 'sam_audio_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n == 'sam_audio_tpu' or n.startswith('sam_audio_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('sam_audio_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
