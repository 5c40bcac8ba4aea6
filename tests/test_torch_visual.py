"""Visual prompting in the PyTorch port against the JAX package (fp32, CPU,
tiny model from one `save_pretrained` snapshot, a narrow PE tower bridged
from the JAX tree, injected noise): separate() with masked video at k=1, k=2
and visual_stride=2, k=2 reranked by ImageBind on the device path and on the
warned host path, the visual stream with JAX's window noise, quantize(8) of
the vision tower. Also the three repairs: Ranker.forward, PE-AV attention
through `attend` (kernel 2's dispatch), and what a missing tower does."""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_imagebind_oracle import tiny_imagebind

from sam_audio_tpu.config import PEAVTransformerConfig as JPEAVTransformerConfig
from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import imagebind as jib
from sam_audio_tpu.models import pe_clip as jpe
from sam_audio_tpu.models import peav as jpeav
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.ops import quant as jquant
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.ranking.imagebind import ImageBindRanker as JImageBindRanker
from sam_audio_tpu.streaming import separate_streaming as jax_separate_streaming
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, streaming
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import (
    ImageBindRankerConfig,
    PEAVTransformerConfig,
    SoundActivityRankerConfig,
)
from sam_audio_tpu_torch.convert import convert_imagebind_state_dict
from sam_audio_tpu_torch.models import imagebind as tib
from sam_audio_tpu_torch.models import peav
from sam_audio_tpu_torch.models.pe_clip import PerceptionEncoder
from sam_audio_tpu_torch.ops import attention
from sam_audio_tpu_torch.ranking.imagebind import ImageBindRanker
from sam_audio_tpu_torch.ranking.sound_activity import SoundActivityRanker
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer
from sam_audio_tpu_torch.utils import tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
SR, HOP = 8000, 8
IB_HUGE = dict(audio_dim=32, audio_layers=2, audio_heads=4, audio_kernel=16, audio_stride=10,
               n_mels=48, target_frames=56, vision_dim=32, vision_layers=2, vision_heads=4,
               vision_patch=14, image_size=28, embed_dim=16)
# 50 ms clips: a 60-frame (480-sample) candidate holds 2 Kaldi windows of 25 ms
IB_PIPE = dict(sample_rate=8000, clip_duration_s=0.05, num_audio_clips=2, n_mels=48,
               target_frames=56)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The same tiny model in both packages, the video gate open (it is 0 at
    init, which would make the video inert), each with a fp32 PE tower of
    the same weights."""
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg)
    jm.params["align_masked_video"]["gate"] = jnp.full((1,), 0.8, jnp.float32)
    path = str(tmp_path_factory.mktemp("snap"))
    jm.save_pretrained(path)
    tm = SAMAudio.from_pretrained(path, device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    pe = jax.tree_util.tree_map(np.asarray, jpe.pe_clip_init(jax.random.PRNGKey(3),
                                                             cfg.vision_encoder))
    jm.vision_encoder = jpe.PerceptionEncoder(cfg.vision_encoder,
                                              jax.tree_util.tree_map(jnp.asarray, pe))
    jm.vision_encoder._encode = jax.jit(
        lambda p, x: jpe.encode_images(p, x, cfg.vision_encoder))   # fp32, as the port's
    tm.vision_encoder = PerceptionEncoder(tm.cfg.vision_encoder, params_from_numpy(pe),
                                          device="cpu", compute_dtype=torch.float32)
    return cfg, jm, tm, pe


def _clip(frames, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(frames * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.randn(len(t))).astype(np.float32)


def _video(n, seed, hw=(28, 36)):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 3) + hw).astype(np.uint8)
    mask = (rng.rand(n, 3, *hw) > 0.7).astype(np.uint8)
    return frames, mask


def _batches(frames_list, video_lens, seed=0):
    audios = [_clip(f, seed + i)[None] for i, f in enumerate(frames_list)]
    tp, jp = SAMAudioProcessor(HOP, SR), JaxProcessor(audio_hop_length=HOP,
                                                      audio_sampling_rate=SR)
    vids = [_video(n, seed + 10 + i) for i, n in enumerate(video_lens)]
    masked = tp.mask_videos([v for v, _ in vids], [m for _, m in vids])
    desc = ["a dog barking", "rain"][: len(audios)]
    return (tp(descriptions=desc, audios=audios, masked_videos=masked),
            jp(descriptions=desc, audios=audios, masked_videos=masked))


def _assert_same(out, ref):
    for i in range(len(ref.target)):
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]), **TOL)
        np.testing.assert_allclose(out.residual[i], np.asarray(ref.residual[i]), **TOL)


def test_ranker_forward_is_call():
    r = SoundActivityRanker(SoundActivityRankerConfig())
    rng = np.random.RandomState(0)
    kw = dict(extracted_audio=[rng.randn(3, 800).astype(np.float32)],
              input_audio=[rng.randn(3, 800).astype(np.float32)], sample_rate=SR,
              spans=[[("+", 0.01, 0.05)]])
    np.testing.assert_array_equal(r.forward(**kw), r(**kw))


@pytest.mark.parametrize("case", ["128-wide-1024-frames", "judge-64-wide", "bias_k"])
def test_peav_attention_goes_through_attend(monkeypatch, case):
    """128-wide heads over 1024 frames reach the flash kernel's entry (its
    plain version on the CPU) and match JAX; the default judge's 64-wide
    heads over 250 frames, and a bias_k tower, do not."""
    hidden, heads, t = {"128-wide-1024-frames": (256, 2, 1024), "judge-64-wide": (128, 2, 250),
                        "bias_k": (256, 2, 1024)}[case]
    calls = []
    flash = attention.flash_attention
    monkeypatch.setattr(attention, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or flash(*a, **kw))
    jcfg = JPEAVTransformerConfig(hidden_size=hidden, num_layers=1, num_heads=heads,
                                  mlp_ratio=1.0, pos="none")
    p = jax.tree_util.tree_map(np.asarray, jpeav.peav_init(jax.random.PRNGKey(0), jcfg))
    if case == "bias_k":
        rng = np.random.RandomState(1)
        p["layers"]["attn"]["bias_k"] = rng.randn(1, hidden).astype(np.float32) * 0.1
        p["layers"]["attn"]["bias_v"] = rng.randn(1, hidden).astype(np.float32) * 0.1
    x = np.random.RandomState(2).randn(1, t, hidden).astype(np.float32)
    mask = np.ones((1, t), bool)
    mask[0, t - 100:] = False
    out = peav.peav_apply(params_from_numpy(p), torch.as_tensor(x),
                          PEAVTransformerConfig(**dataclasses.asdict(jcfg)),
                          padding_mask=torch.as_tensor(mask))
    ref = jpeav.peav_apply(p, jnp.asarray(x), jcfg, padding_mask=jnp.asarray(mask))
    assert calls == ([(1, t, heads, hidden // heads)] if case.startswith("128") else [])
    np.testing.assert_allclose(out.last_hidden_state.numpy()[mask],
                               np.asarray(ref.last_hidden_state)[mask], **TOL)


@pytest.mark.parametrize("k,stride", [(1, 1), (2, 1), (1, 2)], ids=["k1", "k2", "stride2"])
def test_visual_separate_matches_jax(pair, k, stride):
    cfg, jm, tm, _ = pair
    tb, jb = _batches([40, 33], [47, 20])
    noise = np.random.RandomState(k + stride).randn(
        2 * k, tb.anchor_alignment.shape[-1], 8).astype(np.float32)
    out = tm.separate(tb, noise=noise, reranking_candidates=k, visual_stride=stride)
    ref = jm.separate(jb, noise=noise, reranking_candidates=k, visual_stride=stride)
    _assert_same(out, ref)
    # the video conditions the result
    tb.masked_video = None
    text_only = tm.separate(tb, noise=noise, reranking_candidates=k)
    assert float(np.abs(text_only.target[0] - out.target[0]).max()) > 1e-4


def _imagebind_rankers(seed=5):
    model, _, _ = tiny_imagebind(seed=seed)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, _, _ = convert_imagebind_state_dict(sd, tib.ImageBindHugeConfig(**IB_HUGE))
    jparams, _, _ = jib.convert_imagebind_state_dict(sd, jib.ImageBindHugeConfig(**IB_HUGE))
    ours = tib.ImageBindHugeModel(tib.ImageBindHugeConfig(**IB_HUGE), params_from_numpy(params),
                                  tib.ImageBindConfig(**IB_PIPE))
    ref = jib.ImageBindHugeModel(jib.ImageBindHugeConfig(**IB_HUGE), jparams,
                                 jib.ImageBindConfig(**IB_PIPE))
    return (ImageBindRanker(ImageBindRankerConfig(), model=ours, device="cpu"),
            JImageBindRanker(None, model=ref))


@pytest.mark.parametrize("lengths", [(60, 60), (60, 52)], ids=["device-path", "padded-host-path"])
def test_visual_rerank_with_imagebind_matches_jax(pair, monkeypatch, caplog, lengths):
    cfg, jm, tm, _ = pair
    ours, ref = _imagebind_rankers()
    tm.visual_ranker, jm.visual_ranker = ours, ref
    host_calls = []
    host = ImageBindRanker.__call__
    monkeypatch.setattr(ImageBindRanker, "__call__",
                        lambda self, **kw: host_calls.append(1) or host(self, **kw))
    tm._warned_visual_host = False
    try:
        tb, jb = _batches(list(lengths), [60, 45], seed=3)
        noise = np.random.RandomState(9).randn(4, tb.anchor_alignment.shape[-1], 8).astype(
            np.float32)
        with caplog.at_level(logging.WARNING):
            out = tm.separate(tb, noise=noise, reranking_candidates=2)
            again = tm.separate(tb, noise=noise, reranking_candidates=2)
        ref_out = jm.separate(jb, noise=noise, reranking_candidates=2)
    finally:
        tm.visual_ranker = jm.visual_ranker = None
    _assert_same(out, ref_out)
    np.testing.assert_array_equal(again.target[0], out.target[0])
    padded = lengths[0] != lengths[1]
    assert len(host_calls) == (2 if padded else 0)
    assert caplog.text.count("scored on the host path") == (1 if padded else 0)


@pytest.mark.parametrize("bw", [1, 3])
def test_visual_stream_matches_jax(pair, monkeypatch, bw):
    """50 latent frames through 12-frame windows; a 37-frame video (not one
    frame a latent frame) mapped by the global nearest-frame map."""
    cfg, jm, tm, _ = pair
    rng = jax.random.PRNGKey(7)

    def jax_window_noise(seed, item, window, shape, device):
        return torch.as_tensor(np.array(jax.random.normal(jax.random.fold_in(rng, window),
                                                          shape, jnp.float32)), device=device)

    monkeypatch.setattr(streaming, "_window_noise", jax_window_noise)
    wav = _clip(50, 4)
    frames, mask = _video(37, 5)
    masked = frames * (mask == 0)
    kw = dict(window_s=0.012, overlap_s=0.002, batch_windows=bw, masked_video=masked)
    out = streaming.separate_streaming(tm, "a dog barking", wav, seed=0, **kw)
    ref = jax_separate_streaming(jm, "a dog barking", wav, rng=rng, **kw)
    assert out.num_windows == ref.num_windows == 5
    np.testing.assert_allclose(out.target, np.asarray(ref.target), **TOL)
    np.testing.assert_allclose(out.residual, np.asarray(ref.residual), **TOL)


def test_quantize_8_quantizes_the_vision_tower(pair):
    cfg, jm0, tm0, pe = pair
    # fresh models on the fixture's trees: quantize() builds new trees
    jm = JaxSAMAudio(cfg, jm0.params, tokenizer=jm0.tokenizer, allow_random_towers=True)
    tm = SAMAudio(tm0.cfg, tm0.params, device="cpu", tokenizer=tm0.tokenizer)
    jm.vision_encoder = jpe.PerceptionEncoder(cfg.vision_encoder,
                                              jax.tree_util.tree_map(jnp.asarray, pe))
    jm.vision_encoder._encode = jax.jit(lambda p, x: jpe.encode_images(p, x, cfg.vision_encoder))
    tm.vision_encoder = PerceptionEncoder(tm.cfg.vision_encoder, params_from_numpy(pe),
                                          device="cpu", compute_dtype=torch.float32)
    jm.quantize(8)
    tm.quantize(8)
    ours = tree_map(lambda t: t.numpy(), tm.vision_encoder.params)
    ref = jax.tree_util.tree_map(np.asarray, jquant.quantize_pe_params(pe))
    fo, fr = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (ours, ref))
    assert [k for k, _ in fo] == [k for k, _ in fr]
    for (_, a), (_, b) in zip(fo, fr):
        np.testing.assert_array_equal(a, b)
    assert "w8" in tm.vision_encoder.params["layers"]["mlp"]["fc1"]
    tb, jb = _batches([40], [31], seed=6)
    noise = np.random.RandomState(2).randn(1, 40, 8).astype(np.float32)
    _assert_same(tm.separate(tb, noise=noise), jm.separate(jb, noise=noise))


def test_visual_prompt_needs_a_tower(pair, tmp_path):
    cfg, jm, tm, _ = pair
    tb, _ = _batches([20], [20])
    strict = SAMAudio(tm.cfg, tm.params, device="cpu", tokenizer=tm.tokenizer)
    with pytest.raises(ValueError, match="PE-Core"):
        strict.separate(tb, noise=np.zeros((1, 20, 8), np.float32))
    # a snapshot whose config names an ImageBind visual ranker builds it
    cfg_dict = dataclasses.asdict(tm.cfg)
    cfg_dict["visual_ranker"] = {"kind": "imagebind", "checkpoint": None}
    from sam_audio_tpu_torch.checkpoint import save_params

    save_params(str(tmp_path / "params.npz"), tm.params)
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg_dict, f)
    loaded = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                      tokenizer=tm.tokenizer)
    assert isinstance(loaded.visual_ranker, ImageBindRanker)
