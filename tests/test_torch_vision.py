"""The PE-Core vision tower of the PyTorch port against the JAX package (fp32,
CPU, a narrow tower, one parameter tree bridged by
checkpoint.params_from_numpy): the axial 2-D RoPE tables, the frame
preprocessing (jax.image's antialiased cubic resize, shrinking and growing),
encode_images with and without RoPE, PerceptionEncoder's chunking and
padding, the strided-feature interpolation, encode_videos at stride 1 and 3,
the int8 quantizer, sdpa's `score_dtype`, the video decoder's frame-rate
warning and the processor's masked videos."""

import dataclasses
import logging
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import PerceptionEncoderConfig as JPEConfig
from sam_audio_tpu.models import pe_clip as jpe
from sam_audio_tpu.ops import attention as jattn
from sam_audio_tpu.ops import quant as jquant
from sam_audio_tpu.ops import rope as jrope
from sam_audio_tpu.processor import SAMAudioProcessor as JProcessor
from sam_audio_tpu_torch import video_io
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import PerceptionEncoderConfig
from sam_audio_tpu_torch.models import pe_clip
from sam_audio_tpu_torch.models.init import pe_clip_init
from sam_audio_tpu_torch.ops import attention, quant, rope
from sam_audio_tpu_torch.processor import SAMAudioProcessor
from sam_audio_tpu_torch.utils import tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(dim=12, width=32, vit_layers=2, vit_heads=4, image_size=28, patch_size=14)


def cfgs(**over):
    j = JPEConfig(**TINY, **over)
    return j, PerceptionEncoderConfig(**dataclasses.asdict(j))


def jax_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jpe.pe_clip_init(jax.random.PRNGKey(seed), jcfg))


def close(got, ref, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(), np.asarray(ref),
                               **(tol or TOL))


def test_rope_2d_tables_equal_jax():
    for args in ((8, 2, 10000.0, 1), (64, 24, 10000.0, 1), (16, 3, 500.0, 0)):
        for ours, ref in zip(rope.precompute_rope_2d(*args), jrope.precompute_rope_2d(*args)):
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hw", [(40, 50), (20, 14), (360, 640), (28, 13)],
                         ids=["shrink", "grow", "video-shrink", "mixed"])
def test_preprocess_frames_matches_jax(hw):
    jcfg, cfg = cfgs()
    frames = np.random.RandomState(0).randint(0, 256, (2, 3) + hw).astype(np.uint8)
    ours = pe_clip.preprocess_frames(torch.as_tensor(frames), cfg)
    close(ours, jpe.preprocess_frames(jnp.asarray(frames), jcfg))
    assert ours.shape == (2, 3, 28, 28)


def test_resize_weights_are_jax_cubic_not_torch_bicubic():
    """Shrinking antialiases (the kernel spans more than 4 inputs), unlike
    F.interpolate(mode="bicubic"), whose a = -0.75 also differs when growing."""
    w = pe_clip.resize_weights(64, 16)
    assert (np.abs(w[:, 8]) > 0).sum() > 4
    np.testing.assert_allclose(w.sum(axis=0), 1.0, rtol=1e-6)
    x = torch.rand(1, 1, 8, 8)
    up = torch.einsum("nchw,hy,wx->ncyx", x, torch.as_tensor(pe_clip.resize_weights(8, 16)),
                      torch.as_tensor(pe_clip.resize_weights(8, 16)))
    tb = torch.nn.functional.interpolate(x, size=(16, 16), mode="bicubic", align_corners=False)
    assert float((up - tb).abs().max()) > 1e-3


@pytest.mark.parametrize("rope2d", [False, True], ids=["no-rope", "rope2d"])
def test_encode_images_matches_jax(rope2d):
    jcfg, cfg = cfgs(use_rope2d=rope2d)
    p = jax_params(jcfg)
    x = np.random.RandomState(1).randn(3, 3, 28, 28).astype(np.float32)
    ours = pe_clip.encode_images(params_from_numpy(p), torch.as_tensor(x), cfg)
    ref = jpe.encode_images(p, jnp.asarray(x), jcfg)
    close(ours, ref)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=-1), 1.0, rtol=1e-5)


def _jax_encoder(jcfg, p):
    """The JAX PerceptionEncoder, its jitted encode at fp32 (the class runs bf16)."""
    enc = jpe.PerceptionEncoder(jcfg, jax.tree_util.tree_map(jnp.asarray, p))
    enc._encode = jax.jit(lambda params, x: jpe.encode_images(params, x, jcfg))
    return enc


def test_perception_encoder_chunks_and_pads():
    jcfg, cfg = cfgs(batch_size=3)
    p = jax_params(jcfg)
    rng = np.random.RandomState(2)
    videos = [rng.randint(0, 256, (n, 3, 30, 40)).astype(np.uint8) for n in (7, 4)]
    enc = pe_clip.PerceptionEncoder(cfg, params_from_numpy(p), device="cpu",
                                    compute_dtype=torch.float32)
    ours = enc(videos)
    assert ours.shape == (2, 7, 12)
    assert float(ours[1, 4:].abs().max()) == 0.0
    close(ours, _jax_encoder(jcfg, p)(videos))
    # the chunk size does not change the features
    whole = pe_clip.PerceptionEncoder(dataclasses.replace(cfg, batch_size=0),
                                      params_from_numpy(p), device="cpu",
                                      compute_dtype=torch.float32)(videos)
    np.testing.assert_allclose(ours.numpy(), whole.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,stride", [(10, 1), (10, 3), (9, 3), (5, 4)])
def test_interp_strided_features_matches_jax(n, stride):
    feats = np.random.RandomState(3).randn(-(-n // stride), 6).astype(np.float32)
    ours = pe_clip.interp_strided_features(torch.as_tensor(feats), n, stride)
    close(ours, jpe.interp_strided_features(jnp.asarray(feats), n, stride), rtol=1e-6, atol=1e-6)


class _Model:
    """The attributes encode_videos reads of a SAMAudio."""

    def __init__(self, cfg, encoder, allow_random_towers=False):
        self.cfg, self.vision_encoder = cfg, encoder
        self.allow_random_towers = allow_random_towers
        self.device = torch.device("cpu")


@pytest.mark.parametrize("stride", [1, 3])
def test_encode_videos_matches_jax(stride):
    jcfg, cfg = cfgs(batch_size=4)
    p = jax_params(jcfg)
    rng = np.random.RandomState(4)
    videos = [rng.randint(0, 256, (n, 3, 28, 36)).astype(np.uint8) for n in (8, 5)]
    enc = pe_clip.PerceptionEncoder(cfg, params_from_numpy(p), device="cpu",
                                    compute_dtype=torch.float32)
    jmodel = _Model(None, _jax_encoder(jcfg, p))
    for t_frames in (8, 10, 6):
        ours = pe_clip.encode_videos(_Model(None, enc), videos, t_frames, stride=stride)
        ref = jpe.encode_videos(jmodel, videos, t_frames, stride=stride)
        assert ours.shape == (2, 12, t_frames)
        close(ours, ref)


def test_encode_videos_without_a_tower():
    jcfg, cfg = cfgs()
    model_cfg = type("C", (), {"vision_encoder": cfg})()
    videos = [np.zeros((3, 3, 28, 28), np.uint8)]
    with pytest.raises(ValueError, match="pe-clip"):
        pe_clip.encode_videos(_Model(model_cfg, None), videos, 3)
    model = _Model(model_cfg, None, allow_random_towers=True)
    assert pe_clip.encode_videos(model, videos, 3).shape == (1, 12, 3)
    assert isinstance(model.vision_encoder, pe_clip.PerceptionEncoder)


def test_pe_init_tree_matches_jax_layout():
    jcfg, cfg = cfgs()
    ours = pe_clip_init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax_params(jcfg)

    def shapes(tree):
        return {jax.tree_util.keystr(path): np.shape(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert shapes(tree_map(lambda t: t.numpy(), ours)) == shapes(ref)


def test_quantize_pe_params_bit_identical_to_jax():
    jcfg, _ = cfgs()
    p = jax_params(jcfg)
    ours = tree_map(lambda t: t.numpy(), quant.quantize_pe_params(params_from_numpy(p)))
    ref = jax.tree_util.tree_map(np.asarray, jquant.quantize_pe_params(
        jax.tree_util.tree_map(jnp.asarray, p)))
    flat_o = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [k for k, _ in flat_o] == [k for k, _ in flat_r]
    for (k, a), (_, b) in zip(flat_o, flat_r):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)
    assert "w8" in ours["layers"]["attn"]["wq"] and "weight" in ours["attn_pool"]["wq"]


@pytest.mark.parametrize("inputs", ["fp32", "bf16"])
def test_sdpa_score_dtype_matches_jax(inputs):
    """The logits round once to bf16 after the product; the softmax runs in
    fp32. bf16 inputs at a power-of-two scale take bf16 products."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 9, 3, 64).astype(np.float32) for _ in range(3))
    dt, jdt = ((torch.float32, jnp.float32) if inputs == "fp32"
               else (torch.bfloat16, jnp.bfloat16))
    tq, tk, tv = (torch.as_tensor(x).to(dt) for x in (q, k, v))
    ours = attention.sdpa(tq, tk, tv, score_dtype=torch.bfloat16)
    ref = jattn.sdpa(*(jnp.asarray(x, jdt) for x in (q, k, v)), score_dtype=jnp.bfloat16)
    assert ours.dtype == dt and ours.shape == (2, 9, 3, 64)
    tol = 1e-6 if inputs == "fp32" else 2e-2
    close(ours, np.asarray(ref, np.float32), rtol=tol, atol=tol)
    # the rounding is real: without it the fp32 result differs
    if inputs == "fp32":
        plain = attention.sdpa(tq, tk, tv)
        assert float((plain - ours).abs().max()) > 1e-6
    # masked keys
    mask = torch.ones(2, 9, dtype=torch.bool)
    mask[1, 5:] = False
    ours = attention.sdpa(tq, tk, tv, mask, score_dtype=torch.bfloat16)
    ref = jattn.sdpa(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(mask.numpy()),
                     score_dtype=jnp.bfloat16)
    close(ours, np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_attend_passes_score_dtype(monkeypatch):
    seen = []
    plain = attention.sdpa
    monkeypatch.setattr(attention, "sdpa", lambda *a, **kw: seen.append(kw) or plain(*a, **kw))
    x = torch.randn(1, 5, 2, 64)
    attention.attend(x, x, x, score_dtype=torch.bfloat16)
    assert seen[0]["score_dtype"] == torch.bfloat16


def test_video_decoder_warns_when_no_rate_is_known(monkeypatch, caplog):
    frames = np.arange(2 * 4 * 6 * 3, dtype=np.uint8)

    def run(cmd, **kw):
        if "ffprobe" in cmd[0]:
            out = ('{"streams": [{"width": 6, "height": 4, "r_frame_rate": "0/0", '
                   '"avg_frame_rate": "0/0"}]}')
            return subprocess.CompletedProcess(cmd, 0, stdout=out)
        return subprocess.CompletedProcess(cmd, 0, stdout=frames.tobytes())

    monkeypatch.setattr(video_io.shutil, "which", lambda name: f"/bin/{name}")
    monkeypatch.setattr(video_io.subprocess, "run", run)
    with caplog.at_level(logging.WARNING, logger=video_io.__name__):
        got, pts = video_io.decode_video_frames("clip.webm")
    assert "assuming 25 fps" in caplog.text
    assert got.shape == (2, 3, 4, 6)
    np.testing.assert_array_equal(pts, [0.0, 0.04])
    assert video_io._stream_fps({"r_frame_rate": "30000/1001"}) == pytest.approx(29.97, 1e-3)
    assert video_io._stream_fps({"nb_frames": "50", "duration": "2.0"}) == 25.0


def test_processor_masked_videos_match_jax():
    rng = np.random.RandomState(6)
    videos = [rng.randint(0, 256, (n, 3, 8, 10)).astype(np.uint8) for n in (30, 7)]
    masks = [rng.randint(0, 2, v.shape).astype(np.uint8) for v in videos]
    audios = [rng.randn(96).astype(np.float32), rng.randn(70).astype(np.float32)]
    ours = SAMAudioProcessor(8, 8000)
    ref = JProcessor(audio_hop_length=8, audio_sampling_rate=8000)
    masked = ours.mask_videos(videos, masks)
    for a, b in zip(masked, ref.mask_videos(videos, masks)):
        np.testing.assert_array_equal(a, b)
    b1 = ours(descriptions=["a", "b"], audios=audios, masked_videos=masked)
    b2 = ref(descriptions=["a", "b"], audios=audios, masked_videos=masked)
    assert [v.shape[0] for v in b1.masked_video] == [12, 9]
    for a, b in zip(b1.masked_video, b2.masked_video):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="3, H, W"):
        ours(descriptions=["a"], audios=audios[:1], masked_videos=[np.zeros((4, 8, 10, 3))])
