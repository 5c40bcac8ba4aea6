"""The ImageBind stack of the PyTorch port against the JAX package (fp32, CPU,
tiny towers, one parameter tree bridged by checkpoint.params_from_numpy):
the Kaldi fbank on the host and on the device, the on-device resample, the
mel clips, both scorers' embeddings (imagebind_huge from a converted
key-faithful oracle, the light towers), the ImageBindRanker's host and
device paths, the int8 quantizer, the random init's layout, create_ranker
and the checkpoint sniffing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_imagebind_oracle import tiny_imagebind

from sam_audio_tpu.models import imagebind as jib
from sam_audio_tpu.ops import mel as jmel
from sam_audio_tpu.ops import quant as jquant
from sam_audio_tpu.ops import resample as jresample
from sam_audio_tpu.ranking.imagebind import ImageBindRanker as JImageBindRanker
from sam_audio_tpu_torch.checkpoint import params_from_numpy, save_params
from sam_audio_tpu_torch.config import ImageBindRankerConfig
from sam_audio_tpu_torch.convert import convert_imagebind_state_dict
from sam_audio_tpu_torch.models import imagebind as tib
from sam_audio_tpu_torch.models.init import imagebind_huge_init
from sam_audio_tpu_torch.ops import mel, quant, resample
from sam_audio_tpu_torch.ranking import create_ranker
from sam_audio_tpu_torch.ranking.imagebind import ImageBindRanker
from sam_audio_tpu_torch.utils import tree_map

TOL = dict(rtol=1e-4, atol=1e-4)
HUGE = dict(audio_dim=32, audio_layers=2, audio_heads=4, audio_kernel=16, audio_stride=10,
            n_mels=48, target_frames=56, vision_dim=32, vision_layers=2, vision_heads=4,
            vision_patch=14, image_size=28, embed_dim=16)
PIPE = dict(sample_rate=8000, clip_duration_s=0.25, num_audio_clips=2, n_mels=48,
            target_frames=56, n_fft=128, hop_length=32)
LIGHT = dict(sample_rate=8000, clip_duration_s=0.25, num_audio_clips=2, n_mels=32,
             target_frames=32, audio_patch=16, audio_hidden=16, audio_layers=2, audio_heads=2,
             image_size=32, image_patch=16, num_video_clips=3, vision_hidden=16,
             vision_layers=2, vision_heads=2, embed_dim=8)


def close(got, ref, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(), np.asarray(ref),
                               **(tol or TOL))


def _wav(n, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.randn(n)).astype(np.float32)


def test_kaldi_fbank_host_and_device_match_jax():
    wav = _wav(3300)
    host = mel.kaldi_fbank(wav, sample_frequency=16000, num_mel_bins=64)
    np.testing.assert_array_equal(host, jmel.kaldi_fbank(wav, sample_frequency=16000,
                                                          num_mel_bins=64))
    batch = np.stack([wav, _wav(3300, 1)])
    dev = mel.kaldi_fbank_torch(torch.as_tensor(batch), sample_frequency=16000, num_mel_bins=64)
    ref = jmel.kaldi_fbank_jax(jnp.asarray(batch), sample_frequency=16000, num_mel_bins=64)
    assert dev.shape == (2, 19, 64)
    close(dev, ref)
    close(dev[0], host)
    assert mel.kaldi_fbank_torch(torch.zeros(2, 100)).shape == (2, 0, 128)
    np.testing.assert_array_equal(mel.kaldi_mel_banks(40, 512, 16000.0),
                                  jmel.kaldi_mel_banks(40, 512, 16000.0))


@pytest.mark.parametrize("rates", [(48000, 16000), (8000, 16000), (16000, 8000), (44100, 16000)])
def test_resample_on_device_matches_jax(rates):
    wav = np.stack([_wav(1234), _wav(1234, 2)])
    ours = resample.resample(torch.as_tensor(wav), *rates)
    close(ours, jresample.resample(jnp.asarray(wav), *rates), rtol=1e-5, atol=1e-5)
    close(ours, resample.resample_np(wav, *rates), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [4000, 1500, 100], ids=["long", "shorter-than-clip", "tiny"])
def test_melclips_host_and_device_match_jax(n):
    cfg, jcfg = tib.ImageBindConfig(**PIPE), jib.ImageBindConfig(**PIPE)
    wav = _wav(n)
    host = tib.audio_to_melclips(wav, cfg)
    np.testing.assert_array_equal(host, jib.audio_to_melclips(wav, jcfg))
    rows = np.stack([wav, _wav(n, 3)])
    dev = tib.audio_to_melclips_torch(torch.as_tensor(rows), cfg)
    close(dev, jib.audio_to_melclips_jax(jnp.asarray(rows), jcfg))
    close(dev[0], host)


def _huge_pair(seed=0):
    model, _, _ = tiny_imagebind(seed=seed)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, left, _ = convert_imagebind_state_dict(sd, tib.ImageBindHugeConfig(**HUGE))
    assert left == []
    jparams, _, _ = jib.convert_imagebind_state_dict(sd, jib.ImageBindHugeConfig(**HUGE))
    ours = tib.ImageBindHugeModel(tib.ImageBindHugeConfig(**HUGE), params_from_numpy(params),
                                  tib.ImageBindConfig(**PIPE))
    ref = jib.ImageBindHugeModel(jib.ImageBindHugeConfig(**HUGE), jparams,
                                 jib.ImageBindConfig(**PIPE))
    return ours, ref


def _light_pair():
    jcfg = jib.ImageBindConfig(**LIGHT)
    p = jax.tree_util.tree_map(np.asarray, jib.imagebind_init(jax.random.PRNGKey(1), jcfg))
    return (tib.ImageBindModel(tib.ImageBindConfig(**LIGHT), params_from_numpy(p)),
            jib.ImageBindModel(jcfg, p))


@pytest.mark.parametrize("which", ["huge", "light"])
def test_embeddings_match_jax(which):
    ours, ref = _huge_pair(3) if which == "huge" else _light_pair()
    rng = np.random.RandomState(0)
    wavs = [_wav(4000, 1), _wav(3000, 2)]
    close(ours.embed_audio(wavs, 16000), ref.embed_audio(wavs, 16000))
    rows = np.stack([_wav(4000, 4), _wav(4000, 5)])
    close(ours.embed_audio_device(torch.as_tensor(rows), 16000),
          ref.embed_audio_device(jnp.asarray(rows), 16000))
    videos = [rng.randint(0, 256, (9, 3, 40, 50)).astype(np.uint8) for _ in range(2)]
    emb = ours.embed_videos(videos)
    close(emb, ref.embed_videos(videos))
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=-1), 1.0, rtol=1e-5)


def test_huge_towers_match_jax_on_stills_and_clips():
    ours, ref = _huge_pair(4)
    rng = np.random.RandomState(1)
    mels = rng.randn(2, 2, 56, 48).astype(np.float32)
    close(tib.imagebind_encode_audio(ours.params, ours.cfg, torch.as_tensor(mels)),
          jib.imagebind_encode_audio(ref.params, ref.cfg, jnp.asarray(mels)))
    for shape in ((2, 3, 3, 28, 28), (2, 3, 3, 2, 28, 28)):   # stills repeat to 2 frames
        clips = rng.rand(*shape).astype(np.float32)
        close(tib.imagebind_encode_vision(ours.params, ours.cfg, torch.as_tensor(clips)),
              jib.imagebind_encode_vision(ref.params, ref.cfg, jnp.asarray(clips)))


def test_ranker_device_path_matches_host_and_jax():
    """Equal, unpadded candidates: the device path equals the host path
    (the clip starts come from the same true duration), both equal JAX's."""
    ours, ref = _huge_pair(5)
    ranker = ImageBindRanker(ImageBindRankerConfig(), model=ours, device="cpu")
    rng = np.random.RandomState(2)
    cands = [np.stack([_wav(4800, 10 * i + j) for j in range(3)]) for i in range(2)]
    videos = [rng.randint(0, 256, (12, 3, 30, 44)).astype(np.uint8) for _ in range(2)]
    host = ranker.forward(extracted_audio=cands, videos=videos, sample_rate=16000)
    assert ranker.supports_on_device([4800, 4800], 16000)
    assert not ranker.supports_on_device([4800, 4000], 16000)
    dev = ranker.score_on_device(torch.as_tensor(np.stack(cands)), [4800, 4800], videos,
                                 sample_rate=16000)
    close(dev, host)
    jhost = JImageBindRanker(None, model=ref)(extracted_audio=cands, videos=videos,
                                              sample_rate=16000)
    close(host, jhost)
    jdev = JImageBindRanker(None, model=ref).score_on_device(
        jnp.asarray(np.stack(cands)), [4800, 4800], videos, sample_rate=16000)
    close(dev, jdev)


def test_quantize_imagebind_params_bit_identical_to_jax():
    _, ref = _huge_pair(6)
    ours = tree_map(lambda t: t.numpy(), quant.quantize_imagebind_params(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, ref.params))))
    jq = jax.tree_util.tree_map(np.asarray, jquant.quantize_imagebind_params(
        jax.tree_util.tree_map(jnp.asarray, ref.params)))
    fo, fr = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (ours, jq))
    assert [k for k, _ in fo] == [k for k, _ in fr]
    for (k, a), (_, b) in zip(fo, fr):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b)
    assert "w8" in ours["vision"]["trunk"]["layers"]["attn"]["wq"]


def test_huge_init_has_the_converted_layout():
    ours, _ = _huge_pair()
    init = imagebind_huge_init(tib.ImageBindHugeConfig(**HUGE), torch.Generator().manual_seed(0),
                               "cpu")

    def shapes(tree):
        return {jax.tree_util.keystr(p): tuple(x.shape)
                for p, x in jax.tree_util.tree_flatten_with_path(tree_map(np.asarray, tree))[0]}

    conv = shapes(tree_map(lambda t: t.numpy(), ours.params))
    got = shapes(tree_map(lambda t: t.numpy(), init))
    # the oracle's audio stem conv has no bias and its vision stem no norm, as the init
    assert got == conv


def test_create_ranker_and_checkpoint_sniffing(tmp_path):
    r = create_ranker(ImageBindRankerConfig(), device="cpu")
    assert isinstance(r, ImageBindRanker)
    with pytest.raises(ValueError, match="imagebind"):
        r.supports_on_device([10], 16000)
    r = create_ranker(ImageBindRankerConfig(), allow_random=True, device="cpu")
    assert isinstance(r.model, tib.ImageBindModel)
    ours, _ = _huge_pair()
    save_params(str(tmp_path / "ib.npz"), ours.params)
    assert isinstance(tib.load_imagebind_model(str(tmp_path / "ib.npz"), "cpu"),
                      tib.ImageBindHugeModel)
    light, _ = _light_pair()
    save_params(str(tmp_path / "light.npz"), light.params)
    assert isinstance(tib.load_imagebind_model(str(tmp_path / "light.npz"), "cpu"),
                      tib.ImageBindModel)
