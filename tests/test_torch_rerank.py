"""k-candidate separate() with a CLAP text ranker, the port against the JAX
package (fp32, CPU, tiny models, the same noise): the on-device scoring path
(clips within the CLAP window at its sample rate), the host path (another
sample rate: resampled on the host), and the preview_nfe path. The same
winners must be chosen and the outputs agree within 1e-4 (PARITY.md's bound
for converted weights)."""

import dataclasses

import jax
import numpy as np
import pytest

from sam_audio_tpu.config import ClapRankerConfig as JaxClapRankerConfig
from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import clap as jclap
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.ranking.clap import ClapRanker as JaxClapRanker
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import ClapRankerConfig
from sam_audio_tpu_torch.models import clap as tclap
from sam_audio_tpu_torch.ranking import create_ranker
from sam_audio_tpu_torch.ranking.clap import ClapRanker
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
CLAP = dict(duration_s=0.02, n_fft=64, hop_length=8, n_mels=8, fmin=50.0, fmax=3500.0,
            spec_size=32, patch_size=4, audio_embed_dim=8, depths=(2, 2),
            audio_heads=(2, 2), window_size=4, text_vocab=300, text_hidden=16,
            text_layers=2, text_heads=2, text_intermediate=32, max_text_len=16,
            embed_dim=8)


class Spy:
    """Wraps a ranker and records the winners it picks."""

    def __init__(self, ranker):
        self.ranker, self.winners = ranker, []

    def supports_on_device(self, *a):
        return self.ranker.supports_on_device(*a)

    def score_on_device(self, *a, **kw):
        s = self.ranker.score_on_device(*a, **kw)
        self.winners.append(np.asarray(s).argmax(1).tolist())
        return s

    def __call__(self, **kw):
        s = self.ranker(**kw)
        self.winners.append(np.asarray(s).argmax(1).tolist())
        return s


def _pair(tmp_path, clap_rate):
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=JaxByteTokenizer(cfg.text_encoder.vocab_size))
    jm.save_pretrained(str(tmp_path))
    tm = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    kw = {**CLAP, "sample_rate": clap_rate}
    cp = jax.tree_util.tree_map(np.asarray, jclap.clap_init(
        jax.random.PRNGKey(1), jclap.ClapConfig(**kw)))
    jm.text_ranker = Spy(JaxClapRanker(JaxClapRankerConfig(), model=jclap.ClapModel(
        jclap.ClapConfig(**kw), cp, tokenizer=JaxByteTokenizer(300))))
    tm.text_ranker = Spy(ClapRanker(ClapRankerConfig(), device="cpu", model=tclap.ClapModel(
        tclap.ClapConfig(**kw), params_from_numpy(cp), tokenizer=ByteFallbackTokenizer(300))))
    return cfg, jm, tm


@pytest.mark.parametrize("preview_nfe", [None, 4], ids=["full", "preview4"])
@pytest.mark.parametrize("clap_rate", [8000, 16000], ids=["on-device", "host"])
def test_reranked_separate_matches_jax(tmp_path, clap_rate, preview_nfe):
    cfg, jm, tm = _pair(tmp_path, clap_rate)
    rng = np.random.RandomState(11)
    # whole latent frames (hop 8): the JAX host path slices the mixture to
    # the frame-rounded size
    audios = [rng.randn(1, 80).astype(np.float32) * 0.2,
              rng.randn(1, 48).astype(np.float32) * 0.2]
    kw = dict(audio_hop_length=cfg.audio_codec.hop_length,
              audio_sampling_rate=cfg.audio_codec.sample_rate)
    desc = ["a dog barking", "rain on a roof"]
    jb = JaxProcessor(**kw)(descriptions=desc, audios=audios)
    tb = SAMAudioProcessor(**kw)(descriptions=desc, audios=audios)
    k = 4
    noise = rng.randn(2 * k, jb.anchor_alignment.shape[-1],
                      2 * cfg.audio_codec.codebook_dim).astype(np.float32)
    ref = jm.separate(jb, noise=noise, reranking_candidates=k, preview_nfe=preview_nfe)
    out = tm.separate(tb, noise=noise, reranking_candidates=k, preview_nfe=preview_nfe)
    assert tm.text_ranker.winners == jm.text_ranker.winners and tm.text_ranker.winners
    assert len(tm.text_ranker.winners) == 1   # one ranking, on the path the rate selects
    for i in range(2):
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]), **TOL)
        np.testing.assert_allclose(out.residual[i], np.asarray(ref.residual[i]), **TOL)
    if preview_nfe is None:
        # the returned target is the winning candidate of the k=1 solve of its noise
        w = tm.text_ranker.winners[0][0]
        single = tm.separate(tb, noise=noise[[w, k]], reranking_candidates=1)
        np.testing.assert_allclose(out.target[0], single.target[0], rtol=1e-5, atol=1e-5)


def test_ranker_configs_and_validation(tmp_path):
    from sam_audio_tpu_torch.config import (
        EnsembleRankerConfig,
        ImageBindRankerConfig,
        JudgeRankerConfig,
        SoundActivityRankerConfig,
    )

    # every kind is ported (tests/test_torch_rankers.py, tests/test_torch_imagebind.py)
    for c in (ImageBindRankerConfig(), JudgeRankerConfig(), SoundActivityRankerConfig(),
              EnsembleRankerConfig()):
        assert create_ranker(c, device="cpu") is not None
    assert create_ranker(None) is None
    weightless = create_ranker(ClapRankerConfig(), device="cpu")
    with pytest.raises(ValueError, match="weights"):
        weightless.model
    # a snapshot whose config names a CLAP text ranker loads with one
    cfg = dataclasses.replace(jax_tiny_config(), text_ranker=JaxClapRankerConfig())
    JaxSAMAudio(cfg, JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg).params
                ).save_pretrained(str(tmp_path))
    tm = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(256))
    assert isinstance(tm.text_ranker, ClapRanker) and tm.text_ranker.allow_random
    batch = SAMAudioProcessor(8, 8000)(descriptions=["x"],
                                       audios=[np.zeros(40, np.float32)])
    for bad in (3, 0):
        with pytest.raises(ValueError, match="preview_nfe"):
            tm.separate(batch, reranking_candidates=2, preview_nfe=bad)
