"""The host rankers of the PyTorch port against the JAX package (sound
activity, the ensemble), the ranker factory, and a k=4 separate() reranked
by a judge (fp32, CPU, tiny widths): the same winners and waveforms within
1e-4, on the on-device scoring path and on the host path."""

import dataclasses

import jax
import numpy as np
import pytest

from sam_audio_tpu.config import DACVAEConfig as JDACVAEConfig
from sam_audio_tpu.config import JudgeRankerConfig as JJudgeRankerConfig
from sam_audio_tpu.config import ModernBertTextConfig as JModernBertTextConfig
from sam_audio_tpu.config import PEAVTransformerConfig as JPEAVTransformerConfig
from sam_audio_tpu.config import SAMAudioJudgeConfig as JSAMAudioJudgeConfig
from sam_audio_tpu.config import SoundActivityRankerConfig as JSoundActivityRankerConfig
from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import judge as jjudge
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.processor import SAMAudioJudgeProcessor as JJudgeProcessor
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.ranking import sound_activity as jsa
from sam_audio_tpu.ranking.judge import JudgeRanker as JJudgeRanker
from sam_audio_tpu.ranking.ranker import EnsembleRanker as JEnsembleRanker
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JByteTokenizer
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import (
    ClapRankerConfig,
    EnsembleRankerConfig,
    ImageBindRankerConfig,
    JudgeRankerConfig,
    SAMAudioJudgeConfig,
    SoundActivityRankerConfig,
    parse_ranker_config,
)
from sam_audio_tpu_torch.models.judge import SAMAudioJudgeModel
from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor
from sam_audio_tpu_torch.ranking import create_ranker
from sam_audio_tpu_torch.ranking import sound_activity as tsa
from sam_audio_tpu_torch.ranking.clap import ClapRanker
from sam_audio_tpu_torch.ranking.judge import JudgeRanker
from sam_audio_tpu_torch.ranking.ranker import EnsembleRanker
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)


def _bursts(sr, seconds, spans, seed):
    """Noise bursts over `spans` (seconds) on a quiet floor."""
    rng = np.random.RandomState(seed)
    n = int(sr * seconds)
    wav = rng.randn(n).astype(np.float32) * 1e-4
    for a, b in spans:
        wav[int(a * sr): int(b * sr)] += rng.randn(int(b * sr) - int(a * sr)) * 0.3
    return wav


@pytest.mark.parametrize("sr,mode,threshold", [(24000, "rel_to_max", -40),
                                               (48000, "rel_to_max", -30),
                                               (8000, "abs", -35)])
def test_detect_nonsilent_matches_jax(sr, mode, threshold):
    for seconds, spans in ((2.0, [(0.3, 0.8), (1.2, 1.9)]), (0.2, [(0.0, 0.1)]),
                           (1.237, [(0.5, 1.237)])):
        wav = _bursts(sr, seconds, spans, seed=int(seconds * 100))
        ours = tsa.detect_nonsilent(wav, sr, sil_threshold=threshold, threshold_mode=mode)
        ref = jsa.detect_nonsilent(wav, sr, sil_threshold=threshold, threshold_mode=mode)
        assert ours == ref and ours


def test_iou_recall_precision_matches_jax():
    for hyp, ref in (([(0.0, 1.0)], [(0.5, 1.5)]), ([(0.1, 0.2), (0.4, 0.9)], [(0.0, 0.5)]),
                     ([], [(0.0, 1.0)]), ([(0.0, 1.0)], [])):
        assert tsa.compute_iou_recall_precision(hyp, ref) == \
            jsa.compute_iou_recall_precision(hyp, ref)


@pytest.mark.parametrize("metric", ["iou", "recall", "precision"])
def test_sound_activity_ranker_matches_jax(metric):
    sr = 16000
    cands = [np.stack([_bursts(sr, 1.0, s, seed=j) for j, s in enumerate(
                ([(0.1, 0.4)], [(0.2, 0.9)], [(0.0, 1.0)]))]),
             np.stack([_bursts(sr, 1.0, s, seed=5 + j) for j, s in enumerate(
                 ([(0.5, 0.6)], [], [(0.3, 0.7)]))])]
    spans = [[["+", 0.1, 0.5]], [["+", 0.3, 0.7], ["-", 0.8, 0.9]]]
    kw = dict(extracted_audio=cands, spans=spans, sample_rate=sr)
    ours = tsa.SoundActivityRanker(SoundActivityRankerConfig(metric=metric))(**kw)
    ref = jsa.SoundActivityRanker(JSoundActivityRankerConfig(metric=metric))(**kw)
    assert ours.shape == (2, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


class Fixed:
    def __init__(self, scores):
        self.scores = np.asarray(scores, np.float32)

    def __call__(self, **kwargs):
        return self.scores


def test_ensemble_is_the_weighted_sum():
    a, b = [[1.0, 2.0, 3.0]], [[0.5, -1.0, 4.0]]
    ours = EnsembleRanker([Fixed(a), Fixed(b)], [1.0, 0.5])(x=1)
    ref = JEnsembleRanker([Fixed(a), Fixed(b)], [1.0, 0.5])(x=1)
    np.testing.assert_array_equal(ours, np.asarray(a) + 0.5 * np.asarray(b))
    np.testing.assert_array_equal(ours, ref)
    with pytest.raises(ValueError):
        EnsembleRanker([Fixed(a)], [1.0, 2.0])


def test_create_ranker_for_each_kind():
    assert create_ranker(None) is None
    assert isinstance(create_ranker(SoundActivityRankerConfig()), tsa.SoundActivityRanker)
    assert isinstance(create_ranker(ClapRankerConfig(), device="cpu"), ClapRanker)
    judge = create_ranker(JudgeRankerConfig(checkpoint_or_model_id="/nonexistent"),
                          device="cpu")
    assert isinstance(judge, JudgeRanker) and judge.device == "cpu"
    with pytest.raises(FileNotFoundError, match="local"):
        judge.model   # the port reads local snapshots only
    ens = create_ranker(parse_ranker_config({"kind": "ensemble", "rankers": {
        "judge": [{"kind": "judge"}, 1.0], "sa": [{"kind": "sound_activity"}, 0.5]}}),
        device="cpu")
    assert isinstance(ens, EnsembleRanker) and ens.weights == [1.0, 0.5]
    assert [type(r) for r in ens.rankers] == [JudgeRanker, tsa.SoundActivityRanker]
    from sam_audio_tpu_torch.ranking.imagebind import ImageBindRanker

    assert isinstance(create_ranker(ImageBindRankerConfig(), device="cpu"), ImageBindRanker)
    ens = create_ranker(EnsembleRankerConfig(rankers=(("ib", (ImageBindRankerConfig(), 1.0)),)),
                        allow_random=True, device="cpu")
    assert isinstance(ens.rankers[0], ImageBindRanker) and ens.rankers[0].allow_random


class Spy:
    """Wraps a ranker and records the winners it picks."""

    def __init__(self, ranker, on_device=True):
        self.ranker, self.winners = ranker, []
        if on_device:
            self.supports_on_device = ranker.supports_on_device

    def score_on_device(self, *a, **kw):
        s = self.ranker.score_on_device(*a, **kw)
        self.winners.append(np.asarray(s).argmax(1).tolist())
        return s

    def __call__(self, **kw):
        s = self.ranker(**kw)
        self.winners.append(np.asarray(s).argmax(1).tolist())
        return s


def _judge(rates):
    codec = dict(encoder_dim=4, encoder_rates=rates, latent_dim=16, decoder_dim=16,
                 decoder_rates=(4, 2), codebook_dim=4, sample_rate=8000)
    jcfg = JSAMAudioJudgeConfig(
        audio_codec=JDACVAEConfig(**codec),
        transformer=JPEAVTransformerConfig(hidden_size=16, num_layers=2, num_heads=2),
        finetune_transformer=JPEAVTransformerConfig(hidden_size=12, num_layers=1, num_heads=2),
        text_model=JModernBertTextConfig(vocab_size=300, hidden_size=16, num_hidden_layers=3,
                                         num_attention_heads=2, intermediate_size=24,
                                         local_attention=8),
        nth_text_layer=2, bottleneck_dim=8, compute_dtype="float32")
    params = jax.tree_util.tree_map(np.asarray, jjudge.judge_init(jax.random.PRNGKey(4), jcfg))
    tcfg = SAMAudioJudgeConfig.from_dict(dataclasses.asdict(jcfg))
    hop = int(np.prod(rates))
    jr = JJudgeRanker(JJudgeRankerConfig(), model=jjudge.SAMAudioJudgeModel(jcfg, params),
                      processor=JJudgeProcessor(audio_hop_length=hop, audio_sampling_rate=8000,
                                                tokenizer=JByteTokenizer(300)))
    tr = JudgeRanker(JudgeRankerConfig(), device="cpu",
                     model=SAMAudioJudgeModel(tcfg, params_from_numpy(params), device="cpu"),
                     processor=SAMAudioJudgeProcessor(hop, 8000,
                                                      tokenizer=ByteFallbackTokenizer(300)))
    return jr, tr


@pytest.mark.parametrize("rates", [(2, 4), (4, 4)], ids=["on-device", "host"])
def test_judge_reranked_separate_matches_jax(tmp_path, rates):
    """Judge hop 8 (the SAM-Audio hop): frame-aligned candidates are scored on
    the device path with the mixtures; judge hop 16: the 56-sample item is not
    a hop multiple, so both packages take the host path."""
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=JByteTokenizer(cfg.text_encoder.vocab_size))
    jm.save_pretrained(str(tmp_path))
    tm = SAMAudio.from_pretrained(str(tmp_path), device="cpu", allow_random_towers=True,
                                  tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    jr, tr = _judge(rates)
    on_device = rates == (2, 4)
    jm.text_ranker, tm.text_ranker = Spy(jr, on_device), Spy(tr, on_device)
    rng = np.random.RandomState(11)
    audios = [rng.randn(1, 80).astype(np.float32) * 0.2,
              rng.randn(1, 56).astype(np.float32) * 0.2]
    kw = dict(audio_hop_length=8, audio_sampling_rate=8000)
    desc = ["a dog barking", "rain on a roof"]
    anchors = [[("+", 0.0, 0.004)], [("-", 0.001, 0.003)]]
    jb = JaxProcessor(**kw)(descriptions=desc, audios=audios, anchors=anchors)
    tb = SAMAudioProcessor(**kw)(descriptions=desc, audios=audios, anchors=anchors)
    k = 4
    noise = rng.randn(2 * k, jb.anchor_alignment.shape[-1], 8).astype(np.float32)
    ref = jm.separate(jb, noise=noise, reranking_candidates=k)
    out = tm.separate(tb, noise=noise, reranking_candidates=k)
    assert tm.text_ranker.winners == jm.text_ranker.winners
    assert len(tm.text_ranker.winners) == 1
    for i in range(2):
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]), **TOL)
        np.testing.assert_allclose(out.residual[i], np.asarray(ref.residual[i]), **TOL)
