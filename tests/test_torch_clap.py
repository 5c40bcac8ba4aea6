"""The port's CLAP scorer against the JAX package's (fp32, CPU): the mel
frontend, HTSAT, RoBERTa, the CLAP audio and text embeddings, the RoBERTa BPE
tokenizer, and the ranker's two scoring paths. Parameters come from the JAX
`*_init` functions, bridged by checkpoint.params_from_numpy (the CLAP tree
holds lists of stages and blocks).

Tolerance 1e-4 (PARITY.md's bound for converted weights): the same math,
summed in another order; the STFT goes through another FFT."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.checkpoint import save_params
from sam_audio_tpu.config import ClapRankerConfig as JaxClapRankerConfig
from sam_audio_tpu.models import clap as jclap
from sam_audio_tpu.models import htsat as jhtsat
from sam_audio_tpu.models import roberta as jroberta
from sam_audio_tpu.ops import mel as jmel
from sam_audio_tpu.ranking.clap import ClapRanker as JaxClapRanker
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu.text_tokenizer import RobertaBPETokenizer as JaxBPE
from sam_audio_tpu_torch.checkpoint import load_params, params_from_numpy
from sam_audio_tpu_torch.config import ClapRankerConfig
from sam_audio_tpu_torch.models import clap as tclap
from sam_audio_tpu_torch.models import htsat as thtsat
from sam_audio_tpu_torch.models import roberta as troberta
from sam_audio_tpu_torch.models.init import clap_init
from sam_audio_tpu_torch.ops import mel as tmel
from sam_audio_tpu_torch.ranking.clap import ClapRanker
from sam_audio_tpu_torch.text_tokenizer import (
    ByteFallbackTokenizer,
    RobertaBPETokenizer,
    get_roberta_tokenizer,
)

TOL = dict(rtol=1e-4, atol=1e-4)
# a small CLAP of the kind tests/test_clap_exact.py uses: 1 s at 8 kHz
KW = dict(sample_rate=8000, duration_s=1.0, n_fft=512, hop_length=400, n_mels=16,
          fmin=50.0, fmax=3500.0, spec_size=64, patch_size=4, audio_embed_dim=16,
          depths=(2, 2), audio_heads=(2, 4), window_size=4, text_vocab=300,
          text_hidden=32, text_layers=2, text_heads=4, text_intermediate=48,
          max_text_len=12, embed_dim=8)
JCFG, TCFG = jclap.ClapConfig(**KW), tclap.ClapConfig(**KW)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    p = _np(jclap.clap_init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.RandomState(0)   # non-trivial BatchNorm statistics
    bn = p["audio_branch"]["bn0"]
    bn["mean"] = rng.uniform(-2, 2, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 2, bn["var"].shape).astype(np.float32)
    return p


def _wav(b, n, seed):
    return (0.4 * np.random.RandomState(seed).randn(b, n)).astype(np.float32).clip(-1, 1)


def test_mel_frontend_matches():
    assert dataclasses.asdict(JCFG) == dataclasses.asdict(TCFG)
    x = _wav(2, 3000, 1)
    np.testing.assert_allclose(
        tmel.mel_filterbank(8000, 512, 16, 50.0, 3500.0, "slaney", "slaney"),
        jmel.mel_filterbank(8000, 512, 16, 50.0, 3500.0, "slaney", "slaney"), rtol=1e-6)
    np.testing.assert_allclose(tmel.stft_power(torch.tensor(x), 512, 400).numpy(),
                               np.asarray(jmel.stft_power(jnp.asarray(x), 512, 400)),
                               rtol=1e-4, atol=1e-3)
    kw = dict(sample_rate=8000, n_fft=256, hop_length=128, n_mels=16, top_db=80.0)
    np.testing.assert_allclose(tmel.log_mel_spectrogram(torch.tensor(x), **kw).numpy(),
                               np.asarray(jmel.log_mel_spectrogram(jnp.asarray(x), **kw)),
                               **TOL)


def test_htsat_and_bicubic_match(jax_params):
    x = np.random.RandomState(2).randn(2, 21, 16).astype(np.float32)
    np.testing.assert_allclose(thtsat.bicubic_resize_1d(torch.tensor(x), 256, 1).numpy(),
                               np.asarray(jhtsat.bicubic_resize_1d(jnp.asarray(x), 256, 1)),
                               rtol=1e-5, atol=1e-5)
    wav = _wav(2, 8000, 3)
    ref = jhtsat.htsat_embed(jax_params["audio_branch"], JCFG.htsat, jnp.asarray(wav))
    out = thtsat.htsat_embed(params_from_numpy(jax_params["audio_branch"]), TCFG.htsat,
                             torch.tensor(wav))
    assert out.shape == (2, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_roberta_matches(jax_params):
    rng = np.random.RandomState(4)
    ids = rng.randint(4, 300, (2, 9)).astype(np.int64)
    mask = np.ones((2, 9), bool)
    ids[1, 6:], mask[1, 6:] = 1, False
    ref_h, ref_p = jroberta.roberta_encode(jax_params["text_branch"], jnp.asarray(ids),
                                           jnp.asarray(mask), JCFG.roberta)
    h, pooled = troberta.roberta_encode(params_from_numpy(jax_params["text_branch"]),
                                        torch.tensor(ids), torch.tensor(mask), TCFG.roberta)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(ref_p), **TOL)


@pytest.mark.parametrize("n", [8000, 3000, 11000], ids=["fits", "repeat-pad", "centre-crop"])
def test_clap_embeddings_match(jax_params, n):
    tp = params_from_numpy(jax_params)
    wav = _wav(3, n, n)
    wav[0, :50] = 1.5   # clipped by the int16 round trip
    np.testing.assert_allclose(
        tclap.clap_audio_embed(tp, TCFG, torch.tensor(wav)).numpy(),
        np.asarray(jclap.clap_audio_embed(jax_params, JCFG, jnp.asarray(wav))), **TOL)
    ids, mask = JaxByteTokenizer(300)(["a dog barking", "rain"], max_length=12)
    np.testing.assert_allclose(
        tclap.clap_text_embed(tp, TCFG, torch.tensor(ids), torch.tensor(mask)).numpy(),
        np.asarray(jclap.clap_text_embed(jax_params, JCFG, jnp.asarray(ids),
                                         jnp.asarray(mask))), **TOL)
    np.testing.assert_array_equal(
        tclap.quantize_roundtrip(torch.tensor(wav)).numpy(),
        np.asarray(jclap.quantize_roundtrip(jnp.asarray(wav))))
    rng_a, rng_b = np.random.RandomState(5), np.random.RandomState(5)
    np.testing.assert_array_equal(
        tclap.fit_duration_np(wav[1], 8000, rand_trunc=True, rng=rng_a),
        jclap.fit_duration_np(wav[1], 8000, rand_trunc=True, rng=rng_b))


def test_ranker_paths_match_jax(jax_params, tmp_path):
    jr = JaxClapRanker(JaxClapRankerConfig(), seed=3, model=jclap.ClapModel(
        JCFG, jax_params, tokenizer=JaxByteTokenizer(300)))
    path = str(tmp_path / "clap.npz")
    save_params(path, jax_params)   # the flat npz a converted checkpoint is
    tr = ClapRanker(ClapRankerConfig(checkpoint=path), seed=3, device="cpu",
                    model=tclap.ClapModel(TCFG, load_params(path),
                                          tokenizer=ByteFallbackTokenizer(300)))
    rng = np.random.RandomState(6)
    sizes = [8000, 3000]                       # one full window, one repeat-padded
    targets = (0.3 * rng.randn(2, 4, 8000)).astype(np.float32)
    desc = ["a dog barking", "rain on a roof"]
    assert tr.supports_on_device(sizes, 8000) and not tr.supports_on_device([9000], 8000)
    ref = np.asarray(jr.score_on_device(jnp.asarray(targets), sizes, desc))
    dev = tr.score_on_device(torch.tensor(targets), sizes, desc).numpy()
    cands = [targets[i, :, :sizes[i]] for i in range(2)]
    host = tr(extracted_audio=cands, descriptions=desc, sample_rate=8000)
    np.testing.assert_allclose(dev, ref, **TOL)
    np.testing.assert_allclose(host, dev, **TOL)
    np.testing.assert_allclose(host, jr(extracted_audio=cands, descriptions=desc,
                                        sample_rate=8000), **TOL)
    np.testing.assert_array_equal(np.argmax(dev, 1), np.argmax(ref, 1))
    # at another sample rate the host path resamples; long clips take a seeded crop
    long_c = [(0.3 * rng.randn(3, 19000)).astype(np.float32)]
    np.testing.assert_allclose(
        tr(extracted_audio=long_c, descriptions=["x"], sample_rate=16000),
        jr(extracted_audio=long_c, descriptions=["x"], sample_rate=16000), **TOL)


def test_random_clap_tree_matches_the_jax_tree():
    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in shapes(v, f"{prefix}{k}/").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in shapes(v, f"{prefix}{i}/").items()}
        return {prefix[:-1]: tuple(tree.shape)}

    ours = clap_init(TCFG, torch.Generator().manual_seed(0), "cpu")
    assert shapes(ours) == shapes(_np(jclap.clap_init(jax.random.PRNGKey(0), JCFG)))
    emb = tclap.ClapModel(TCFG, ours, tokenizer=ByteFallbackTokenizer(300))
    assert torch.isfinite(emb.get_text_embedding(["x", "yz"])).all()


def test_roberta_tokenizer_matches_jax(tmp_path, monkeypatch):
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in "".join(chr(c) for c in range(ord("!"), ord("~") + 1)):
        vocab.setdefault(ch, len(vocab))
    for tok in ["Ġ", "he", "ll", "hell", "hello", "Ġw", "or", "orld", "world", "Ġworld"]:
        vocab.setdefault(tok, len(vocab))
    merges = ["h e", "l l", "he ll", "hell o", "Ġ w", "o r", "or ld", "w orld", "Ġw orld"]
    (tmp_path / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n",
                                         encoding="utf-8")
    monkeypatch.setenv("SAM_AUDIO_ROBERTA_TOKENIZER", str(tmp_path))
    ours = get_roberta_tokenizer()
    assert isinstance(ours, RobertaBPETokenizer)
    ref = JaxBPE.from_dir(str(tmp_path))
    for text in ["hello world", "world hello hello", "hexllo wyyorld !"]:
        for a, b in zip(ours([text], max_length=12), ref([text], max_length=12)):
            np.testing.assert_array_equal(a, b)
    # without the files (and without a cached HF tokenizer) the fallback is gated
    monkeypatch.setenv("SAM_AUDIO_ROBERTA_TOKENIZER", str(tmp_path / "missing"))
    with pytest.raises(RuntimeError, match="RoBERTa"):
        get_roberta_tokenizer()
    assert isinstance(get_roberta_tokenizer(allow_fallback=True), ByteFallbackTokenizer)


def test_quantized_clap_matches_jax(jax_params):
    """ClapModel.quantize(): the same int8 tree as the JAX package's
    quantize_clap_params, and the same W8A8 embeddings."""
    from sam_audio_tpu.ops.quant import quantize_clap_params as jax_quantize
    from sam_audio_tpu_torch.ops.quant import quantize_clap_params

    ref = _np(jax_quantize(jax_params))
    ours = quantize_clap_params(params_from_numpy(jax_params))
    blk = ours["audio_branch"]["stages"][1]["blocks"][0]
    jblk = ref["audio_branch"]["stages"][1]["blocks"][0]
    for name in ("qkv", "proj", "fc1", "fc2"):
        np.testing.assert_array_equal(blk[name]["w8"].numpy(), jblk[name]["w8"])
    np.testing.assert_array_equal(ours["text_branch"]["layers"]["attn"]["wq"]["w8"].numpy(),
                                  ref["text_branch"]["layers"]["attn"]["wq"]["w8"])
    wav = _wav(2, 8000, 7)
    np.testing.assert_allclose(
        tclap.clap_audio_embed(ours, TCFG, torch.tensor(wav)).numpy(),
        np.asarray(jclap.clap_audio_embed(ref, JCFG, jnp.asarray(wav))), **TOL)
    ids, mask = JaxByteTokenizer(300)(["a dog barking", "rain"], max_length=12)
    np.testing.assert_allclose(
        tclap.clap_text_embed(ours, TCFG, torch.tensor(ids), torch.tensor(mask)).numpy(),
        np.asarray(jclap.clap_text_embed(ref, JCFG, jnp.asarray(ids), jnp.asarray(mask))),
        **TOL)
    model = tclap.ClapModel(TCFG, params_from_numpy(jax_params),
                            tokenizer=ByteFallbackTokenizer(300)).quantize()
    assert "w8" in model.params["text_branch"]["layers"]["fc1"]
