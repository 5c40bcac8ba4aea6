"""Span prediction in the PyTorch port against the JAX package (fp32, CPU, on
inputs made with numpy from a seed): frames_to_spans, the native predictor's
forward, PEAudioFrame's forward and converter, the span_predictor/ snapshot
directory the JAX package writes, and separate(predict_spans=True) with the
same injected noise.

Every comparison of spans also asserts a margin: no valid frame's
probability lies within 1e-3 of the threshold, so that the two stacks'
rounding cannot move a frame across it. The frame heads are scaled up so
that random weights give decisive logits."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.checkpoint import save_params as jax_save_params
from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import span_predictor as jsp
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu.processor import SAMAudioProcessor as JaxProcessor
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JaxByteTokenizer
from sam_audio_tpu.train.span import save_span_predictor as jax_save_span_predictor
from sam_audio_tpu_torch import SAMAudioProcessor
from sam_audio_tpu_torch.checkpoint import load_sam_audio, params_from_numpy, save_span_predictor
from sam_audio_tpu_torch.convert import convert_peaudioframe_state_dict
from sam_audio_tpu_torch.models import span_predictor as sp
from sam_audio_tpu_torch.models.init import center_span_head
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
MARGIN = 1e-3
HEAD_SCALE = 20.0


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_margin(probs, mask, threshold):
    gap = np.abs(np.asarray(probs) - threshold)[np.asarray(mask, bool)]
    assert gap.min() >= MARGIN, f"a frame lies {gap.min():.2e} from the threshold"


def native_cfg(audio_dim=8, text_dim=16, **kw):
    return jsp.SpanPredictorConfig(audio_dim=audio_dim, text_dim=text_dim, hidden=64,
                                   n_layers=2, n_heads=4, **kw)


def native_params(cfg, seed=1):
    """JAX's random init with the head scaled (decisive logits), as numpy."""
    params = to_numpy(jsp.span_predictor_init(jax.random.PRNGKey(seed), cfg))
    params["head"]["weight"] = params["head"]["weight"] * HEAD_SCALE
    return params


def peaf_state_dict(seed, h=32, n_layers=2, audio_dim=4, vocab=300, mlp=64, prefix="transformer."):
    """A PEAudioFrame checkpoint of the reference layout (fairseq-named PE-AV
    tower, token embedding, latent projection, frame head), random."""
    rng = np.random.RandomState(seed)

    def r(*shape, s=0.2):
        return (rng.randn(*shape) * s).astype(np.float32)

    sd = {}
    for i in range(n_layers):
        lp = f"{prefix}layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{lp}.self_attn.{name}.weight"] = r(h, h)
            sd[f"{lp}.self_attn.{name}.bias"] = r(h, s=0.05)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{lp}.{name}.weight"] = 1 + r(h, s=0.1)
            sd[f"{lp}.{name}.bias"] = r(h, s=0.1)
        sd[f"{lp}.fc1.weight"], sd[f"{lp}.fc1.bias"] = r(mlp, h), r(mlp, s=0.05)
        sd[f"{lp}.fc2.weight"], sd[f"{lp}.fc2.bias"] = r(h, mlp), r(h, s=0.05)
    sd[f"{prefix}final_layer_norm.weight"] = 1 + r(h, s=0.1)
    sd[f"{prefix}final_layer_norm.bias"] = r(h, s=0.1)
    sd["text_embed.weight"] = r(vocab, h, s=0.5)
    sd["data_proj.weight"], sd["data_proj.bias"] = r(h, audio_dim), r(h, s=0.05)
    sd["head.weight"], sd["head.bias"] = r(1, h, s=HEAD_SCALE / np.sqrt(h)), r(1, s=0.05)
    return sd


def peaf_cfg(**kw):
    return jsp.PEAudioFrameConfig(audio_dim=4, hidden=32, num_layers=2, num_heads=4,
                                  vocab_size=300, **kw)


def port_cfg(jax_cfg):
    cls = sp.SpanPredictorConfig if isinstance(jax_cfg, jsp.SpanPredictorConfig) \
        else sp.PEAudioFrameConfig
    return cls(**dataclasses.asdict(jax_cfg))


@pytest.mark.parametrize("threshold,min_s,fps", [(0.5, 0.2, 25.0), (0.3, 0.05, 10.0),
                                                 (0.7, 0.0, 1000.0)])
def test_frames_to_spans_equals_jax(threshold, min_s, fps):
    rng = np.random.RandomState(int(threshold * 10))
    probs = rng.rand(4, 60).astype(np.float32)
    probs[1] = (np.sin(np.arange(60) / 4) + 1) / 2   # long runs
    mask = rng.rand(4, 60) > 0.1
    mask[2, 40:] = False
    ours = sp.frames_to_spans(probs, mask, threshold, min_s, fps)
    assert ours == jsp.frames_to_spans(probs, mask, threshold, min_s, fps)
    assert any(ours)


def test_span_predictor_forward_matches_jax():
    cfg = native_cfg()
    params = native_params(cfg)
    rng = np.random.RandomState(2)
    b, t, length = 2, 37, 6
    audio = rng.randn(b, t, cfg.audio_dim).astype(np.float32)
    text = rng.randn(b, length, cfg.text_dim).astype(np.float32)
    amask = np.ones((b, t), bool)
    amask[1, 25:] = False
    tmask = np.ones((b, length), bool)
    tmask[0, 4:] = False
    ref = np.asarray(jsp.span_predictor_forward(params, cfg, jnp.asarray(audio),
                                                jnp.asarray(amask), jnp.asarray(text),
                                                jnp.asarray(tmask)))
    got = sp.span_predictor_forward(params_from_numpy(params), port_cfg(cfg),
                                    torch.from_numpy(audio), torch.from_numpy(amask),
                                    torch.from_numpy(text), torch.from_numpy(tmask))
    assert got.dtype == torch.float32 and got.shape == (b, t)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert np.abs(ref).std() > 1.0   # decisive logits, as the margin checks need


def test_peaudioframe_forward_matches_jax():
    cfg = peaf_cfg()
    params, _, left = jsp.convert_peaudioframe_state_dict(peaf_state_dict(3), cfg)
    assert left == []
    rng = np.random.RandomState(4)
    b, t, length = 2, 21, 5
    audio = rng.randn(b, t, cfg.audio_dim).astype(np.float32)
    ids = rng.randint(3, cfg.vocab_size, (b, length)).astype(np.int32)
    tmask = np.ones((b, length), bool)
    tmask[1, 3:] = False
    amask = np.ones((b, t), bool)
    amask[0, 15:] = False
    ref = np.asarray(jsp.peaudioframe_forward(params, cfg, jnp.asarray(audio),
                                              jnp.asarray(amask), jnp.asarray(ids),
                                              jnp.asarray(tmask)))
    got = sp.peaudioframe_forward(params_from_numpy(to_numpy(params)), port_cfg(cfg),
                                  torch.from_numpy(audio), torch.from_numpy(amask),
                                  torch.from_numpy(ids).long(), torch.from_numpy(tmask))
    assert got.shape == (b, t)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("prefix,wrap", [("transformer.", ""), ("encoder.", "module.")],
                         ids=["transformer", "module-encoder"])
def test_convert_peaudioframe_state_dict_matches_jax(prefix, wrap):
    sd = {wrap + k: v for k, v in peaf_state_dict(5, prefix=prefix).items()}
    sd[wrap + "unexpected.buffer"] = np.zeros(3, np.float32)
    ref, ref_arch, ref_left = jsp.convert_peaudioframe_state_dict(dict(sd), peaf_cfg())
    got, arch, left = convert_peaudioframe_state_dict(dict(sd), peaf_cfg())
    assert arch == ref_arch and left == ref_left == ["unexpected.buffer"]
    flat_ref = jax.tree_util.tree_leaves_with_path(to_numpy(ref))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_got, flat_ref):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize("arch", ["native", "peaudioframe"])
def test_params_from_numpy_carries_span_trees(arch):
    if arch == "native":
        tree = native_params(native_cfg())
    else:
        tree = to_numpy(jsp.convert_peaudioframe_state_dict(peaf_state_dict(6), peaf_cfg())[0])
    got = params_from_numpy(tree)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    assert len(leaves) == len(jax.tree_util.tree_leaves(got))
    for path, want in leaves:
        node = got
        for key in path:
            node = node[key.key]
        assert isinstance(node, torch.Tensor) and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), want, err_msg=str(path))
    assert got["transformer" if arch != "native" else "layers"]


# -- the model: tiny config, both stacks from one snapshot -----------------


def _models(tmp_path, arch):
    """The JAX package writes a snapshot with span_predictor/ (its trainer's
    save_span_predictor for the native arch, the converter's layout for
    PEAudioFrame); both stacks load it."""
    cfg = jax_tiny_config()
    jm = JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg,
                                 tokenizer=JaxByteTokenizer(cfg.text_encoder.vocab_size))
    snap = str(tmp_path / "snap")
    jm.save_pretrained(snap)
    if arch == "native":
        sp_cfg = native_cfg(audio_dim=cfg.audio_codec.codebook_dim, text_dim=cfg.text_encoder.dim,
                            min_duration_s=0.002)
        jax_save_span_predictor(snap, sp_cfg, native_params(sp_cfg))
    else:
        sp_cfg = peaf_cfg(min_duration_s=0.002)
        params, _, _ = jsp.convert_peaudioframe_state_dict(peaf_state_dict(7), sp_cfg)
        os.makedirs(os.path.join(snap, "span_predictor"))
        jax_save_params(os.path.join(snap, "span_predictor", "params.npz"), to_numpy(params))
        with open(os.path.join(snap, "span_predictor", "config.json"), "w") as f:
            json.dump(dataclasses.asdict(sp_cfg), f)
        with open(os.path.join(snap, "config.json")) as f:
            raw = json.load(f)
        raw["span_predictor"] = "pe-a-frame-large"
        with open(os.path.join(snap, "config.json"), "w") as f:
            json.dump(raw, f)
    from sam_audio_tpu.checkpoint import load_sam_audio as jax_load

    jm = jax_load(snap, allow_random_towers=True)
    jm._tokenizer = JaxByteTokenizer(cfg.text_encoder.vocab_size)
    tm = load_sam_audio(snap, device="cpu", allow_random_towers=True,
                        tokenizer=ByteFallbackTokenizer(cfg.text_encoder.vocab_size))
    # the anchor gate is 0 at init, which would make the predicted spans inert
    jm.params["embed_anchors"]["gate"] = jnp.full((1,), 0.5, jnp.float32)
    tm.params["embed_anchors"]["gate"].fill_(0.5)
    return cfg, jm, tm, snap


def _batches(cfg):
    rng = np.random.RandomState(9)
    audios = [(np.sin(np.arange(160) / 5) * 0.3 + 0.1 * rng.randn(160)).astype(np.float32),
              (0.2 * rng.randn(2, 101)).astype(np.float32)]
    desc = ["a dog barking", "rain on a roof"]
    kw = dict(audio_hop_length=cfg.audio_codec.hop_length,
              audio_sampling_rate=cfg.audio_codec.sample_rate)
    return (JaxProcessor(**kw)(descriptions=desc, audios=audios),
            SAMAudioProcessor(**kw)(descriptions=desc, audios=audios))


def _center_head(jm, tm, tb):
    """Centre the port's span head (models.init.center_span_head: random
    weights may put every frame on one side) and give JAX's head the same
    bias. Returns the probabilities after the shift."""
    logits = tm.span_predictor.logits(tm, tb, torch.from_numpy(tb.audios)).numpy()
    mid = center_span_head((tm.span_predictor,), logits, tb.audio_pad_mask)
    jm.span_predictor.params["head"]["bias"] = jnp.asarray(
        tm.span_predictor.params["head"]["bias"].numpy())
    return 1 / (1 + np.exp(-(logits - mid)))


@pytest.mark.parametrize("arch", ["native", "peaudioframe"])
def test_separate_predict_spans_matches_jax(tmp_path, arch):
    cfg, jm, tm, _ = _models(tmp_path, arch)
    want_cls = sp.SpanPredictor if arch == "native" else sp.PEAudioFrameModel
    assert type(tm.span_predictor) is want_cls
    assert type(jm.span_predictor).__name__ == want_cls.__name__
    jb, tb = _batches(cfg)
    # the probabilities behind the spans, and their margin
    assert_margin(_center_head(jm, tm, tb), tb.audio_pad_mask, tm.span_predictor.cfg.threshold)
    noise = np.random.RandomState(10).randn(
        2, tb.anchor_alignment.shape[-1], 2 * cfg.audio_codec.codebook_dim).astype(np.float32)
    ref = jm.separate(jb, noise=noise, predict_spans=True)
    out = tm.separate(tb, noise=noise, predict_spans=True)
    assert tb.anchors == jb.anchors and any(tb.anchors)
    assert all(a[0] == "+" for item in tb.anchors for a in item)
    np.testing.assert_array_equal(tb.anchor_alignment, jb.anchor_alignment)
    for i in range(2):
        np.testing.assert_allclose(out.target[i], np.asarray(ref.target[i]), **TOL)
        np.testing.assert_allclose(out.residual[i], np.asarray(ref.residual[i]), **TOL)
    # the spans condition the result
    _, plain = _batches(cfg)
    assert np.abs(tm.separate(plain, noise=noise).target[0] - out.target[0]).max() > 1e-3
    # a batch with anchors keeps them
    _, tb2 = _batches(cfg)
    tb2.process_anchors([[("+", 0.0, 0.004)], []])
    tm.separate(tb2, noise=noise, predict_spans=True)
    assert tb2.anchors == [[("+", 0.0, 0.004)], []]


def test_predict_spans_needs_a_predictor(tmp_path):
    cfg, _, tm, _ = _models(tmp_path, "native")
    tm.span_predictor = None
    _, tb = _batches(cfg)
    noise = np.zeros((2, tb.anchor_alignment.shape[-1], 8), np.float32)
    tm.allow_random_towers = False
    with pytest.raises(ValueError, match="span predictor"):
        tm.separate(tb, noise=noise, predict_spans=True)
    # with random towers allowed it is skipped, as in JAX
    tm.allow_random_towers = True
    out = tm.separate(tb, noise=noise, predict_spans=True)
    assert tb.anchors is None
    np.testing.assert_array_equal(out.target[0], tm.separate(tb, noise=noise).target[0])
    # past the direct limit it raises, as in JAX
    with pytest.raises(ValueError, match="max_direct_seconds"):
        tm.separate(tb, predict_spans=True, max_direct_seconds=0.001)


def test_save_span_predictor_round_trip(tmp_path):
    """The port's writer gives the layout the JAX loader reads and attaches."""
    cfg, _, tm, snap = _models(tmp_path, "native")
    out = str(tmp_path / "again")
    tm.save_pretrained(out)
    save_span_predictor(out, tm.span_predictor)
    with open(os.path.join(out, "span_predictor", "config.json")) as f:
        assert json.load(f)["arch"] == "sam_audio_tpu_span"
    from sam_audio_tpu.checkpoint import load_sam_audio as jax_load

    jm = jax_load(out, allow_random_towers=True)
    assert type(jm.span_predictor).__name__ == "SpanPredictor"
    back = load_sam_audio(out, device="cpu", allow_random_towers=True)
    for name in ("head", "audio_embed"):
        assert torch.equal(back.span_predictor.params[name]["weight"],
                           tm.span_predictor.params[name]["weight"])


def test_convert_command_line_span_predictor(tmp_path):
    from sam_audio_tpu_torch.convert import main

    sd = peaf_state_dict(11)
    ckpt = str(tmp_path / "peaf.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    out = str(tmp_path / "span_predictor")
    main(["span-predictor", "--torch", ckpt, "--out", out])
    ref, arch, _ = jsp.convert_peaudioframe_state_dict(sd, jsp.PEAudioFrameConfig())
    with open(os.path.join(out, "config.json")) as f:
        written = json.load(f)
    assert written == dataclasses.asdict(dataclasses.replace(
        jsp.PEAudioFrameConfig(), **{k: v for k, v in arch.items() if k in written}))
    with np.load(os.path.join(out, "params.npz")) as z:
        assert np.array_equal(z["head/weight"], sd["head.weight"])
        assert np.array_equal(z["transformer/layers/attn/wq/weight"][1],
                              sd["transformer.layers.1.self_attn.q_proj.weight"])
