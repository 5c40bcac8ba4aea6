"""WavLM and the aesthetics predictors of the PyTorch port against the JAX
package (fp32, CPU, narrow widths, one parameter tree bridged by
checkpoint.params_from_numpy): the bucketed position bias, wavlm_encode in
both layouts with and without a padding mask, the WavLM and
audiobox-aesthetics converters on a checkpoint built here, AudioboxAesthetics
and AesPredictor scores on clips of 3 s and 23 s, and the converter's
snapshot loaded by the Aesthetic metric."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.eval import metrics as jmetrics
from sam_audio_tpu.models import aesthetics as jaes
from sam_audio_tpu.models import wavlm as jwavlm
from sam_audio_tpu_torch import convert
from sam_audio_tpu_torch.checkpoint import flatten, params_from_numpy
from sam_audio_tpu_torch.eval.metrics import Aesthetic
from sam_audio_tpu_torch.models import aesthetics as taes
from sam_audio_tpu_torch.models import wavlm as twavlm

TOL = dict(rtol=1e-4, atol=1e-4)
NARROW = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=96,
              conv_dim=(32,) * 7, num_buckets=40,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
LAYOUTS = {"group": dict(feat_extract_norm="group", do_stable_layer_norm=False),
           "layer": dict(feat_extract_norm="layer", do_stable_layer_norm=True)}
AXES = ("CE", "CU", "PC", "PQ")


def wavlm_cfgs(layout="group"):
    j = jwavlm.WavLMConfig(**NARROW, **LAYOUTS[layout])
    return j, twavlm.WavLMConfig(**dataclasses.asdict(j))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_relative_position_buckets_are_jax_s():
    for q, k, nb, md in ((1, 1, 320, 800), (17, 17, 40, 100), (499, 499, 320, 800),
                         (30, 45, 64, 50)):
        got = twavlm._relative_position_buckets(q, k, nb, md)
        ref = jwavlm._relative_position_buckets(q, k, nb, md)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("layout", ["group", "layer"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_wavlm_encode_matches_jax(layout, masked):
    jcfg, tcfg = wavlm_cfgs(layout)
    params = np_tree(jwavlm.wavlm_init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.RandomState(0)
    wav = (rng.randn(3, 4000) * 0.1).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 4000), bool)
        mask[1, 2600:] = False
        mask[2, 1000:] = False
    ref = jwavlm.wavlm_encode(params, jcfg, jnp.asarray(wav),
                              None if mask is None else jnp.asarray(mask),
                              output_hidden_states=True)
    got = twavlm.wavlm_encode(params_from_numpy(params), tcfg, torch.as_tensor(wav),
                              None if mask is None else torch.as_tensor(mask),
                              output_hidden_states=True)
    assert len(got) == len(ref) == jcfg.num_layers + 1
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    last = twavlm.wavlm_encode(params_from_numpy(params), tcfg, torch.as_tensor(wav),
                               None if mask is None else torch.as_tensor(mask))
    assert torch.equal(last, got[-1])


# -- converters ---------------------------------------------------------------


def _unfold(w, rng):
    """weight_g / weight_v (dim=2) whose fold is close to `w`."""
    v = (w * rng.uniform(0.5, 2.0, (1, 1, w.shape[2]))).astype(np.float32)
    g = np.sqrt(np.sum(np.square(w.astype(np.float64)), axis=(0, 1), keepdims=True))
    return g.astype(np.float32), v


def hf_state_dict(params, cfg, rng, parametrized=False):
    """The HF WavLMModel state dict of a models/wavlm.py tree."""
    sd = {}
    for i, conv in enumerate(params["feature_extractor"]):
        base = f"feature_extractor.conv_layers.{i}"
        sd[f"{base}.conv.weight"] = conv["weight"]
        if "bias" in conv:
            sd[f"{base}.conv.bias"] = conv["bias"]
        for name in ("group_norm", "layer_norm"):
            if name in conv:
                sd[f"{base}.layer_norm.weight"] = conv[name]["weight"]
                sd[f"{base}.layer_norm.bias"] = conv[name]["bias"]
    for n in ("layer_norm", "projection"):
        for leaf, v in params["feature_projection"][n].items():
            sd[f"feature_projection.{n}.{leaf}"] = v
    g, v = _unfold(params["pos_conv"]["weight"], rng)
    pc = "encoder.pos_conv_embed.conv"
    if parametrized:
        sd[f"{pc}.parametrizations.weight.original0"] = g
        sd[f"{pc}.parametrizations.weight.original1"] = v
    else:
        sd[f"{pc}.weight_g"], sd[f"{pc}.weight_v"] = g, v
    sd[f"{pc}.bias"] = params["pos_conv"]["bias"]
    for leaf, val in params["encoder_layer_norm"].items():
        sd[f"encoder.layer_norm.{leaf}"] = val
    for i, layer in enumerate(params["layers"]):
        base = f"encoder.layers.{i}"
        att = layer["attention"]
        for n in ("q_proj", "k_proj", "v_proj", "out_proj", "gru_rel_pos_linear"):
            for leaf, val in att[n].items():
                sd[f"{base}.attention.{n}.{leaf}"] = val
        sd[f"{base}.attention.gru_rel_pos_const"] = att["gru_rel_pos_const"]
        if "rel_attn_embed" in att:
            sd[f"{base}.attention.rel_attn_embed.weight"] = att["rel_attn_embed"]
        for n, hf in (("layer_norm", "layer_norm"), ("final_layer_norm", "final_layer_norm"),
                      ("intermediate_dense", "feed_forward.intermediate_dense"),
                      ("output_dense", "feed_forward.output_dense")):
            for leaf, val in layer[n].items():
                sd[f"{base}.{hf}.{leaf}"] = val
    sd["masked_spec_embed"] = np.zeros(cfg.hidden_size, np.float32)
    return {k: np.asarray(v) for k, v in sd.items()}


FAIRSEQ = ((".attention.gru_rel_pos_linear", ".self_attn.grep_linear"),
           (".attention.gru_rel_pos_const", ".self_attn.grep_a"),
           (".attention.rel_attn_embed", ".self_attn.relative_attention_bias"),
           (".attention.", ".self_attn."),
           (".feed_forward.intermediate_dense", ".fc1"),
           (".feed_forward.output_dense", ".fc2"))


def fairseq_names(hf):
    """The original-WavLM spelling of an HF state dict (the layout that the
    audiobox-aesthetics checkpoint vendors)."""
    import re

    out = {}
    for k, v in hf.items():
        if k == "masked_spec_embed":
            continue
        nk = re.sub(r"conv_layers\.(\d+)\.conv\.", r"conv_layers.\1.0.", k)
        nk = re.sub(r"conv_layers\.(\d+)\.layer_norm\.", r"conv_layers.\1.2.", nk)
        nk = nk.replace("feature_projection.projection.", "post_extract_proj.")
        nk = nk.replace("feature_projection.layer_norm.", "layer_norm.")
        nk = nk.replace("encoder.pos_conv_embed.conv.", "encoder.pos_conv.0.")
        if ".layers." in nk:
            nk = re.sub(r"(layers\.\d+)\.layer_norm\.", r"\1.self_attn_layer_norm.", nk)
        for a, b in FAIRSEQ:
            nk = nk.replace(a, b)
        out[nk] = v
    return out


def assert_same_leaves(ours, ref, folded=("pos_conv/weight",)):
    a, b = flatten(ours), {k: np.asarray(v) for k, v in flatten(np_tree(ref)).items()}
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if any(k.endswith(f) for f in folded):
            # the fold sums ||v||^2 in float64 (convert.fold_weight_norm)
            np.testing.assert_allclose(a[k], b[k], rtol=4e-7, atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("layout,parametrized", [("group", False), ("layer", True)])
def test_wavlm_converters_match_jax(layout, parametrized):
    jcfg, tcfg = wavlm_cfgs(layout)
    params = np_tree(jwavlm.wavlm_init(jax.random.PRNGKey(2), jcfg))
    hf = hf_state_dict(params, jcfg, np.random.RandomState(3), parametrized)
    hf["encoder.unknown.weight"] = np.zeros(2, np.float32)
    got, got_left = convert.convert_wavlm_state_dict(hf, tcfg)
    ref, ref_left = jwavlm.convert_wavlm_state_dict(hf, jcfg)
    assert got_left == ref_left == ["encoder.unknown.weight"]
    assert_same_leaves(got, ref)
    fs = fairseq_names(hf)
    assert convert.fairseq_wavlm_to_hf_keys(fs).keys() == jwavlm.fairseq_wavlm_to_hf_keys(fs).keys()
    renamed, _ = convert.convert_wavlm_state_dict(convert.fairseq_wavlm_to_hf_keys(fs), tcfg)
    assert_same_leaves(renamed, ref)


def aes_checkpoint(path, layout="group", extra=None):
    """A self-built audiobox-aesthetics checkpoint: a fairseq-named WavLM
    tower under `model.encoder.`, per-axis heads (CE with three linears named
    0, 2 and 10, to need the numeric sort), a target_transform."""
    jcfg, _ = wavlm_cfgs(layout)
    params = np_tree(jwavlm.wavlm_init(jax.random.PRNGKey(4), jcfg))
    rng = np.random.RandomState(5)
    fs = fairseq_names(hf_state_dict(params, jcfg, rng))
    sd = {f"model.encoder.{k}": torch.from_numpy(v.copy()) for k, v in fs.items()}
    h = jcfg.hidden_size
    for ax in AXES:
        names = ("0", "2", "10") if ax == "CE" else ("0", "2")
        for i, n in enumerate(names):
            out = 1 if i == len(names) - 1 else h
            sd[f"model.proj_{ax}.{n}.weight"] = torch.from_numpy(
                (rng.randn(out, h) * 0.2).astype(np.float32))
            sd[f"model.proj_{ax}.{n}.bias"] = torch.from_numpy(
                (rng.randn(out) * 0.1).astype(np.float32))
    sd.update(extra or {})
    torch.save({"state_dict": sd,
                "target_transform": {ax: {"mean": 5.0 + i, "std": 1.5} for i, ax in
                                     enumerate(AXES)}}, path)
    return jcfg


@pytest.mark.parametrize("layout", ["group", "layer"])
def test_convert_aes_checkpoint_matches_jax(tmp_path, layout):
    path = str(tmp_path / "aes.pt")
    jcfg = aes_checkpoint(path, layout, extra={"model.stray.weight": torch.zeros(2)})
    # the configs start at the other layout: the converter switches to the checkpoint's
    start = "layer" if layout == "group" else "group"
    jstart, tstart = wavlm_cfgs(start)
    ref, ref_left, ref_cfg = jaes.convert_aes_checkpoint(
        path, jaes.AudioboxAestheticsConfig(wavlm=jstart))
    got, got_left, got_cfg = convert.convert_aes_checkpoint(
        path, taes.AudioboxAestheticsConfig(wavlm=tstart))
    assert got_left == ref_left == ["model.stray.weight"]
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(ref_cfg)
    assert got_cfg.wavlm.feat_extract_norm == layout
    assert len(got["heads"]["CE"]) == 3 and got["heads"]["CE"][2]["weight"].shape[0] == 1
    assert got["target_transform"] == ref["target_transform"]
    tt = got.pop("target_transform")
    ref = dict(ref)
    ref.pop("target_transform")
    assert_same_leaves(got, ref)
    assert tt["PQ"] == {"mean": 8.0, "std": 1.5}


# -- the predictors -----------------------------------------------------------


def clips(sr=48_000):
    """3 s stereo and 23 s mono (three 10 s chunks at 16 kHz: 10, 10, 3)."""
    rng = np.random.RandomState(6)
    return [(rng.randn(2, 3 * sr) * 0.1).astype(np.float32),
            (np.sin(np.arange(23 * sr) / 37.0) * 0.2 + rng.randn(23 * sr) * 0.05
             ).astype(np.float32)]


def test_audiobox_aesthetics_matches_jax():
    jcfg, tcfg = wavlm_cfgs("group")
    jm = jaes.AudioboxAesthetics.init_random(jax.random.PRNGKey(7),
                                             jaes.AudioboxAestheticsConfig(wavlm=jcfg))
    jm.params["target_transform"] = {ax: {"mean": 5.0, "std": 2.0} for ax in AXES[:3]}
    tm = taes.AudioboxAesthetics(taes.AudioboxAestheticsConfig(wavlm=tcfg),
                                 params_from_numpy(np_tree(jm.params)))
    wavs = clips()
    ref, got = jm(wavs, 48_000), tm(wavs, 48_000)
    for r, g in zip(ref, got):
        assert list(g) == list(AXES)
        np.testing.assert_allclose([g[a] for a in AXES], [r[a] for a in AXES], **TOL)
    # each chunk alone: the 23 s clip is the length-weighted mean of its chunks
    per_chunk = tm([wavs[1][i * 480_000:(i + 1) * 480_000] for i in range(3)], 48_000)
    w = np.asarray([10.0, 10.0, 3.0])
    for a in AXES:
        np.testing.assert_allclose(got[1][a], np.average([c[a] for c in per_chunk], weights=w),
                                   rtol=1e-5, atol=1e-5)


def test_aes_predictor_matches_jax():
    jcfg = jaes.AestheticsConfig(hidden=32, layers=2, heads=2)
    tcfg = taes.AestheticsConfig(**dataclasses.asdict(jcfg))
    jm = jaes.AesPredictor.init_random(jax.random.PRNGKey(8), jcfg)
    tm = taes.AesPredictor(tcfg, params_from_numpy(np_tree(jm.params)))
    ref, got = jm(clips(), 48_000), tm(clips(), 48_000)
    for r, g in zip(ref, got):
        np.testing.assert_allclose([g[a] for a in AXES], [r[a] for a in AXES], **TOL)


def test_converter_snapshot_loads_in_the_aesthetic_metric(tmp_path, monkeypatch):
    """`convert aesthetics` -> Aesthetic(checkpoint=dir) scores what
    from_torch_checkpoint's model scores; the JAX metric cannot load the same
    directory (it sends it to AesPredictor's np.load)."""
    path = str(tmp_path / "aes.pt")
    jcfg = aes_checkpoint(path)
    # the converter takes the default config's widths, as JAX's does: narrow
    # the default (WavLM-base) to the checkpoint's
    narrow = wavlm_cfgs("group")[1]
    monkeypatch.setattr(taes.AudioboxAestheticsConfig, "__post_init__", lambda self: (
        object.__setattr__(self, "wavlm", self.wavlm or narrow)))
    out = str(tmp_path / "aes_dir")
    convert.main(["aesthetics", "--torch", path, "--out", out])
    with open(f"{out}/config.json") as f:
        assert json.load(f)["wavlm"]["hidden_size"] == jcfg.hidden_size
    direct = taes.AudioboxAesthetics.from_torch_checkpoint(path, device="cpu")
    assert direct.cfg.wavlm == wavlm_cfgs("group")[1]
    metric = Aesthetic(checkpoint=out, device="cpu")
    assert isinstance(metric.model, taes.AudioboxAesthetics)
    assert metric.model.cfg == direct.cfg
    wavs = [clips()[0], clips()[1][:48_000 * 4]]
    ref = direct(wavs, 48_000)
    got = metric(target_wavs=wavs, target_wavs_sample_rate=48_000)
    for i, row in enumerate(ref):
        for short, long_name in jmetrics.COLUMN_MAP.items():
            assert got[long_name][i] == row[short]
    # the same weights in JAX score the same
    jref = jaes.AudioboxAesthetics.from_torch_checkpoint(
        path, jaes.AudioboxAestheticsConfig(wavlm=jcfg))(wavs, 48_000)
    for r, g in zip(jref, ref):
        np.testing.assert_allclose([g[a] for a in AXES], [r[a] for a in AXES], **TOL)
    with pytest.raises((IsADirectoryError, KeyError, ValueError, OSError)):
        jmetrics.Aesthetic(checkpoint=out)(target_wavs=wavs, target_wavs_sample_rate=48_000)


def test_audiobox_aesthetics_drops_a_tail_too_short_for_a_frame():
    """A clip 300 samples past 10 s at 16 kHz: the tail makes no WavLM frame.
    JAX scores it NaN (its attention row is fully masked); the port leaves
    the tail out, which gives the first chunk's scores."""
    jcfg, tcfg = wavlm_cfgs("group")
    jm = jaes.AudioboxAesthetics.init_random(jax.random.PRNGKey(9),
                                             jaes.AudioboxAestheticsConfig(wavlm=jcfg))
    tm = taes.AudioboxAesthetics(taes.AudioboxAestheticsConfig(wavlm=tcfg),
                                 params_from_numpy(np_tree(jm.params)))
    wav = (np.random.RandomState(10).randn(160_300) * 0.1).astype(np.float32)
    assert all(np.isnan(v) for v in jm([wav], 16_000)[0].values())
    got, head = tm([wav], 16_000)[0], tm([wav[:160_000]], 16_000)[0]
    assert got == head and all(np.isfinite(v) for v in got.values())
    ref = jm([wav[:160_000]], 16_000)[0]
    np.testing.assert_allclose([got[a] for a in AXES], [ref[a] for a in AXES], **TOL)
