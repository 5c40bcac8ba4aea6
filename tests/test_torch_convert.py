"""The port's reference-checkpoint converters (sam_audio_tpu_torch/convert.py)
against the JAX package's, on reference-shaped state dicts built here from
the torch oracles of the JAX package's tests (no download, no reference
checkout): the same keys, dtypes and values. Then the npz the port writes in
JAX's `load_params`, `load_sam_audio` on a `checkpoint.pt`, strict key
coverage, `save_pretrained` -> `load_sam_audio` bit-identity (also after
quantize(8)) and the command line."""

import json

import jax
import numpy as np
import pytest
import torch

import test_pe_clip_converter as pe_case
import test_sam_audio_torch_parity as sam_case
from test_peav_converter import _fairseq_tower_sd
from torch_dacvae_oracle import DACVAEOracle
from torch_htsat_oracle import HTSATOracle, default_tiny_melw
from torch_imagebind_oracle import tiny_imagebind

from sam_audio_tpu import checkpoint as jckpt
from sam_audio_tpu.config import DACVAEConfig as JDACVAEConfig
from sam_audio_tpu.config import ModernBertTextConfig as JModernBertTextConfig
from sam_audio_tpu.config import PEAVTransformerConfig as JPEAVTransformerConfig
from sam_audio_tpu.config import SAMAudioJudgeConfig as JSAMAudioJudgeConfig
from sam_audio_tpu.config import T5EncoderConfig as JT5EncoderConfig
from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import clap as jclap
from sam_audio_tpu.models import imagebind as jib
from sam_audio_tpu.models import pe_clip as jpe
from sam_audio_tpu.models.sam_audio import SAMAudio as JaxSAMAudio
from sam_audio_tpu_torch import SAMAudio, SAMAudioProcessor, convert
from sam_audio_tpu_torch.checkpoint import flatten, load_sam_audio, params_from_numpy, save_params
from sam_audio_tpu_torch.config import (
    PerceptionEncoderConfig,
    SAMAudioConfig,
    SAMAudioJudgeConfig,
    T5EncoderConfig,
)
from sam_audio_tpu_torch.models.clap import ClapConfig
from sam_audio_tpu_torch.models.imagebind import ImageBindHugeConfig
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_pytree(tree).items()}


def assert_same_tree(ours, ref, folded_under=()):
    """Equal keys, dtypes and values. A weight-norm-folded leaf (a path under
    one of `folded_under`) may differ from XLA's float32 fold by a few ulps:
    the port sums ||v||^2 in float64 (convert.fold_weight_norm)."""
    a, b = _flat(ours), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        if not np.array_equal(a[k], b[k]):
            assert any(k.startswith(p) for p in folded_under), k
            np.testing.assert_array_max_ulp(a[k], b[k], maxulp=4)


def _sam_sd():
    oracle = sam_case.SAMAudioOracle().eval()
    return {k: v.detach().numpy() for k, v in oracle.state_dict().items()}


def _port_cfg(jcfg):
    import dataclasses

    return SAMAudioConfig.from_dict(dataclasses.asdict(jcfg))


def test_sam_audio_converter_matches_jax():
    sd = _sam_sd()
    assert any(k.endswith("weight_v") or "parametrizations" in k for k in sd)
    ours = convert.convert_sam_audio_state_dict(sd, _port_cfg(sam_case.CFG))
    assert_same_tree(ours, jckpt.convert_sam_audio_state_dict(sd, sam_case.CFG),
                     folded_under=("audio_codec/",))
    # the folded weights are the weight-norm product to float32 precision
    key = next(k for k in sd if k.endswith("weight_v") or k.endswith("original1"))
    g_key = key.replace("weight_v", "weight_g").replace("original1", "original0")
    v, g = sd[key].astype(np.float64), sd[g_key].astype(np.float64)
    exact = g * v / np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    np.testing.assert_allclose(convert.fold_weight_norm(sd[g_key], sd[key]), exact, rtol=1e-6)


def _judge_sd(rng):
    codec = DACVAEOracle(4, [2, 4], 16, 16, [4, 2], 4).eval()
    sd = {f"audio_codec.{k}": v.detach().numpy() for k, v in codec.state_dict().items()
          if not (k.startswith("decoder") or "out_proj" in k)}
    h, mlp = 16, 24

    def r(*shape):
        return (rng.randn(*shape) * 0.2).astype(np.float32)

    sd["text_model.embeddings.tok_embeddings.weight"] = r(300, h)
    sd["text_model.embeddings.norm.weight"] = r(h)
    for i in range(3):
        p = f"text_model.layers.{i}"
        sd[f"{p}.attn.Wqkv.weight"] = r(3 * h, h)
        sd[f"{p}.attn.Wo.weight"] = r(h, h)
        sd[f"{p}.mlp.Wi.weight"] = r(2 * mlp, h)
        sd[f"{p}.mlp.Wo.weight"] = r(h, mlp)
        sd[f"{p}.mlp_norm.weight"] = r(h)
        if i:
            sd[f"{p}.attn_norm.weight"] = r(h)
    sd["text_model.final_norm.weight"] = r(h)
    sd.update(_fairseq_tower_sd("transformer.", rng, 16, 2, 32))
    sd.update(_fairseq_tower_sd("finetune_transformer.", rng, 12, 1, 24))
    for name, din, dout, bias in (("data_proj", 4, 16, True), ("cat_audio_proj", 32, 8, True),
                                  ("text_proj1", 16, 16, False), ("text_proj2", 16, 8, True),
                                  ("proj_audio_and_text", 16, 8, True),
                                  ("finetune_data_proj", 8, 12, True), ("head", 12, 4, False)):
        sd[f"{name}.weight"] = r(dout, din)
        if bias:
            sd[f"{name}.bias"] = r(dout)
    sd["layer_norm.weight"], sd["layer_norm.bias"] = r(8), r(8)
    sd["mean"], sd["std"] = np.arange(4, dtype=np.float64), np.full(4, 2.0, np.float32)
    return sd


def test_judge_and_t5_converters_match_jax():
    import dataclasses

    torch.manual_seed(7)
    rng = np.random.RandomState(8)
    sd = _judge_sd(rng)
    jcfg = JSAMAudioJudgeConfig(
        audio_codec=JDACVAEConfig(encoder_dim=4, encoder_rates=(2, 4), latent_dim=16,
                                  decoder_dim=16, decoder_rates=(4, 2), codebook_dim=4,
                                  sample_rate=8000),
        transformer=JPEAVTransformerConfig(hidden_size=16, num_layers=2, num_heads=2),
        finetune_transformer=JPEAVTransformerConfig(hidden_size=12, num_layers=1, num_heads=2),
        text_model=JModernBertTextConfig(vocab_size=300, hidden_size=16, num_hidden_layers=3,
                                         num_attention_heads=2, intermediate_size=24),
        nth_text_layer=2, bottleneck_dim=8)
    cfg = SAMAudioJudgeConfig.from_dict(dataclasses.asdict(jcfg))
    ours, left, archs = convert.convert_judge_state_dict(sd, cfg, return_arch=True)
    ref, ref_left, ref_archs = jckpt.convert_judge_state_dict(sd, jcfg, return_arch=True)
    assert left == ref_left == [] and archs == ref_archs
    assert ours["mean"].dtype == np.float32   # float64 stored as float32, as JAX does
    assert_same_tree(ours, ref, folded_under=("audio_codec/",))

    # an HF T5 encoder's keys (contiguous heads, shared embedding)
    t5 = {"shared.weight": rng.randn(64, 16).astype(np.float32),
          "encoder.final_layer_norm.weight": rng.randn(16).astype(np.float32),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              rng.randn(32, 2).astype(np.float32)}
    for i in range(2):
        b = f"encoder.block.{i}.layer"
        for n in "qkvo":
            t5[f"{b}.0.SelfAttention.{n}.weight"] = rng.randn(16, 16).astype(np.float32)
        t5[f"{b}.0.layer_norm.weight"] = rng.randn(16).astype(np.float32)
        t5[f"{b}.1.DenseReluDense.wi.weight"] = rng.randn(32, 16).astype(np.float32)
        t5[f"{b}.1.DenseReluDense.wo.weight"] = rng.randn(16, 32).astype(np.float32)
        t5[f"{b}.1.layer_norm.weight"] = rng.randn(16).astype(np.float32)
    kw = dict(dim=16, num_layers=2, num_heads=2, head_dim=8, d_ff=32, vocab_size=64)
    assert_same_tree(convert.convert_t5_state_dict(t5, T5EncoderConfig(**kw)),
                     jckpt.convert_t5_state_dict(t5, JT5EncoderConfig(**kw)))


def _clap_sd():
    """A laion_clap-shaped state dict: the HTSAT oracle, HF RoBERTa keys,
    the projections, the DDP 'module.' prefix and the stale position_ids."""
    torch.manual_seed(0)
    rng = np.random.RandomState(1)
    htsat = HTSATOracle(default_tiny_melw()).eval()
    sd = {f"module.audio_branch.{k}": v.detach().numpy() for k, v in htsat.state_dict().items()}

    def r(*shape):
        return (rng.randn(*shape) * 0.2).astype(np.float32)

    t = "module.text_branch"
    sd.update({f"{t}.embeddings.word_embeddings.weight": r(120, 32),
               f"{t}.embeddings.position_embeddings.weight": r(40, 32),
               f"{t}.embeddings.token_type_embeddings.weight": r(1, 32),
               f"{t}.embeddings.LayerNorm.weight": r(32), f"{t}.embeddings.LayerNorm.bias": r(32),
               f"{t}.embeddings.position_ids": np.arange(40)[None],
               f"{t}.pooler.dense.weight": r(32, 32), f"{t}.pooler.dense.bias": r(32)})
    for i in range(3):
        L = f"{t}.encoder.layer.{i}"
        for n, shape in (("attention.self.query", (32, 32)), ("attention.self.key", (32, 32)),
                         ("attention.self.value", (32, 32)), ("attention.output.dense", (32, 32)),
                         ("intermediate.dense", (48, 32)), ("output.dense", (32, 48))):
            sd[f"{L}.{n}.weight"], sd[f"{L}.{n}.bias"] = r(*shape), r(shape[0])
        for n in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{L}.{n}.weight"], sd[f"{L}.{n}.bias"] = r(32), r(32)
    for proj in ("audio_projection", "text_projection"):
        for j, din in ((0, 16 * 2 if proj == "audio_projection" else 32), (2, 8)):
            sd[f"module.{proj}.{j}.weight"], sd[f"module.{proj}.{j}.bias"] = r(8, din), r(8)
    sd["module.logit_scale_a"] = sd["module.logit_scale_t"] = np.float32(np.log(1 / 0.07))
    return sd


CLAP_TINY = dict(sample_rate=8000, duration_s=1.0, n_fft=512, hop_length=400, n_mels=16,
                 fmin=50.0, fmax=3500.0, spec_size=64, patch_size=4, audio_embed_dim=16,
                 depths=(2, 2), audio_heads=(2, 4), window_size=4, text_vocab=120,
                 text_hidden=32, text_layers=3, text_heads=4, text_intermediate=48,
                 max_text_len=12, embed_dim=8)
IB_TINY = dict(audio_dim=32, audio_layers=2, audio_heads=4, audio_kernel=16, audio_stride=10,
               n_mels=48, target_frames=56, vision_dim=32, vision_layers=2, vision_heads=4,
               vision_patch=14, image_size=28, embed_dim=16)


@pytest.mark.parametrize("tower", ["clap", "pe_clip", "imagebind"])
def test_tower_converters_match_jax(tower):
    if tower == "clap":
        sd = _clap_sd()
        ours, left = convert.convert_clap_state_dict(sd, ClapConfig(**CLAP_TINY))
        ref, ref_left = jclap.convert_clap_state_dict(sd, jclap.ClapConfig(**CLAP_TINY))
    elif tower == "pe_clip":
        sd, _ = pe_case._clip_style_sd(np.random.RandomState(0))
        import dataclasses

        cfg = PerceptionEncoderConfig(**dataclasses.asdict(pe_case.CFG))
        ours, left = convert.convert_pe_clip_state_dict(sd, cfg)
        ref, ref_left = jpe.convert_pe_clip_state_dict(sd, pe_case.CFG)
    else:
        model, _, _ = tiny_imagebind()
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        sd["modality_trunks.text.blocks.0.attn.in_proj_weight"] = np.zeros((24, 8), np.float32)
        ours, left, skipped = convert.convert_imagebind_state_dict(sd, ImageBindHugeConfig(**IB_TINY))
        ref, ref_left, ref_skipped = jib.convert_imagebind_state_dict(
            sd, jib.ImageBindHugeConfig(**IB_TINY))
        assert skipped == ref_skipped == ["modality_trunks.text.blocks.0.attn.in_proj_weight"]
        # the Conv3d stem is kept as stored: (D, 3, frames, P, P)
        assert ours["vision"]["stem"]["weight"].shape == (32, 3, 2, 14, 14)
    assert left == ref_left == []
    assert_same_tree(ours, ref)


def test_strict_coverage_counts_every_read():
    """An extra module fails in both packages; keys read only through `in`,
    items(), keys() or iteration count as read in the port's tracker."""
    sd = _sam_sd()
    cfg = _port_cfg(sam_case.CFG)
    extra = dict(sd, **{"mystery_module.weight": np.zeros(3, np.float32)})
    for fn, c in ((convert.convert_sam_audio_state_dict, cfg),
                  (jckpt.convert_sam_audio_state_dict, sam_case.CFG)):
        with pytest.raises(ValueError, match="mystery_module"):
            fn(extra, c)
        fn(extra, c, strict=False)
        fn(dict(sd, **{"text_encoder.anything": np.zeros(1)}), c)   # a skipped tower

    tracked = convert._TrackedStateDict({"a.x": 1, "a.y": 2, "b.z": 3, "c.w": 4})
    assert "b.z" in tracked and dict(tracked.subdict("a.").items()) == {"x": 1, "y": 2}
    assert tracked.accessed == {"a.x", "a.y", "b.z"}
    list(iter(tracked))
    assert tracked.accessed == {"a.x", "a.y", "b.z", "c.w"}


@pytest.mark.parametrize("extra", [False, True], ids=["complete", "extra-module"])
def test_strict_with_a_converter_that_reads_through_items(monkeypatch, extra):
    """A conditioning converter that reads the anchor head's keys through
    items() of a subdict (never indexing them) passes strict=True on a
    complete dict; an extra module still fails."""
    sd = _sam_sd()
    if extra:
        sd["extra_head.weight"] = np.zeros(2, np.float32)
    plain = convert.convert_conditioning

    def through_items(tsd, cfg):
        # the plain converter on an untracked copy: it reads nothing of tsd
        out = plain({k: dict.__getitem__(tsd, k) for k in tsd.all_keys()}, cfg)
        heads = {}
        for prefix in ("transformer.", "proj.", "align_masked_video.", "memory_proj.",
                       "embed_anchors."):
            heads.update({prefix + k: v for k, v in tsd.subdict(prefix).items()})
        assert len(heads) == sum(1 for k in sd if not k.startswith(("audio_codec.",
                                                                     "extra_head.")))
        return out

    monkeypatch.setattr(convert, "convert_conditioning", through_items)
    cfg = _port_cfg(sam_case.CFG)
    if extra:
        with pytest.raises(ValueError, match="extra_head"):
            convert.convert_sam_audio_state_dict(sd, cfg)
    else:
        ours = convert.convert_sam_audio_state_dict(sd, cfg)
        assert_same_tree(ours, jckpt.convert_sam_audio_state_dict(sd, sam_case.CFG),
                         folded_under=("audio_codec/",))


def test_port_npz_loads_in_jax(tmp_path):
    sd = _sam_sd()
    tree = convert.convert_sam_audio_state_dict(sd, _port_cfg(sam_case.CFG))
    # through tensors: bf16 leaves widen to float32, exactly
    tensors = params_from_numpy(tree)
    tensors["proj"]["weight"] = tensors["proj"]["weight"].to(torch.bfloat16)
    save_params(str(tmp_path / "p.npz"), tensors)
    back = jckpt.load_params(str(tmp_path / "p.npz"))
    expect = _flat(tree)
    expect["proj/weight"] = tensors["proj"]["weight"].float().numpy()
    got = _flat(back)
    assert sorted(got) == sorted(expect)
    for k in expect:
        assert got[k].dtype == expect[k].dtype
        np.testing.assert_array_equal(got[k], expect[k])
    assert sorted(flatten(tensors)) == sorted(expect)


def test_load_sam_audio_reads_checkpoint_pt(tmp_path):
    """A snapshot of config.json + the reference's checkpoint.pt loads with
    the port alone; t5_path= converts the text tower."""
    import dataclasses

    oracle = sam_case.SAMAudioOracle().eval()
    torch.save(oracle.state_dict(), tmp_path / "checkpoint.pt")
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dataclasses.asdict(sam_case.CFG), f)
    rng = np.random.RandomState(3)
    t5 = {"shared.weight": rng.randn(64, 16).astype(np.float32),
          "encoder.final_layer_norm.weight": np.ones(16, np.float32),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              rng.randn(32, 2).astype(np.float32)}
    for n in "qkvo":
        t5[f"encoder.block.0.layer.0.SelfAttention.{n}.weight"] = rng.randn(16, 16).astype(
            np.float32)
    t5["encoder.block.0.layer.0.layer_norm.weight"] = np.ones(16, np.float32)
    t5["encoder.block.0.layer.1.DenseReluDense.wi.weight"] = rng.randn(32, 16).astype(np.float32)
    t5["encoder.block.0.layer.1.DenseReluDense.wo.weight"] = rng.randn(16, 32).astype(np.float32)
    t5["encoder.block.0.layer.1.layer_norm.weight"] = np.ones(16, np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in t5.items()}, tmp_path / "t5.pt")

    with pytest.raises(FileNotFoundError, match="t5_path"):
        load_sam_audio(str(tmp_path), device="cpu")
    model = load_sam_audio(str(tmp_path), device="cpu", t5_path=str(tmp_path / "t5.pt"),
                           tokenizer=ByteFallbackTokenizer(64))
    ref = jckpt.convert_sam_audio_state_dict(
        {k: v.numpy() for k, v in oracle.state_dict().items()}, sam_case.CFG)
    ref["text_encoder"] = jckpt.convert_t5_state_dict(t5, sam_case.CFG.text_encoder)
    got = flatten(model.params)
    ref = _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7)


def test_save_pretrained_round_trip_is_bit_identical(tmp_path):
    """model.save_pretrained(dir) -> load_sam_audio(dir) separates
    bit-identically, also after quantize(8); the snapshot loads in the JAX
    package as the same tree."""
    cfg = jax_tiny_config()
    JaxSAMAudio.init_random(jax.random.PRNGKey(0), cfg).save_pretrained(str(tmp_path / "jax"))
    tok = ByteFallbackTokenizer(cfg.text_encoder.vocab_size)
    model = SAMAudio.from_pretrained(str(tmp_path / "jax"), device="cpu",
                                     allow_random_towers=True, tokenizer=tok)
    proc = SAMAudioProcessor(model.hop_length, model.sample_rate)
    wav = np.random.RandomState(0).randn(1, 5 * model.hop_length).astype(np.float32) * 0.1
    batch = proc(descriptions=["tone"], audios=[wav])
    noise = np.random.RandomState(1).randn(1, batch.anchor_alignment.shape[-1], 8).astype(
        np.float32)
    for what in ("exact", "int8"):
        if what == "int8":
            model.quantize(8)
        ref = model.separate(batch, noise=noise)
        out = model.save_pretrained(str(tmp_path / what))
        loaded = load_sam_audio(out, device="cpu", allow_random_towers=True, tokenizer=tok)
        got = loaded.separate(batch, noise=noise)
        assert torch.equal(torch.as_tensor(got.target[0]), torch.as_tensor(ref.target[0]))
        assert torch.equal(torch.as_tensor(got.residual[0]), torch.as_tensor(ref.residual[0]))
        jax_back = _flat(jckpt.load_params(f"{out}/params.npz"))
        ours = {k: v for k, v in flatten(model.params).items()}
        assert sorted(jax_back) == sorted(ours)
        for k in ours:
            np.testing.assert_array_equal(jax_back[k], ours[k])
    assert "w8" in loaded.params["transformer"]["layers"]["attention"]["wq"]
    loaded_jax = JaxSAMAudio.from_pretrained(out, allow_random_towers=True)
    assert "w8" in loaded_jax.params["transformer"]["layers"]["attention"]["wq"]


def test_command_line(tmp_path, monkeypatch):
    import dataclasses

    import sam_audio_tpu_torch.config as tconfig
    import sam_audio_tpu_torch.models.imagebind as tib

    snap = tmp_path / "snap"
    snap.mkdir()
    oracle = sam_case.SAMAudioOracle().eval()
    torch.save(oracle.state_dict(), snap / "checkpoint.pt")
    with open(snap / "config.json", "w") as f:
        json.dump(dataclasses.asdict(sam_case.CFG), f)
    convert.main(["--snapshot", str(snap), "--out", str(tmp_path / "out")])
    assert_same_tree(jckpt.load_params(str(tmp_path / "out" / "params.npz")),
                     jckpt.convert_sam_audio_state_dict(
                         {k: v.numpy() for k, v in oracle.state_dict().items()}, sam_case.CFG),
                     folded_under=("audio_codec/",))
    torch.save(oracle.state_dict() | {"mystery.weight": torch.zeros(2)}, snap / "checkpoint.pt")
    with pytest.raises(ValueError, match="mystery"):
        convert.main(["--snapshot", str(snap), "--out", str(tmp_path / "out2")])

    # the tower subcommands, at the tiny widths of the oracles
    model, _, _ = tiny_imagebind()
    torch.save(model.state_dict(), tmp_path / "ib.pth")
    monkeypatch.setattr(tib, "ImageBindHugeConfig", lambda: ImageBindHugeConfig(**IB_TINY))
    convert.main(["imagebind", "--torch", str(tmp_path / "ib.pth"),
                  "--out", str(tmp_path / "ib.npz")])
    ref, _, _ = jib.convert_imagebind_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, jib.ImageBindHugeConfig(**IB_TINY))
    assert_same_tree(jckpt.load_params(str(tmp_path / "ib.npz")), ref)

    sd, _ = pe_case._clip_style_sd(np.random.RandomState(0))
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}, tmp_path / "pe.pt")
    pe_cfg = PerceptionEncoderConfig(**dataclasses.asdict(pe_case.CFG))
    monkeypatch.setattr(tconfig, "PerceptionEncoderConfig", lambda: pe_cfg)
    convert.main(["pe-clip", "--torch", str(tmp_path / "pe.pt"), "--out", str(tmp_path / "pe.npz")])
    ref, _ = jpe.convert_pe_clip_state_dict(sd, pe_case.CFG)
    assert_same_tree(jckpt.load_params(str(tmp_path / "pe.npz")), ref)

    sd = _clap_sd()
    torch.save({"state_dict": {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}},
               tmp_path / "clap.pt")
    import sam_audio_tpu_torch.models.clap as tclap

    monkeypatch.setattr(tclap, "ClapConfig", lambda: ClapConfig(**CLAP_TINY))
    convert.main(["clap", "--torch", str(tmp_path / "clap.pt"), "--out", str(tmp_path / "c.npz")])
    ref, _ = jclap.convert_clap_state_dict(sd, jclap.ClapConfig(**CLAP_TINY))
    assert_same_tree(jckpt.load_params(str(tmp_path / "c.npz")), ref)
