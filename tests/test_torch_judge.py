"""The judge stack of the PyTorch port against the JAX package (fp32, CPU,
tiny widths, one parameter tree bridged by checkpoint.params_from_numpy):
ModernBERT, PE-AV under every architecture switch, judge_forward and its
grouped form, the judge processor, the int8 quantizers, a JAX-written judge
snapshot, and the JudgeRanker's two scoring paths."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu import checkpoint as jckpt
from sam_audio_tpu.config import DACVAEConfig as JDACVAEConfig
from sam_audio_tpu.config import JudgeRankerConfig as JJudgeRankerConfig
from sam_audio_tpu.config import ModernBertTextConfig as JModernBertTextConfig
from sam_audio_tpu.config import PEAVTransformerConfig as JPEAVTransformerConfig
from sam_audio_tpu.config import SAMAudioJudgeConfig as JSAMAudioJudgeConfig
from sam_audio_tpu.models import judge as jjudge
from sam_audio_tpu.models import modernbert as jmb
from sam_audio_tpu.models import peav as jpeav
from sam_audio_tpu.ops import quant as jquant
from sam_audio_tpu.processor import SAMAudioJudgeProcessor as JJudgeProcessor
from sam_audio_tpu.ranking.judge import JudgeRanker as JJudgeRanker
from sam_audio_tpu.text_tokenizer import ByteFallbackTokenizer as JByteTokenizer
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import (
    JudgeRankerConfig,
    ModernBertTextConfig,
    PEAVTransformerConfig,
    SAMAudioJudgeConfig,
)
from sam_audio_tpu_torch.models import judge as tjudge
from sam_audio_tpu_torch.models.modernbert import modernbert_encode
from sam_audio_tpu_torch.models.peav import peav_apply
from sam_audio_tpu_torch.ops import quant as tquant
from sam_audio_tpu_torch.processor import SAMAudioJudgeProcessor
from sam_audio_tpu_torch.ranking.judge import JudgeRanker
from sam_audio_tpu_torch.text_tokenizer import ByteFallbackTokenizer

TOL = dict(rtol=1e-4, atol=1e-4)
CODEC = dict(encoder_dim=4, encoder_rates=(2, 4), latent_dim=16, decoder_dim=16,
             decoder_rates=(4, 2), codebook_dim=4, sample_rate=8000)
TOWER = dict(hidden_size=16, num_layers=2, num_heads=2)
FT_TOWER = dict(hidden_size=12, num_layers=1, num_heads=2)
TEXT = dict(vocab_size=300, hidden_size=16, num_hidden_layers=4, num_attention_heads=2,
            intermediate_size=24, global_attn_every_n_layers=3, local_attention=8)


def judge_cfgs(**over):
    """The same tiny judge config in both packages."""
    kw = dict(nth_text_layer=2, bottleneck_dim=8, compute_dtype="float32", **over)
    j = JSAMAudioJudgeConfig(
        audio_codec=JDACVAEConfig(**CODEC), transformer=JPEAVTransformerConfig(**TOWER),
        finetune_transformer=JPEAVTransformerConfig(**FT_TOWER),
        text_model=JModernBertTextConfig(**TEXT), **kw)
    return j, SAMAudioJudgeConfig.from_dict(dataclasses.asdict(j))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref), **(tol or TOL))


def test_configs_parse_like_jax():
    j, t = judge_cfgs()
    d = dataclasses.asdict(j)
    d["transformer"] = {"n_layers": 3, "num_attention_heads": 4, "hidden_size": 32,
                        "unknown": 1}
    tj, tt = JSAMAudioJudgeConfig.from_dict(d), SAMAudioJudgeConfig.from_dict(d)
    assert dataclasses.asdict(tt) == dataclasses.asdict(tj)
    assert tt.transformer.num_layers == 3 and tt.transformer.num_heads == 4
    assert dataclasses.asdict(SAMAudioJudgeConfig()) == dataclasses.asdict(JSAMAudioJudgeConfig())


def test_modernbert_matches_jax():
    """Padded ids; layers 0 and 3 global, 1 and 2 local (window +-4 over 14
    positions); every hidden state, the judge's layer 2 among them."""
    jcfg = JModernBertTextConfig(**TEXT)
    tcfg = ModernBertTextConfig(**TEXT)
    params = np_tree(jmb.modernbert_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 300, (3, 14)).astype(np.int32)
    mask = np.ones((3, 14), bool)
    mask[1, 9:] = False
    mask[2, 3:] = False    # padded queries far from every valid key on local layers
    j_last, j_hidden = jmb.modernbert_encode(params, jnp.asarray(ids), jnp.asarray(mask), jcfg)
    t_last, t_hidden = modernbert_encode(params_from_numpy(params), torch.as_tensor(ids),
                                         torch.as_tensor(mask), tcfg)
    assert len(t_hidden) == len(j_hidden) == 5
    close(t_last, j_last)
    for got, ref in zip(t_hidden, j_hidden):
        close(got, ref)
    # bf16 compute: padded rows on local layers stay finite (min + min = -inf
    # on fp32 logits, softmax keeps a finite maximum)
    b_last, _ = modernbert_encode(params_from_numpy(params), torch.as_tensor(ids),
                                  torch.as_tensor(mask), tcfg, compute_dtype=torch.bfloat16)
    assert torch.isfinite(b_last.float()).all()


def _peav_variant(params, variant, t_max, rng):
    """Adds to a JAX PE-AV tree the optional entries a converted checkpoint
    can carry."""
    p = {**params, "layers": dict(params["layers"])}
    layers = p["layers"]
    n, h = layers["ln1"]["weight"].shape
    hd = h // 2

    def r(*shape, s=0.2):
        return (rng.randn(*shape) * s).astype(np.float32)

    if variant.get("qk_norm"):
        for name in ("q_norm", "k_norm"):
            norm = {"weight": 1 + r(n, hd)}
            if variant["qk_norm"] == "layernorm":
                norm["bias"] = r(n, hd)
            layers["attn"] = {**layers["attn"], name: norm}
    if variant.get("bias_kv"):
        layers["attn"] = {**layers["attn"], "bias_k": r(n, h, s=1.0), "bias_v": r(n, h, s=1.0)}
    if variant.get("layer_scale"):
        layers["ls1"], layers["ls2"] = 0.5 + r(n, h), 0.5 + r(n, h)
    if variant.get("swiglu"):
        m = 24
        layers["mlp"] = {"w1": {"weight": r(n, m, h), "bias": r(n, m)},
                         "w2": {"weight": r(n, h, m), "bias": r(n, h)},
                         "w3": {"weight": r(n, m, h), "bias": r(n, m)}}
    if variant.get("pos_embed"):
        p["pos_embed"] = r(t_max, h)
    if variant.get("ln_pre"):
        p["ln_pre"] = {"weight": 1 + r(h), "bias": r(h)}
    if variant.get("no_final_norm"):
        del p["final_norm"]
    return p


PEAV_VARIANTS = {
    "default": ({}, {}),
    "postln-gelu-nopos": (dict(prenorm=False, act="gelu", pos="none"), {}),
    "quickgelu-learned-lnpre": (dict(act="quick_gelu", pos="learned"),
                                dict(pos_embed=True, ln_pre=True, no_final_norm=True)),
    "relu-rope-rmsnorm": (dict(act="relu", pos="rope", rope_theta=500.0, norm="rmsnorm"),
                          dict(qk_norm="rmsnorm")),
    "silu-lnqk-layerscale": (dict(act="silu"), dict(qk_norm="layernorm", layer_scale=True)),
    "swiglu-biaskv-postln": (dict(act="swiglu", prenorm=False), dict(swiglu=True, bias_kv=True)),
    "gelutanh-biaskv-rope": (dict(pos="rope"), dict(bias_kv=True, layer_scale=True)),
}


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "nomask"])
@pytest.mark.parametrize("variant", list(PEAV_VARIANTS))
def test_peav_matches_jax(variant, masked):
    switches, extras = PEAV_VARIANTS[variant]
    jcfg = JPEAVTransformerConfig(**TOWER, **switches)
    tcfg = PEAVTransformerConfig(**TOWER, **switches)
    rng = np.random.RandomState(1)
    params = _peav_variant(np_tree(jpeav.peav_init(jax.random.PRNGKey(2), jcfg)), extras, 32,
                           rng)
    x = rng.randn(3, 10, 16).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((3, 10), bool)
        mask[1, 6:] = False
        mask[2, 1:] = False
    ref = jpeav.peav_apply(params, jnp.asarray(x), jcfg,
                           padding_mask=None if mask is None else jnp.asarray(mask))
    out = peav_apply(params_from_numpy(params), torch.as_tensor(x), tcfg,
                     padding_mask=None if mask is None else torch.as_tensor(mask))
    close(out.last_hidden_state, ref.last_hidden_state)
    close(out.pooler_output, ref.pooler_output)


def _judge_inputs(cfg, b=2, k=3, seed=3):
    hop = cfg.audio_codec.hop_length
    rng = np.random.RandomState(seed)
    t_pad = 6 * hop
    sizes = [4 * hop, 6 * hop][:b]
    ids = rng.randint(3, 300, (b, 5)).astype(np.int32)
    attn = np.ones((b, 5), bool)
    attn[0, 3:] = False
    mix = np.zeros((b, 1, t_pad), np.float32)
    sep = np.zeros((b * k, 1, t_pad), np.float32)
    for i in range(b):
        mix[i, 0, : sizes[i]] = rng.randn(sizes[i]) * 0.1
        for j in range(k):
            sep[i * k + j, 0, : sizes[i]] = rng.randn(sizes[i]) * 0.1
    pad = np.arange(t_pad)[None, :] < np.asarray(sizes)[:, None]
    return dict(ids=ids, attn=attn, mix=mix, sep=sep, pad=pad, k=k)


def _outputs(out):
    return (out.overall, out.recall, out.precision, out.faithfulness)


@pytest.fixture(scope="module")
def judge_pair():
    jcfg, tcfg = judge_cfgs()
    params = np_tree(jjudge.judge_init(jax.random.PRNGKey(0), jcfg))
    params["mean"] = np.asarray([0.5, -1.0, 2.0, 0.0], np.float32)
    params["std"] = np.asarray([2.0, 0.5, 1.0, 3.0], np.float32)
    return jcfg, tcfg, params


@pytest.mark.parametrize("padded", [True, False], ids=["padding-mask", "no-mask"])
def test_judge_forward_and_grouped_match_jax(judge_pair, padded):
    jcfg, tcfg, params = judge_pair
    d = _judge_inputs(tcfg)
    k = d["k"]
    pad = d["pad"] if padded else None
    tp = params_from_numpy(params)

    def rep(x):
        return np.repeat(x, k, axis=0)

    flat = dict(input_ids=rep(d["ids"]), attention_mask=rep(d["attn"]),
                input_values=rep(d["mix"]), separated_values=d["sep"],
                padding_mask=None if pad is None else rep(pad))
    ref = jjudge.judge_forward(params, jcfg, **{n: None if v is None else jnp.asarray(v)
                                                for n, v in flat.items()})
    out = tjudge.judge_forward(tp, tcfg, **{n: None if v is None else torch.as_tensor(v)
                                            for n, v in flat.items()})
    for got, want in zip(_outputs(out), _outputs(ref)):
        close(got, want)
    grouped = dict(input_ids=d["ids"], attention_mask=d["attn"], input_values=d["mix"],
                   separated_values=d["sep"], padding_mask=pad)
    jg = jjudge.judge_forward_grouped(params, jcfg, k=k, **{
        n: None if v is None else jnp.asarray(v) for n, v in grouped.items()})
    tg = tjudge.judge_forward_grouped(tp, tcfg, k=k, **{
        n: None if v is None else torch.as_tensor(v) for n, v in grouped.items()})
    for got, want, flat_out in zip(_outputs(tg), _outputs(jg), _outputs(out)):
        close(got, want)
        close(got, flat_out.numpy(), rtol=1e-5, atol=1e-5)


def test_judge_processor_matches_jax():
    kw = dict(audio_hop_length=8, audio_sampling_rate=8000)
    ours = SAMAudioJudgeProcessor(**kw, tokenizer=ByteFallbackTokenizer(300))
    ref = JJudgeProcessor(**kw, tokenizer=JByteTokenizer(300))
    rng = np.random.RandomState(0)
    for audio in ([rng.randn(1, 13).astype(np.float32), rng.randn(1, 24).astype(np.float32)],
                  rng.randn(21).astype(np.float32),       # a bare array is one clip
                  rng.randn(2, 10).astype(np.float32)):    # (C, T): one stereo clip
        a = ours(text=["a dog", "rain on a roof"], input_audio=audio, separated_audio=audio)
        b = ref(text=["a dog", "rain on a roof"], input_audio=audio, separated_audio=audio)
        assert sorted(a) == sorted(b)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    out = ours._process_audio([np.ones((1, 13), np.float32)])
    assert out["input_values"].shape == (1, 1, 16) and out["padding_mask"][0].sum() == 16
    np.testing.assert_array_equal(out["input_values"][0, 0, 13:],
                                  np.pad(np.ones(13), (0, 3), mode="reflect")[13:])
    with pytest.raises(ValueError, match="sampling rate"):
        ours(input_audio=[np.ones(8, np.float32)], sampling_rate=16000)


def test_int8_judge_quantization_bit_identical(judge_pair):
    jcfg, tcfg, params = judge_pair
    jq = np_tree(jquant.quantize_judge_params(jax.tree_util.tree_map(jnp.asarray, params)))
    tq = tquant.quantize_judge_params(params_from_numpy(params))
    jflat = jckpt.flatten_pytree(jq)
    tflat = jckpt.flatten_pytree(jax.tree_util.tree_map(lambda x: x.numpy(), tq))
    assert sorted(jflat) == sorted(tflat)
    assert any(k.endswith("w8") for k in tflat)
    for key in jflat:
        assert tflat[key].dtype == jflat[key].dtype, key
        np.testing.assert_array_equal(tflat[key], jflat[key], err_msg=key)
    # and the quantized judge scores as JAX's does
    d = _judge_inputs(tcfg)
    args = dict(input_ids=d["ids"], attention_mask=d["attn"], input_values=d["mix"],
                separated_values=d["sep"], padding_mask=d["pad"], k=d["k"])
    ref = jjudge.judge_forward_grouped(jax.tree_util.tree_map(jnp.asarray, jq), jcfg, **{
        n: jnp.asarray(v) if isinstance(v, np.ndarray) else v for n, v in args.items()})
    out = tjudge.judge_forward_grouped(tq, tcfg, **{
        n: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for n, v in args.items()})
    close(out.overall, ref.overall)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_judge_snapshot_written_by_jax(tmp_path, judge_pair, quantized):
    """config.json + params.npz written with the JAX package's save_params,
    read by SAMAudioJudgeModel.from_pretrained: the same scores."""
    jcfg, tcfg, params = judge_pair
    tree = params
    if quantized:
        tree = np_tree(jquant.quantize_judge_params(jax.tree_util.tree_map(jnp.asarray, params)))
    jckpt.save_params(str(tmp_path / "params.npz"), tree)
    (tmp_path / "config.json").write_text(json.dumps(dataclasses.asdict(jcfg)))
    model = tjudge.SAMAudioJudgeModel.from_pretrained(str(tmp_path), device="cpu")
    assert model.cfg == tcfg
    d = _judge_inputs(tcfg, k=1)
    ref = jjudge.judge_forward(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                               input_ids=jnp.asarray(d["ids"]),
                               input_values=jnp.asarray(d["mix"]),
                               separated_values=jnp.asarray(d["sep"]),
                               attention_mask=jnp.asarray(d["attn"]),
                               padding_mask=jnp.asarray(d["pad"]))
    out = model(input_ids=torch.as_tensor(d["ids"]), input_values=torch.as_tensor(d["mix"]),
                separated_values=torch.as_tensor(d["sep"]),
                attention_mask=torch.as_tensor(d["attn"]),
                padding_mask=torch.as_tensor(d["pad"]))
    for got, want in zip(_outputs(out), _outputs(ref)):
        close(got, want)
    proc = SAMAudioJudgeProcessor.from_pretrained(str(tmp_path), allow_fallback_tokenizer=True)
    assert (proc.audio_hop_length, proc.audio_sampling_rate) == (8, 8000)
    assert isinstance(proc.tokenizer, ByteFallbackTokenizer)
    with pytest.raises(FileNotFoundError):
        tjudge.SAMAudioJudgeModel.from_pretrained(str(tmp_path / "absent"), device="cpu")


def test_judge_init_tree_matches_jax():
    jcfg, tcfg = judge_cfgs()
    jt = jckpt.flatten_pytree(np_tree(jjudge.judge_init(jax.random.PRNGKey(0), jcfg)))
    model = tjudge.SAMAudioJudgeModel.init_random(tcfg, seed=0, device="cpu")
    tt = jckpt.flatten_pytree(jax.tree_util.tree_map(lambda x: x.numpy(), model.params))
    assert sorted(tt) == sorted(jt)
    for key in jt:
        assert tt[key].shape == jt[key].shape, key


def test_judge_ranker_paths_match_jax(judge_pair):
    """JudgeRanker.score_on_device (grouped, on tensors) equals the host
    __call__ path (processor + judge_forward on the flattened pairs), and
    both equal JAX's."""
    jcfg, tcfg, params = judge_pair
    tproc = SAMAudioJudgeProcessor(8, 8000, tokenizer=ByteFallbackTokenizer(300))
    jproc = JJudgeProcessor(audio_hop_length=8, audio_sampling_rate=8000,
                            tokenizer=JByteTokenizer(300))
    ours = JudgeRanker(JudgeRankerConfig(), device="cpu", processor=tproc,
                       model=tjudge.SAMAudioJudgeModel(tcfg, params_from_numpy(params),
                                                       device="cpu"))
    ref = JJudgeRanker(JJudgeRankerConfig(), processor=jproc,
                       model=jjudge.SAMAudioJudgeModel(jcfg, params))
    d = _judge_inputs(tcfg)
    b, k = 2, d["k"]
    sizes = [32, 48]
    tgt = d["sep"].reshape(b, k, -1)
    desc = ["a dog barking", "rain"]
    assert ours.supports_on_device(sizes, 8000)
    assert not ours.supports_on_device([9], 8000) and not ours.supports_on_device(sizes, 16000)
    dev = ours.score_on_device(torch.as_tensor(tgt), sizes, desc,
                               mixtures=torch.as_tensor(d["mix"]))
    jdev = ref.score_on_device(jnp.asarray(tgt), sizes, desc, mixtures=jnp.asarray(d["mix"]))
    host_kw = dict(extracted_audio=[tgt[i, :, : sizes[i]] for i in range(b)],
                   input_audio=[np.broadcast_to(d["mix"][i, 0, : sizes[i]], (k, sizes[i]))
                                for i in range(b)],
                   descriptions=desc, sample_rate=8000)
    host = ours(**host_kw)
    assert dev.shape == host.shape == (b, k)
    close(dev, jdev)
    np.testing.assert_allclose(host, np.asarray(ref(**host_kw)), **TOL)
    np.testing.assert_allclose(dev.numpy(), host, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="mixtures"):
        ours.score_on_device(torch.as_tensor(tgt), sizes, desc)
