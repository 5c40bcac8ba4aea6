"""PyTorch port vs JAX package: the T5 encoder, the DiT (each self-attention
dispatch branch) and the DAC-VAE codec, fp32 on the CPU, with parameters
made by the JAX `*_init` functions and bridged by
checkpoint.params_from_numpy. Tolerance 1e-4 (PARITY.md's bound for
converted weights): the same math, summed in another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models import dacvae as jdac
from sam_audio_tpu.models.dit import dit_apply as jax_dit_apply
from sam_audio_tpu.models.dit import dit_init as jax_dit_init
from sam_audio_tpu.models.sam_audio import sam_audio_init as jax_sam_audio_init
from sam_audio_tpu.models.t5 import t5_encode as jax_t5_encode
from sam_audio_tpu.models.t5 import t5_encoder_init as jax_t5_init
from sam_audio_tpu_torch import config as tcfg
from sam_audio_tpu_torch.checkpoint import cast_matmul_weights, params_from_numpy
from sam_audio_tpu_torch.models import dacvae as tdac
from sam_audio_tpu_torch.models.dit import dit_apply
from sam_audio_tpu_torch.models.init import sam_audio_init
from sam_audio_tpu_torch.models.t5 import relative_position_bucket, t5_encode

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _shapes(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _shapes(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tuple(tree.shape)}


def test_config_copy_matches_jax_config():
    jcfg = jax_tiny_config()
    assert dataclasses.asdict(tcfg.tiny_test_config()) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.SAMAudioConfig()) == dataclasses.asdict(
        type(jcfg)())
    d = dataclasses.asdict(jcfg)
    d["text_ranker"] = {"kind": "ensemble", "rankers": {
        "clap": [{"kind": "clap"}, 0.5], "sa": [{"kind": "sound_activity"}, 0.5]}}
    cfg = tcfg.SAMAudioConfig.from_dict(d)
    assert cfg.text_ranker.kind == "ensemble"
    assert [k for k, _ in cfg.text_ranker.items()] == ["clap", "sa"]


def test_random_init_builds_the_jax_tree():
    """Same names, shapes and layer stacking as sam_audio_init."""
    cfg = tcfg.tiny_test_config()
    jax_tree = _np(jax_sam_audio_init(jax.random.PRNGKey(0), jax_tiny_config()))
    ours = sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(ours) == _shapes(jax_tree)


def test_cast_matmul_weights_keeps_norms_fp32():
    cfg = tcfg.tiny_test_config()
    p = cast_matmul_weights(sam_audio_init(cfg, torch.Generator().manual_seed(0), "cpu"),
                            torch.bfloat16)
    layer = p["transformer"]["layers"]
    assert layer["attention"]["wq"]["weight"].dtype == torch.bfloat16
    assert layer["attention"]["q_norm"]["weight"].dtype == torch.float32
    assert layer["attention"]["wq"].get("bias") is None or \
        layer["attention"]["wq"]["bias"].dtype == torch.float32
    assert p["text_encoder"]["relative_attention_bias"]["weight"].dtype == torch.float32
    assert p["audio_codec"]["decoder"]["blocks"][0]["res"][0]["conv1"]["weight"].dtype \
        == torch.bfloat16
    assert {x.dtype for x in jax.tree_util.tree_leaves(p)} == {torch.float32,
                                                               torch.bfloat16}


def test_relative_position_buckets_match():
    from sam_audio_tpu.models.t5 import _relative_position_bucket

    rel = np.arange(-300, 301)[None, :] - np.arange(0, 5)[:, None]
    np.testing.assert_array_equal(
        relative_position_bucket(torch.tensor(rel)).numpy(),
        np.asarray(_relative_position_bucket(jnp.asarray(rel))))


def test_t5_encode_matches():
    cfg = jax_tiny_config().text_encoder
    p = _np(jax_t5_init(jax.random.PRNGKey(1), cfg))
    rng = np.random.RandomState(0)
    ids = rng.randint(2, cfg.vocab_size, (2, 9)).astype(np.int32)
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    ref = jax_t5_encode(p, ids, mask, cfg)
    out = t5_encode(params_from_numpy(p), torch.tensor(ids), torch.tensor(mask),
                    tcfg.tiny_test_config().text_encoder)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _dit_cfgs():
    """Tiny DiT widths with head_dim 128, so the fused branch is eligible."""
    kw = dict(dim=256, n_heads=2, n_layers=2, dropout=0.0, context_dim=32,
              frequency_embedding_dim=16, out_channels=8)
    from sam_audio_tpu.config import TransformerConfig as JT

    return JT(**kw), tcfg.TransformerConfig(**kw)


@pytest.mark.parametrize("t", [40, 600, 1030],
                         ids=["fused-kernel-branch", "plain-sdpa", "flash-kernel-branch"])
def test_dit_apply_matches_each_dispatch_branch(t):
    jc, tc = _dit_cfgs()
    p = _np(jax_dit_init(jax.random.PRNGKey(2), jc))
    rng = np.random.RandomState(t)
    x = rng.randn(2, t, 256).astype(np.float32)
    time = np.array([0.25, 0.75], np.float32)
    memory = rng.randn(2, 5, 32).astype(np.float32)
    mem_mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    pad = np.ones((2, t), bool)
    pad[1, t * 2 // 3:] = False
    ref = jax_dit_apply(p, x, time, cfg=jc, padding_mask=pad, memory=memory,
                        memory_padding_mask=mem_mask)
    out = dit_apply(params_from_numpy(p), torch.tensor(x), torch.tensor(time), cfg=tc,
                    padding_mask=torch.tensor(pad), memory=torch.tensor(memory),
                    memory_padding_mask=torch.tensor(mem_mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_dacvae_encode_decode_match():
    jcfg = jax_tiny_config().audio_codec
    p = _np(jdac.dacvae_init(jax.random.PRNGKey(3), jcfg))
    tcfg_codec = tcfg.tiny_test_config().audio_codec
    wav = np.random.RandomState(4).randn(2, 1, 45).astype(np.float32) * 0.3  # not a hop multiple
    ref = jdac.encode(p, wav, jcfg)
    tp = params_from_numpy(p)
    out = tdac.encode(tp, torch.tensor(wav), tcfg_codec)
    assert out.shape == ref.shape == (2, jcfg.codebook_dim, 6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    z = np.random.RandomState(5).randn(2, jcfg.codebook_dim, 6).astype(np.float32)
    ref = jdac.decode(p, z, jcfg)
    out = tdac.decode(tp, torch.tensor(z), tcfg_codec)
    assert out.shape == ref.shape == (2, 1, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tdac.feature_idx_to_wav_idx(7, 8, 8000) == jdac.feature_idx_to_wav_idx(7, 8, 8000)
