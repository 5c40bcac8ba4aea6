"""PyTorch port vs JAX package: single ops (ops/nn, rope, attention, conv,
ode) on the same numpy inputs, fp32 on the CPU. Identical math is held at
1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sam_audio_tpu.ops import attention as JA
from sam_audio_tpu.ops import conv as JC
from sam_audio_tpu.ops import nn as JN
from sam_audio_tpu.ops import ode as JO
from sam_audio_tpu.ops import rope as JR
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.ops import attention as TA
from sam_audio_tpu_torch.ops import conv as TC
from sam_audio_tpu_torch.ops import nn as TN
from sam_audio_tpu_torch.ops import ode as TO
from sam_audio_tpu_torch.ops import rope as TR

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


def test_linear_norms_modulate():
    x = _rand(2, 5, 16)
    p = _np_tree(JN.linear_init(jax.random.PRNGKey(0), 16, 8))
    _close(TN.linear(params_from_numpy(p), torch.tensor(x)), JN.linear(p, x))
    w = {"weight": _rand(16, seed=1)}
    _close(TN.rmsnorm(params_from_numpy(w), torch.tensor(x)), JN.rmsnorm(w, x))
    ln = {"weight": _rand(16, seed=2), "bias": _rand(16, seed=3)}
    _close(TN.layernorm(params_from_numpy(ln), torch.tensor(x)),
           JN.layernorm(ln, x))
    sh, sc = _rand(2, 1, 16, seed=4), _rand(2, 1, 16, seed=5)
    _close(TN.modulate(torch.tensor(x), torch.tensor(sh), torch.tensor(sc)),
           JN.modulate(x, sh, sc))


@pytest.mark.parametrize("non_linearity", ["swiglu", "silu", "gelu"])
def test_projection_and_feedforward(non_linearity):
    x = _rand(2, 3, 12)
    p = _np_tree(JN.projection_init(jax.random.PRNGKey(1), 12, 10, non_linearity))
    _close(TN.projection(params_from_numpy(p), torch.tensor(x), non_linearity),
           JN.projection(p, x, non_linearity))
    f = _np_tree(JN.feedforward_init(jax.random.PRNGKey(2), 12, 20, non_linearity))
    _close(TN.feedforward(params_from_numpy(f), torch.tensor(x), non_linearity),
           JN.feedforward(f, x, non_linearity))


def test_timestep_embeddings_and_embedder():
    t = np.array([0.0, 0.0625, 0.5, 0.96875], np.float32)
    _close(TN.sinusoidal_embedding(torch.tensor(t), 32),
           JN.sinusoidal_embedding(jnp.asarray(t), 32))
    _close(TN.glide_timestep_embedding(torch.tensor(t), 9),
           JN.glide_timestep_embedding(jnp.asarray(t), 9))
    p = _np_tree(JN.timestep_embedder_init(jax.random.PRNGKey(3), 16, 8))
    _close(TN.timestep_embedder(params_from_numpy(p), torch.tensor(t), 8),
           JN.timestep_embedder(p, jnp.asarray(t), 8))


def test_embed_anchors_and_align_modalities():
    x = _rand(2, 6, 16)
    p = _np_tree(JN.embed_anchors_init(jax.random.PRNGKey(4), 3, 8, 16))
    p["gate"] = np.array([0.7], np.float32)  # non-zero so the branch matters
    ids = np.array([[0, 3, 1, 2], [0, 3, 3, 3]], np.int32)
    align = np.array([[0, 2, 2, 3, 1, 1], [0, 0, 1, 1, 1, 1]], np.int32)
    _close(TN.embed_anchors(params_from_numpy(p), torch.tensor(x), torch.tensor(ids),
                            torch.tensor(align)),
           JN.embed_anchors(p, x, ids, align))
    a = _np_tree(JN.align_modalities_init(jax.random.PRNGKey(5), 12, 16))
    a["gate"] = np.array([-0.4], np.float32)
    tgt = _rand(2, 12, 6, seed=6)
    _close(TN.align_modalities(params_from_numpy(a), torch.tensor(x), torch.tensor(tgt)),
           JN.align_modalities(a, x, tgt))


def test_rope_tables_and_rotation():
    ct, st = TR.precompute_rope(16, 40, 20000)
    cj, sj = JR.precompute_rope(16, 40, 20000)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    x = _rand(2, 33, 3, 16)
    _close(TR.apply_rope_half(torch.tensor(x), ct, st), JR.apply_rope_half(x, cj, sj))


def test_rope_table_cache_holds_precompute_ropes_tables():
    """The DiT's tables, built once a length and kept on their device, are
    precompute_rope's exact float32 tables, also when first asked for
    inside inference mode (a training step may save them)."""
    from sam_audio_tpu_torch.config import TransformerConfig
    from sam_audio_tpu_torch.models.dit import dit_rope_tables

    cfg = TransformerConfig(dim=64, n_heads=4, n_layers=1, max_positions=7000)
    with torch.inference_mode():
        cos, sin = dit_rope_tables(cfg, 45, torch.device("cpu"))
    assert not cos.is_inference() and dit_rope_tables(cfg, 45, "cpu")[0] is cos
    ct, st = TR.precompute_rope(cfg.head_dim, 45, 14000)
    assert torch.equal(cos, ct) and torch.equal(sin, st) and cos.dtype == torch.float32
    assert dit_rope_tables(dataclasses.replace(cfg, use_rope=False), 45, "cpu") is None


def test_dit_graphs_engage_only_on_an_unsharded_card_solve():
    """CUDA graphs of the DiT serve a solve on a CUDA device with autograd
    off and no sharding; the CPU, a recorded gradient and the sharded paths
    run eagerly (a stand-in object plays the card's state here)."""
    from types import SimpleNamespace

    from sam_audio_tpu_torch.models.dit_graph import DiTGraphs

    card = SimpleNamespace(is_cuda=True)
    with torch.no_grad():
        assert DiTGraphs.engages(card, sharded=False)
        assert not DiTGraphs.engages(card, sharded=True)
        assert not DiTGraphs.engages(torch.zeros(2, 3), sharded=False)
    assert not DiTGraphs.engages(card, sharded=False)   # autograd on


def test_sdpa_masks_and_fully_masked_row_is_mean_of_v():
    q, k, v = _rand(2, 7, 2, 8, seed=1), _rand(2, 9, 2, 8, seed=2), _rand(2, 9, 2, 8, seed=3)
    mask = np.ones((2, 9), bool)
    mask[0, 5:] = False
    mask[1, :] = False
    out = TA.sdpa(torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(mask))
    _close(out, JA.sdpa(q, k, v, key_padding_mask=mask))
    np.testing.assert_allclose(out[1].numpy(),
                               np.broadcast_to(v[1].mean(0), (7, 2, 8)), **TOL)


def test_pad1d_reflect_on_too_short_input():
    x = _rand(2, 3, 4)
    for pads in ((5, 7), (0, 3), (2, 2)):
        _close(TC.pad1d(torch.tensor(x), pads, mode="reflect"),
               JC.pad1d(x, pads, mode="reflect"))
    _close(TC.pad1d(torch.tensor(x), (1, 2)), JC.pad1d(x, (1, 2)))


@pytest.mark.parametrize("stride,padding,dilation", [(1, 3, 1), (2, 1, 1), (1, 9, 3),
                                                     (1, (2, 5), 1)])
def test_conv1d(stride, padding, dilation):
    p = _np_tree(JC.conv1d_init(jax.random.PRNGKey(6), 4, 6, 7))
    x = _rand(2, 4, 37)
    _close(TC.conv1d(params_from_numpy(p), torch.tensor(x), stride, padding, dilation),
           JC.conv1d(p, x, stride, padding, dilation))


@pytest.mark.parametrize("stride,length", [(2, 9), (4, 10), (12, 5)])
def test_conv_transpose1d_lengths(stride, length):
    p = _np_tree(JC.conv_transpose1d_init(jax.random.PRNGKey(7), 6, 4, 2 * stride))
    x = _rand(1, 6, length)
    pad = -(-stride // 2)
    out = TC.conv_transpose1d(params_from_numpy(p), torch.tensor(x), stride, pad)
    ref = JC.conv_transpose1d(p, x, stride, pad)
    assert out.shape == ref.shape == (1, 4, length * stride)
    _close(out, ref)


def test_audiocraft_conv_and_groupnorm():
    p = _np_tree(JC.conv1d_init(jax.random.PRNGKey(8), 8, 8, 3))
    x = _rand(2, 8, 11)
    _close(TC.audiocraft_conv1d(params_from_numpy(p), torch.tensor(x)),
           JC.audiocraft_conv1d(p, x))
    g = {"weight": _rand(8, seed=9), "bias": _rand(8, seed=10)}
    _close(TC.groupnorm(params_from_numpy(g), torch.tensor(x), 2),
           JC.groupnorm(g, x, 2))


@pytest.mark.parametrize("fast", [False, True])
def test_snake_exact_and_fast(fast):
    x = _rand(2, 5, 300, scale=20.0)
    p = {"alpha": np.abs(_rand(1, 5, 1, seed=11)) + 0.2}
    _close(TC.snake(params_from_numpy(p), torch.tensor(x), fast=fast),
           JC.snake(p, x, fast=fast), rtol=1e-5, atol=2e-5)
    z = _rand(1000, seed=12, scale=100.0)
    np.testing.assert_allclose(TC.sin2_fast(torch.tensor(z)).numpy(),
                               np.asarray(JC._sin2_fast(jnp.asarray(z))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_ode_integrators(method):
    a = _rand(3, 4, seed=13)
    y0 = _rand(3, 4, seed=14)

    def ft(t, y):
        return torch.tensor(a) * y + torch.sin(t)

    def fj(t, y):
        return a * y + jnp.sin(t)

    _close(TO.odeint(ft, torch.tensor(y0), method=method, step_size=2 / 32),
           JO.odeint(fj, jnp.asarray(y0), method=method, step_size=2 / 32))
    with pytest.raises(ValueError):
        TO.odeint(ft, torch.tensor(y0), step_size=0.3)
