"""Flow-matching training in the PyTorch port against the JAX package (fp32,
CPU, a DiT of 128 x 2 with one 128-wide head, so that self-attention takes
kernel 1's route; inputs from a numpy seed; bound 1e-4): the loss with
JAX's t and x0 injected, the gradient of every trainable leaf against
jax.grad, Trainer steps against JAX's Trainer (warmup + cosine, clipping,
accumulation, EMA), the learning-rate schedules against optax, the remat
policies, dropout, and the attention kernels' autograd Functions run with
their plain forwards injected."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sam_audio_tpu.config import tiny_test_config as jax_tiny_config
from sam_audio_tpu.models.sam_audio import sam_audio_init as jax_sam_audio_init
from sam_audio_tpu.train import flow_matching as jfm
from sam_audio_tpu_torch.checkpoint import params_from_numpy
from sam_audio_tpu_torch.config import SAMAudioConfig
from sam_audio_tpu_torch.ops import nn as N
from sam_audio_tpu_torch.ops.flash_attention import FlashAttentionFn, flash_attention_plain
from sam_audio_tpu_torch.ops.fused_attention import (
    FusedGlueAttentionFn, fused_glue_attention_plain)
from sam_audio_tpu_torch.ops.rope import precompute_rope
from sam_audio_tpu_torch.train import flow_matching as fm
from sam_audio_tpu_torch.utils import tree_leaves_with_path

TOL = dict(rtol=1e-4, atol=1e-4)


def jax_cfg(dropout=0.0):
    tr = jax_tiny_config().transformer.__class__(
        dim=128, n_heads=1, n_layers=2, dropout=dropout, context_dim=128,
        max_positions=64, frequency_embedding_dim=8, out_channels=8)
    return jax_tiny_config(transformer=tr)


def port_cfg(cfg):
    return SAMAudioConfig.from_dict(dataclasses.asdict(cfg))


def jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, jax_sam_audio_init(jax.random.PRNGKey(seed), cfg))


def np_batch(cfg, b=2, t=12, text_len=5, seed=3):
    rng = np.random.RandomState(seed)
    c2 = 2 * cfg.audio_codec.codebook_dim
    text_mask = np.ones((b, text_len), bool)
    text_mask[1, 3:] = False
    pad = np.ones((b, t), bool)
    pad[1, 9:] = False
    align = rng.randint(0, 4, (b, t)).astype(np.int32)
    align[~pad] = 1
    return {
        "audio_features": rng.randn(b, t, c2).astype(np.float32),
        "target_latents": rng.randn(b, t, c2).astype(np.float32),
        "text_features": rng.randn(b, text_len, cfg.text_encoder.dim).astype(np.float32),
        "text_mask": text_mask,
        "anchor_ids": np.array([[0, 3, 1, 2], [0, 3, 3, 3]], np.int32)[:b],
        "anchor_alignment": align,
        "audio_pad_mask": pad,
    }


def to_torch(batch):
    out = {}
    for k, v in batch.items():
        x = torch.from_numpy(np.asarray(v))
        out[k] = x.long() if x.dtype == torch.int32 else x
    return out


def jax_draws(rng, batch):
    """JAX's t and x0 for flow_matching_loss(..., rng)."""
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    x1 = batch["target_latents"]
    t = jax.random.uniform(t_rng, (x1.shape[0],), jnp.float32)
    x0 = jax.random.normal(n_rng, x1.shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(x0))


def trainable_paths(params):
    return [p for p, _ in tree_leaves_with_path(params)
            if not p.startswith(fm.DEFAULT_FROZEN_PREFIXES)]


def assert_tree_close(ours, ref, paths=None, **tol):
    ref = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, ref)))
    for path, x in tree_leaves_with_path(ours):
        if paths is None or path in paths:
            np.testing.assert_allclose(x.detach().numpy(), ref[path], err_msg=path,
                                       **(tol or TOL))


@pytest.mark.parametrize("remat", [None, "full"])
def test_flow_matching_loss_matches_jax(remat):
    cfg = jax_cfg()
    params = jax_params(cfg)
    batch = np_batch(cfg)
    rng = jax.random.PRNGKey(11)
    ref = jfm.flow_matching_loss(params, cfg, batch, rng, remat=remat or False)
    t, x0 = jax_draws(rng, batch)
    ours = fm.flow_matching_loss(params_from_numpy(params), port_cfg(cfg), to_torch(batch),
                                 t=t, x0=x0, remat=remat)
    np.testing.assert_allclose(float(ours), float(ref), **TOL)


def test_gradients_match_jax_grad():
    cfg = jax_cfg()
    params = jax_params(cfg)
    batch = np_batch(cfg)
    rng = jax.random.PRNGKey(12)
    ref = jax.grad(lambda p: jfm.flow_matching_loss(p, cfg, batch, rng))(params)
    t, x0 = jax_draws(rng, batch)
    tp = params_from_numpy(params)
    paths = trainable_paths(tp)
    leaves = dict(tree_leaves_with_path(tp))
    for p in paths:
        leaves[p].requires_grad_(True)
    loss = fm.flow_matching_loss(tp, port_cfg(cfg), to_torch(batch), t=t, x0=x0)
    grads = torch.autograd.grad(loss, [leaves[p] for p in paths], allow_unused=True)
    ref = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, ref)))
    attn = 0
    for p, g in zip(paths, grads):
        g = torch.zeros_like(leaves[p]) if g is None else g
        np.testing.assert_allclose(g.numpy(), ref[p], err_msg=p, **TOL)
        if "/attention/" in p and ("/wq/" in p or "q_norm" in p):
            attn += 1
            assert float(g.abs().max()) > 0, p      # kernel 1's route carries a gradient
    assert attn == 2


TRAINER_KW = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip=0.5, lr_schedule="cosine",
                  warmup_steps=1, total_steps=4, final_lr_ratio=0.1, ema_decay=0.9)


@pytest.mark.parametrize("accum,micro_steps", [(1, 3), (2, 6)], ids=["accum1", "accum2"])
def test_trainer_steps_match_jax(accum, micro_steps):
    cfg = jax_cfg()
    params = jax_params(cfg)
    batches = [np_batch(cfg, seed=20 + i) for i in range(micro_steps)]
    rngs = jax.random.split(jax.random.PRNGKey(13), micro_steps)
    jt = jfm.Trainer(cfg, jax.tree_util.tree_map(jnp.asarray, params), accum_steps=accum,
                     **TRAINER_KW)
    ours = fm.Trainer(port_cfg(cfg), params_from_numpy(params), device="cpu",
                      accum_steps=accum, **TRAINER_KW)
    clipped = 0
    for batch, rng in zip(batches, rngs):
        ref = jt.step(batch, rng)
        t, x0 = jax_draws(rng, batch)
        got = ours.step(to_torch(batch), t=t, x0=x0)
        np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), **TOL)
        np.testing.assert_allclose(float(got["grad_norm"]), float(ref["grad_norm"]), **TOL)
        clipped += float(ref["grad_norm"]) >= TRAINER_KW["grad_clip"]
    assert clipped, "the clip never triggered"
    assert ours.state.step == int(jt.state.step) == micro_steps
    assert_tree_close(ours.state.params, jt.state.params)
    assert_tree_close(ours.ema_inference_params(), jt.ema_inference_params())
    # the frozen towers did not move; a trainable leaf did
    start = dict(tree_leaves_with_path(params))
    now = dict(tree_leaves_with_path(ours.state.params))
    for p, x in now.items():
        if p.startswith(fm.DEFAULT_FROZEN_PREFIXES):
            assert np.array_equal(x.detach().numpy(), start[p]), p
    assert not np.array_equal(now["transformer/layers/attention/wq/weight"].detach().numpy(),
                              start["transformer/layers/attention/wq/weight"])


@pytest.mark.parametrize("schedule,warmup,total,ratio", [
    ("constant", 0, 0, 0.0), ("constant", 3, 10, 0.0), ("cosine", 3, 10, 0.1),
    ("cosine", 0, 7, 0.0), ("linear", 2, 9, 0.2), ("linear", 0, 1, 0.5)])
def test_lr_schedule_matches_optax(schedule, warmup, total, ratio):
    ref = jfm.make_lr_schedule(3e-4, schedule, warmup, total, ratio)
    ours = fm.make_lr_schedule(3e-4, schedule, warmup, total, ratio)
    assert callable(ours) == callable(ref)
    for count in range(total + 4):
        want = float(ref(count)) if callable(ref) else ref
        got = ours(count) if callable(ours) else ours
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=str(count))
    if warmup:
        assert ours(0) == 0.0   # the count is read before its increment


def test_adamw_clip_and_decay_match_optax():
    """The optimizer alone: clip_by_global_norm + adamw (decay masked to the
    trainable leaves) over two steps, on gradients from a numpy seed."""
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32),
              "frozen": rng.randn(2).astype(np.float32)}
    grads = [{k: (s * rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
             for s in (3.0, 0.01)]
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        fm.make_lr_schedule(1e-2, "cosine", 1, 3, 0.0), weight_decay=0.3,
        mask={"a": True, "b": True, "frozen": False}))
    jp, st = jax.tree_util.tree_map(jnp.asarray, params), None
    st = opt.init(jp)
    state = fm.new_train_state(params_from_numpy(params), lambda p: p != "frozen",
                               weight_decay=0.3, ema_decay=0.0, accum_steps=1, generators={})
    leaves = dict(tree_leaves_with_path(state.params))
    for g in grads:
        gj = dict(g, frozen=np.zeros(2, np.float32))
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, gj), st, jp)
        jp = optax.apply_updates(jp, upd)

        def loss_fn(g=g):
            loss = sum((leaves[k] * torch.from_numpy(g[k])).sum() for k in ("a", "b"))
            return loss, {}

        fm.apply_step(state, loss_fn, grad_clip=1.0,
                      lr_schedule=fm.make_lr_schedule(1e-2, "cosine", 1, 3, 0.0))
    assert_tree_close(state.params, jp, rtol=1e-5, atol=1e-6)


def test_remat_policies_give_equal_gradients():
    """None, "full" and "dots" on the same seeds, dropout on: the recomputed
    layers must draw the same masks."""
    cfg = port_cfg(jax_cfg(dropout=0.1))
    params = params_from_numpy(jax_params(jax_cfg(dropout=0.1)))
    batch = to_torch(np_batch(jax_cfg()))
    paths = trainable_paths(params)
    leaves = dict(tree_leaves_with_path(params))
    for p in paths:
        leaves[p].requires_grad_(True)
    out = {}
    for remat in (None, "full", "dots"):
        loss = fm.flow_matching_loss(params, cfg, batch, torch.Generator().manual_seed(1),
                                     remat=remat,
                                     dropout_generator=torch.Generator().manual_seed(2))
        out[remat] = [float(loss.detach())] + [g for g in torch.autograd.grad(
            loss, [leaves[p] for p in paths], allow_unused=True)]
    no_dropout = fm.flow_matching_loss(params, cfg, batch, torch.Generator().manual_seed(1))
    assert abs(float(no_dropout.detach()) - out[None][0]) > 1e-6     # dropout was on
    for remat in ("full", "dots"):
        assert out[remat][0] == pytest.approx(out[None][0], rel=1e-6)
        for p, a, b in zip(paths, out[remat][1:], out[None][1:]):
            if a is None or b is None:
                assert a is None and b is None, p
                continue
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=p)


def test_dropout_identity_and_keep_fraction():
    x = torch.randn(400, 500, generator=torch.Generator().manual_seed(0))
    assert N.dropout(x, 0.0, torch.Generator().manual_seed(1)) is x
    assert N.dropout(x, 0.1, None) is x
    y = N.dropout(x, 0.1, torch.Generator().manual_seed(1))
    keep = (y != 0)
    assert abs(float(keep.float().mean()) - 0.9) < 0.005
    torch.testing.assert_close(y[keep], x[keep] / 0.9)
    assert torch.equal(y, N.dropout(x, 0.1, torch.Generator().manual_seed(1)))
    # bf16 keeps its dtype
    assert N.dropout(x.bfloat16(), 0.5, torch.Generator().manual_seed(1)).dtype == torch.bfloat16


def _glue(dtype=torch.float32, b=2, t=40, h=2, d=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, t, h, d, generator=g).to(dtype) for _ in range(3))
    qw, kw = (1 + 0.1 * torch.randn(d, generator=g) for _ in range(2))
    cos, sin = precompute_rope(d, t, 20000)
    mask = torch.ones((b, t), dtype=torch.bool)
    mask[1, t * 3 // 4:] = False
    return q, k, v, qw, kw, cos, sin, mask


@pytest.mark.parametrize("with_mask", [True, False])
def test_fused_attention_function_backward_equals_plain_autograd(with_mask):
    q, k, v, qw, kw, cos, sin, mask = _glue()
    mask = mask if with_mask else None
    inputs = [x.requires_grad_(True) for x in (q, k, v, qw, kw)]
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    out = FusedGlueAttentionFn.apply(fused_glue_attention_plain, *inputs, cos, sin, mask, 1e-5)
    got = torch.autograd.grad((out * w).sum(), inputs)
    ref_out = fused_glue_attention_plain(*inputs, cos, sin, mask, 1e-5)
    ref = torch.autograd.grad((ref_out * w).sum(), inputs)
    torch.testing.assert_close(out, ref_out, rtol=0, atol=0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # only the inputs that need a gradient get one
    q2 = q.detach()
    out = FusedGlueAttentionFn.apply(fused_glue_attention_plain, q2, k, v, qw.detach(),
                                     kw, cos, sin, mask, 1e-5)
    gk, gkw = torch.autograd.grad((out * w).sum(), [k, kw])
    torch.testing.assert_close(gk, ref[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gkw, ref[4], rtol=1e-6, atol=1e-6)


def test_flash_attention_function_backward_equals_plain_autograd():
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(2, 140, 2, 128, generator=g).requires_grad_(True) for _ in range(3))
    mask = torch.ones((2, 140), dtype=torch.bool)
    mask[0, 100:] = False
    w = torch.randn(q.shape, generator=g)
    out = FlashAttentionFn.apply(flash_attention_plain, q, k, v, mask, None)
    got = torch.autograd.grad((out * w).sum(), [q, k, v])
    ref = torch.autograd.grad((flash_attention_plain(q, k, v, mask) * w).sum(), [q, k, v])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_trainer_refuses_bf16_master_params():
    """A model's stored weights (bf16 matmul weights) are not a master copy."""
    from sam_audio_tpu_torch.checkpoint import cast_matmul_weights

    cfg = jax_cfg()
    params = cast_matmul_weights(params_from_numpy(jax_params(cfg)), torch.bfloat16)
    with pytest.raises(ValueError, match="fp32 master"):
        fm.Trainer(port_cfg(cfg), params, device="cpu")
